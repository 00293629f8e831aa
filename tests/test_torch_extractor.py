"""Port parity: ORB extractor, including the plain versions of kernels D and G.

On the same level image the port's FAST strength, cell fallback, NMS,
per-cell and global top-k, subpixel offsets and patch gather are exact (the
same float32 operations; the tie order of lax.top_k is reproduced with
stable sorts). The images include tied responses and corners within 3 px of
the edges, where FAST wraps around.

The bf16-operand products (pyramid, descriptor+moment operator) accumulate
in another order than XLA's, so: descriptor bits agree wherever the JAX
comparison score is farther than 1e-2 from 0, angles agree within 1e-4 rad,
and the whole extractor gives the same valid keypoints, levels and uv
(within 1e-4) on at least 99% of rows.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cubemapslam_tpu import synth
from cubemapslam_tpu import warp as JW
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu.features import extractor as JE
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.features import extractor as TE

INI, MIN, CELL = 20, 7, 32


def tied_image():
    """Identical squares (tied FAST responses) on a flat background, some
    within 3 px of the image edges, where FAST neighbours wrap around."""
    H, W = 150, 203
    img = np.full((H, W), 40.0, np.float32)
    for y in range(-2, H, 23):
        for x in range(-1, W, 29):
            img[max(y, 0):y + 9, max(x, 0):x + 9] = 200.0
    img[H - 2:, 60:70] = 220.0            # touches the bottom edge
    img[70:80, W - 2:] = 10.0             # touches the right edge
    return img


def textured_image():
    rng = np.random.default_rng(0)
    coarse = rng.uniform(0, 255, (40, 52)).astype(np.float32)
    img = np.kron(coarse, np.ones((4, 4), np.float32))[:157, :201]
    return img + rng.normal(0, 3, img.shape).astype(np.float32)


IMAGES = {"tied": tied_image, "textured": textured_image}


def jax_detect(img, k):
    """The JAX CPU detect path of _extract_level, step by step."""
    raw = JE._fast_adaptive(img, INI, MIN, CELL)
    score = JE._nms3(raw)
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W]
    b = JE.EDGE_BORDER
    inb = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    score = jnp.where(inb, score, 0.0)
    ys, xs, resp = JE._topk_grid(score, CELL, k)
    dy, dx = JE._subpixel_offsets(raw, ys, xs)
    return raw, score, ys, xs, resp, dy, dx


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_fast_nms_topk_subpixel_exact(name):
    img = IMAGES[name]()
    jimg, timg = jnp.asarray(img), torch.as_tensor(img)
    jhi, jlo, js = JE._fast_maps_dual(jimg, INI, MIN)
    thi, tlo, ts = TE._fast_maps_dual(timg, INI, MIN)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    # corners within 3 px of the edges see the opposite edge
    edge = np.zeros(img.shape, bool)
    edge[:3], edge[-3:], edge[:, :3], edge[:, -3:] = True, True, True, True
    assert (np.asarray(jhi) & edge).any()

    k = 60
    raw, score, ys, xs, resp, dy, dx = jax_detect(jimg, k)
    traw = TE._fast_adaptive(timg, INI, MIN, CELL)
    np.testing.assert_array_equal(traw.numpy(), np.asarray(raw))
    tscore = TE._border_mask(TE._nms3(traw))
    np.testing.assert_array_equal(tscore.numpy(), np.asarray(score))
    tys, txs, tresp = TE._topk_grid(tscore, CELL, k)
    np.testing.assert_array_equal(tys.numpy(), np.asarray(ys))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(tresp.numpy(), np.asarray(resp))
    tdy, tdx = TE._subpixel_offsets(traw, tys, txs)
    np.testing.assert_array_equal(tdy.numpy(), np.asarray(dy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(dx))
    if name == "tied":
        r = np.asarray(resp)
        assert len(np.unique(r[r > 0])) < (r > 0).sum()   # ties were ranked

    # the level detector the kernel path shares: per-cell candidates of
    # the plain version of kernel D, then the stable global selection
    yi, xi, ys_f, xs_f, tr = TE._detect_level(timg, k, CELL, INI, MIN)
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ys))
    np.testing.assert_array_equal(xi.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(resp))
    np.testing.assert_array_equal(
        ys_f.numpy(), np.asarray(ys.astype(jnp.float32) + dy))
    np.testing.assert_array_equal(
        xs_f.numpy(), np.asarray(xs.astype(jnp.float32) + dx))
    # the wrapper takes the plain version on a CPU tensor
    for a, b in zip(TE.detect_cells(timg, CELL, INI, MIN),
                    TE._detect_cells_plain(timg, CELL, INI, MIN)):
        assert torch.equal(a, b)


def test_gather_patches_exact():
    img = textured_image()
    H, W = img.shape
    rng = np.random.default_rng(1)
    ys = np.concatenate([rng.integers(0, H, 40), [-5, 0, H - 1, H + 7, 3]])
    xs = np.concatenate([rng.integers(0, W, 40), [2, -9, W + 3, W - 1, 0]])
    ref = np.asarray(JE._gather_patches_padded(
        jnp.asarray(img), jnp.asarray(ys, jnp.int32),
        jnp.asarray(xs, jnp.int32)))
    out = TE.gather_patches(torch.as_tensor(img), torch.as_tensor(ys),
                            torch.as_tensor(xs))
    assert out.shape == (len(ys), 48, 48)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_operators_equal():
    np.testing.assert_array_equal(TE._desc_and_moment_operator(),
                                  JE._desc_and_moment_operator())
    hw = tuple(JE.plan_levels(256, 4, 1.2, (384, 384)).level_hw)
    for (ja, jb), (ta, tb) in zip(JE._pyramid_operators(hw),
                                  TE._pyramid_operators(hw)):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
    assert TE.plan_levels(2000, 8, 1.2, (1950, 1950)) == \
        tuple(JE.plan_levels(2000, 8, 1.2, (1950, 1950)))


def test_angle_and_desc():
    img = textured_image()
    rng = np.random.default_rng(2)
    ys = rng.integers(20, img.shape[0] - 20, 300)
    xs = rng.integers(20, img.shape[1] - 20, 300)
    patches = np.asarray(JE._gather_patches_padded(
        jnp.asarray(img), jnp.asarray(ys, jnp.int32),
        jnp.asarray(xs, jnp.int32)))
    jang, jdesc = JE._angle_and_desc(jnp.asarray(patches))
    op = TE.desc_operator("cpu")
    tang, tdesc = TE._angle_and_desc(torch.as_tensor(patches), op)
    np.testing.assert_allclose(tang.numpy(), np.asarray(jang), atol=1e-4)
    # the JAX comparison scores of the chosen bin
    fused = np.asarray(jax.lax.dot(
        jnp.asarray(patches.reshape(300, -1), jnp.bfloat16),
        jnp.asarray(JE._desc_and_moment_operator(), jnp.bfloat16),
        preferred_element_type=jnp.float32))
    bins = np.mod(np.round(np.asarray(jang) * (32 / (2 * np.pi))), 32)
    sc = fused[:, :32 * 256].reshape(300, 32, 256)[np.arange(300),
                                                     bins.astype(int)]
    jbits = np.unpackbits(np.asarray(jdesc).view(np.uint8),
                          bitorder="little").reshape(300, 256)
    tbits = np.unpackbits(interop.desc_to_numpy(tdesc).view(np.uint8),
                          bitorder="little").reshape(300, 256)
    firm = np.abs(sc) > 1e-2
    np.testing.assert_array_equal(tbits[firm], jbits[firm])
    share = (tbits == jbits).mean()
    print(f"descriptor bits equal: {share:.5f}; "
          f"firm share {firm.mean():.5f}")
    assert share > 0.999


@pytest.fixture(scope="module")
def small():
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4)
    jcam = JCam.from_config(cfg)
    return cfg, jcam, TCam.from_config(cfg, "cpu")


def render_fisheye(cfg, jcam, seed=0):
    """A synth.Renderer fisheye frame at the identity pose, as uint8."""
    rng = np.random.default_rng(seed)
    pts, patches = synth.make_world(rng, n=400, fx=cfg.cube_face_w / 2.0)
    img = synth.Renderer(jcam, cfg, target="fisheye").render(
        pts, patches, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def test_extract_orb_on_rendered_frame(small):
    cfg, jcam, tcam = small
    fish = render_fisheye(cfg, jcam)
    wm = JW.build_warp_map(jcam, cfg.cube_w, cfg.cube_h)
    cube = np.asarray(JW.warp_bilinear(jnp.asarray(fish), wm))
    mask = np.asarray(JW.fov_mask(jcam, cfg.cube_w, cfg.cube_h))
    run, _ = JE.build_extractor(cfg, jcam, cfg.n_features, cube.shape)
    jkp = run(jnp.asarray(cube), jnp.asarray(mask))
    trun, _ = TE.build_extractor(cfg, tcam, cfg.n_features, cube.shape)
    tkp = interop.keypoints_to_numpy(trun(torch.as_tensor(cube),
                                          torch.as_tensor(mask)))
    jv, tv = np.asarray(jkp.valid), tkp["valid"]
    assert jv.sum() > 100
    np.testing.assert_array_equal(tkp["level"], np.asarray(jkp.level))
    duv = np.abs(tkp["uv"] - np.asarray(jkp.uv)).max(axis=1)
    row_ok = (jv == tv) & (~jv | (duv <= 1e-4))
    assert row_ok.mean() >= 0.99, row_ok.mean()
    both = jv & tv & row_ok
    np.testing.assert_array_equal(tkp["face"][both],
                                  np.asarray(jkp.face)[both])
    np.testing.assert_allclose(tkp["rays"][both], np.asarray(jkp.rays)[both],
                               atol=1e-5)
    desc_same = (tkp["desc"][both] == np.asarray(jkp.desc)[both]).all(1)
    print(f"rows equal: {row_ok.mean():.4f}; descriptors equal on "
          f"{desc_same.mean():.4f} of valid rows")
    assert desc_same.mean() >= 0.95
