"""Port parity: the level-batched extractor pieces and the describe kernel's
plain version and formulation.

* The sparse descriptor table the describe kernel reads, scattered back to
  dense, is the descriptor+moment operator, bitwise.
* ``detect_cells_levels`` and ``_select_levels`` (all levels at once) equal
  the per-level plain functions exactly, ties and unfilled slots included,
  and ``extract_orb`` equals the per-level composition it replaced.
* The describe plain function equals JAX's gather + ``_angle_and_desc`` on
  the same level images, under the tolerance of ``test_torch_extractor``:
  bits agree wherever the JAX score is farther than 1e-2 from 0, angles
  within 1e-4 rad.
* A float64 evaluation of the kernel's arithmetic (exact moments over the
  disc, the sparse table of the chosen bin only) agrees with the dense
  plain product under the kernel's tolerance: angles within 1e-4 rad
  (mod 2 pi), bins on >= 99.5% of keypoints, bits wherever the plain score
  is farther than 1e-2 from 0 on keypoints whose bins agree.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu.features import extractor as JE
from cubemapslam_tpu_torch import SlamConfig, interop
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.features import extractor as TE

INI, MIN, CELL = 20, 7, 32


def textured(H, W, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (H // 4 + 1, W // 4 + 1)).astype(np.float32)
    img = np.kron(coarse, np.ones((4, 4), np.float32))[:H, :W]
    return img + rng.normal(0, 3, img.shape).astype(np.float32)


def tied(H, W):
    img = np.full((H, W), 40.0, np.float32)
    for y in range(-2, H, 23):
        for x in range(-1, W, 29):
            img[max(y, 0):y + 9, max(x, 0):x + 9] = 200.0
    return img


def pyramid(img, n_levels):
    plan = TE.plan_levels(256, n_levels, 1.2, img.shape)
    t = torch.as_tensor(img)
    return [t] + [TE.pyramid_level(t, A, Bt)
                  for A, Bt in TE.pyramid_operators(plan.level_hw, "cpu")]


def keypoints(levels, level_k, seed):
    """Random integer keypoints per level, some outside the image (the
    gather clamps them)."""
    rng = np.random.default_rng(seed)
    ys, xs = [], []
    for lv, k in zip(levels, level_k):
        H, W = lv.shape
        ys.append(np.concatenate([rng.integers(0, H, k - 4),
                                  [-5, 0, H - 1, H + 7]]))
        xs.append(np.concatenate([rng.integers(0, W, k - 4),
                                  [2, -9, W + 3, W - 1]]))
    return np.concatenate(ys), np.concatenate(xs)


def unpack_bits(desc):
    return np.unpackbits(interop.desc_to_numpy(desc).view(np.uint8),
                         bitorder="little").reshape(-1, 256)


def rot_bin(ang):
    return np.mod(np.rint(ang.astype(np.float32) * np.float32(
        TE.N_ROT / (2.0 * np.pi))).astype(np.int64), TE.N_ROT)


def test_table_scatters_back_to_operator():
    table = TE.desc_table("cpu")
    assert table.shape[0] == TE.N_ROT and table.shape[2] == 256
    assert table.dtype == torch.int32
    assert torch.equal(TE._operator_from_table(table),
                       TE.desc_operator("cpu"))


@pytest.mark.parametrize("kind", ["tied", "textured"])
def test_level_batched_detect_and_select(kind):
    img = tied(300, 380) if kind == "tied" else textured(300, 380, 1)
    levels = pyramid(img, 4)
    cands = TE.detect_cells_levels(levels, CELL, INI, MIN)
    per_level = [TE._detect_cells_plain(lv, CELL, INI, MIN) for lv in levels]
    for a, parts in zip(cands, zip(*per_level)):
        assert torch.equal(a, torch.cat(parts))
    # the last level asks for more than its 4 x cells candidates
    cells = tuple(TE._n_cells(lv.shape, CELL) for lv in levels)
    level_k = (60, 50, 40, 4 * cells[-1] + 7)
    index, take = (torch.as_tensor(a)
                   for a in TE._selection_index(cells, level_k))
    got = TE._select_levels(cands, index, take)
    want = [TE._detect_level(lv, k, CELL, INI, MIN)
            for lv, k in zip(levels, level_k)]
    for a, parts in zip(got, zip(*want)):
        assert a.dtype == parts[0].dtype
        assert torch.equal(a, torch.cat(parts))
    if kind == "tied":
        r = got[4][:level_k[0]].numpy()
        assert len(np.unique(r[r > 0])) < (r > 0).sum()   # ties were ranked


def test_extract_orb_equals_per_level_composition():
    cfg = SlamConfig(cube_face_w=96, cube_face_h=96, n_features=300,
                     n_levels=4)
    cam = CubemapCamera.from_config(cfg, "cpu")
    ex, params = TE.build_extractor(cfg, cam, cfg.n_features,
                                    (cfg.cube_h, cfg.cube_w))
    img = torch.as_tensor(textured(cfg.cube_h, cfg.cube_w, 7))
    kp = ex(img)
    # the composition the level-batched path replaced
    levels = [img] + [TE.pyramid_level(img, A, Bt) for A, Bt in ex.ops.pyr]
    uv, resp, patches = [], [], []
    for lv, (lvl_img, k) in enumerate(zip(levels, params.level_k)):
        ys, xs, ys_f, xs_f, r = TE._detect_level(lvl_img, k, params.cell,
                                                 ex.ini_th, ex.min_th)
        patches.append(TE.gather_patches(lvl_img, ys, xs))
        s = params.scale_factor ** lv
        uv.append(torch.stack([xs_f * s, ys_f * s], dim=-1))
        resp.append(r)
    ang, desc = TE._angle_and_desc(torch.cat(patches),
                                   TE.desc_operator("cpu"))
    assert torch.equal(kp.uv, torch.cat(uv))
    assert torch.equal(kp.response, torch.cat(resp))
    assert torch.equal(kp.angle, ang)
    assert torch.equal(kp.desc, desc)
    assert torch.equal(kp.level, torch.repeat_interleave(
        torch.arange(params.n_levels), torch.tensor(params.level_k)))
    assert int(kp.valid.sum()) > 50


def test_describe_plain_matches_jax():
    levels = pyramid(textured(300, 380, 2), 4)
    level_k = (120, 90, 60, 40)
    ys, xs = keypoints(levels, level_k, 3)
    ang, desc = TE.describe_keypoints(levels, torch.as_tensor(ys),
                                      torch.as_tensor(xs), level_k,
                                      TE.desc_table("cpu"))
    b = np.concatenate([[0], np.cumsum(level_k)])
    j_ang, j_desc, j_sc = [], [], []
    op = jnp.asarray(JE._desc_and_moment_operator(), jnp.bfloat16)
    for i, lv in enumerate(levels):
        patches = JE._gather_patches_padded(
            jnp.asarray(lv.numpy()), jnp.asarray(ys[b[i]:b[i + 1]], jnp.int32),
            jnp.asarray(xs[b[i]:b[i + 1]], jnp.int32))
        a, d = JE._angle_and_desc(patches)
        fused = np.asarray(jnp.dot(
            patches.reshape(patches.shape[0], -1).astype(jnp.bfloat16), op,
            preferred_element_type=jnp.float32))
        sc = fused[:, :TE.N_ROT * 256].reshape(-1, TE.N_ROT, 256)
        j_sc.append(sc[np.arange(len(sc)), rot_bin(np.asarray(a))])
        j_ang.append(np.asarray(a))
        j_desc.append(np.asarray(d))
    np.testing.assert_allclose(ang.numpy(), np.concatenate(j_ang), atol=1e-4)
    jbits = np.unpackbits(np.concatenate(j_desc).view(np.uint8),
                          bitorder="little").reshape(-1, 256)
    tbits = unpack_bits(desc)
    firm = np.abs(np.concatenate(j_sc)) > 1e-2
    np.testing.assert_array_equal(tbits[firm], jbits[firm])
    assert (tbits == jbits).mean() > 0.999


def kernel_arithmetic_f64(levels, ys, xs, level_k, table):
    """The describe kernel's arithmetic in float64: the 43x43 window of
    bf16-rounded pixels, exact moments over the radius-15 disc rounded once
    to float32, the float32 angle and bin, and the chosen bin's scores from
    the sparse table."""
    win, r = TE._WIN, TE.RAW_R
    words = table.numpy().view(np.uint32)
    coef = (words & 0xFFFF0000).view(np.float32).astype(np.float64)
    off = (words & 0xFFFF).astype(np.int64)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    disc = dx * dx + dy * dy <= TE.ORI_R ** 2
    b = np.concatenate([[0], np.cumsum(level_k)])
    angs, scores = [], []
    for i, lv in enumerate(levels):
        img = TE._bf16_round(lv).numpy().astype(np.float64)
        H, W = img.shape
        for y, x in zip(ys[b[i]:b[i + 1]], xs[b[i]:b[i + 1]]):
            yc, xc = np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)
            rows = np.clip(yc - r + np.arange(win), 0, H - 1)
            cols = np.clip(xc - r + np.arange(win), 0, W - 1)
            patch = img[rows[:, None], cols[None, :]]
            m10 = np.float32((dx * patch)[disc].sum())
            m01 = np.float32((dy * patch)[disc].sum())
            ang = np.arctan2(m01, m10)
            bn = rot_bin(np.array([ang]))[0]
            flat = patch.reshape(-1)
            scores.append((coef[bn] * flat[off[bn]]).sum(axis=0))
            angs.append(ang)
    return np.array(angs, np.float32), np.array(scores)


def test_kernel_arithmetic_agrees_with_dense_product():
    levels = pyramid(textured(300, 380, 4), 4)
    level_k = (100, 80, 60, 40)
    ys, xs = keypoints(levels, level_k, 5)
    table = TE.desc_table("cpu")
    ang, sc = kernel_arithmetic_f64(levels, ys, xs, level_k, table)
    args = (levels, torch.as_tensor(ys), torch.as_tensor(xs), level_k, table)
    p_ang, p_desc = TE._describe_plain(*args)
    p_ang = p_ang.numpy()
    d = np.mod(ang - p_ang + np.pi, 2 * np.pi) - np.pi
    assert np.abs(d).max() <= 1e-4
    same = rot_bin(ang) == rot_bin(p_ang)
    assert same.mean() >= 0.995
    # the plain version's scores of its chosen bin
    K = len(ys)
    b = np.concatenate([[0], np.cumsum(level_k)])
    flat = TE._bf16_round(torch.cat([
        TE._gather_patches_plain(lv, args[1][b[i]:b[i + 1]],
                                 args[2][b[i]:b[i + 1]])
        for i, lv in enumerate(levels)]).reshape(K, -1))
    fused = (flat @ TE.desc_operator("cpu")).numpy()
    p_sc = fused[:, :TE.N_ROT * 256].reshape(K, TE.N_ROT, 256)[
        np.arange(K), rot_bin(p_ang)]
    bits, p_bits = sc > 0, unpack_bits(p_desc).astype(bool)
    firm = (np.abs(p_sc) > 1e-2) & same[:, None]
    np.testing.assert_array_equal(bits[firm], p_bits[firm])
    share = (bits == p_bits).mean()
    print(f"bins equal on {same.mean():.4f}; bits equal {share:.6f}")
    assert share > 0.999


def test_wrappers_never_drop_to_plain_off_the_cpu():
    """A tensor that is not on the CPU launches a kernel or raises; on a
    device without the kernels (meta) every wrapper raises."""
    img = torch.zeros((64, 64), device="meta")
    idx = torch.zeros((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        TE.detect_cells_levels([img], 8, INI, MIN)     # no kernel for 8 px
    with pytest.raises(ValueError):
        TE.detect_cells_levels([img], CELL, INI, MIN)  # not a CUDA tensor
    with pytest.raises(ValueError):
        TE.describe_keypoints([img], idx, idx, [4],
                              TE.desc_table("meta"))
    with pytest.raises(ValueError):
        TE.gather_patches(img, idx, idx)
    with pytest.raises(ValueError):                   # levels on two devices
        TE.detect_cells_levels([torch.zeros((64, 64)), img], CELL, INI, MIN)
