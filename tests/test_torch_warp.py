"""Port parity: warp map, FOV mask and the plain version of kernel W.

The port's map is built by its own camera code; its source coordinates agree
with the JAX map's within 1e-3 px. Carried across (the JAX camera's source
coordinates, the input of its build_warp_map), the port derives exactly the
JAX map's gather index and weights. The resampler is held to JAX's
warp_bilinear on that map within 1e-3 (float32 rounding of the four-term
sum only), and to the TPU warp pair (in interpret mode) with that test's own
bounds: mean < 0.5, p99 < 3.0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import warp as JW
from cubemapslam_tpu import warp_tpu as WT
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch import warp as TW
from cubemapslam_tpu_torch import warp_cuda
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam


@pytest.fixture(scope="module")
def setup():
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4)
    jcam = JCam.from_config(cfg)
    tcam = TCam.from_config(cfg, "cpu")
    jwm = JW.build_warp_map(jcam, cfg.cube_w, cfg.cube_h)
    twm = TW.build_warp_map(tcam, cfg.cube_w, cfg.cube_h)
    return cfg, jcam, tcam, jwm, twm


def carried(jcam, cfg):
    """The JAX camera's source coordinates of the cross, carried across."""
    uu, vv = jnp.meshgrid(jnp.arange(cfg.cube_w, dtype=jnp.float32),
                          jnp.arange(cfg.cube_h, dtype=jnp.float32))
    uv_f, valid = JC.cubemap_to_fisheye(jcam, jnp.stack([uu, vv], axis=-1))
    return interop.warp_map_from_numpy(
        np.asarray(uv_f), np.asarray(valid),
        (cfg.fisheye_width, cfg.fisheye_height))


def source_coords(idx00, w, W):
    """Fisheye coordinates a map samples: corner + bilinear fraction."""
    x = idx00 % W + w[..., 1] + w[..., 3]
    y = idx00 // W + w[..., 2] + w[..., 3]
    return x, y


def fisheye_image(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (cfg.fisheye_height, cfg.fisheye_width),
                        dtype=np.uint8)


def test_build_warp_map_and_fov_mask(setup):
    cfg, jcam, tcam, jwm, twm = setup
    jv, tv = np.asarray(jwm.valid), twm.valid.numpy()
    # validity is decided by the same comparisons on coordinates that
    # agree to float32 ulps: equal except on the image rim
    assert (jv != tv).sum() <= 0.0005 * jv.size
    assert twm.src_wh == tuple(int(v) for v in np.asarray(jwm.src_wh))
    W = cfg.fisheye_width
    both = jv & tv
    jx, jy = source_coords(np.asarray(jwm.idx00), np.asarray(jwm.w), W)
    idx00, w = (t.numpy() for t in TW.bilinear_operands(twm))
    tx, ty = source_coords(idx00, w, W)
    np.testing.assert_allclose(tx[both], jx[both], atol=1e-3)
    np.testing.assert_allclose(ty[both], jy[both], atol=1e-3)
    assert idx00.dtype == np.int32 and twm.xy.dtype == torch.float32
    assert np.isnan(twm.xy.numpy()[~tv]).all()
    np.testing.assert_array_equal(
        np.asarray(JW.fov_mask(jcam, cfg.cube_w, cfg.cube_h)),
        TW.fov_mask(tcam, cfg.cube_w, cfg.cube_h).numpy())


def test_carried_map_gives_the_jax_operands(setup):
    cfg, jcam, _, jwm, _ = setup
    wm = carried(jcam, cfg)
    idx00, w = TW.bilinear_operands(wm)
    np.testing.assert_array_equal(idx00.numpy(), np.asarray(jwm.idx00))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jwm.w))
    np.testing.assert_array_equal(wm.valid.numpy(), np.asarray(jwm.valid))


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_bilinear_on_carried_map(setup, seed):
    cfg, jcam, _, jwm, _ = setup
    img = fisheye_image(cfg, seed)
    ref = np.asarray(JW.warp_bilinear(jnp.asarray(img), jwm))
    wm = carried(jcam, cfg)
    out = TW.warp_bilinear(torch.as_tensor(img), wm)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)
    # the kernel's wrapper takes the plain version on a CPU tensor
    np.testing.assert_array_equal(
        warp_cuda.warp_to_cross(torch.as_tensor(img), wm).numpy(),
        out.numpy())
    assert (out.numpy()[~np.asarray(jwm.valid)] == 0).all()
    np.testing.assert_array_equal(
        TW.warp_nearest(torch.as_tensor(img), wm).numpy(),
        np.asarray(JW.warp_nearest(jnp.asarray(img), jwm)))
    np.testing.assert_array_equal(
        TW.extract_faces(out, cfg.cube_face_w, cfg.cube_face_h).numpy(),
        np.asarray(JW.extract_faces(jnp.asarray(out.numpy()),
                                    cfg.cube_face_w, cfg.cube_face_h)))


def test_wrapper_checks_inputs(setup):
    cfg, _, _, _, twm = setup
    img = torch.as_tensor(fisheye_image(cfg, 0))
    with pytest.raises(ValueError):
        warp_cuda.warp_to_cross(img.float(), twm)
    with pytest.raises(ValueError):
        warp_cuda.warp_to_cross(img[:-1], twm)


@pytest.fixture()
def interp_pallas():
    """Run the TPU warp kernels in interpret mode on the CPU."""
    orig = WT.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    WT.pl.pallas_call = patched
    yield
    WT.pl.pallas_call = orig


def test_plain_warp_against_tpu_warp_pair(setup, interp_pallas):
    cfg, jcam, tcam, _, twm = setup
    yy, xx = np.mgrid[0:cfg.fisheye_height,
                      0:cfg.fisheye_width].astype(np.float32)
    img = np.clip(120 + 70 * np.sin(xx / 13) * np.cos(yy / 19)
                  + 30 * np.sin((xx - yy) / 11), 0, 255).astype(np.uint8)
    faces = np.asarray(WT.DeviceWarp(jcam, cfg.cube_w, cfg.cube_h)(
        jnp.asarray(img.astype(np.float32))))
    cube = TW.warp_bilinear(torch.as_tensor(img), twm).numpy()
    fh, fw = cfg.cube_face_h, cfg.cube_face_w
    e = np.stack([np.abs(faces[i] - cube[cy * fh:(cy + 1) * fh,
                                         cx * fw:(cx + 1) * fw])
                  for i, (cx, cy) in enumerate(WT.FACE_CELLS)])
    assert e.mean() < 0.5, e.mean()
    assert np.percentile(e, 99) < 3.0, np.percentile(e, 99)
