"""Port parity: the native image loader and host warp
(``cubemapslam_tpu_torch.native``), analogs of ``tests/test_native.py``.

The port builds its own copy of the loader (``csrc/dataloader.cpp``) into
``build/native/``: with PNG and JPEG where libpng and libjpeg are installed
(as here), else binary PGM alone, whose variant is built and checked here
too. Decoded 8-bit frames are exact (atol 0.5 as the JAX test), RGB luma
within 1.0. ``NativeWarp`` on the JAX map carried across is held to the
port's plain ``warp_bilinear`` and the JAX ``warp_bilinear`` within 1e-3
(float32 rounding of the four-term sum), and its face stack to the cross's
cells rounded to uint8 within 1.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import warp as JW
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu_torch import interop, native
from cubemapslam_tpu_torch import warp as TW


def write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(f"P5 {img.shape[1]} {img.shape[0]} 255\n".encode())
        f.write(img.astype(np.uint8).tobytes())


def write_png(path, img):
    Image.fromarray(img.astype(np.uint8)).save(path)


def mixed_sequence(rng, tmp_path, n=12):
    paths, imgs = [], []
    for i in range(n):
        img = rng.integers(0, 255, (48, 64)).astype(np.uint8)
        p = tmp_path / (f"f{i:03d}.pgm" if i % 2 else f"f{i:03d}.png")
        (write_pgm if i % 2 else write_png)(str(p), img)
        paths.append(str(p))
        imgs.append(img)
    return paths, imgs


def test_builds_outside_the_committed_binary():
    path = native.build(native.CODECS[0])
    assert path is not None, "the dataloader did not build with its codecs"
    assert "native/_build" not in path and "/build/native/" in path
    assert native._load_lib() is native.load_library(native.CODECS[0])


def test_ordered_decode_matches(rng, tmp_path):
    paths, imgs = mixed_sequence(rng, tmp_path)
    loader = native.NativeImageLoader(paths, n_workers=3, queue_cap=4)
    got = list(loader)
    loader.close()
    assert [i for i, _ in got] == list(range(12))
    for (_, arr), exp in zip(got, imgs):
        assert arr is not None
        np.testing.assert_allclose(arr, exp.astype(np.float32), atol=0.5)


def test_decode_failure_reported(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    loader = native.NativeImageLoader([str(bad)], n_workers=1)
    idx, arr = next(loader)
    assert idx == 0 and arr is None
    loader.close()


def test_rgb_png_luma(rng, tmp_path):
    rgb = rng.integers(0, 255, (32, 40, 3)).astype(np.uint8)
    p = tmp_path / "rgb.png"
    Image.fromarray(rgb).save(str(p))
    loader = native.NativeImageLoader([str(p)], n_workers=1)
    _, arr = next(loader)
    loader.close()
    exp = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
    np.testing.assert_allclose(arr, exp, atol=1.0)


def test_pgm_only_variant(rng, tmp_path, monkeypatch):
    """The variant built where libpng / libjpeg are missing: PGM decodes,
    PNG reports a decode failure, in order."""
    lib = native.load_library(native.CODECS[-1])
    assert native.CODECS[-1] == () and lib is not None
    monkeypatch.setattr(native, "_load_lib", lambda: lib)
    paths, imgs = mixed_sequence(rng, tmp_path, n=6)
    loader = native.NativeImageLoader(paths, n_workers=2)
    got = list(loader)
    loader.close()
    assert [i for i, _ in got] == list(range(6))
    for i, arr in got:
        if i % 2:
            np.testing.assert_array_equal(arr, imgs[i].astype(np.float32))
        else:
            assert arr is None


def test_make_loader_takes_native_and_pil_matches(rng, tmp_path):
    paths, imgs = mixed_sequence(rng, tmp_path, n=4)
    loader = native.make_loader(paths, n_workers=2)
    assert isinstance(loader, native.NativeImageLoader)
    loader.close()
    fb = list(native.FallbackImageLoader(paths))
    assert [i for i, _ in fb] == list(range(4))
    for (_, arr), exp in zip(fb, imgs):
        np.testing.assert_array_equal(arr, exp.astype(np.float32))


def test_make_loader_falls_back_to_pil(rng, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_load_lib", lambda: None)
    paths, _ = mixed_sequence(rng, tmp_path, n=2)
    assert isinstance(native.make_loader(paths),
                      native.FallbackImageLoader)


@pytest.fixture(scope="module")
def warp_setup():
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4)
    jcam = JCam.from_config(cfg)
    jwm = JW.build_warp_map(jcam, cfg.cube_w, cfg.cube_h)
    uu, vv = jnp.meshgrid(jnp.arange(cfg.cube_w, dtype=jnp.float32),
                          jnp.arange(cfg.cube_h, dtype=jnp.float32))
    uv_f, valid = JC.cubemap_to_fisheye(jcam, jnp.stack([uu, vv], axis=-1))
    twm = interop.warp_map_from_numpy(
        np.asarray(uv_f), np.asarray(valid),
        (cfg.fisheye_width, cfg.fisheye_height))
    img = np.random.default_rng(5).integers(
        0, 256, (cfg.fisheye_height, cfg.fisheye_width), dtype=np.uint8)
    return cfg, jwm, twm, img


def test_native_warp_matches_plain_and_jax(warp_setup):
    cfg, jwm, twm, img = warp_setup
    nw = native.NativeWarp(twm, n_threads=2)
    out = nw(img)
    plain = TW.warp_bilinear(torch.as_tensor(img), twm).numpy()
    ref = np.asarray(JW.warp_bilinear(jnp.asarray(img), jwm))
    assert out.shape == ref.shape == (cfg.cube_h, cfg.cube_w)
    np.testing.assert_allclose(out, plain, atol=1e-3, rtol=0)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    faces = nw.faces(img)
    want = TW.extract_faces(torch.as_tensor(plain), cfg.cube_face_w,
                            cfg.cube_face_h).numpy()
    assert faces.shape == (5, cfg.cube_face_h, cfg.cube_face_w)
    assert faces.dtype == np.uint8
    assert np.abs(faces.astype(np.float32)
                  - np.clip(np.round(want), 0, 255)).max() <= 1.0
    nw.close()


def test_variant_that_does_not_load_is_skipped(tmp_path, monkeypatch):
    """A built variant whose codec libraries are missing at run time (a
    library built elsewhere) loads as None, so the next variant is tried."""
    junk = tmp_path / "junk.so"
    junk.write_bytes(b"not a shared object")
    monkeypatch.setattr(native, "build", lambda codecs: str(junk))
    assert native.load_library(("-DDL_WITH_NOTHING",)) is None
