"""Port parity for the synthetic world, its fisheye renderer and the
trajectory (``cubemapslam_tpu_torch.runtime.synthetic`` against
``cubemapslam_tpu.synth``).

Tolerances: world arrays and trajectory poses exactly equal (the same
seeded draws in numpy); rendered images within 1 grey level (the per-pixel
rays come from two camera implementations in float32), and the port's depth
image positive exactly where a billboard was drawn.
"""

import numpy as np
import pytest

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import synth
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime import synthetic as S

SMALL = dict(cube_face_w=128, cube_face_h=128, n_features=256, n_levels=4)


@pytest.mark.parametrize("with_centers", [False, True])
def test_make_world_equal(with_centers):
    centers = (np.arange(12, dtype=np.float32).reshape(4, 3)
               if with_centers else None)
    p_ref, w_ref = synth.make_world(np.random.default_rng(3), n=300,
                                    centers=centers, fx=64.0)
    p, w = S.make_world(np.random.default_rng(3), n=300, centers=centers,
                        fx=64.0)
    np.testing.assert_array_equal(p, p_ref)
    assert w.keys() == w_ref.keys()
    for k in w_ref:
        assert w[k].dtype == w_ref[k].dtype, k
        np.testing.assert_array_equal(w[k], w_ref[k], err_msg=k)


def test_forward_trajectory_equal():
    for (R, t), (Rr, tr) in zip(S.forward_trajectory(7, 0.05, 0.01),
                                synth.forward_trajectory(7, 0.05, 0.01)):
        np.testing.assert_array_equal(R, Rr)
        np.testing.assert_array_equal(t, tr)


def test_fisheye_render_matches_jax():
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    pts, patches = synth.make_world(np.random.default_rng(5), n=400,
                                    fx=64.0)
    ref = synth.Renderer(JC.CubemapCamera.from_config(jcfg), jcfg,
                         target="fisheye")
    ours = S.Renderer(CubemapCamera.from_config(tcfg, "cpu"), tcfg)
    for R, t in synth.forward_trajectory(3, step=0.1):
        img_ref = ref.render(pts, patches, R, t)
        img, depth = ours.render(pts, patches, R, t)
        assert img.shape == img_ref.shape == (tcfg.fisheye_height,
                                              tcfg.fisheye_width)
        assert np.abs(img - img_ref).max() <= 1.0
        drawn = img > ours.bg
        assert drawn.mean() > 0.2
        assert (depth[drawn] > 0).mean() > 0.99
        assert ((depth > 0) <= (img >= ours.bg)).all()
        assert 2.0 < np.median(depth[depth > 0]) < 7.0


def test_cubemap_render_matches_jax():
    """``Renderer(target="cubemap")`` draws the cross as the JAX
    renderer's cubemap target does, within 1 grey level."""
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    pts, patches = synth.make_world(np.random.default_rng(5), n=400,
                                    fx=64.0)
    ref = synth.Renderer(JC.CubemapCamera.from_config(jcfg), jcfg,
                         target="cubemap")
    ours = S.Renderer(CubemapCamera.from_config(tcfg, "cpu"), tcfg,
                      target="cubemap")
    for R, t in synth.forward_trajectory(2, step=0.1):
        img_ref = ref.render(pts, patches, R, t)
        img, depth = ours.render(pts, patches, R, t)
        assert img.shape == img_ref.shape == (tcfg.cube_h, tcfg.cube_w)
        assert np.abs(img - img_ref).max() <= 1.0
        assert (img > ours.bg).mean() > 0.1
        assert ((depth > 0) <= (img >= ours.bg)).all()
