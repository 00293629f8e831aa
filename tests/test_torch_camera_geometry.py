"""Port parity: camera and geometry modules, elementwise against JAX.

Tolerance 1e-5 (relative and absolute): the same float32 formulas, apart
from the last-ulp differences of transcendental functions and fused
multiply-adds. Face ids are identical except for points within 1e-4 of a
face boundary, where the octant test or the in-face test sits on a tie.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu_torch import camera as TC
from cubemapslam_tpu_torch import geometry as TG
from cubemapslam_tpu_torch import interop

TOL = dict(rtol=1e-5, atol=1e-5)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), **(kw or TOL))


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def cams(request):
    from cubemapslam_tpu.config import SlamConfig
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4)
    jcam = JC.CubemapCamera.from_config(cfg)
    return jcam, TC.CubemapCamera.from_config(cfg, "cpu"), cfg


def unit_rays(rng, n=4000):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def off_boundary(rays, eps=1e-4):
    """Rays whose two largest |components| differ by more than eps."""
    a = np.sort(np.abs(rays), axis=1)
    return (a[:, 2] - a[:, 1]) > eps


def test_camera_leaves_equal(cams):
    jcam, tcam, _ = cams
    for name, v in jcam._asdict().items():
        np.testing.assert_array_equal(np.asarray(v),
                                      getattr(tcam, name).numpy(), name)
    carried = interop.camera_from_numpy(
        {k: np.asarray(v) for k, v in jcam._asdict().items()})
    for name in jcam._fields:
        assert torch.equal(getattr(carried, name), getattr(tcam, name))


def test_fisheye_rays(cams):
    jcam, tcam, cfg = cams
    rng = np.random.default_rng(0)
    uv = rng.uniform([0, 0], [cfg.fisheye_width, cfg.fisheye_height],
                     (4000, 2)).astype(np.float32)
    close(JC.img_to_ray(jcam, jnp.asarray(uv)), TC.img_to_ray(tcam, T(uv)))
    rays = unit_rays(rng)
    rays = rays[rays[:, 2] > -0.3]
    close(JC.ray_to_img(jcam, jnp.asarray(rays)),
          TC.ray_to_img(tcam, T(rays)), rtol=1e-5, atol=1e-4)
    # the Horner scan runs from the highest coefficient down in both
    x = rng.uniform(0, 2, 64).astype(np.float32)
    close(JC._horner(jcam.inv_poly, jnp.asarray(x)),
          TC._horner(tcam.inv_poly, T(x)))


def test_faces_and_cubemap_projection(cams):
    jcam, tcam, _ = cams
    rng = np.random.default_rng(1)
    rays = unit_rays(rng)
    ok = off_boundary(rays)
    np.testing.assert_array_equal(np.asarray(JC.face_from_ray(rays))[ok],
                                  TC.face_from_ray(T(rays)).numpy()[ok])
    juv, jf = JC.ray_to_cubemap(jcam, jnp.asarray(rays))
    tuv, tf = TC.ray_to_cubemap(tcam, T(rays))
    np.testing.assert_array_equal(np.asarray(jf)[ok], tf.numpy()[ok])
    close(np.asarray(juv)[ok], tuv.numpy()[ok], rtol=1e-5, atol=1e-4)
    jin, jf2 = JC.ray_to_face_uv(jcam, jnp.asarray(rays))
    tin, tf2 = TC.ray_to_face_uv(tcam, T(rays))
    np.testing.assert_array_equal(np.asarray(jf2)[ok], tf2.numpy()[ok])
    close(np.asarray(jin)[ok], tin.numpy()[ok], rtol=1e-5, atol=1e-4)
    face = rng.integers(0, 5, len(rays))
    fwd = rays[:, :] * np.where(rays[:, 2:3] < 0, -1, 1)
    close(JC.ray_to_target_face(jcam, jnp.asarray(fwd), jnp.asarray(face)),
          TC.ray_to_target_face(tcam, T(fwd), T(face, torch.int64)),
          rtol=1e-5, atol=1e-3)
    close(JC.rig_to_face(jcam, jnp.asarray(rays), jnp.asarray(face)),
          TC.rig_to_face(tcam, T(rays), T(face, torch.int64)))
    close(JC.face_to_rig(jcam, jnp.asarray(rays), jnp.asarray(face)),
          TC.face_to_rig(tcam, T(rays), T(face, torch.int64)))


def test_cubemap_pixels(cams):
    jcam, tcam, cfg = cams
    rng = np.random.default_rng(2)
    uv = rng.uniform(-5, cfg.cube_w + 5, (4000, 2)).astype(np.float32)
    frac = uv / cfg.cube_face_w
    ok = (np.abs(frac - np.round(frac)) > 1e-4).all(axis=1)
    np.testing.assert_array_equal(
        np.asarray(JC.face_from_cubemap_uv(jcam, jnp.asarray(uv)))[ok],
        TC.face_from_cubemap_uv(tcam, T(uv)).numpy()[ok])
    jr, jf = JC.cubemap_to_ray(jcam, jnp.asarray(uv))
    tr, tf = TC.cubemap_to_ray(tcam, T(uv))
    np.testing.assert_array_equal(np.asarray(jf)[ok], tf.numpy()[ok])
    close(np.asarray(jr)[ok], tr.numpy()[ok])
    close(JC.cubemap_uv_to_in_face(jcam, jnp.asarray(uv))[ok],
          TC.cubemap_uv_to_in_face(tcam, T(uv)).numpy()[ok], atol=1e-4)
    juf, jv = JC.cubemap_to_fisheye(jcam, jnp.asarray(uv))
    tuf, tv = TC.cubemap_to_fisheye(tcam, T(uv))
    both = ok & np.asarray(jv) & tv.numpy()
    assert (np.asarray(jv)[ok] == tv.numpy()[ok]).mean() > 0.999
    close(np.asarray(juf)[both], tuf.numpy()[both], rtol=1e-5, atol=1e-4)
    fuv = rng.uniform([0, 0], [cfg.fisheye_width, cfg.fisheye_height],
                      (4000, 2)).astype(np.float32)
    juv, jff = JC.fisheye_to_cubemap(jcam, jnp.asarray(fuv))
    tuv, tff = TC.fisheye_to_cubemap(tcam, T(fuv))
    same = np.asarray(jff) == tff.numpy()
    assert same.mean() > 0.999
    close(np.asarray(juv)[same], tuv.numpy()[same], rtol=1e-5, atol=1e-3)


def test_angular_noise_model(cams):
    jcam, tcam, cfg = cams
    rng = np.random.default_rng(3)
    # keypoints inside the five faces, away from the cell edges
    cells = np.array([(1, 1), (0, 1), (2, 1), (1, 0), (1, 2)])
    c = cells[rng.integers(0, 5, 300)]
    uv = ((c + rng.uniform(0.05, 0.95, (300, 2))) * cfg.cube_face_w
          ).astype(np.float32)
    close(JC.epipolar_radius(jcam, jnp.asarray(uv)),
          TC.epipolar_radius(tcam, T(uv)), rtol=1e-5, atol=1e-4)
    close(JC.vector_sigma(jcam, jnp.asarray(uv)), TC.vector_sigma(tcam, T(uv)))
    nrm = unit_rays(rng, 300)
    close(JC.vector_sigma_along_normal(jcam, jnp.asarray(uv),
                                       jnp.asarray(nrm)),
          TC.vector_sigma_along_normal(tcam, T(uv), T(nrm)),
          rtol=1e-4, atol=1e-6)
    close(JC.vector_sigma_along_normal_pairwise(jcam, jnp.asarray(uv),
                                                jnp.asarray(nrm[:40])),
          TC.vector_sigma_along_normal_pairwise(tcam, T(uv), T(nrm[:40])),
          rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _tangents(rng, n, dim, scale):
    x = rng.normal(size=(n, dim)).astype(np.float32) * scale
    x[:3] = 0.0                       # exact identity: Taylor branches
    x[3:6] *= 1e-6                    # near identity
    return x


@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_so3_se3(scale):
    rng = np.random.default_rng(4)
    xi = _tangents(rng, 200, 6, scale)
    jR, jt = JG.se3_exp(jnp.asarray(xi))
    tR, tt = TG.se3_exp(T(xi))
    close(jR, tR)
    close(jt, tt)
    close(JG.so3_log(jR), TG.so3_log(T(jR)), rtol=1e-5, atol=1e-4)
    close(JG.se3_log(jR, jt), TG.se3_log(T(jR), T(jt)), rtol=1e-4, atol=1e-4)
    close(JG.hat(jnp.asarray(xi[:, :3])), TG.hat(T(xi[:, :3])))
    jR2, jt2 = JG.se3_exp(jnp.asarray(xi[::-1].copy()))
    close(JG.se3_compose(jR, jt, jR2, jt2)[0],
          TG.se3_compose(T(jR), T(jt), T(jR2), T(jt2))[0])
    close(JG.se3_compose(jR, jt, jR2, jt2)[1],
          TG.se3_compose(T(jR), T(jt), T(jR2), T(jt2))[1])
    close(JG.se3_inverse(jR, jt)[1], TG.se3_inverse(T(jR), T(jt))[1])
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    close(JG.se3_apply(jR, jt, jnp.asarray(pts)),
          TG.se3_apply(T(jR), T(jt), T(pts)))
    close(JG.mat3_apply(jR, jnp.asarray(pts)),
          TG.mat3_apply(T(jR), T(pts)))


def test_so3_log_near_pi():
    rng = np.random.default_rng(5)
    axis = rng.normal(size=(100, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    phi = axis * (np.pi - rng.uniform(0, 5e-4, (100, 1))).astype(np.float32)
    R = np.asarray(JG.so3_exp(jnp.asarray(phi)))
    close(JG.so3_log(jnp.asarray(R)), TG.so3_log(T(R)), rtol=1e-5,
          atol=1e-4)


def test_quaternions():
    rng = np.random.default_rng(6)
    phi = rng.normal(size=(300, 3)).astype(np.float32)
    phi[:4] = [[np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi], [0, 0, 0]]
    R = np.asarray(JG.so3_exp(jnp.asarray(phi)))
    close(JG.rot_to_quat(jnp.asarray(R)), TG.rot_to_quat(T(R)), rtol=1e-5,
          atol=1e-4)
    q = rng.normal(size=(300, 4)).astype(np.float32)
    close(JG.quat_to_rot(jnp.asarray(q)), TG.quat_to_rot(T(q)))


@pytest.mark.parametrize("scale", [0.05, 0.8])
def test_sim3(scale):
    rng = np.random.default_rng(7)
    xi = _tangents(rng, 200, 7, scale)
    js, jR, jt = JG.sim3_exp(jnp.asarray(xi))
    ts, tR, tt = TG.sim3_exp(T(xi))
    close(js, ts)
    close(jR, tR)
    close(jt, tt, rtol=1e-4, atol=1e-5)
    close(JG.sim3_log(js, jR, jt), TG.sim3_log(T(js), T(jR), T(jt)),
          rtol=1e-4, atol=1e-4)
    jinv = JG.sim3_inverse(js, jR, jt)
    tinv = TG.sim3_inverse(T(js), T(jR), T(jt))
    for a, b in zip(jinv, tinv):
        close(a, b)
    jc = JG.sim3_compose(js, jR, jt, *jinv)
    tc = TG.sim3_compose(T(js), T(jR), T(jt), *tinv)
    for a, b in zip(jc, tc):
        close(a, b, rtol=1e-5, atol=1e-4)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    close(JG.sim3_apply(js, jR, jt, jnp.asarray(pts)),
          TG.sim3_apply(T(js), T(jR), T(jt), T(pts)))
