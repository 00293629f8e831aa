"""Port parity: reprojection residuals and pose-only LM.

Residuals and Jacobians agree elementwise within 1e-5 (relative). The
normal equations are summed in another order than XLA's, so the optimised
pose agrees within 1e-4 and the inlier mask is the same except for edges
whose final chi2 lies within 1e-3 of the 5.991 gate.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu.optim import pose_opt as JP
from cubemapslam_tpu.optim import residuals as JR
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.optim import pose_opt as TP
from cubemapslam_tpu_torch.optim import residuals as TR


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def cams():
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128)
    return JCam.from_config(cfg), TCam.from_config(cfg, "cpu")


def problem(seed, n=300, noise=0.5, outliers=0.15):
    """Landmarks seen on their own faces from a known pose, with pixel
    noise and gross outliers."""
    rng = np.random.default_rng(seed)
    R = np.asarray(JG.so3_exp(jnp.asarray([0.05, -0.1, 0.03], jnp.float32)))
    t = np.array([0.1, -0.05, 0.2], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Xc = d * rng.uniform(2, 8, (n, 1)).astype(np.float32)
    Xw = ((Xc - t) @ R).astype(np.float32)               # R^T (Xc - t)
    a = np.abs(Xc)
    face = np.select([(Xc[:, 2] >= a[:, 0]) & (Xc[:, 2] >= a[:, 1]),
                      Xc[:, 0] >= a[:, 1], Xc[:, 0] <= -a[:, 1],
                      Xc[:, 1] >= 0], [0, 2, 1, 4], 3).astype(np.int32)
    return rng, R, t, Xw, face, Xc


def test_residuals_and_jacobians(cams):
    jcam, tcam = cams
    rng, R, t, Xw, face, _ = problem(0)
    uv = rng.uniform(0, 128, (len(Xw), 2)).astype(np.float32)
    np.testing.assert_allclose(
        TR.reproj_residual(tcam, T(R), T(t), T(Xw), T(face, torch.int64),
                           T(uv)).numpy(),
        np.asarray(JR.reproj_residual(jcam, R, t, Xw, face, uv)),
        rtol=1e-5, atol=1e-3)
    for a, b in zip(TR.reproj_jacobians(tcam, T(R), T(t), T(Xw),
                                        T(face, torch.int64)),
                    JR.reproj_jacobians(jcam, R, t, Xw, face)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)
    local = np.asarray(JG.mat3_apply(jcam.face_R[face], Xw))
    np.testing.assert_allclose(
        TR._proj_jac_local(tcam, T(local)).numpy(),
        np.asarray(JR._proj_jac_local(jcam, jnp.asarray(local))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pose_optimization(cams, seed):
    jcam, tcam = cams
    rng, R, t, Xw, face, Xc = problem(seed)
    uv = np.asarray(JR.project_to_face(jcam, jnp.asarray(Xc), face))
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    bad = rng.uniform(size=len(uv)) < 0.15
    uv[bad] += rng.uniform(-30, 30, (bad.sum(), 2)).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 3, len(uv))).astype(np.float32)
    valid = rng.uniform(size=len(uv)) < 0.95
    # start 2 degrees and 5 cm off
    dR = np.asarray(JG.so3_exp(jnp.asarray([0.02, 0.02, -0.02],
                                           jnp.float32)))
    R0 = (dR @ R).astype(np.float32)
    t0 = (t + np.array([0.05, -0.03, 0.02], np.float32)).astype(np.float32)
    jR, jt, jinl, jn = JP.pose_optimization(jcam, R0, t0, Xw, face, uv,
                                            inv_s2, valid)
    tR, tt, tinl, tn = TP.pose_optimization(
        tcam, T(R0), T(t0), T(Xw), T(face, torch.int64), T(uv), T(inv_s2),
        T(valid, torch.bool))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    e = np.asarray(JR.reproj_residual(jcam, jR, jt, Xw, face, uv))
    chi2 = (e * e).sum(1) * inv_s2
    edge = np.abs(chi2 - 5.991) < 1e-3
    np.testing.assert_array_equal(tinl.numpy()[~edge],
                                  np.asarray(jinl)[~edge])
    assert abs(int(tn) - int(jn)) <= edge.sum()
    assert int(jn) > 200
