"""Port parity: bearing EPnP + RANSAC (``cubemapslam_tpu_torch/solvers/
pnp.py``) against ``cubemapslam_tpu/solvers/pnp.py``.

The scene is the JAX package's PnP test's (``tests/test_solvers.py``): 150
points in front of the Lafida camera at a known pose, their bearings and
cross pixels, a share of the matches scrambled.

* The pieces before and after the eigen-solves, on shared inputs:
  ``_control_points`` (each PCA axis up to its sign), ``_barycentric``,
  ``_betas_candidates`` and ``_gauss_newton`` (on the JAX package's L, rho
  and null-space differences of a non-degenerate set), ``_count_inliers``
  and ``_best_candidate`` (on the JAX package's three candidate poses), to
  1e-4 relative; inlier counts within 1.
* ``pnp_ransac`` as a whole, on the same JAX-drawn minimal sets, held to
  its outcome: the null space of a minimal set is exactly 4-dimensional, so
  its basis (and each hypothesis) differs between LAPACK and JAX. At 30% and
  60% outliers both succeed, the pose is within 1 degree / 0.05 of the
  truth (the bounds of ``tests/test_solvers.py``) and the inlier counts are
  within 5% of each other.
* A pool with no valid point fails cleanly (no exception from the
  eigen-solves, no success).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu.solvers import pnp as JP
from cubemapslam_tpu.solvers import sampling as JS
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.solvers import pnp as TP

CFG = SlamConfig()


@pytest.fixture(scope="module")
def cams():
    return JCam.from_config(CFG), TCam.from_config(CFG, "cpu")


def t(x):
    return torch.as_tensor(np.array(x))


def scene(jcam, seed, rotvec, trans, n_out, n=150):
    """(pts, R, t, rays, uv, valid, scrambled) with ``n_out`` scrambled
    matches."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.0, 3.0, (n, 3))
    pts[:, 2] += 5.0
    pts = pts.astype(np.float32)
    R = np.asarray(JG.so3_exp(jnp.asarray(rotvec, jnp.float32)))
    tr = np.asarray(trans, np.float32)
    pc = pts @ R.T + tr
    rays = (pc / np.linalg.norm(pc, axis=1, keepdims=True)).astype(np.float32)
    uv, face = JC.ray_to_cubemap(jcam, jnp.asarray(rays))
    uv, valid = np.array(uv), np.asarray(face) != JC.UNKNOWN_FACE
    idx = rng.choice(np.nonzero(valid)[0], n_out, replace=False)
    perm = rng.permutation(idx)
    rays[idx], uv[idx] = rays[perm], uv[perm]
    scrambled = np.zeros(n, bool)
    scrambled[idx] = True
    return dict(pts=pts, R=R, t=tr, rays=rays, uv=uv, valid=valid,
                scrambled=scrambled, sig2=np.ones(n, np.float32))


@pytest.fixture(scope="module")
def clean(cams):
    return scene(cams[0], 0, [0.2, -0.3, 0.1], [0.4, -0.2, 0.6], 0)


def rel_close(a, b, tol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-12)
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


def test_control_points_and_barycentric(clean):
    rng = np.random.default_rng(1)
    w = (rng.uniform(size=150) < 0.7).astype(np.float32)
    cj = np.asarray(JP._control_points(jnp.asarray(clean["pts"]),
                                       jnp.asarray(w)))
    ct = TP._control_points(t(clean["pts"]), t(w)).numpy()
    rel_close(ct[0], cj[0])
    for j in range(1, 4):        # each axis up to its sign
        a, b = ct[j] - ct[0], cj[j] - cj[0]
        rel_close(a * np.sign(a @ b), b)
    aj = np.asarray(JP._barycentric(jnp.asarray(clean["pts"]),
                                    jnp.asarray(cj)))
    at = TP._barycentric(t(clean["pts"]), t(cj)).numpy()
    rel_close(at, aj)
    # batched: 4-point sets, each against JAX's own solve
    sets = rng.choice(150, (5, 4), replace=True)
    cb = TP._control_points(t(clean["pts"][sets]),
                            torch.ones(5, 4)).numpy()
    for s, c in zip(sets, cb):
        ws = np.zeros(150, np.float32)
        ws[s] = 1.0
        cjs = np.asarray(JP._control_points(jnp.asarray(clean["pts"]),
                                            jnp.asarray(ws)))
        rel_close(c[0], cjs[0])
        for j in range(1, 4):
            a, b = c[j] - c[0], cjs[j] - cjs[0]
            rel_close(a * np.sign(a @ b), b, tol=1e-3)


def jax_null_space_terms(pw, bearings, w):
    """The JAX package's (V, dv, rho, L) of one weighted solve, as
    ``_solve_epnp_candidates`` builds them (``pnp.py:126-144``)."""
    cw = JP._control_points(pw, w)
    alphas = JP._barycentric(pw, cw)
    M = (alphas[:, None, :, None] * JG.hat(bearings)[:, :, None, :])
    M = M.reshape(-1, 12) * jnp.repeat(w, 3)[:, None]
    _, evecs = jnp.linalg.eigh(M.T @ M)
    V = evecs[:, :4]
    v = V.T.reshape(4, 4, 3)
    iu, ju = jnp.triu_indices(4, 1)
    dv = v[:, iu] - v[:, ju]
    rho = jnp.sum((cw[iu] - cw[ju]) ** 2, axis=-1)
    L = jnp.stack([(1.0 if a == b else 2.0) * jnp.sum(dv[a] * dv[b], -1)
                   for a, b in JP._SYM_PAIRS], axis=1)
    return dv, rho, L


def test_betas_and_gauss_newton(clean):
    w = jnp.asarray(clean["valid"].astype(np.float32))
    dv, rho, L = jax_null_space_terms(jnp.asarray(clean["pts"]),
                                      jnp.asarray(clean["rays"]), w)
    bj = np.asarray(JP._betas_candidates(L, rho))
    bt = TP._betas_candidates(t(L), t(rho)).numpy()
    rel_close(bt, bj)
    gj = np.stack([np.asarray(JP._gauss_newton(dv, rho, jnp.asarray(b)))
                   for b in bj])
    gt = TP._gauss_newton(t(dv)[None], t(rho)[None], t(bj)).numpy()
    rel_close(gt, gj)


def test_count_inliers_and_best_candidate(cams, clean):
    jcam, tcam = cams
    s = scene(jcam, 2, [0.15, 0.25, -0.2], [-0.3, 0.1, 0.5], 40)
    args = ("pts", "uv")
    w = (s["valid"] & ~s["scrambled"]).astype(np.float32)
    w[:60] = 0.0                    # a fit on some of the true matches
    Rs, ts = JP._solve_epnp_candidates(jnp.asarray(s["pts"]),
                                       jnp.asarray(s["rays"]),
                                       jnp.asarray(w))
    max_err2 = 5.991 * s["sig2"]
    for R, tt in zip(np.asarray(Rs), np.asarray(ts)):
        inl_j, n_j = JP._count_inliers(
            jcam, jnp.asarray(R), jnp.asarray(tt),
            *(jnp.asarray(s[k]) for k in args), jnp.asarray(max_err2),
            jnp.asarray(s["valid"]))
        inl_t, n_t = TP._count_inliers(tcam, t(R), t(tt),
                                       *(t(s[k]) for k in args),
                                       t(max_err2), t(s["valid"]))
        assert abs(int(n_t) - int(n_j)) <= 1
        assert (inl_t.numpy() != np.asarray(inl_j)).sum() <= 1
    bj = JP._best_candidate(jcam, Rs, ts, *(jnp.asarray(s[k]) for k in args),
                            jnp.asarray(max_err2), jnp.asarray(s["valid"]))
    bt = TP._best_candidate(tcam, t(Rs), t(ts), *(t(s[k]) for k in args),
                            t(max_err2), t(s["valid"]))
    rel_close(bt[0].numpy(), bj[0])
    rel_close(bt[1].numpy(), bj[1])
    assert abs(int(bt[3]) - int(bj[3])) <= 1 and int(bj[3]) > 80


@pytest.mark.parametrize("case", ["30pct", "60pct"])
def test_pnp_ransac_outcome(cams, case):
    jcam, tcam = cams
    if case == "30pct":
        s = scene(jcam, 3, [0.2, -0.3, 0.1], [0.4, -0.2, 0.6], 45)
        key, n_iters, min_n = 1, 200, 80
    else:
        s = scene(jcam, 4, [0.15, 0.25, -0.2], [-0.3, 0.1, 0.5], 90)
        key, n_iters, min_n = 3, 300, 45
    sets = np.asarray(JS.sample_minimal_sets(
        jax.random.PRNGKey(key), jnp.asarray(s["valid"]), n_iters, 4))
    names = ("pts", "rays", "uv", "sig2", "valid")
    rj = JP.pnp_ransac(jcam, jax.random.PRNGKey(key),
                       *(jnp.asarray(s[k]) for k in names), n_iters=n_iters)
    rt = TP.pnp_ransac(tcam, None, *(t(s[k]) for k in names),
                       n_iters=n_iters, sets=t(sets))
    for res in (rj, rt):
        assert bool(res.success)
        dR = np.asarray(res.R) @ s["R"].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 1.0
        assert np.linalg.norm(np.asarray(res.t) - s["t"]) < 0.05
        assert int(res.n_inliers) > min_n
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) \
        <= 0.05 * int(rj.n_inliers)
    assert int(rt.n_inliers) == int(rt.inliers.sum())


def test_pnp_ransac_without_valid_points(cams, clean):
    _, tcam = cams
    names = ("pts", "rays", "uv", "sig2")
    res = TP.pnp_ransac(tcam, torch.Generator().manual_seed(0),
                        *(t(clean[k]) for k in names),
                        torch.zeros(150, dtype=torch.bool), n_iters=50)
    assert not bool(res.success) and int(res.n_inliers) == 0
