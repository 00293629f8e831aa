"""Port parity: Sim3 RANSAC (``solvers/sim3.py``) and the single-vertex Sim3
refinement (``optim/sim3_opt.py``).

Seeded scenes at the Lafida calibration, given to both packages as numpy
arrays: 80 points seen from two keyframes related by a Sim3, 20% of the
matches displaced. Tolerances: the inlier masks of ``_check_inliers``
exactly equal; each 3-point Horn hypothesis (s, R, t) within 1e-4 of JAX's
on the same minimal set, t within 1e-3 (t = c1 - s R c2, with centroids
about 5 from the cameras; Horn's top eigenvalue is simple for every set, so
the hypothesis is the same rotation in every backend; the gap is checked);
``sim3_ransac`` on JAX-drawn sets (with Horn's eigen-solves as on the
CPU and in the order of the card's ``sym_eig`` kernel, ``sym_eig_ordered``)
and ``optimize_sim3`` from the same start within 1e-4 of JAX in s, R and t
with the inlier masks equal; ``sim3_ransac`` on scores drawn outside it
bitwise the call that draws them; OptimizeSim3's ``edge_jacobians``
(float32) against JAX's ``jacfwd`` of the same residuals in float64, on
that scene and on the exact revisit of ``chip_smoke.py``'s closure as the
card recorded it (``torch_exact_revisit_sim3.npz``): each column within
1e-5 of its largest entry, the scale columns within 1e-7 px more. The outcome
tests are those of the JAX package (``tests/test_solvers.py:132-164``,
``tests/test_optim.py:223-252``): the scale within 0.02 / 1e-3, the
rotation within 1 / 0.1 degree, the translation within 0.05.

``test_e2e_refinements_against_jax`` replays refinements that closures of
the e2e circuit ran on the card (``scripts/torch_loop_e2e.py --dump``:
worlds 42, 1 and 2 with the CPU run's RANSAC sets, world 2 with the card's
own), their inputs as the card recorded them (``torch_e2e_refinements.npz``
beside this file): the inlier counts of JAX, the port on the CPU and the
card are equal; where JAX keeps 20 inliers or more (the loop closer's
gate), the port's and the card's scales lie within 5e-3 of JAX's,
relatively (the scale's direction is damped by an absolute 1e-6 only, so
rounding moves it: ROADMAP Queue 3), rotation and translation within
1e-5; where JAX's refinement is not finite, the port and the card keep
fewer than 20 inliers, so the closer rejects the candidate on both.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu.optim import sim3_opt as JO
from cubemapslam_tpu.solvers import horn as JH
from cubemapslam_tpu.solvers import sampling as JSmp
from cubemapslam_tpu.solvers import sim3 as JS
from cubemapslam_tpu_torch import geometry as TG
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.optim import sim3_opt as TO
from cubemapslam_tpu_torch.solvers import sim3 as TS
from cubemapslam_tpu_torch.solvers import sym_eig as SE
from cubemapslam_tpu_torch.solvers.sampling import draw_scores

CFG = SlamConfig()
N_PTS, N_OUT = 80, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cams():
    return JCam.from_config(CFG), TCam.from_config(CFG, "cpu")


def t_(x):
    a = np.array(x)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def angle_deg(Ra, Rb):
    dR = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))


def sim3_scene(jcam, rng):
    """(p1, p2 with N_OUT displaced, uv1, uv2, valid, (s, R, t) truth)."""
    p2 = rng.uniform(-3, 3, (N_PTS, 3)).astype(np.float32)
    p2[:, 2] += 5.0
    s_gt = 1.4
    R_gt = np.asarray(JG.so3_exp(jnp.asarray([0.1, 0.2, -0.05])))
    t_gt = np.array([0.5, -0.3, 0.2], np.float32)
    p1 = (s_gt * (R_gt @ p2.T).T + t_gt).astype(np.float32)
    uv1 = np.asarray(JC.ray_to_cubemap(jcam, jnp.asarray(p1))[0])
    uv2 = np.asarray(JC.ray_to_cubemap(jcam, jnp.asarray(p2))[0])
    valid = (uv1[:, 0] >= 0) & (uv2[:, 0] >= 0)
    out = rng.choice(np.nonzero(valid)[0], N_OUT, replace=False)
    p2b = p2.copy()
    p2b[out] += rng.normal(0, 2.0, (N_OUT, 3)).astype(np.float32)
    return p1, p2b, uv1, uv2, valid, (s_gt, R_gt, t_gt)


@pytest.fixture(scope="module")
def scene(cams):
    return sim3_scene(cams[0], np.random.default_rng(42))


def test_check_inliers(cams, scene):
    jcam, tcam = cams
    p1, p2, uv1, uv2, valid, (s, R, t) = scene
    sig = np.full(N_PTS, 9.21, np.float32)
    for ds in (1.0, 1.01):          # the true Sim3, and one 1% off in scale
        ji, jn = JS._check_inliers(jcam, jnp.float32(s * ds), jnp.asarray(R),
                                   jnp.asarray(t), *map(jnp.asarray, (
                                       p1, p2, uv1, uv2, sig, sig, valid)))
        ti, tn = TS._check_inliers(tcam, torch.tensor(s * ds), t_(R), t_(t),
                                   *map(t_, (p1, p2, uv1, uv2, sig, sig,
                                             valid)))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert int(tn) == int(jn)
    assert 0 < int(tn) < valid.sum()


def _horn_gap(p1, p2):
    """Relative gap of the two largest eigenvalues of Horn's 4x4 matrix."""
    q1 = p1 - p1.mean(0)
    q2 = p2 - p2.mean(0)
    S = q2.T.astype(np.float64) @ q1
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = S.reshape(-1)
    N = np.array([
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy]])
    ev = np.linalg.eigvalsh(N)
    return (ev[3] - ev[2]) / max(abs(ev[3]), 1e-12)


def test_hypotheses_one_by_one(scene):
    """Each 3-point hypothesis on JAX-drawn sets, after checking that every
    set has a simple top eigenvalue."""
    p1, p2, _, _, valid, _ = scene
    sets = np.asarray(JSmp.sample_minimal_sets(
        jax.random.PRNGKey(2), jnp.asarray(valid), 200, 3))
    gaps = [_horn_gap(p1[s], p2[s]) for s in sets]
    assert min(gaps) > 1e-3, min(gaps)

    def one(idx):
        w = jnp.zeros(N_PTS).at[idx].set(1.0) * jnp.asarray(valid)
        s, R, t = JH.horn_alignment(jnp.asarray(p1), jnp.asarray(p2),
                                    weights=w)
        return jnp.maximum(s, 1e-6), R, t

    js, jR, jt = jax.vmap(one)(jnp.asarray(sets))
    ts, tR, tt = TS.sim3_hypotheses(t_(p1), t_(p2), t_(valid), t_(sets))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    # t = c1 - s R c2: the centroids lie about 5 from the cameras, which
    # scales the rounding of s R in t
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)


@pytest.mark.parametrize("eigh", ["sym_eig", "sym_eig_ordered"])
def test_sim3_ransac_on_jax_sets(cams, scene, eigh):
    """On JAX's sets, with the default eigen-solve (on CPU tensors
    ``torch.linalg.eigh``) and with the card kernel's order in plain
    PyTorch (``sym_eig_ordered``)."""
    jcam, tcam = cams
    p1, p2, uv1, uv2, valid, _ = scene
    sig = np.ones(N_PTS, np.float32)
    key = jax.random.PRNGKey(2)
    sets = JSmp.sample_minimal_sets(key, jnp.asarray(valid), 200, 3)
    jr = JS.sim3_ransac(jcam, key, *map(jnp.asarray, (
        p1, p2, uv1, uv2, sig, sig, valid)), n_iters=200, min_inliers=20)
    tr = TS.sim3_ransac(tcam, None, *map(t_, (p1, p2, uv1, uv2, sig, sig,
                                              valid)),
                        n_iters=200, min_inliers=20, sets=t_(sets),
                        eigh=getattr(SE, eigh))
    assert bool(tr.success) and bool(jr.success)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers)
    np.testing.assert_allclose(float(tr.s12), float(jr.s12), atol=1e-4)
    np.testing.assert_allclose(tr.R12.numpy(), np.asarray(jr.R12), atol=1e-4)
    np.testing.assert_allclose(tr.t12.numpy(), np.asarray(jr.t12), atol=1e-4)


def test_sim3_ransac_scores_bitwise_generator(cams, scene):
    """``sim3_ransac`` on (n_iters, N) scores drawn outside it is bitwise
    the call that draws them from the same generator, which both leave in
    the same state."""
    tcam = cams[1]
    p1, p2, uv1, uv2, valid, _ = scene
    args = [t_(x) for x in (p1, p2, uv1, uv2, np.ones(N_PTS, np.float32),
                            np.ones(N_PTS, np.float32), valid)]
    g_own, g_out = (torch.Generator().manual_seed(5) for _ in range(2))
    a = TS.sim3_ransac(tcam, g_own, *args, n_iters=200, min_inliers=20)
    scores = draw_scores(g_out, 200, N_PTS, "cpu")
    b = TS.sim3_ransac(tcam, None, *args, n_iters=200, min_inliers=20,
                       scores=scores)
    assert bool(a.success)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(g_own.get_state(), g_out.get_state())


def test_recovers_similarity(cams, scene):
    """The analog of TestSim3::test_recovers_similarity, on the port's own
    generator."""
    tcam = cams[1]
    p1, p2, uv1, uv2, valid, (s_gt, R_gt, t_gt) = scene
    sig = np.ones(N_PTS, np.float32)
    res = TS.sim3_ransac(tcam, torch.Generator().manual_seed(2),
                         *map(t_, (p1, p2, uv1, uv2, sig, sig, valid)),
                         n_iters=200, min_inliers=20)
    assert bool(res.success)
    assert abs(float(res.s12) - s_gt) < 0.02
    assert angle_deg(res.R12.numpy(), R_gt) < 1.0
    assert np.linalg.norm(res.t12.numpy() - t_gt) < 0.05


def observe(jcam, pts):
    uv, face = JC.ray_to_cubemap(jcam, jnp.asarray(pts, jnp.float32))
    return np.array(JC.cubemap_uv_to_in_face(jcam, uv)), np.asarray(face)


@pytest.fixture(scope="module")
def refine_case(cams):
    """The scene of TestOptimizeSim3 (60 points, a Sim3 start perturbed by
    2% in each tangent direction), with 3 matches displaced."""
    jcam = cams[0]
    rng = np.random.default_rng(7)
    n = 60
    p2 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    p2[:, 2] += 5
    s_gt = 1.3
    R_gt = np.asarray(JG.so3_exp(jnp.asarray([0.05, 0.1, -0.02])))
    t_gt = np.array([0.2, -0.1, 0.15], np.float32)
    p1 = (s_gt * (R_gt @ p2.T).T + t_gt).astype(np.float32)
    uv1, f1 = observe(jcam, p1)
    uv2, f2 = observe(jcam, p2)
    uv1[:3] += 25.0
    valid = (f1 >= 0) & (f2 >= 0)
    ds, dR, dt = JG.sim3_exp(jnp.asarray(rng.normal(size=7) * 0.02,
                                         jnp.float32))
    start = JG.sim3_compose(ds, dR, dt, jnp.asarray(s_gt, jnp.float32),
                            jnp.asarray(R_gt, jnp.float32),
                            jnp.asarray(t_gt))
    start = tuple(np.asarray(x) for x in start)
    w = np.ones(n, np.float32)
    return (start, (p1, p2, uv1, f1, uv2, f2, w, w, valid),
            (s_gt, R_gt, t_gt))


def test_optimize_sim3_against_jax(cams, refine_case):
    jcam, tcam = cams
    start, args, _ = refine_case
    js, jR, jt, jinl, jn = JO.optimize_sim3(
        jcam, *map(jnp.asarray, start), *map(jnp.asarray, args))
    ts, tR, tt, tinl, tn = TO.optimize_sim3(tcam, *map(t_, start),
                                            *map(t_, args))
    np.testing.assert_allclose(float(ts), float(js), atol=1e-4)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn)
    assert not tinl.numpy()[:3].any()      # the displaced matches were cut


def test_refines_noisy_sim3(cams, refine_case):
    """The analog of TestOptimizeSim3::test_refines_noisy_sim3."""
    tcam = cams[1]
    start, args, (s_gt, R_gt, t_gt) = refine_case
    s, R, t, inl, n = TO.optimize_sim3(tcam, *map(t_, start), *map(t_, args))
    valid = args[-1]
    assert abs(float(s) - s_gt) < 1e-3
    assert angle_deg(R.numpy(), R_gt) < 0.1
    assert np.linalg.norm(t.numpy() - t_gt) < 0.05
    assert int(n) > 0.9 * (valid.sum() - 3)


REFINEMENTS = ("card_w42_cpu_draws_0", "card_w1_cpu_draws_0",
               "card_w2_cpu_draws_0", "card_w2_own_draws_0",
               "card_w2_own_draws_1", "card_w2_own_draws_2",
               "card_w2_own_draws_3")
SIM3_ARGS = ("s12", "R12", "t12", "p1", "p2", "uv1", "face1", "uv2", "face2",
             "inv_sigma2_1", "inv_sigma2_2", "valid")
MIN_INLIERS = 20                       # LoopCloser's refinement gate


@pytest.mark.parametrize("case", REFINEMENTS)
def test_e2e_refinements_against_jax(case):
    """A refinement of the e2e circuit on the card, replayed on its
    recorded inputs by JAX and by the port on the CPU."""
    data = np.load(pathlib.Path(__file__).with_name(
        "torch_e2e_refinements.npz"))
    args = [data[f"{case}/{k}"] for k in SIM3_ARGS]
    args = [a.astype(np.int64) if a.dtype == np.int8 else a for a in args]
    cfg = SlamConfig(cube_face_w=160, cube_face_h=160)   # the circuit's
    jcam, tcam = JCam.from_config(cfg), TCam.from_config(cfg, "cpu")
    j = JO.optimize_sim3(jcam, *map(jnp.asarray, args), th2=10.0,
                         fix_scale=False)
    t = TO.optimize_sim3(tcam, *map(torch.as_tensor, args), th2=10.0,
                         fix_scale=False)
    card_s, card_n = float(data[f"{case}/card_s"]), int(
        data[f"{case}/card_inliers"])
    assert int(j[4]) == int(t[4]) == card_n
    if not np.isfinite(float(j[0])):
        assert card_n < MIN_INLIERS
        return
    assert card_n >= MIN_INLIERS
    s_j = float(j[0])
    assert abs(float(t[0]) - s_j) <= 5e-3 * s_j
    assert abs(card_s - s_j) <= 5e-3 * s_j
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-5)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), atol=1e-5)


def _jax64_edge_jacobians(cfg, s, R, t, p1, p2, face1, face2):
    """(J1, J2), each (n, 2, 7), of JAX's OptimizeSim3 residuals
    (``sim3_opt.py:38-46``, the observations left out: they do not enter a
    derivative) by ``jax.jacfwd`` at xi = 0, in float64."""
    from cubemapslam_tpu.optim.residuals import project_to_face
    with jax.enable_x64(True):
        cam = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                     JCam.from_config(cfg))
        s, R, t, p1, p2 = (jnp.asarray(np.asarray(x, np.float64))
                           for x in (s, R, t, p1, p2))
        face1, face2 = jnp.asarray(face1), jnp.asarray(face2)

        def res(xi):
            ds, dR, dt = JG.sim3_exp(xi)
            s_, R_, t_ = JG.sim3_compose(ds, dR, dt, s, R, t)
            r1 = -project_to_face(cam, JG.sim3_apply(s_, R_, t_, p2), face1)
            si, Ri, ti = JG.sim3_inverse(s_, R_, t_)
            r2 = -project_to_face(cam, JG.sim3_apply(si, Ri, ti, p1), face2)
            return r1, r2

        J1, J2 = jax.jacfwd(res)(jnp.zeros(7, jnp.float64))
        return np.asarray(J1), np.asarray(J2)


def _exact_revisit():
    """The arguments of OptimizeSim3 in ``chip_smoke.py``'s constructed-drift
    closure at ``SlamConfig()`` (its loop keyframes share a viewpoint), as
    the card recorded them with ``scripts/torch_loop_sim3_eigh.py --dump``
    (``torch_exact_revisit_sim3.npz`` beside this file)."""
    data = np.load(pathlib.Path(__file__).with_name(
        "torch_exact_revisit_sim3.npz"))
    return [data[f"sym_eig/{k}"] for k in SIM3_ARGS]


@pytest.mark.parametrize("case", ["refine_case", "exact_revisit"])
def test_edge_jacobians_against_jax64(cams, refine_case, case):
    """``edge_jacobians`` in float32 against JAX's ``jacfwd`` of the same
    residuals in float64: every column within 1e-5 of its own largest
    entry, the scale columns within 1e-7 px more. On the exact revisit the
    true scale columns are at most 2.6e-5 px, and the float32 products
    J_proj(q) q that ``jacfwd`` forms in JAX's float32 code miss them by
    4.7e-5 and 5.5e-5 px."""
    if case == "refine_case":
        (s, R, t), (p1, p2, _, face1, _, face2, _, _, _), _ = refine_case
    else:
        s, R, t, p1, p2, _, face1, _, face2, _, _, _ = _exact_revisit()
    J1j, J2j = _jax64_edge_jacobians(CFG, s, R, t, p1, p2, face1, face2)
    st, Rt, tt, p1t, p2t = map(t_, (s, R, t, p1, p2))
    q1 = TG.sim3_apply(st, Rt, tt, p2t)
    q2 = TG.sim3_apply(*TG.sim3_inverse(st, Rt, tt), p1t)
    J1, J2 = TO.edge_jacobians(cams[1], st, Rt, tt, TO._point_tangent(p1t),
                               q1, t_(face1), q2, t_(face2))
    for Jt, Jj in ((J1.numpy(), J1j), (J2.numpy(), J2j)):
        gap = np.abs(Jt - Jj).max(axis=(0, 1))
        bound = 1e-5 * np.abs(Jj).max(axis=(0, 1))
        bound[6] += 1e-7
        assert (gap <= bound).all(), (gap, bound)
