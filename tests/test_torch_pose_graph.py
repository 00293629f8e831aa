"""Port parity: the essential-graph Sim3 pose graph (``optim/pose_graph.py``).

A seeded 16-vertex graph (the temporal chain, covisibility pairs and two
loop edges; 6 of the edges masked; vertex 0 fixed, vertex 15 invalid; the
estimates drifted from the truth along the chain, with scale drift) is given
to both packages as numpy arrays. Tolerances: s, R and t within 1e-4 of JAX
after 12 Gauss-Newton iterations; the same problem with its masked edges
left out gives the masked result within 1e-6 (a masked edge adds exact
zeros; only the float order of the sums can change); the point remap within
1e-5. The outcome test is that of the JAX package (``TestPoseGraph``,
``tests/test_optim.py:168-220``): the largest position error falls below a
quarter of its value before, the scales within 0.02 of 1. The
Gauss-Newton iterations on copies of the state, through ``CapturedLoop``
or a Python loop, bitwise the loop as it was before
(``tests/torch_parent_loops.py``) after 1, 2, 5 and 12 iterations. The
valid edges padded with masked rows to capacities of 256 and 1024 (the loop
closer's fixed-shape step): the two bitwise equal, and within 1e-6 of the
compacted solve, not bitwise on the CPU, whose elementwise kernels round a
few rows of the Sim3 log and exp differently at another length (on the
card the eager closure pads too, so its bits do not depend on this).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.optim import pose_graph as JP
from cubemapslam_tpu_torch import geometry as TG
from cubemapslam_tpu_torch.optim import pose_graph as TP
from cubemapslam_tpu_torch.runtime.fused_step import CapturedLoop

import torch_parent_loops as PARENT

M = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(x):
    a = np.array(x)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def ring(rng, m, drift_rot=0.02, drift_t=0.05, drift_s=0.01):
    """m poses on a unit circle (truth) and their drifted estimates."""
    R_gt, t_gt = [], []
    for k in range(m):
        ang = 2 * np.pi * k / m
        R_gt.append(np.asarray(JG.so3_exp(jnp.asarray([0, ang, 0],
                                                      jnp.float32))))
        t_gt.append(np.array([np.cos(ang), 0, np.sin(ang)], np.float32))
    R_gt, t_gt = np.stack(R_gt), np.stack(t_gt)
    R_e, t_e, s_e = [R_gt[0]], [t_gt[0]], [1.0]
    for k in range(1, m):
        dR = np.asarray(JG.so3_exp(jnp.asarray(
            rng.normal(size=3) * drift_rot * k / m, jnp.float32)))
        R_e.append(dR @ R_gt[k])
        t_e.append(t_gt[k] + rng.normal(0, drift_t * k / m, 3))
        s_e.append(1.0 + rng.normal(0, drift_s * k / m))
    return (R_gt, t_gt, np.stack(R_e).astype(np.float32),
            np.stack(t_e).astype(np.float32),
            np.asarray(s_e, np.float32))


def measurement(R_gt, t_gt, i, j):
    """S_ji = S_j S_i^-1 from the truth (scale 1), as numpy."""
    S = JG.sim3_compose(jnp.asarray(1.0), jnp.asarray(R_gt[j]),
                        jnp.asarray(t_gt[j]),
                        *JG.sim3_inverse(jnp.asarray(1.0),
                                         jnp.asarray(R_gt[i]),
                                         jnp.asarray(t_gt[i])))
    return float(S[0]), np.asarray(S[1]), np.asarray(S[2])


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(3)
    R_gt, t_gt, R_e, t_e, s_e = ring(rng, M)
    pairs = [(k, k + 1) for k in range(M - 1)]              # the chain
    pairs += [(k, k + 2) for k in range(0, M - 2, 2)]       # covisibility
    pairs += [(M - 2, 0), (M - 3, 1)]                       # loops
    pairs += [(3, 15), (15, 7)]                 # to the invalid vertex
    ei = np.array([a for a, _ in pairs], np.int32)
    ej = np.array([b for _, b in pairs], np.int32)
    meas = [measurement(R_gt, t_gt, a, b) for a, b in pairs]
    ms = np.array([m[0] for m in meas], np.float32)
    mR = np.stack([m[1] for m in meas]).astype(np.float32)
    mt = np.stack([m[2] for m in meas]).astype(np.float32)
    e_ok = np.ones(len(pairs), bool)
    e_ok[[2, 9, 11, 16]] = False
    e_ok[-2:] = False
    v_valid = np.ones(M, bool)
    v_valid[15] = False
    v_fixed = np.zeros(M, bool)
    v_fixed[0] = True
    args = (s_e, R_e, t_e, v_valid, v_fixed, ei, ej, ms, mR, mt, e_ok)
    return args, (R_gt, t_gt)


def test_essential_graph_against_jax(graph):
    args, _ = graph
    js, jR, jt = JP.optimize_essential_graph(*map(jnp.asarray, args),
                                             n_iters=12)
    ts, tR, tt = TP.optimize_essential_graph(*map(t_, args), n_iters=12)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    # the fixed and the invalid vertices kept their state
    for k in (0, 15):
        np.testing.assert_array_equal(tR.numpy()[k], args[1][k])


@pytest.mark.parametrize("n_iters", [1, 2, 5, 12])
def test_gauss_newton_loop_bitwise_parent_loop(graph, n_iters):
    """The Gauss-Newton iterations on copies of s, R, t updated in place,
    run through ``CapturedLoop`` (eager on the CPU; n calls are n
    iterations) and as a Python loop: s, R, t bitwise the loop as it was
    before (``torch_parent_loops.optimize_essential_graph``), and the
    inputs unchanged."""
    args, _ = graph
    old = PARENT.optimize_essential_graph(*map(t_, args), n_iters=n_iters)
    inputs = [t_(a) for a in args]
    loop = CapturedLoop(torch.device("cpu"))
    for runner in (loop, None):
        new = TP.optimize_essential_graph(*inputs, n_iters=n_iters,
                                          loop=runner)
        for a, b in zip(new, old):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    assert (loop.captures, loop.replays) == (0, 0)
    for a, b in zip(inputs, map(t_, args)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def padded_solves(graph):
    """The valid edges alone, and padded with masked rows (each repeating
    the last valid edge) to 256 and 1024 rows: each solve's (s, R, t)."""
    args, _ = graph
    keep = np.nonzero(args[-1])[0]
    cut = [t_(a) for a in args]
    for i in range(5, 11):
        cut[i] = cut[i][torch.as_tensor(keep)]
    out = {"compacted": TP.optimize_essential_graph(*cut, n_iters=12)}
    for cap in (256, 1024):
        rows = torch.as_tensor(np.minimum(np.arange(cap), len(keep) - 1))
        padded = list(cut)
        for i in range(5, 10):
            padded[i] = cut[i][rows]
        padded[10] = torch.arange(cap) < len(keep)
        out[cap] = TP.optimize_essential_graph(*padded, n_iters=12)
    return out


@pytest.mark.parametrize("cap", [256, 1024])
def test_padded_edges_against_compacted(graph, padded_solves, cap):
    ours = padded_solves[cap]
    for a, b in zip(ours, padded_solves[256]):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    for a, b in zip(ours, padded_solves["compacted"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_array_equal(ours[1].numpy()[0], graph[0][1][0])


def test_masked_edges_may_be_left_out(graph):
    args, _ = graph
    full = TP.optimize_essential_graph(*map(t_, args), n_iters=12)
    keep = np.nonzero(args[-1])[0]
    cut = list(args)
    for i in range(5, 11):
        cut[i] = args[i][keep]
    part = TP.optimize_essential_graph(*map(t_, cut), n_iters=12)
    for a, b in zip(part, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_remap_points_through_sim3():
    rng = np.random.default_rng(4)
    X = rng.uniform(-3, 3, (50, 3)).astype(np.float32)
    xi = rng.normal(0, 0.2, (2, 7)).astype(np.float32)
    old = JG.sim3_exp(jnp.asarray(xi[0]))
    new = JG.sim3_exp(jnp.asarray(xi[1]))
    j = JP.remap_points_through_sim3(jnp.asarray(X), *old, *new)
    t = TP.remap_points_through_sim3(
        t_(X), *TG.sim3_exp(t_(xi[0])), *TG.sim3_exp(t_(xi[1])))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_closes_loop_drift():
    """The analog of TestPoseGraph::test_closes_loop_drift: a ring of 12
    poses with drift, measurements from the truth, the loop edge 11 -> 0."""
    m = 12
    rng = np.random.default_rng(42)
    R_gt, t_gt, R_e, t_e, s_e = ring(rng, m)
    ei = np.arange(m, dtype=np.int32)
    ej = (ei + 1) % m
    meas = [measurement(R_gt, t_gt, a, b) for a, b in zip(ei, ej)]
    s_o, R_o, t_o = TP.optimize_essential_graph(
        t_(s_e), t_(R_e), t_(t_e), torch.ones(m, dtype=torch.bool),
        t_(np.arange(m) == 0), t_(ei), t_(ej),
        t_(np.array([x[0] for x in meas], np.float32)),
        t_(np.stack([x[1] for x in meas])),
        t_(np.stack([x[2] for x in meas])), torch.ones(m, dtype=torch.bool),
        n_iters=15)
    err_before = np.linalg.norm(t_e - t_gt, axis=1).max()
    err_after = np.linalg.norm(t_o.numpy() - t_gt, axis=1).max()
    assert err_after < 0.25 * err_before + 1e-4
    np.testing.assert_allclose(s_o.numpy(), 1.0, atol=0.02)
