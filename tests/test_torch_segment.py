"""Port parity: the segmented sums of ``cubemapslam_tpu_torch/segment.py``
and the solvers that use them.

Seeded numpy inputs go to JAX's ``zeros((n+1,) + v.shape[1:]).at[idx].add(v)``
(the last row is the dump slot that an id ``n`` drops, as
``slam_map._scatter`` uses it) and to the port's two plain versions:
``segment_sum`` on the CPU (``index_add_``) and ``segment_sum_ordered`` (the
CUDA kernel's order of additions). Cases: one lane, 3 and 6x6 lanes, mostly
empty segments, the dump row, segments of about 1,000 rows like the CG BA's
camera segments, and one plan reused over several value sets.

Tolerances, per segment, against the sum of the absolute values S of its
rows: ``index_add_`` within 1e-6 S (both add in index order); the kernel's
order within len * 2^-23 * S (each of two float32 summations of len terms is
within (len - 1) * 2^-24 * S of the exact sum). A segment of at most 32 rows
is summed by the kernel in index order, so there the two plain versions are
bitwise equal.

On the CPU ``segment_sum`` is the scatter it replaced: at every call site's
layout (the direct BA's (9, P) and (18, Mf*P) sums along dim 1, the pose
graph's four ``index_put_(accumulate=True)`` and two ``index_add_``, the
landmark normals' dump row, and the BA's padding and masked edges, whose
exact zeros the plans drop where the scatter added them to row 0: a float
sum from +0 never is -0, so adding +-0 leaves it unchanged) it is bitwise
equal to the scatter it replaced,
and ``_bundle_adjust_direct``, ``_bundle_adjust_cg`` and
``optimize_essential_graph`` with their plans are bitwise equal to the same
solvers with the plain ``zeros(...).index_add_`` in place of
``segment_sum`` (the dropped rows added into row 0). With the kernel's order in place of ``segment_sum``, the
solvers are held to JAX with the tolerances of ``test_torch_ba.py`` and
``test_torch_pose_graph.py``: the direct BA's poses and its points seen by 3
or more used edges within 1e-4, inliers equal; one CG LM step's free
cameras and points seen 3 or more times within 1e-4; the pose graph's s, R,
t within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ba as BA
import test_torch_pose_graph as PG
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.optim import ba as JB
from cubemapslam_tpu.optim import pose_graph as JP
from cubemapslam_tpu_torch import segment as SG
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.optim import ba as TB
from cubemapslam_tpu_torch.optim import pose_graph as TP


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (rows, segments, lanes, share of rows on the dump id n, rows forced into
# segment 1)
CASES = {
    "one_lane": (400, 30, (), 0.0, 0),
    "three_lanes": (600, 40, (3,), 0.0, 40),
    "blocks_6x6": (900, 12, (6, 6), 0.0, 100),
    "mostly_empty": (50, 200, (7,), 0.0, 0),
    "dump_row": (500, 60, (3,), 0.4, 33),
    "camera_segments": (3000, 3, (36,), 0.0, 0),
}


def make_case(name, seed=0):
    E, n, tail, dump, forced = CASES[name]
    rng = np.random.default_rng([seed, len(name)])
    idx = rng.integers(0, n, E)
    idx[rng.uniform(size=E) < dump] = n
    idx[:forced] = 1
    scale = 10.0 ** rng.uniform(-3, 3, (E,) + tail)
    v = (rng.normal(size=(E,) + tail) * scale).astype(np.float32)
    return idx, v, n


def jax_sum(idx, v, n):
    out = jnp.zeros((n + 1,) + v.shape[1:], jnp.float32)
    return np.asarray(out.at[jnp.asarray(idx)].add(jnp.asarray(v)))[:n]


def per_segment(idx, v, n):
    """(rows, sum of |v|) of each segment, broadcast over its lanes."""
    lens = np.bincount(idx, minlength=n + 1)[:n].astype(np.float64)
    mag = np.zeros((n + 1,) + v.shape[1:])
    np.add.at(mag, idx, np.abs(v.astype(np.float64)))
    shape = (n,) + (1,) * (v.ndim - 1)
    return lens.reshape(shape), mag[:n]


def plan_of(idx, n):
    return SG.SegmentPlan(torch.as_tensor(idx, dtype=torch.int64), n)


@pytest.mark.parametrize("case", list(CASES))
def test_index_add_version_against_jax(case):
    idx, v, n = make_case(case)
    out = SG.segment_sum(plan_of(idx, n), torch.as_tensor(v)).numpy()
    ref = jax_sum(idx, v, n)
    _, mag = per_segment(idx, v, n)
    assert out.shape == ref.shape
    assert (np.abs(out - ref) <= 1e-6 * mag).all()


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_order_against_jax(case):
    idx, v, n = make_case(case)
    out = SG.segment_sum_ordered(plan_of(idx, n), torch.as_tensor(v)).numpy()
    ref = jax_sum(idx, v, n)
    lens, mag = per_segment(idx, v, n)
    assert out.shape == ref.shape
    assert (np.abs(out - ref) <= lens * 2.0 ** -23 * mag).all()


@pytest.mark.parametrize("case", list(CASES))
def test_short_segments_sum_in_index_order(case):
    """The kernel's order is the index order on segments of <= 32 rows,
    and an empty segment is +0."""
    idx, v, n = make_case(case)
    plan = plan_of(idx, n)
    a = SG.segment_sum(plan, torch.as_tensor(v))
    b = SG.segment_sum_ordered(plan, torch.as_tensor(v))
    lens = np.bincount(idx, minlength=n + 1)[:n]
    short = torch.as_tensor(lens <= SG.WARP)
    assert torch.equal(a[short], b[short])
    assert not torch.signbit(b[torch.as_tensor(lens == 0)]).any()


def test_plan_reuse_across_value_sets():
    """One plan over several value sets gives what a fresh plan gives, and
    sorts once."""
    idx, _, n = make_case("blocks_6x6")
    plan = plan_of(idx, n)
    perm = plan.order()[0]
    rng = np.random.default_rng(7)
    for _ in range(3):
        v = torch.as_tensor(rng.normal(size=(len(idx), 6, 6)).astype(
            np.float32))
        fresh = plan_of(idx, n)
        for fn in (SG.segment_sum, SG.segment_sum_ordered):
            assert torch.equal(fn(plan, v), fn(fresh, v))
    assert plan.order()[0] is perm


def _site(name, rng):
    """(the scatter the call site had, its segment sum) on the CPU."""
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    if name == "point_lanes":          # optim/ba.py, the direct step
        P, idx = 50, t(rng.integers(0, 50, 300))
        lanes = t(rng.normal(size=(9, 300)).astype(np.float32))
        old = torch.zeros(9, P).index_add_(1, idx, lanes)
        new = SG.segment_sum(SG.SegmentPlan(idx, P), lanes.T.contiguous()).T
    elif name == "coupling":           # optim/ba.py, the direct step
        Mf, P, Nc = 4, 30, 20
        obs_pt = t(rng.integers(0, P, (Mf, Nc)))
        Wv = t(rng.normal(size=(18, Mf, Nc)).astype(np.float32))
        tgt = (torch.arange(Mf)[:, None] * P + obs_pt).reshape(-1)
        old = torch.zeros(18, Mf * P).index_add_(1, tgt, Wv.reshape(18, -1))
        old = old.reshape(18, Mf, P).permute(1, 0, 2).reshape(Mf, 6, 3, P)
        new = SG.segment_sum(SG.SegmentPlan(tgt, Mf * P),
                             Wv.permute(1, 2, 0).reshape(-1, 18))
        new = new.reshape(Mf, P, 18).permute(0, 2, 1).reshape(Mf, 6, 3, P)
    elif name in ("pose_graph_H", "pose_graph_b"):   # optim/pose_graph.py
        M, E = 9, 40
        ei, ej = t(rng.integers(0, M, E)), t(rng.integers(0, M, E))
        A = [t(rng.normal(size=(E, 7, 7)).astype(np.float32))
             for _ in range(4)]
        if name == "pose_graph_H":
            old = torch.zeros(M, M, 7, 7)
            for (a, b), blk in zip(((ei, ei), (ej, ej), (ei, ej), (ej, ei)),
                                   A):
                old.index_put_((a, b), blk, accumulate=True)
            keys = torch.cat([ei * M + ei, ej * M + ej, ei * M + ej,
                              ej * M + ei])
            new = SG.segment_sum(SG.SegmentPlan(keys, M * M),
                                 torch.cat(A)).view(M, M, 7, 7)
        else:
            old = torch.zeros(M, 7)
            old.index_add_(0, ei, A[0][:, 0])
            old.index_add_(0, ej, A[1][:, 0])
            new = SG.segment_sum(SG.SegmentPlan(torch.cat([ei, ej]), M),
                                 torch.cat([A[0][:, 0], A[1][:, 0]]))
    elif name == "padding_dropped":    # optim/ba.py, both plans
        P, idx = 20, t(rng.integers(0, 20, 300))
        ok = t(rng.uniform(size=300) < 0.7)
        v = t(rng.normal(size=(300, 9)).astype(np.float32))
        v = torch.where(ok[:, None], v, -0.0 * v)       # +-0 on padding
        old = torch.zeros(P, 9).index_add_(0, torch.where(ok, idx, 0), v)
        new = SG.segment_sum(SG.SegmentPlan(torch.where(ok, idx, P), P), v)
    else:                              # slam_map.py, the normals' dump row
        S, seg = 40, t(rng.integers(0, 41, 400))
        v = t(rng.normal(size=(400, 3)).astype(np.float32))
        old = SM._scatter(S + 1, 0.0, seg, v, "sum")[:-1]
        new = SG.segment_sum(SG.SegmentPlan(seg, S), v)
    return old, new


@pytest.mark.parametrize("site", ["point_lanes", "coupling", "pose_graph_H",
                                  "pose_graph_b", "normal_sum",
                                  "padding_dropped"])
def test_call_sites_bitwise_the_replaced_scatter(site):
    old, new = _site(site, np.random.default_rng(11))
    assert old.shape == new.shape
    assert torch.equal(old, new)


def _index_add_segsum(plan, values):
    """The plain ``zeros((n,) + v.shape[1:]).index_add_(0, idx, v)``,
    with the rows a plan drops (padding and masked edges, whose values
    are zeros) added into row 0, where the JAX layout puts padding."""
    idx = torch.where(plan.idx == plan.n, 0, plan.idx)
    return torch.zeros((plan.n,) + tuple(values.shape[1:]),
                       dtype=values.dtype).index_add_(0, idx, values)


def _pose_graph_args():
    """A seeded 16-vertex ring: the chain, covisibility pairs, two loops;
    vertex 0 fixed."""
    rng = np.random.default_rng(3)
    m = 16
    R_gt, t_gt, R_e, t_e, s_e = PG.ring(rng, m)
    pairs = [(k, k + 1) for k in range(m - 1)]
    pairs += [(k, k + 2) for k in range(0, m - 2, 2)]
    pairs += [(m - 2, 0), (m - 3, 1)]
    meas = [PG.measurement(R_gt, t_gt, a, b) for a, b in pairs]
    fixed = np.zeros(m, bool)
    fixed[0] = True
    return (s_e, R_e, t_e, np.ones(m, bool), fixed,
            np.array([a for a, _ in pairs]), np.array([b for _, b in pairs]),
            np.array([x[0] for x in meas], np.float32),
            np.stack([x[1] for x in meas]).astype(np.float32),
            np.stack([x[2] for x in meas]).astype(np.float32),
            np.ones(len(pairs), bool))


def _solve(solver):
    """The solver's outputs on its seeded problem (CPU tensors)."""
    tcam = TCam.from_config(BA.CFG, "cpu")
    if solver == "direct":
        f, _ = BA.make_problem(np.random.default_rng(0))
        out, inl = TB._bundle_adjust_direct(tcam, BA.tprob(f), (5, 10),
                                            TB.CHI2_TH, 100, BA.N_FREE)
        return (out.R, out.t, out.X, inl)
    if solver == "cg":
        f, _ = BA.cg_problem(np.random.default_rng(9))
        out, inl = TB._bundle_adjust_cg(tcam, BA.tprob(f), (5, 10),
                                        TB.CHI2_TH, 30)
        return (out.R, out.t, out.X, inl)
    return TP.optimize_essential_graph(*map(PG.t_, _pose_graph_args()),
                                       n_iters=12)


@pytest.mark.parametrize("solver", ["direct", "cg", "pose_graph"])
def test_solvers_bitwise_the_index_add_scatter(solver, monkeypatch):
    with_plans = _solve(solver)
    monkeypatch.setattr(TB, "segment_sum", _index_add_segsum)
    monkeypatch.setattr(TP, "segment_sum", _index_add_segsum)
    scattered = _solve(solver)
    for a, b in zip(with_plans, scattered):
        assert torch.equal(a, b)


@pytest.mark.parametrize("solver", ["direct", "cg_step", "pose_graph"])
def test_solvers_in_kernel_order_against_jax(solver, monkeypatch):
    monkeypatch.setattr(TB, "segment_sum", SG.segment_sum_ordered)
    monkeypatch.setattr(TP, "segment_sum", SG.segment_sum_ordered)
    jcam, tcam = JCam.from_config(BA.CFG), TCam.from_config(BA.CFG, "cpu")
    if solver == "pose_graph":
        args = _pose_graph_args()
        j = JP.optimize_essential_graph(*map(jnp.asarray, args), n_iters=12)
        t = TP.optimize_essential_graph(*map(PG.t_, args), n_iters=12)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        return
    if solver == "cg_step":
        f, _ = BA.cg_problem(np.random.default_rng(8))
        act = f["obs_valid"]
        j = JB._lm_step(jcam, BA.jprob(f), jnp.asarray(act), True,
                        jnp.float32(1e-4), 30)
        t = TB._lm_step(tcam, BA.tprob(f), torch.as_tensor(act), True,
                        torch.tensor(1e-4), 30)
        used = act & f["cam_valid"][f["obs_cam"]]
    else:
        f, _ = BA.make_problem(np.random.default_rng(0))
        jout, jinl = JB.bundle_adjust(jcam, BA.jprob(f), solver="direct",
                                      n_free=BA.N_FREE, max_obs_per_cam=100)
        tout, tinl = TB.bundle_adjust(tcam, BA.tprob(f), solver="direct",
                                      n_free=BA.N_FREE, max_obs_per_cam=100)
        np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
        j, t = (jout.R, jout.t, jout.X), (tout.R, tout.t, tout.X)
        # the edges the solve used: compacted, of a valid camera, inliers
        ctx = JB._make_direct_ctx(jcam, BA.jprob(f), 100)
        used = np.zeros((BA.M, BA.N), bool)
        for m in range(BA.M):
            row = np.asarray(ctx.sel)[m][np.asarray(ctx.valid0)[m]]
            used[m, row] = True
        used = (used.reshape(-1) & np.asarray(jinl)
                & f["cam_valid"][f["obs_cam"]])
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-4)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-4)
    held = np.bincount(f["obs_pt"][used], minlength=BA.P) >= 3
    assert held.mean() > 0.85
    np.testing.assert_allclose(t[2].numpy()[held], np.asarray(j[2])[held],
                               atol=1e-4)
