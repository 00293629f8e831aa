"""Port parity: the distributed global BA (``cubemapslam_tpu_torch.dist``
and the collective hooks of the CG solver in ``optim/ba.py``).

* ``partition_edges_by_camera`` and ``shard_ba_problem`` (edge and point
  permutations, owners, boundary length, the padded edge arrays) exactly
  equal to the JAX package's.
* ``distributed_bundle_adjust`` over 1, 2 and 4 gloo ranks (spawned
  processes that import only the port, one thread each, joined through a
  ``FileStore`` under ``tmp_path``, each wait bounded) against the port's
  single-process ``bundle_adjust`` of the same sharded problem, and at 4
  ranks against the JAX ``distributed_bundle_adjust`` on a 4-device
  sub-mesh of the conftest's CPU mesh, with ``tests/test_dist.py``'s
  tolerances: R and t within 1e-4, points within 1e-3, inliers equal. At one
  rank every ``all_reduce`` is the identity, so the result is bitwise the
  single-process one; every rank returns the same result.
* ``make_synthetic_arena`` against JAX's from the same seed (integer tables
  equal, floats within 1e-4), ``dryrun(2)`` on the CPU, and the loop
  closer's global BA over 2 ranks (its sharded branch) against its
  single-process branch on the tier-1 constructed-drift arena.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import dist as JD
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.camera import cubemap_uv_to_in_face
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.optim.ba import BAProblem as JProblem
from cubemapslam_tpu_torch import dist as D
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.optim.ba import BAProblem, bundle_adjust
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser

CG_ITERS = 20
RANK_TIMEOUT = 240.0
LOOP_CFG = dict(cube_face_w=160, cube_face_h=160, n_features=600,
                n_levels=3, max_keyframes=64, max_landmarks=8192)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_problem(rng, cam, n_cams=6, n_pts=80):
    """``tests/test_dist.py``'s problem, as numpy arrays."""
    pts = rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    Rs, ts = [], []
    for k in range(n_cams):
        Rs.append(np.asarray(JG.so3_exp(jnp.asarray(
            rng.normal(size=3) * 0.03, jnp.float32))))
        ts.append((np.array([0.3 * k, 0, 0])
                   + rng.normal(0, 0.01, 3)).astype(np.float32))
    obs = []
    for ci in range(n_cams):
        pc = (Rs[ci] @ pts.T).T + ts[ci]
        uv, face = JC.ray_to_cubemap(cam, jnp.asarray(pc, jnp.float32))
        uvf = np.asarray(cubemap_uv_to_in_face(cam, uv))
        face = np.asarray(face)
        for pi in np.where(face >= 0)[0]:
            obs.append((ci, pi, face[pi], uvf[pi] + rng.normal(0, 0.3, 2)))
    E = len(obs)
    X0 = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)
    return dict(
        R=np.stack(Rs), t=np.stack(ts),
        cam_fixed=np.array([True] + [False] * (n_cams - 1)),
        cam_valid=np.ones(n_cams, bool), X=X0, pt_valid=np.ones(n_pts, bool),
        obs_cam=np.array([o[0] for o in obs], np.int32),
        obs_pt=np.array([o[1] for o in obs], np.int32),
        obs_face=np.array([o[2] for o in obs], np.int32),
        obs_uv=np.stack([o[3] for o in obs]).astype(np.float32),
        obs_inv_sigma2=np.ones(E, np.float32), obs_valid=np.ones(E, bool))


def tprob(f):
    return BAProblem(**{k: torch.as_tensor(
        v.astype(np.int64) if v.dtype == np.int32 else v)
        for k, v in f.items()})


def jprob(f):
    return JProblem(**{k: jnp.asarray(v) for k, v in f.items()})


@pytest.fixture(scope="module")
def problem(lafida_cam):
    f = build_problem(np.random.default_rng(42), lafida_cam)
    return f, TCam.from_config(TConfig(), "cpu")


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_partition_matches_jax(n_shards):
    obs_cam = np.random.default_rng(42).integers(0, 17, 4000).astype(
        np.int32)
    ours = D.partition_edges_by_camera(obs_cam, n_shards)
    ref = JD.partition_edges_by_camera(obs_cam, n_shards)
    assert len(ours) == len(ref) == n_shards
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shard_points", [False, True])
def test_shard_ba_problem_matches_jax(problem, shard_points):
    f, _ = problem
    ours = D.shard_ba_problem(tprob(f), 4, return_perm=True,
                              shard_points=shard_points)
    ref = JD.shard_ba_problem(jprob(f), 4, return_perm=True,
                              shard_points=shard_points)
    if shard_points:
        assert ours.n_boundary == ref.n_boundary > 0
        np.testing.assert_array_equal(ours.edge_perm, ref.edge_perm)
        np.testing.assert_array_equal(ours.point_perm, ref.point_perm)
        np.testing.assert_array_equal(ours.owner_shard.numpy(),
                                      np.asarray(ref.owner_shard))
        ours_p, ref_p = ours.prob, ref.prob
    else:
        (ours_p, ours_perm), (ref_p, ref_perm) = ours, ref
        np.testing.assert_array_equal(ours_perm, ref_perm)
    for name in BAProblem._fields:
        a, b = getattr(ours_p, name).numpy(), np.asarray(getattr(ref_p, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def solves(problem, tmp_path_factory):
    """For n in 1, 2, 4: the point-sharded problem laid out for n ranks,
    its solve by n spawned gloo ranks, and the single-process solve of the
    same layout."""
    f, tcam = problem
    out = {}
    for n in (1, 2, 4):
        sharded = D.shard_ba_problem(tprob(f), n, shard_points=True)
        ranks = D.run_ranks(D.rank_bundle_adjust, n,
                            args=(tcam, sharded, "cpu", (5, 10), CG_ITERS),
                            timeout=RANK_TIMEOUT,
                            workdir=tmp_path_factory.mktemp("ranks"))
        ref, ref_inl = bundle_adjust(tcam, sharded.prob, solver="cg",
                                     cg_iters=CG_ITERS)
        out[n] = (sharded, ranks, ref, ref_inl)
    return out


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_sharded_solve_matches_single_process(solves, n_ranks):
    sharded, ranks, ref, ref_inl = solves[n_ranks]
    r0 = ranks[0]
    for other in ranks[1:]:
        for k in ("R", "t", "X", "inl"):
            assert torch.equal(other[k], r0[k]), k
    if n_ranks == 1:
        for k, v in (("R", ref.R), ("t", ref.t), ("X", ref.X),
                     ("inl", ref_inl)):
            assert torch.equal(r0[k], v), k
    np.testing.assert_allclose(r0["R"].numpy(), ref.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(r0["t"].numpy(), ref.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(r0["X"].numpy(), ref.X.numpy(), atol=1e-3)
    np.testing.assert_array_equal(r0["inl"].numpy(), ref_inl.numpy())
    assert sharded.n_boundary > 0 or n_ranks == 1


def test_sharded_solve_matches_jax(problem, solves, lafida_cam):
    f, _ = problem
    _, ranks, _, _ = solves[4]
    jsh = JD.shard_ba_problem(jprob(f), 4, shard_points=True)
    mesh = JD.make_mesh(jax.devices()[:4])
    out, inl = JD.distributed_bundle_adjust(lafida_cam, jsh, mesh,
                                            cg_iters=CG_ITERS)
    r0 = ranks[0]
    np.testing.assert_allclose(r0["R"].numpy(), np.asarray(out.R),
                               atol=1e-4)
    np.testing.assert_allclose(r0["t"].numpy(), np.asarray(out.t),
                               atol=1e-4)
    np.testing.assert_allclose(r0["X"].numpy(), np.asarray(out.X),
                               atol=1e-3)
    np.testing.assert_array_equal(r0["inl"].numpy(), np.asarray(inl))


def test_replicated_layout_matches_single_process(problem, tmp_path):
    """The plain layout (full point-table reductions, no ownership) over 2
    ranks."""
    f, tcam = problem
    prob = D.shard_ba_problem(tprob(f), 2)
    r0, r1 = D.run_ranks(D.rank_bundle_adjust, 2,
                         args=(tcam, prob, "cpu", (5, 10), CG_ITERS),
                         timeout=RANK_TIMEOUT, workdir=tmp_path)
    ref, ref_inl = bundle_adjust(tcam, prob, solver="cg", cg_iters=CG_ITERS)
    assert all(torch.equal(r0[k], r1[k]) for k in ("R", "t", "X", "inl"))
    np.testing.assert_allclose(r0["R"].numpy(), ref.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(r0["t"].numpy(), ref.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(r0["X"].numpy(), ref.X.numpy(), atol=1e-3)
    np.testing.assert_array_equal(r0["inl"].numpy(), ref_inl.numpy())


def test_make_synthetic_arena_matches_jax():
    cfg = dict(cube_face_w=128, cube_face_h=128, n_features=256, n_levels=4)
    tcfg, jcfg = TConfig(**cfg), JConfig(**cfg)
    ours = interop.arena_to_numpy(D.make_synthetic_arena(
        tcfg, TCam.from_config(tcfg, "cpu"), n_kf=8, n_pts=128, seed=3))
    ref = {k: np.asarray(v) for k, v in JD.make_synthetic_arena(
        jcfg, JCam.from_config(jcfg), n_kf=8, n_pts=128,
        seed=3)._asdict().items()}
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == \
            ref[k].shape, k
        if np.issubdtype(ref[k].dtype, np.floating):
            np.testing.assert_allclose(ours[k], ref[k], atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ours["kf_kp_valid"].sum() > 0


def test_dryrun_hook():
    D.dryrun(2, device="cpu")


def test_loop_global_ba_two_ranks_matches_single_process(tmp_path):
    cfg = TConfig(**LOOP_CFG)
    arena, _, _, _ = S.build_drifted_loop_arena(cfg,
                                                np.random.default_rng(42))
    f = interop.arena_to_numpy(arena)
    ranks = D.run_ranks(D.rank_loop_global_ba, 2, args=(cfg, f, "cpu"),
                        timeout=RANK_TIMEOUT, workdir=tmp_path)
    system = types.SimpleNamespace(arena=interop.arena_from_numpy(f))
    LoopCloser(cfg, TCam.from_config(cfg, "cpu"))._global_ba(system)
    ref = interop.arena_to_numpy(system.arena)
    for k in ref:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    got = ranks[0]
    np.testing.assert_allclose(got["kf_R"], ref["kf_R"], atol=1e-4)
    np.testing.assert_allclose(got["kf_t"], ref["kf_t"], atol=1e-4)
    np.testing.assert_allclose(got["lm_pos"], ref["lm_pos"], atol=1e-3)
    np.testing.assert_array_equal(got["kf_obs_lm"], ref["kf_obs_lm"])
    # the BA moved the map and cut outliers the same way
    assert not np.array_equal(got["kf_t"], f["kf_t"])
