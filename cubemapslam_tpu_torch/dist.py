"""Distributed global bundle adjustment over ``torch.distributed`` ranks.

Counterpart of ``cubemapslam_tpu/dist.py``: the global BA's observation
edges are partitioned into keyframe blocks, one block a rank. Camera and
point tables are replicated; each rank runs the CG solver of
``optim/ba.py`` on its own edges, and every segment sum into a table is
followed by an ``all_reduce`` over the group (``_psum`` / ``_psum_pts``), so
ranks exchange only the reduced O(M*6 + P*3) accumulators while each touches
only its O(E/n) edges. With landmark ownership (``shard_ba_problem(...,
shard_points=True)``) the point-table exchange shrinks to the boundary
points, those seen from two or more blocks.

PyTorch idiom: the JAX ``shard_map`` over a device mesh becomes SPMD over
the ranks of a process group (``make_mesh``): every rank calls
``distributed_bundle_adjust`` with the same problem and takes edge block
``rank``. Gloo serves CPU tensors and, on a machine with one card, CUDA
tensors of several ranks (it stages them through the host); NCCL serves
CUDA tensors with one card a rank. ``run_ranks`` spawns ranks that
rendezvous through a ``FileStore``, for the tests, ``dryrun`` and the
card's smoke run.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import tempfile
import time
import traceback
import types
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.optim.ba import BAProblem, bundle_adjust

EDGE_FIELDS = ("obs_cam", "obs_pt", "obs_face", "obs_uv", "obs_inv_sigma2",
               "obs_valid")
# host reads of one shard_ba_problem: a copy of each problem field
SHARD_READS = len(BAProblem._fields)


def make_mesh():
    """The process group of the keyframe-block axis (the JAX mesh axis
    ``"kf_block"``): every rank of the default group."""
    return dist.group.WORLD


def partition_edges_by_camera(obs_cam: np.ndarray,
                              n_shards: int) -> list:
    """Keyframe-block edge partition (``dist.py:46-62``): all edges of one
    keyframe land on one shard, shards balanced by edge count (greedy,
    largest camera first). Returns ``n_shards`` edge-index arrays."""
    obs_cam = np.asarray(obs_cam)
    cams, inv, counts = np.unique(obs_cam, return_inverse=True,
                                  return_counts=True)
    shard_of_cam = np.zeros(len(cams), np.int32)
    loads = np.zeros(n_shards, np.int64)
    for ci in np.argsort(-counts, kind="stable"):
        s = int(np.argmin(loads))
        shard_of_cam[ci] = s
        loads[s] += counts[ci]
    edge_shard = shard_of_cam[inv.reshape(-1)]
    return [np.where(edge_shard == s)[0] for s in range(n_shards)]


class ShardedBA(NamedTuple):
    """A keyframe-block-sharded BA problem with landmark ownership
    (``dist.py:65-76``): each point is owned by the block observing it most;
    points observed by >= 2 blocks (the boundary) are permuted to the front
    of the point table, so the ranks exchange only their accumulators each
    CG iteration (``optim.ba._psum_pts``)."""

    prob: BAProblem
    edge_perm: np.ndarray       # (E_sharded,) -> original edge index (-1 pad)
    point_perm: np.ndarray      # (P,) new position -> original point index
    owner_shard: torch.Tensor   # (P,) int64 owning shard (new order; -1 none)
    n_boundary: int             # boundary-prefix length


def shard_ba_problem(prob: BAProblem, n_shards: int,
                     return_perm: bool = False,
                     shard_points: bool = False):
    """Reorder and pad the edge arrays into ``n_shards`` equal keyframe
    blocks (``dist.py:79-148``): each keyframe's edges contiguous on one
    shard, shards padded to the largest block with masked-out edges. The
    layout is computed on the host (one copy of each problem field), the
    result put on the problem's device. With ``return_perm``, also returns
    the (E_sharded,) int64 map from layout position to original edge (-1
    for padding). ``shard_points=True`` also assigns landmark ownership by
    majority observer block and permutes the boundary points to the front,
    returning a ``ShardedBA``."""
    dev = prob.X.device
    host = {f: getattr(prob, f).cpu().numpy() for f in BAProblem._fields}
    blocks = partition_edges_by_camera(host["obs_cam"], n_shards)
    S = max(len(b) for b in blocks)
    perm = np.full(n_shards * S, -1, np.int64)
    for s, b in enumerate(blocks):
        perm[s * S:s * S + len(b)] = b

    def layout(x, fill=0):
        out = np.full((n_shards * S,) + x.shape[1:], fill, x.dtype)
        for s, b in enumerate(blocks):
            out[s * S:s * S + len(b)] = x[b]
        return out

    lay = {f: layout(host[f], fill=False if f == "obs_valid" else 0)
           for f in EDGE_FIELDS}
    if not shard_points:
        sharded = prob._replace(**{f: torch.as_tensor(v, device=dev)
                                   for f, v in lay.items()})
        return (sharded, perm) if return_perm else sharded

    # landmark ownership and the boundary-first point permutation
    P = host["X"].shape[0]
    obs_pt, obs_ok = host["obs_pt"], host["obs_valid"]
    cnt = np.zeros((n_shards, P), np.int32)
    for s, b in enumerate(blocks):
        ok = b[obs_ok[b]]
        np.add.at(cnt[s], obs_pt[ok], 1)
    n_touch = (cnt > 0).sum(axis=0)
    owner = np.where(n_touch > 0, np.argmax(cnt, axis=0), -1).astype(
        np.int32)
    is_boundary = n_touch >= 2
    point_perm = np.concatenate([np.where(is_boundary)[0],
                                 np.where(~is_boundary)[0]]).astype(np.int64)
    inv = np.empty(P, np.int64)
    inv[point_perm] = np.arange(P)
    lay["obs_pt"] = inv[lay["obs_pt"]]
    sharded = prob._replace(
        X=torch.as_tensor(host["X"][point_perm], device=dev),
        pt_valid=torch.as_tensor(host["pt_valid"][point_perm], device=dev),
        **{f: torch.as_tensor(v, device=dev) for f, v in lay.items()})
    return ShardedBA(prob=sharded, edge_perm=perm, point_perm=point_perm,
                     owner_shard=torch.as_tensor(owner[point_perm],
                                                 dtype=torch.int64,
                                                 device=dev),
                     n_boundary=int(is_boundary.sum()))


def distributed_bundle_adjust(cam: CubemapCamera, prob, mesh,
                              phase_iters: Tuple[int, ...] = (5, 10),
                              cg_iters: int = 30):
    """This rank's part of one SPMD ``bundle_adjust`` over the process group
    ``mesh`` (``dist.py:151-199``). Every rank passes the same ``prob``:
    either a ``BAProblem`` whose edge arrays divide by the group's size
    (replicated tables, full reductions; see ``shard_ba_problem``), or a
    ``ShardedBA`` (boundary-only point exchange; each rank keeps the
    authoritative rows of its own points, and the point table is recombined
    by owner in one ``all_reduce`` at the end). Rank r solves edge block r.
    Returns (the updated problem in the sharded layout, the edge inliers in
    the sharded order), the same on every rank."""
    n, r = dist.get_world_size(mesh), dist.get_rank(mesh)
    meta = prob if isinstance(prob, ShardedBA) else None
    if meta is not None:
        prob = meta.prob
    E = prob.obs_cam.shape[0]
    if E % n:
        raise ValueError(f"{E} edges do not divide into {n} blocks; "
                         "lay them out with shard_ba_problem")
    S = E // n
    local = prob._replace(**{f: getattr(prob, f)[r * S:(r + 1) * S]
                             for f in EDGE_FIELDS})
    out, inl = bundle_adjust(
        cam, local, phase_iters=phase_iters, solver="cg", cg_iters=cg_iters,
        group=mesh, n_boundary=None if meta is None else meta.n_boundary)
    # the inliers in the sharded order: each block set by its own rank
    inl_all = torch.zeros(E, dtype=torch.uint8, device=inl.device)
    inl_all[r * S:(r + 1) * S] = inl.to(torch.uint8)
    dist.all_reduce(inl_all, group=mesh)
    X = out.X
    if meta is not None:
        # interior rows are authoritative only on their owning rank
        mine = (meta.owner_shard == r)[:, None]
        X_own = torch.where(mine, X, torch.zeros_like(X))
        dist.all_reduce(X_own, group=mesh)
        X = torch.where((meta.owner_shard >= 0)[:, None], X_own, X)
    return prob._replace(R=out.R, t=out.t, X=X), inl_all.bool()


def broadcast_problem(prob: BAProblem, mesh, src: int = 0) -> BAProblem:
    """A copy of rank ``src``'s problem on every rank of ``mesh`` (the
    ranks' own problems must have its shapes and dtypes)."""
    out = {}
    for f in BAProblem._fields:
        t = getattr(prob, f).clone(memory_format=torch.contiguous_format)
        dist.broadcast(t, src, group=mesh)
        out[f] = t
    return BAProblem(**out)


def global_ba_problem_from_arena(cam: CubemapCamera, arena: SM.MapArena,
                                 inv_level_sigma2: torch.Tensor
                                 ) -> BAProblem:
    """The full-map BA problem (GlobalBundleAdjustemnt analog,
    ``dist.py:202-220``): every valid keyframe and landmark, the temporally
    first valid keyframe fixed (slots are recycled, so "KF 0" is by frame
    id; ties go to the lower slot). The monocular scale gauge is retracted
    inside ``bundle_adjust``."""
    kf_idx, lm, face, uv_face, inv_s2, live = SM.ba_edges_from_arena(
        cam, arena, arena.kf_valid, inv_level_sigma2)
    ordkey = torch.where(arena.kf_valid, arena.kf_frame_id,
                         torch.full_like(arena.kf_frame_id, SM._BIG))
    # a stable sort's first entry: the first minimum
    first = torch.sort(ordkey, stable=True)[1][:1]
    cam_fixed = torch.zeros(arena.n_kf_cap, dtype=torch.bool,
                            device=arena.device).index_fill_(0, first, True)
    return BAProblem(
        R=arena.kf_R, t=arena.kf_t, cam_fixed=cam_fixed,
        cam_valid=arena.kf_valid, X=arena.lm_pos,
        pt_valid=arena.lm_valid, obs_cam=kf_idx, obs_pt=lm,
        obs_face=face, obs_uv=uv_face, obs_inv_sigma2=inv_s2,
        obs_valid=live)


def make_synthetic_arena(cfg, cam: CubemapCamera, n_kf: int = 12,
                         n_pts: int = 256, seed: int = 0,
                         pos_noise: float = 0.01) -> SM.MapArena:
    """A populated arena on ``cam``'s device for dryruns and benchmarks
    (``dist.py:223-281``, the same draws from ``seed``): keyframes on a short
    trajectory observing a shared random point cloud, observations wired
    through ``kf_obs_lm`` as the mapping step writes them."""
    from cubemapslam_tpu_torch import camera as C
    from cubemapslam_tpu_torch import geometry as G

    rng = np.random.default_rng(seed)
    N = cfg.n_features
    K, L = max(n_kf, 4), max(n_pts, 8)
    cam_cpu = _camera_on(cam, "cpu")
    d = rng.normal(size=(n_pts, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * rng.uniform(3, 7, (n_pts, 1))).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    lm_pos = np.zeros((L, 3), np.float32)
    lm_pos[:n_pts] = pts + rng.normal(0, pos_noise, pts.shape).astype(
        np.float32)
    lm_desc = np.zeros((L, 8), np.int64)
    lm_desc[:n_pts] = desc
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.zeros((K, 3), np.float32)
    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_rays = np.zeros((K, N, 3), np.float32)
    kf_face = np.full((K, N), -1, np.int64)
    kf_desc = np.zeros((K, N, 8), np.int64)
    kf_ok = np.zeros((K, N), bool)
    kf_lm = np.full((K, N), SM.NO_LM, np.int64)
    for k in range(n_kf):
        Rk = G.so3_exp(torch.as_tensor(
            (rng.normal(size=3) * 0.03).astype(np.float32))).numpy()
        tk = (np.array([0.25 * k, 0, 0.1 * k])
              + rng.normal(0, 0.01, 3)).astype(np.float32)
        pc = (Rk @ pts.T).T + tk
        uv, face = C.ray_to_cubemap(cam_cpu, torch.as_tensor(
            pc, dtype=torch.float32))
        uv, face = uv.numpy(), face.numpy()
        vis = np.where(face >= 0)[0][:N]
        m = len(vis)
        kf_lm[k, :m] = vis
        kf_uv[k, :m] = uv[vis] + rng.normal(0, 0.3, (m, 2))
        kf_face[k, :m] = face[vis]
        kf_desc[k, :m] = desc[vis]
        kf_ok[k, :m] = True
        kf_rays[k, :m] = pc[vis] / np.linalg.norm(pc[vis], axis=1,
                                                  keepdims=True)
        kf_R[k], kf_t[k] = Rk, tk
    arena = SM.make_arena(K, N, L, cam.device)
    kf_valid = np.zeros(K, bool)
    kf_valid[:n_kf] = True
    kf_frame_id = np.full(K, -1, np.int64)
    kf_frame_id[:n_kf] = np.arange(n_kf)
    lm_valid = np.zeros(L, bool)
    lm_valid[:n_pts] = True
    for name, v in dict(kf_R=kf_R, kf_t=kf_t, kf_valid=kf_valid,
                        kf_frame_id=kf_frame_id, kf_uv=kf_uv,
                        kf_rays=kf_rays, kf_face=kf_face, kf_desc=kf_desc,
                        kf_kp_valid=kf_ok, kf_obs_lm=kf_lm, lm_pos=lm_pos,
                        lm_valid=lm_valid, lm_desc=lm_desc).items():
        getattr(arena, name).copy_(torch.as_tensor(v))
    return arena


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------

def _camera_on(cam: CubemapCamera, device) -> CubemapCamera:
    return dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).to(device)
        for f in dataclasses.fields(cam)})


def _rank_main(fn: Callable, rank: int, world_size: int, workdir: str,
               timeout: float, args: tuple) -> None:
    """One spawned rank: one intra-op thread, the gloo process group through
    a ``FileStore`` in ``workdir``, ``fn(group, *args)``, whose result is
    saved for the parent (a traceback in its place if it raised)."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(dist.group.WORLD, *args)
        torch.save(out, os.path.join(workdir, f"out.{rank}"))
    except BaseException:
        with open(os.path.join(workdir, f"err.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: tuple = (),
              timeout: float = 300.0, workdir: Optional[str] = None) -> list:
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks, one
    process each, in a gloo group (CPU tensors, or CUDA tensors of ranks
    that share a card) joined through a ``FileStore`` in a temporary
    directory (under ``workdir`` if given). ``fn`` must be importable by its module
    path (the ranks import it, and nothing of the caller). ``timeout``
    bounds the rendezvous, each collective and the whole run: a rank still
    alive then is killed and this raises. Returns the ranks' results in
    rank order."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, d, timeout, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} did not finish "
                               f"within {timeout} s")
        errors = []
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                path = os.path.join(d, f"err.{r}")
                msg = open(path).read() if os.path.exists(path) else ""
                errors.append(f"rank {r} exited {p.exitcode}\n{msg}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [torch.load(os.path.join(d, f"out.{r}"), weights_only=False)
                for r in range(world_size)]


def rank_bundle_adjust(group, cam: CubemapCamera, prob, device: str,
                       phase_iters: Tuple[int, ...] = (5, 10),
                       cg_iters: int = 30) -> dict:
    """A rank's entry for ``run_ranks``: ``distributed_bundle_adjust`` of
    ``prob`` (a ``BAProblem`` or ``ShardedBA``) on ``device``. Returns the
    solution on the host and the solve's wall seconds, timed between two
    barriers (the card synchronised)."""
    def to(t):
        return t.to(device) if isinstance(t, torch.Tensor) else t

    cam = _camera_on(cam, device)
    if isinstance(prob, ShardedBA):
        prob = prob._replace(prob=BAProblem(*map(to, prob.prob)),
                             owner_shard=to(prob.owner_shard))
    else:
        prob = BAProblem(*map(to, prob))

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier(group=group)

    sync()
    t0 = time.perf_counter()
    out, inl = distributed_bundle_adjust(cam, prob, group, phase_iters,
                                         cg_iters)
    sync()
    wall = time.perf_counter() - t0
    return dict(R=out.R.cpu(), t=out.t.cpu(), X=out.X.cpu(), inl=inl.cpu(),
                wall_s=wall)


def rank_loop_global_ba(group, cfg, arena_np: dict, device: str) -> dict:
    """A rank's entry for ``run_ranks``: the loop closer's post-loop global
    BA (``LoopCloser._global_ba``, whose sharded branch runs with more than
    one rank) on the arena given as numpy arrays in the JAX package's
    dtypes. Returns the arena after it, in the same form."""
    from cubemapslam_tpu_torch import interop
    from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser

    arena = interop.arena_from_numpy(arena_np, device)
    lc = LoopCloser(cfg, CubemapCamera.from_config(cfg, device))
    system = types.SimpleNamespace(arena=arena)
    lc._global_ba(system)
    return interop.arena_to_numpy(system.arena)


def _dryrun_rank(group, n_devices: int, device: str) -> bool:
    from cubemapslam_tpu_torch.config import SlamConfig

    cfg = SlamConfig(cube_face_w=64, cube_face_h=64, n_features=64,
                     n_levels=2)
    cam = CubemapCamera.from_config(cfg, device)
    arena = make_synthetic_arena(cfg, cam, n_kf=10, n_pts=96)
    inv_s2 = 1.0 / torch.tensor(cfg.level_sigma2, dtype=torch.float32,
                                device=device)
    prob = global_ba_problem_from_arena(cam, arena, inv_s2)
    sharded = shard_ba_problem(prob, n_devices, shard_points=True)
    out, inl = distributed_bundle_adjust(cam, sharded, group,
                                         phase_iters=(2, 2), cg_iters=8)
    return bool(torch.isfinite(out.R).all() and torch.isfinite(out.X).all()
                and int(inl.sum()) > 0)


def dryrun(n_devices: int, device=None) -> None:
    """Build and run one sharded global-BA solve over ``n_devices`` spawned
    gloo ranks (``dist.py:284-301``) on an arena-derived problem, the
    construction the post-loop global BA runs, at tiny shapes; on the card
    (every rank on it) unless ``device="cpu"``."""
    from cubemapslam_tpu_torch.runtime.frame_step import resolve_device

    dev = str(resolve_device(device))
    ok = run_ranks(_dryrun_rank, n_devices, args=(n_devices, dev))
    if not all(ok):
        raise AssertionError(f"dryrun over {n_devices} ranks: non-finite "
                             f"result or no inlier ({ok})")
