"""The port's CubemapSLAM closes a loop on a rendered circuit.

    python3 scripts/torch_loop_e2e.py [--device cpu] [--seed 42]
                                      [--draws device,cpu]
                                      [--vocab-device cpu] [--dump PATH]
                                      [--project-rotations] [--eager-loop]

The counterpart of the JAX package's slow test
``tests/test_loop_e2e.py::test_closes_loop_and_reduces_ate``: 170
frames of ``loop_trajectory(radius=3.0, n_loops=1.25, facing="tangent")``
through a seeded world of 1500 billboards, at the test's configuration
(160^2 faces, 600 features, 3 levels, K=144, L=16384), with a vocabulary
trained on 12 rendered frames of the circuit (the test's
``pretrained_vocab``) and loop closing at consistency_th = 3. As the test
does, it renders cubemap crosses and tracks every frame with
``track_cubemap`` (under the FOV mask), on the card (``--device cpu`` runs
the plain versions, for a rehearsal), and requires: at least one loop closed,
state OK at the end, the keyframe ATE after the closure (Sim3-aligned)
below the last ATE sampled before it and below 0.05 of the 6.0 circle
diameter; it prints the cross-pass covisibility of the test (the largest
weight between keyframes more than 80 frames apart). Prints one line per
keyframe frame, the closure's stage times, then a JSON summary (with the
ATE right after each closure, and the RANSAC and refined Sim3 scale of
each refinement), the card's
name and power limit, and exits 1 if a check fails. ``--draws cpu`` gives
the card the RANSAC minimal sets of a CPU run (a host generator with the
same seed), which separates the sampling stream from the card's numerics
when the two devices disagree; ``--draws device,cpu`` runs both over one
rendering. The summary's ``rotation_orthonormality_error`` says how far the
returned rotations left SO(3); ``--project-rotations`` keeps the tracked
ones on it (a diagnostic), and ``--dump`` records every frame for
``scripts/torch_e2e_divergence.py``. On the card DetectLoop, ComputeSim3
and CorrectLoop replay the system's loop graphs (``FusedLoop`` and its
``FusedCorrect``) and the global BA replays its LM step from a graph
captured in the closure; ``--eager-loop`` runs them all eagerly, and so
does ``--dump``, which reads the refinement's inputs inside its stage.
"""

from __future__ import annotations

import argparse
import collections
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from cubemapslam_tpu_torch import geometry as G  # noqa: E402
from cubemapslam_tpu_torch import place as PL  # noqa: E402
from cubemapslam_tpu_torch import slam_map as SM  # noqa: E402
from cubemapslam_tpu_torch.camera import CubemapCamera  # noqa: E402
from cubemapslam_tpu_torch.config import SlamConfig  # noqa: E402
from cubemapslam_tpu_torch.runtime import loop_closing as LC  # noqa: E402
from cubemapslam_tpu_torch.runtime import synthetic as S  # noqa: E402
from cubemapslam_tpu_torch.runtime.system import (CubemapSLAM,  # noqa: E402
                                                  TrackState)
from cubemapslam_tpu_torch.solvers import horn_alignment  # noqa: E402

N_FRAMES = 170
SCENE = 6.0                  # the circle's diameter
ATE_FRAC = 0.05
CROSS_PASS_FRAMES = 80
# the inputs of optim/sim3_opt.py::optimize_sim3 after the camera, as a
# --dump records them for each refinement
SIM3_ARGS = ("s12", "R12", "t12", "p1", "p2", "uv1", "face1", "uv2", "face2",
             "inv_sigma2_1", "inv_sigma2_2", "valid")


def loop_cfg(**kw) -> SlamConfig:
    """``tests/test_loop_e2e.py::loop_cfg``."""
    return SlamConfig(cube_face_w=160, cube_face_h=160, n_features=600,
                      n_levels=3, max_keyframes=144, max_landmarks=16384,
                      min_init_keypoints=80, min_init_matches=60,
                      init_min_triangulated=40, init_good_ratio=0.75,
                      min_track_inliers=20, fps=5.0, **kw)


def ate_of(slam, centres_gt) -> float:
    """RMS distance of the live keyframes' centres to the ground truth
    after a Sim3 alignment."""
    a = slam.arena
    valid = a.kf_valid.cpu().numpy()
    fids = a.kf_frame_id.cpu().numpy()
    Rs, ts = a.kf_R.cpu().numpy(), a.kf_t.cpu().numpy()
    ks = np.nonzero(valid)[0]
    est = np.stack([-Rs[k].T @ ts[k] for k in ks])
    gt = np.stack([centres_gt[fids[k]] for k in ks])
    s, Ra, ta = horn_alignment(torch.as_tensor(gt, dtype=torch.float32),
                               torch.as_tensor(est, dtype=torch.float32))
    al = float(s) * (Ra.numpy() @ est.T).T + ta.numpy()
    return float(np.sqrt(np.mean(np.sum((al - gt) ** 2, axis=1))))


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_RENDERER = None


def _start_renderer(cfg, world) -> None:
    global _RENDERER
    torch.set_num_threads(1)
    _RENDERER = (S.Renderer(CubemapCamera.from_config(cfg, "cpu"), cfg,
                            target="cubemap"), world)


def _render(pose) -> np.ndarray:
    ren, world = _RENDERER
    return ren.render(*world, *pose)[0]


def render_frames(cfg, world, poses):
    """The float32 cubemap crosses of ``poses``, rendered on the host by a
    pool of worker processes (the renderer is numpy, about a second a
    frame)."""
    with ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_start_renderer, initargs=(cfg, world)) as pool:
        return list(pool.map(_render, poses, chunksize=4))


def record_scales(lc):
    """Keep, for each ComputeSim3 that reaches the refinement, the scale of
    the RANSAC Sim3 (as the widening receives it) and of the refined one,
    from ``LoopCloser.sim3_trace``, as device tensors read at the end."""
    recs, compute = [], lc._compute_sim3

    def compute_rec(*args):
        out = compute(*args)
        trace = lc.sim3_trace
        if "refined" in trace:
            recs.append({"ransac": trace["ransac"][0],
                         "refined": trace["refined"][0]})
        return out

    lc._compute_sim3 = compute_rec
    return recs


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def record_closures(slam):
    """Keep, for each closure attempt that reaches the refinement, three
    points of the arena: after ``loop.sim3`` (the refined s, R, t and the
    refinement's inputs, which ``optimize_sim3`` takes as they are), after
    ``loop.correct`` (with the pose graph's optimized scales) and after
    ``loop.gba``; each with the live keyframes' slots, frame ids and
    rotations, read to the host. Returns (the list of records, the list of
    the refinements' inputs). The loop closer then runs eagerly
    (``LoopCloser.graphs`` off; its graphs give the same bits): the
    records are read inside its stages."""
    lc = slam.loop_closer
    lc.graphs = False
    recs, sim3_in, pg_scales = [], [], []

    def live(point, scales=None, **extra):
        a = slam.arena
        ks = np.nonzero(_np(a.kf_valid))[0]
        fids = _np(a.kf_frame_id)
        recs.append(dict(point=point, at_frame=int(fids[live.k_cur]),
                         kf=ks.tolist(), frame=fids[ks].tolist(),
                         R=_np(a.kf_R)[ks].tolist(), **extra))
        if scales is not None:
            recs[-1]["scales"] = scales[ks].tolist()

    def refine_rec(inner, cam, *args, **kwargs):
        out = inner(cam, *args, **kwargs)
        sim3_in.append(dict({n: _np(v) for n, v in zip(SIM3_ARGS, args)},
                            **{f"out_{n}": _np(v) for n, v in
                               zip(("s", "R", "t", "inliers"), out[:4])}))
        return out

    def pose_graph_rec(inner, *args, **kwargs):
        out = inner(*args, **kwargs)
        pg_scales.append(_np(out[0]))
        return out

    def patched(fn, name, wrapper):
        """``fn`` with the loop module's function ``name`` seen through
        ``wrapper`` while it runs."""
        def call(*args, **kwargs):
            inner = getattr(LC, name)
            setattr(LC, name, lambda *a, **k: wrapper(inner, *a, **k))
            try:
                return fn(*args, **kwargs)
            finally:
                setattr(LC, name, inner)
        return call

    compute, correct, gba = lc._compute_sim3, lc._correct, lc._global_ba

    def compute_rec(system, k_cur, *args):
        live.k_cur, n_in = k_cur, len(sim3_in)
        out = patched(compute, "optimize_sim3", refine_rec)(system, k_cur,
                                                             *args)
        if len(sim3_in) > n_in:
            r = sim3_in[-1]
            live("sim3", refinement=len(sim3_in) - 1, found=out is not None,
                 refined=dict(s=r["out_s"].tolist(), R=r["out_R"].tolist(),
                              t=r["out_t"].tolist()))
        return out

    def correct_rec(system, *args):
        out = patched(correct, "optimize_essential_graph",
                      pose_graph_rec)(system, *args)
        live("correct", scales=pg_scales[-1])
        return out

    def gba_rec(system):
        out = gba(system)
        live("gba")
        return out

    lc._compute_sim3, lc._correct, lc._global_ba = (compute_rec, correct_rec,
                                                     gba_rec)
    return recs, sim3_in


def project_tracked_rotations(slam) -> None:
    """A diagnostic, off by default: each tracked frame's rotation, its
    velocity and its pose relative to its keyframe projected onto SO(3),
    as localization mode projects its predictions (``CubemapSLAM.
    _predicted_pose``), so no rotation of the SLAM path's motion chain
    leaves SO(3). The system itself keeps the JAX package's numerics."""
    k = slam.kernels
    inner = k.track_frame_full

    def projected(*args, **kwargs):
        out = inner(*args, **kwargs)
        R = G.so3_project(out.R)
        packed = out.packed.clone()
        packed[11:20] = R.reshape(-1)
        return out._replace(R=R, rel_R=G.so3_project(out.rel_R),
                            vel_R=G.so3_project(out.vel_R), packed=packed)

    k.track_frame_full = projected


def orthonormality_error(slam) -> float:
    """The largest |R^T R - I| over the returned rotations: how far the
    SLAM path's rotations left SO(3)."""
    return max((float(np.abs(R.T @ R - np.eye(3)).max())
                for _, R, _ in slam.trajectory), default=0.0)


def record_frame(dump, slam, cross, T) -> None:
    """One frame's state (TrackState value), returned 4x4 pose (NaN when
    none), the tracking extractor's keypoints of the frame (uv, level,
    descriptor words, valid) and the live keyframes and landmarks after
    it, appended to ``dump``'s lists."""
    kp = slam.extractor(cross, slam.as_mask(None))
    dump["state"].append(np.int64(slam.state.value))
    dump["pose"].append(np.full((4, 4), np.nan) if T is None else T)
    dump["kp_uv"].append(kp.uv.cpu().numpy())
    dump["kp_level"].append(kp.level.cpu().numpy())
    dump["kp_desc"].append(kp.desc.cpu().numpy())
    dump["kp_valid"].append(kp.valid.cpu().numpy())
    dump["n_kf"].append(np.int64(int(slam.arena.kf_valid.sum())))
    dump["n_lm"].append(np.int64(int(slam.arena.lm_valid.sum())))


def train_vocab(cfg, world, device, path) -> None:
    """The test's ``pretrained_vocab``: 12 frames of the circuit, their
    valid descriptors, k=8, depth 3, seed 1."""
    probe = CubemapSLAM(cfg, device=device)
    descs = []
    for cross in render_frames(cfg, world, S.loop_trajectory(
            12, radius=3.0, n_loops=1.0, facing="tangent")):
        kp = probe.extract(torch.as_tensor(cross, device=probe.device))
        d = torch.cat([kp.desc, kp.valid[:, None].long()], 1).cpu().numpy()
        descs.append(d[d[:, 8] > 0, :8].astype(np.uint32))
    PL.save_vocabulary(PL.train_vocabulary(np.concatenate(descs), k=8,
                                           depth=3, seed=1, device="cpu"),
                       str(path))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain versions")
    ap.add_argument("--seed", type=int, default=42,
                    help="the world's seed (the JAX test's rng fixture: 42)")
    ap.add_argument("--vocab-device", default=None,
                    help="where the vocabulary's training frames are "
                    "extracted ('cpu': the CPU run's vocabulary); the run's "
                    "device by default")
    ap.add_argument("--dump", default=None,
                    help="write each frame's state, returned pose and "
                    "keypoints to this .npz (one file a --draws entry, the "
                    "entry's name before the suffix), for "
                    "scripts/torch_e2e_divergence.py")
    ap.add_argument("--project-rotations", action="store_true",
                    help="a diagnostic: project each tracked frame's "
                    "rotations onto SO(3) (project_tracked_rotations)")
    ap.add_argument("--eager-loop", action="store_true",
                    help="close loops eagerly (LoopCloser.graphs off); by "
                    "default a closure replays its solves' iterations from "
                    "CUDA graphs")
    ap.add_argument("--draws", default="device",
                    help="where RANSAC draws its minimal sets, a comma list "
                    "run in turn over the same frames: 'device' (the "
                    "system's generator) or 'cpu' (a host generator, the "
                    "CPU run's sets)")
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        print("needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 1
    on_card = args.device is None or args.device.startswith("cuda")
    poses = S.loop_trajectory(N_FRAMES, radius=3.0, n_loops=1.25,
                              facing="tangent")
    centres = S.camera_centres(poses)
    cfg0 = loop_cfg()
    world = S.make_world(np.random.default_rng(args.seed), n=1500,
                         centers=centres,
                         fx=cfg0.cube_face_w / 2.0)
    out_dir = pathlib.Path(__file__).resolve().parents[1] / "build"
    out_dir.mkdir(exist_ok=True)
    voc = out_dir / "loop_e2e_vocab.npz"
    t0 = time.perf_counter()
    train_vocab(cfg0, world, args.vocab_device or args.device, voc)
    frames = render_frames(cfg0, world, poses)
    print(f"[e2e] vocabulary and {N_FRAMES} frames rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    ok = True
    for draws in args.draws.split(","):
        ok &= run_circuit(voc, frames, centres, args, draws, on_card)
    return 0 if ok else 1


def run_circuit(voc, frames, centres, args, draws, on_card) -> bool:
    """The circuit through a fresh ``CubemapSLAM``; RANSAC draws on the
    system's device (``draws="device"``) or from a host generator with the
    same seed (``"cpu"``: on the card, the minimal sets of a CPU run).
    Prints the summary; True when every check holds."""
    slam = CubemapSLAM(loop_cfg(vocab_path=str(voc)), device=args.device)
    if draws == "cpu":
        slam.generator = torch.Generator().manual_seed(0)
    elif draws != "device":
        raise ValueError(f"--draws takes device or cpu, got {draws!r}")
    if args.project_rotations:
        project_tracked_rotations(slam)
    slam.loop_closer.graphs = not args.eager_loop
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ate_pre, ate_pre_frame, walls, closed_at = None, None, [], []
    dump = collections.defaultdict(list)
    closures, sim3_in = record_closures(slam) if args.dump else ([], [])
    ate_at_close, scales = [], record_scales(slam.loop_closer)
    for k, img in enumerate(frames):
        cross = torch.as_tensor(img, device=slam.device)
        sync()
        t1 = time.perf_counter()
        T = slam.track_cubemap(cross, k * 0.1)
        sync()
        walls.append((time.perf_counter() - t1) * 1e3)
        if args.dump:
            record_frame(dump, slam, cross, T)
        row = slam.metrics[-1] if slam.metrics else {}
        if row.get("loop_closed"):
            closed_at.append(k)
            ate_at_close.append(ate_of(slam, centres))
        if row.get("keyframe"):
            loop = {key: round(v, 3) for key, v in row.items()
                    if key.startswith("loop_")}
            print(f"[e2e] frame {k}: keyframe, {slam.n_kf} created, "
                  f"{int(slam.arena.kf_valid.sum())} live; host reads "
                  f"{row.get('host_reads')}; {loop}; wall "
                  f"{walls[-1]:.3f} ms", flush=True)
        if (slam.n_loops_closed == 0 and slam.n_kf >= 4 and k % 10 == 0
                and slam.state == TrackState.OK):
            ate_pre, ate_pre_frame = ate_of(slam, centres), k
    ate_post = ate_of(slam, centres)
    covis = SM.covisibility_matrix(slam.arena).cpu().numpy()
    fids = slam.arena.kf_frame_id.cpu().numpy()
    valid = slam.arena.kf_valid.cpu().numpy()
    cross = (np.abs(fids[:, None] - fids[None, :]) > CROSS_PASS_FRAMES) \
        & valid[:, None] & valid[None, :]
    cross_w = int(covis[cross].max()) if cross.any() else 0
    timings = {k: [round(x * 1e3, 3) for x in v]
               for k, v in slam.loop_closer.timings.items() if k != "detect"}
    det = slam.loop_closer.timings.get("detect", [])
    summary = dict(
        device=(torch.cuda.get_device_name(0) if on_card else "cpu"),
        seed=args.seed, draws=draws, loop_graphs=slam.loop_closer.graphs,
        project_rotations=args.project_rotations,
        frames=N_FRAMES, tracked=slam.tracked_frames,
        state=slam.state.name, keyframes=slam.n_kf,
        live_keyframes=int(valid.sum()), loops_closed=slam.n_loops_closed,
        closed_at_frames=closed_at, ate_pre=ate_pre,
        ate_pre_frame=ate_pre_frame, ate_at_close=ate_at_close,
        ate_post=ate_post,
        ate_bound=ATE_FRAC * SCENE, cross_pass_covis=cross_w,
        closure_stage_ms=timings,
        closure_scales=[{key: float(v) for key, v in rec.items()}
                        for rec in scales if "refined" in rec],
        detect_ms_median=(float(np.median(det)) * 1e3 if det else None),
        frame_wall_ms_median=float(np.median(walls)),
        rotation_orthonormality_error=orthonormality_error(slam))
    print(json.dumps(summary))
    if args.dump:
        path = pathlib.Path(args.dump)
        path = path.with_name(f"{path.stem}_{draws}{path.suffix}")
        refinements = {f"sim3_{i}_{name}": v for i, rec in enumerate(sim3_in)
                       for name, v in rec.items()}
        np.savez_compressed(path, summary=json.dumps(summary),
                            closures=json.dumps(closures), **refinements,
                            **{k: np.stack(v) for k, v in dump.items()})
        print(f"[e2e] per-frame record in {path}")
    if on_card:
        print(nvidia_smi_line())
    ok = (slam.n_loops_closed >= 1 and slam.state == TrackState.OK
          and ate_pre is not None and ate_post < ate_pre
          and ate_post < ATE_FRAC * SCENE)
    print(f"[e2e] {'PASS' if ok else 'FAIL'} ({draws} draws): loops "
          f"{slam.n_loops_closed}, ATE {ate_pre} -> {ate_post} (bound "
          f"{ATE_FRAC * SCENE}); cross-pass covisibility {cross_w} (the JAX "
          f"test asks >= 15)", flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
