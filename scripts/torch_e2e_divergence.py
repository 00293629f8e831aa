"""Where two runs of the e2e circuit part: the port on the card against the
port on the CPU, frame by frame.

    python3 scripts/torch_loop_e2e.py --device cpu --dump build/e2e.npz
    python3 scripts/torch_loop_e2e.py --draws cpu --vocab-device cpu \\
        --dump build/e2e.npz                      # on a card
    python3 scripts/torch_e2e_divergence.py build/e2e_device.npz \\
        build/e2e_cpu.npz
    python3 scripts/torch_e2e_divergence.py --refinements build/e2e_cpu.npz

Both runs of ``torch_loop_e2e.py`` see the same rendered frames; with
``--draws cpu --vocab-device cpu`` the card also gets the CPU run's RANSAC
minimal sets and vocabulary, so what is left between the two runs is the
card's own arithmetic. For every frame this prints one JSON line: the
valid keypoints of each run's tracking extractor on that frame, the share
of the second run's that the first has at the same level within 0.01 px,
the share of those with the same 256-bit descriptor, each run's state,
live keyframes and landmarks, and, when both returned a pose, the rotation
between them (deg) and the distance of their camera centres, and each
run's rotation error to the truth (deg). A last line
sums it up: the extraction agreement over all frames, the first frame
whose pose gap passes 1e-5, 1e-3 and 1e-1, and the first frame where the
states differ. Before it, one line a run and closure point (after
``loop.sim3``, ``loop.correct`` and ``loop.gba`` of each closure attempt
that reached the refinement): the largest |R^T R - I| over the arena's
live keyframe rotations and over the refined Sim3's rotation, the refined
scale, the pose graph's scales' range, and the count of non-finite values
in each. ``--refinements DUMP`` instead runs each refinement a dump
recorded (the inputs of ``optimize_sim3`` as the closure gave them) again
through the port's ``optimize_sim3`` on the CPU and, where there is one,
on the card, and prints one JSON line a refinement and device beside the
recorded result: the refined scale, |R^T R - I| of the refined rotation,
whether s, R and t are finite, and the inlier count.
"""

from __future__ import annotations

import argparse
import json
import sys

import pathlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from cubemapslam_tpu_torch.runtime import synthetic as S  # noqa: E402

STATES = {0: "NO_IMAGES_YET", 1: "NOT_INITIALIZED", 2: "OK", 3: "LOST"}
GAPS = (1e-5, 1e-3, 1e-1)


def keypoint_agreement(a, b, k):
    """(valid in a, valid in b, share of b's valid keypoints that a has at
    the same level within 0.01 px, share of those for which one such
    keypoint of a has the same descriptor)."""
    va, vb = a["kp_valid"][k], b["kp_valid"][k]
    uva, uvb = a["kp_uv"][k][va], b["kp_uv"][k][vb]
    la, lb = a["kp_level"][k][va], b["kp_level"][k][vb]
    da, db = a["kp_desc"][k][va], b["kp_desc"][k][vb]
    if not len(uvb) or not len(uva):
        return int(va.sum()), int(vb.sum()), 0.0, 0.0
    near = (np.abs(uvb[:, None, :] - uva[None, :, :]).max(-1) < 0.01) \
        & (lb[:, None] == la[None, :])
    hit = near.any(1)
    same = (near & (db[:, None, :] == da[None, :, :]).all(-1)).any(1)
    return (int(va.sum()), int(vb.sum()), float(hit.mean()),
            float(same[hit].mean()) if hit.any() else 0.0)


def _nearest_rotation(R):
    """The rotation nearest ``R`` (float64, by SVD)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    return U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt


def pose_gap(Ta, Tb):
    """(rotation between the two poses in deg, distance of the camera
    centres), or None when either run returned no pose. The angle is taken
    between the rotations nearest the two, as 2 asin(|Qa - Qb|_F / 2^1.5),
    which is 0 for equal poses: the trace of Ra^T Rb would give two equal
    poses off SO(3) an angle of their own departure."""
    if np.isnan(Ta).any() or np.isnan(Tb).any():
        return None
    Ra, Rb = Ta[:3, :3], Tb[:3, :3]
    d = np.linalg.norm(_nearest_rotation(Ra) - _nearest_rotation(Rb))
    ca, cb = -Ra.T @ Ta[:3, 3], -Rb.T @ Tb[:3, 3]
    return (float(np.degrees(2.0 * np.arcsin(min(d / 2 ** 1.5, 1.0)))),
            float(np.linalg.norm(ca - cb)))


def truth_rotations(n):
    """The circuit's world->camera rotations in the frame of its first
    camera (the map's frame: the first keyframe is frame 0), the layout of
    ``torch_loop_e2e.py``."""
    poses = S.loop_trajectory(n, radius=3.0, n_loops=1.25, facing="tangent")
    R0 = np.asarray(poses[0][0])
    return [np.asarray(R) @ R0.T for R, _ in poses]


def rot_err(T, R_true):
    """The angle (deg) between a returned pose's rotation and the truth's,
    or None when no pose was returned."""
    if np.isnan(T).any():
        return None
    c = np.clip((np.trace(T[:3, :3].T @ R_true) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def orthonormality_error(poses):
    """The largest |R^T R - I| over a run's returned rotations, and its
    frame."""
    errs = [(float(np.abs(T[:3, :3].T @ T[:3, :3] - np.eye(3)).max()), k)
            for k, T in enumerate(poses) if not np.isnan(T).any()]
    return max(errs) if errs else None


def _departure(Rs):
    """The largest |R^T R - I| over the finite rotations ``Rs`` (k, 3, 3),
    and the count of non-finite entries."""
    Rs = np.asarray(Rs, np.float64).reshape(-1, 3, 3)
    fin = np.isfinite(Rs).all(axis=(1, 2))
    err = np.abs(np.einsum("kji,kjl->kil", Rs[fin], Rs[fin]) - np.eye(3))
    return (float(err.max()) if err.size else 0.0,
            int((~np.isfinite(Rs)).sum()))


def closure_departures(run):
    """One dict a closure point of a dump: the stage, the frame of the
    closing keyframe, the live keyframes' largest |R^T R - I| and
    non-finite entries, and where recorded the refined Sim3's and the pose
    graph's scales."""
    out = []
    for rec in json.loads(str(run["closures"])) if "closures" in run else []:
        err, bad = _departure(rec["R"])
        row = dict(point=rec["point"], at_frame=rec["at_frame"],
                   live=len(rec["kf"]), kf_R_orth_max=err, kf_R_nonfinite=bad)
        if "refined" in rec:
            r = rec["refined"]
            err_r, bad_r = _departure(r["R"])
            row.update(found=rec["found"], refined_s=r["s"],
                       refined_R_orth=err_r,
                       refined_nonfinite=bad_r + int(not np.isfinite(r["s"]))
                       + int((~np.isfinite(r["t"])).sum()))
        if "scales" in rec:
            sc = np.asarray(rec["scales"], np.float64)
            row.update(scales_min=float(np.nanmin(sc)),
                       scales_max=float(np.nanmax(sc)),
                       scales_nonfinite=int((~np.isfinite(sc)).sum()))
        out.append(row)
    return out


def refinements(path) -> int:
    """Each recorded refinement of a dump through the port's
    ``optimize_sim3`` again, on the CPU and on the card, beside the
    recorded result; one JSON line each."""
    import torch
    from torch_loop_e2e import SIM3_ARGS, loop_cfg
    from cubemapslam_tpu_torch.camera import CubemapCamera
    from cubemapslam_tpu_torch.optim.sim3_opt import optimize_sim3
    run = np.load(path)
    n = len({k.split("_")[1] for k in run.files if k.startswith("sim3_")})
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])

    def row(s, R, t, inl):
        s, R, t = (np.asarray(x, np.float64) for x in (s, R, t))
        return dict(s=float(s), R_orth=_departure(R)[0],
                    finite=bool(np.isfinite(s).all() and np.isfinite(R).all()
                                and np.isfinite(t).all()),
                    inliers=int(np.asarray(inl).sum()))

    for i in range(n):
        rec = {k: run[f"sim3_{i}_{k}"] for k in SIM3_ARGS}
        out = dict(refinement=i, recorded=row(
            *(run[f"sim3_{i}_out_{k}"] for k in ("s", "R", "t", "inliers"))),
            matches=int(rec["valid"].sum()))
        for dev in devices:
            cam = CubemapCamera.from_config(loop_cfg(), dev)
            res = optimize_sim3(cam, *(torch.as_tensor(rec[k], device=dev)
                                       for k in SIM3_ARGS), th2=10.0,
                                fix_scale=False)
            out[dev] = row(*(x.cpu().numpy() for x in res[:4]))
        print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("first", help="a --dump file of torch_loop_e2e.py")
    ap.add_argument("second", nargs="?",
                    help="another, over the same frames")
    ap.add_argument("--refinements", action="store_true",
                    help="run the first dump's refinements again instead")
    args = ap.parse_args()
    if args.refinements:
        return refinements(args.first)
    a, b = np.load(args.first), np.load(args.second)
    n = min(len(a["state"]), len(b["state"]))
    first_gap = {g: None for g in GAPS}
    first_state, hits, sames = None, [], []
    truth = truth_rotations(int(json.loads(str(a["summary"]))["frames"]))
    errs = ([], [])
    departures = [closure_departures(x) for x in (a, b)]
    for run, rows in zip((args.first, args.second), departures):
        for row in rows:
            print(json.dumps(dict(run=run, **row)))
    for k in range(n):
        na, nb, hit, same = keypoint_agreement(a, b, k)
        hits.append(hit)
        sames.append(same)
        sa, sb = STATES[int(a["state"][k])], STATES[int(b["state"][k])]
        gap = pose_gap(a["pose"][k], b["pose"][k])
        err = [rot_err(x["pose"][k], truth[k]) for x in (a, b)]
        for e, acc in zip(err, errs):
            if e is not None:
                acc.append(e)
        if sa != sb and first_state is None:
            first_state = k
        for g in GAPS:
            if first_gap[g] is None and gap is not None \
                    and max(gap) > g:
                first_gap[g] = k
        print(json.dumps(dict(
            frame=k, valid=[na, nb], kp_found=round(hit, 6),
            kp_same_desc=round(same, 6), state=[sa, sb],
            keyframes=[int(a["n_kf"][k]), int(b["n_kf"][k])],
            landmarks=[int(a["n_lm"][k]), int(b["n_lm"][k])],
            rot_deg=None if gap is None else gap[0],
            centre_gap=None if gap is None else gap[1],
            rot_err_to_truth_deg=err)))
    print(json.dumps(dict(
        frames=n, kp_found_min=min(hits), kp_found_median=float(
            np.median(hits)), kp_same_desc_min=min(sames),
        first_frame_pose_gap_above={str(g): f for g, f in first_gap.items()},
        first_frame_states_differ=first_state,
        rot_err_to_truth_deg_median=[float(np.median(e)) if e else None
                                     for e in errs],
        rot_err_to_truth_deg_max=[max(e) if e else None for e in errs],
        orthonormality_error_max=[orthonormality_error(x["pose"])
                                  for x in (a, b)],
        closure_kf_R_orth_max=[
            {pt: max([r["kf_R_orth_max"] for r in rows if r["point"] == pt],
                     default=None) for pt in ("sim3", "correct", "gba")}
            for rows in departures],
        summaries=[json.loads(str(a["summary"])),
                   json.loads(str(b["summary"]))])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
