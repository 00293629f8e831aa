"""What decides ``correct``: the numbers that hold a run's outputs against
the reference, each beside its limit.

``Outputs`` is what the harness takes from the program once the window has
closed: the poses it returned for the window's frames, every keypoint row
(all pyramid levels) of a few window frames sampled from the seed, and the
map. ``numbers`` reads
them against the reference (``extract``, ``trajectory``) and the frames as
the camera delivered them; with ``precision="control"`` the extract numbers
compare the reference computed a precision below the stated one in the
program's place instead."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from slambench.reference import camera as C
from slambench.reference import extract as X
from slambench.reference import trajectory as T


class Outputs(NamedTuple):
    """A run's outputs, on the host."""

    poses: List[Tuple[int, np.ndarray, np.ndarray]]  # (frame, R, t) tracked
    kps: List[Tuple[int, dict]]       # (frame, keypoint fields, every row)
    arena: Dict[str, np.ndarray]      # the map after the window
    frame_of: List[int]               # the traffic frame of each program id
    map_changed: Optional[int]        # structural map entries changed in
                                      # the window (localization mode)


def _extract_numbers(out: Outputs, frames, cam, fields, precision, device):
    p = X.plan(fields)
    wp = X.make_warp(cam, device)
    ops = [torch.as_tensor(A) for A in X.pyramid_operators(p)]
    w8 = torch.as_tensor(X.comparison_weights())
    worst: Dict[str, float] = {}
    for frame, got in out.kps:
        img = frames[frame].numpy()
        args = (img, wp, p, ops, fields["ini_th_fast"], fields["min_th_fast"],
                w8)
        ref = X.levels(*args)
        got = X.split(got, p)
        if precision == "control":
            got = [dict(uv=c.uv, valid=c.valid, bits=c.desc, angle=c.angle,
                        response=c.response if "response" in g else None)
                   for c, g in zip(X.levels(*args, "control"), got)]
        for key, v in X.compare(got, ref).items():     # the worst frame's
            worst[key] = max(worst.get(key, 0.0), v)
    return worst


def numbers(out: Outputs, traffic, fields: dict, precision: str = "reference",
            want=None, device="cpu") -> Dict[str, float]:
    """Every number this run can give, by name. ``want`` limits them to a
    workload's compared names; ``device`` is where the reference extracts."""
    cam = C.Camera.from_fields(fields)
    res: Dict[str, float] = {}
    if out.kps:
        res.update(_extract_numbers(out, traffic.frames, cam, fields,
                                    precision, device))
    if precision == "control":
        return res
    if len(out.poses) >= 3:
        gt = [traffic.poses[f] for f, _, _ in out.poses]
        res.update(T.pose_errors(np.stack([p[1] for p in out.poses]),
                                 np.stack([p[2] for p in out.poses]),
                                 np.stack([g[0] for g in gt]),
                                 np.stack([g[1] for g in gt])))
    a = out.arena
    live = np.nonzero(a["kf_valid"])[0]
    if len(live) >= 3:
        fr = [out.frame_of[int(a["kf_frame_id"][k])] for k in live]
        gt = [traffic.poses[f] for f in fr]
        e = T.pose_errors(a["kf_R"][live], a["kf_t"][live],
                          np.stack([g[0] for g in gt]),
                          np.stack([g[1] for g in gt]))
        res["kf_ate_max_pct"] = e["ate_max_pct"]
        px = T.reprojection_px(a["kf_R"], a["kf_t"], a["kf_valid"],
                               a["kf_rays"], a["kf_level"], a["kf_obs_lm"],
                               a["kf_kp_valid"], a["lm_pos"], a["lm_valid"],
                               cam.focal, fields["scale_factor"])
        if len(px):
            res["reproj_p90_px"] = float(np.quantile(px, 0.9))
    if out.map_changed is not None:
        res["map_changed"] = float(out.map_changed)
    if want is not None:
        res = {k: v for k, v in res.items() if k in want}
    return res


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every limited number present and
    at or under its limit."""
    rows = [(k, nums.get(k), lim) for k, lim in limits.items()]
    ok = all(v is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
