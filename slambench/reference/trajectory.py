"""Poses and the map against the renderer's exact poses, in NumPy float64.

A monocular map has no scale of its own, so an estimated trajectory is
first brought onto the true one by a similarity: the rotation that best
carries the estimated camera orientations onto the true ones (the chordal
mean), then the scale and translation that best fit the camera centres.
Orientations fix the rotation where the centres cannot, on a path that is
nearly a straight line.
"""

from __future__ import annotations

import numpy as np


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centres of world->camera poses (n, 3, 3), (n, 3)."""
    return -np.einsum("nji,nj->ni", R, t)


def similarity(R_est, c_est, R_gt, c_gt):
    """(s, R, t) with x_true = s R x_est + t: R the rotation nearest to the
    sum of R_gt^T R_est (a world->camera pair R_gt = R_est R^T), then s and
    t minimising |c_gt - (s R c_est + t)|^2."""
    U, _, Vt = np.linalg.svd(np.einsum("nji,njk->ik", R_gt, R_est))
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ S @ Vt
    p = c_est @ R.T
    a, b = p - p.mean(0), c_gt - c_gt.mean(0)
    var = (a * a).sum()
    s = float((a * b).sum() / var) if var > 0 else 1.0
    return s, R, c_gt.mean(0) - s * p.mean(0)


def rotation_deg(R: np.ndarray) -> np.ndarray:
    """Angles (degrees) of rotation matrices (n, 3, 3)."""
    c = (np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def pose_errors(R_est, t_est, R_gt, t_gt) -> dict:
    """After the best similarity: the largest centre error as a percentage
    of the true centres' extent (``ate_max_pct``) and the largest rotation
    error in degrees (``rot_max_deg``). Needs 3 poses or more."""
    R_est, t_est, R_gt, t_gt = (np.asarray(x, np.float64)
                                for x in (R_est, t_est, R_gt, t_gt))
    ce, cg = centres(R_est, t_est), centres(R_gt, t_gt)
    s, Ra, ta = similarity(R_est, ce, R_gt, cg)
    err = np.linalg.norm(s * ce @ Ra.T + ta - cg, axis=1)
    extent = float(np.linalg.norm(cg.max(0) - cg.min(0)))
    rot = rotation_deg(R_gt @ Ra @ np.transpose(R_est, (0, 2, 1)))
    return {"ate_max_pct": float(100.0 * err.max() / max(extent, 1e-9)),
            "rot_max_deg": float(rot.max())}


def reprojection_px(kf_R, kf_t, kf_valid, kf_rays, kf_level, kf_obs,
                    kf_kp_valid, lm_pos, lm_valid, focal: float,
                    scale_factor: float) -> np.ndarray:
    """For every observation of a live landmark by a live keyframe: the
    angle between the keyframe's keypoint ray and the landmark's direction
    from that keyframe, in face pixels at the keypoint's pyramid level."""
    ks = np.nonzero(kf_valid)[0]
    out = []
    for k in ks:
        lm = kf_obs[k]
        ok = (lm >= 0) & kf_kp_valid[k]
        ok[ok] &= lm_valid[lm[ok]]
        if not ok.any():
            continue
        Xc = lm_pos[lm[ok]] @ kf_R[k].T + kf_t[k]
        ray = kf_rays[k][ok]
        cross = np.linalg.norm(np.cross(Xc, ray), axis=1)
        ang = np.arctan2(cross, (Xc * ray).sum(1))
        out.append(ang * focal / scale_factor ** kf_level[k][ok])
    return np.concatenate(out) if out else np.zeros(0)
