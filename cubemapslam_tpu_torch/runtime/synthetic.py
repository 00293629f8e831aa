"""Seeded synthetic inputs for driving the trackers without a dataset.

Used by ``chip_smoke.py`` and the tests:

* for ``FrameTracker``: a fisheye frame of textured squares on a mid-grey
  disc (a few thousand FAST corners at the Lafida working size), landmarks
  back-projected from a frame's keypoints at seeded depths and padded with
  random distractors, and start poses perturbed from the identity;
* for ``MapTracker``: the port's own copy of the JAX package's billboard
  world, its fisheye renderer and ``forward_trajectory``
  (``cubemapslam_tpu/synth.py:36-222``), and ``build_map``, which fills a
  tracker's arena with keyframes rendered along a trajectory.
"""

from __future__ import annotations

import math
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.geometry import se3_apply, so3_exp
from cubemapslam_tpu_torch.matching import search_by_projection

LINK_RADIUS_PX = 15.0       # build_map's projection-search radius

def synthetic_fisheye(cfg: SlamConfig, seed: int) -> np.ndarray:
    """Textured squares on a mid-grey fisheye disc, as (H, W) uint8."""
    rng = np.random.default_rng(seed)
    H, W = cfg.fisheye_height, cfg.fisheye_width
    yy, xx = np.mgrid[0:H, 0:W]
    disc = np.hypot(xx - cfg.u0, yy - cfg.v0) < 0.8 * max(H, W) / 2
    img = np.where(disc, 128.0, 0.0).astype(np.float32)
    n = int(6e-3 * disc.sum())
    cy, cx = np.nonzero(disc)
    pick = rng.integers(0, len(cy), n)
    sides = rng.integers(3, 9, n)
    vals = rng.uniform(0, 255, n)
    for y, x, s, v in zip(cy[pick], cx[pick], sides, vals):
        img[y:y + s, x:x + s] = v
    img[~disc] = 0.0
    return img.astype(np.uint8)


def landmarks_from_keypoints(kp: Keypoints, n_total: int,
                             rng: np.random.Generator, n_levels: int = 8):
    """Back-project the valid keypoints at seeded depths 3-8 (identity
    pose), padded with random distractors to ``n_total``. Returns
    (lm_pos, lm_desc, lm_level, lm_valid) on the keypoints' device."""
    dev = kp.uv.device
    idx = np.nonzero(kp.valid.cpu().numpy())[0][:n_total]
    depth = rng.uniform(3.0, 8.0, len(idx)).astype(np.float32)
    pos = kp.rays.cpu().numpy()[idx] * depth[:, None]
    n_d = n_total - len(idx)
    d = rng.normal(size=(n_d, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = np.concatenate([pos, d * rng.uniform(3, 8, (n_d, 1))])
    desc = np.concatenate([kp.desc.cpu().numpy()[idx],
                           rng.integers(0, 2 ** 32, (n_d, 8))])
    level = np.concatenate([kp.level.cpu().numpy()[idx],
                            rng.integers(0, n_levels, n_d)])
    return (torch.as_tensor(pos.astype(np.float32), device=dev),
            torch.as_tensor(desc.astype(np.int64), device=dev),
            torch.as_tensor(level.astype(np.int64), device=dev),
            torch.ones(n_total, dtype=torch.bool, device=dev))


def perturbed_pose(rng: np.random.Generator, device, deg: float = 1.0,
                   metres: float = 0.02
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A start pose ``deg`` degrees and ``metres`` away from the identity,
    about a seeded axis and along a seeded direction."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    tdir = rng.normal(size=3)
    tdir /= np.linalg.norm(tdir)
    R0 = so3_exp(torch.tensor(axis * math.radians(deg), dtype=torch.float32,
                              device=device))
    t0 = torch.tensor(tdir * metres, dtype=torch.float32, device=device)
    return R0, t0


# ---------------------------------------------------------------------------
# Billboard world, fisheye renderer and trajectory (cubemapslam_tpu/synth.py)
# ---------------------------------------------------------------------------

PATCH = 14  # texture patch side length (pixels of the texture map)


def make_world(rng: np.random.Generator, n: int = 500,
               r_lo: float = 2.5, r_hi: float = 6.0,
               centers: Optional[np.ndarray] = None,
               fx: float = 80.0) -> Tuple[np.ndarray, Dict]:
    """Random textured billboards on shells around the trajectory
    (``synth.py:36-96``, the same draws from ``rng``): (n, 3) centres and
    the textures, normals, tangent frames and world sizes. ``fx`` is the
    cube-face focal length the billboards are sized for (about 2.5 patch
    widths at their initial distance)."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = rng.uniform(r_lo, r_hi, (n, 1))
    pts = (d * r).astype(np.float32)
    if centers is not None:
        anchor = np.asarray(centers)[rng.integers(0, len(centers), n)]
        pts = (pts + anchor).astype(np.float32)
    # blocky 3 px cells for stable corners, under a shading ramp in a random
    # direction that pins the intensity centroid (and so the IC angle)
    cells = rng.uniform(15, 240, (n, 5, 5)).astype(np.float32)
    patches = np.repeat(np.repeat(cells, 3, axis=1), 3, axis=2)
    patches = patches[:, :PATCH, :PATCH]
    gdir = rng.uniform(0.0, 2.0 * np.pi, n).astype(np.float32)
    grid = (np.arange(PATCH, dtype=np.float32) / (PATCH - 1)) - 0.5
    ramp = (1.0 + 0.9 * (np.cos(gdir)[:, None, None] * grid[None, None, :]
                         + np.sin(gdir)[:, None, None]
                         * grid[None, :, None]))
    patches = np.clip(patches * ramp, 0.0, 255.0)
    nrm = d.astype(np.float32)
    a = np.where(np.abs(nrm[:, 2:3]) < 0.9, np.array([[0, 0, 1.0]]),
                 np.array([[1.0, 0, 0]])).astype(np.float32)
    e1 = np.cross(nrm, a)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(nrm, e1)
    size = (2.5 * PATCH / fx) * r[:, 0]
    return pts, {"tex": patches, "n": nrm, "e1": e1.astype(np.float32),
                 "e2": e2.astype(np.float32),
                 "size": size.astype(np.float32)}


class Renderer:
    """Ray-traces a billboard world into raw fisheye frames or, with
    ``target="cubemap"``, into cubemap crosses (``synth.Renderer``,
    ``synth.py:99-196``), on the host, with the port's camera model.
    ``render`` also returns each pixel's distance to the billboard drawn
    there (0 on the background), a synthetic-data helper that ``build_map``
    back-projects with."""

    def __init__(self, cam: CubemapCamera, cfg: SlamConfig,
                 target: str = "fisheye"):
        self.cam = CubemapCamera(**{
            f.name: getattr(cam, f.name).cpu()
            for f in dataclasses.fields(CubemapCamera)})
        self.target = target
        if target == "cubemap":
            H, W = cfg.cube_h, cfg.cube_w
        elif target == "fisheye":
            H, W = cfg.fisheye_height, cfg.fisheye_width
        else:
            raise ValueError(target)
        uu, vv = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        uv = torch.stack([torch.as_tensor(uu), torch.as_tensor(vv)], dim=-1)
        if target == "cubemap":
            self.rays_img = C.cubemap_to_ray(self.cam, uv)[0].numpy()
            # the faces' pinhole focal length
            self.fx = float(self.cam.fxycxy[0])
        else:
            self.rays_img = C.img_to_ray(self.cam, uv).numpy()
            # first-order px/rad of the fisheye centre
            poly = self.cam.poly.numpy()
            self.fx = float(abs(poly[0])) if len(poly) else 250.0
        self.H, self.W = H, W
        self.bg = 20.0

    def _project(self, pc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Camera points -> (uv, visible) in the target image."""
        pct = torch.as_tensor(pc, dtype=torch.float32)
        if self.target == "cubemap":
            uv, face = C.ray_to_cubemap(self.cam, pct)
            return uv.numpy(), face.numpy() >= 0
        d = np.linalg.norm(pc, axis=-1)
        cosang = pc[:, 2] / np.maximum(d, 1e-12)
        vis = cosang >= float(self.cam.cos_fov_th)
        uv = C.ray_to_img(self.cam, pct).numpy()
        vis &= ((uv[:, 0] >= 0) & (uv[:, 0] < self.W)
                & (uv[:, 1] >= 0) & (uv[:, 1] < self.H))
        return uv, vis

    def render(self, pts: np.ndarray, patches: Dict, R: np.ndarray,
               t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One (H, W) float32 frame at the world->camera pose (R, t), and
        the per-pixel distance of what was drawn."""
        img = np.full((self.H, self.W), self.bg, np.float32)
        depth = np.zeros((self.H, self.W), np.float32)
        pc = (R @ pts.T).T + t
        uv, vis = self._project(pc)
        tex = patches["tex"]
        n_c = (R @ patches["n"].T).T
        e1_c = (R @ patches["e1"].T).T
        e2_c = (R @ patches["e2"].T).T
        sizes = patches["size"]
        for i in np.where(vis)[0]:
            d_i = float(np.linalg.norm(pc[i]))
            half_px = int(np.ceil(0.75 * sizes[i] / d_i * self.fx)) + 2
            u0, v0 = int(round(uv[i, 0])), int(round(uv[i, 1]))
            x0, x1 = u0 - half_px, u0 + half_px + 1
            y0, y1 = v0 - half_px, v0 + half_px + 1
            if x0 < 0 or y0 < 0 or x1 > self.W or y1 > self.H:
                continue
            rays = self.rays_img[y0:y1, x0:x1]
            denom = rays @ n_c[i]
            denom_safe = np.where(np.abs(denom) > 1e-6, denom, 1e-6)
            lam = (pc[i] @ n_c[i]) / denom_safe
            X = rays * lam[..., None]
            rel = X - pc[i]
            tu = (rel @ e1_c[i]) / sizes[i] + 0.5
            tv = (rel @ e2_c[i]) / sizes[i] + 0.5
            inside = ((lam > 0) & (denom > 1e-6)
                      & (tu >= 0) & (tu < 1) & (tv >= 0) & (tv < 1))
            px = np.clip(tu * (PATCH - 1), 0, PATCH - 1.001)
            py = np.clip(tv * (PATCH - 1), 0, PATCH - 1.001)
            xi = px.astype(np.int32)
            yi = py.astype(np.int32)
            fxp = px - xi
            fyp = py - yi
            T = tex[i]
            val = (T[yi, xi] * (1 - fxp) * (1 - fyp)
                   + T[yi, np.minimum(xi + 1, PATCH - 1)] * fxp * (1 - fyp)
                   + T[np.minimum(yi + 1, PATCH - 1), xi] * (1 - fxp) * fyp
                   + T[np.minimum(yi + 1, PATCH - 1),
                       np.minimum(xi + 1, PATCH - 1)] * fxp * fyp)
            region = img[y0:y1, x0:x1]
            drawn = inside & (val >= region)
            img[y0:y1, x0:x1] = np.where(inside, np.maximum(region, val),
                                         region)
            depth[y0:y1, x0:x1] = np.where(
                drawn, np.linalg.norm(X, axis=-1), depth[y0:y1, x0:x1])
        return img, depth


def to_u8(img: np.ndarray) -> np.ndarray:
    """A rendered float frame as the uint8 image a camera delivers."""
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _yaw(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                    np.float32)


def forward_trajectory(n_frames: int, step: float = 0.12,
                       yaw_rate: float = 0.004
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Forward and slightly lateral motion with a small yaw, as
    world->camera (R, t) poses (``synth.py:213-222``)."""
    poses = []
    for k in range(n_frames):
        R = _yaw(yaw_rate * k)
        t_wc = np.array([step * k, 0.0, step * 0.5 * k], np.float32)
        poses.append((R, -R @ t_wc.astype(np.float32)))
    return poses


def loop_trajectory(n_frames: int, radius: float = 3.0,
                    n_loops: float = 1.15, bob: float = 0.0,
                    facing: str = "center"
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A closed circuit of ``radius`` in the x-z plane over ``n_loops``
    revolutions (above 1 it revisits the start), as world->camera (R, t)
    poses (``synth.py:225-249``). ``facing="center"`` keeps the optical axis
    toward the circle's far side; ``"tangent"`` points it along the
    direction of travel."""
    poses = []
    for k in range(n_frames):
        phi = 2.0 * np.pi * n_loops * k / n_frames
        t_wc = np.array([radius * np.sin(phi), bob * np.sin(3.0 * phi),
                         radius * (1.0 - np.cos(phi))], np.float32)
        R = _yaw(phi if facing == "center" else phi - 0.5 * np.pi)
        poses.append((R, -R @ t_wc.astype(np.float32)))
    return poses


def camera_centres(poses) -> np.ndarray:
    """(n, 3) world positions of the cameras of (R, t) poses."""
    return np.stack([-R.T @ t for R, t in poses])


# ---------------------------------------------------------------------------
# A map with a constructed loop drift (the state CorrectLoop faces)
# ---------------------------------------------------------------------------

LOOP_SIM3_DRIFT = (1.06, (0.0, 0.03, 0.01), (0.15, -0.05, 0.1))
LOOP_KEYFRAMES = 14          # segment A 0-5, connectors 6-9, segment B 10-13


def loop_gt_pose(j: int) -> Tuple[np.ndarray, np.ndarray]:
    """World->camera pose j of the revisited path segment
    (``tests/test_loop.py:77-82``)."""
    R = so3_exp(torch.tensor([0.0, 0.06 * j, 0.0])).numpy()
    t_wc = np.array([0.1 * j, 0, 0.05 * j], np.float32)
    return R.astype(np.float32), (-R @ t_wc).astype(np.float32)


def build_drifted_loop_arena(cfg: SlamConfig, rng: np.random.Generator,
                             n_pts: int = 500, device="cpu"):
    """The port's copy of ``tests/test_loop.py:85-170``: segment A
    (keyframes 0-5) maps a shell of ``n_pts`` points at ground truth; after
    connector keyframes 6-9 (40 observations each, off to the side), segment
    B (10-13) revisits A's viewpoints, but its duplicate landmarks and poses
    sit in a Sim3-drifted frame D (x' = s R_d x + t_d). Projections stay
    exact: the stored pose of a segment-B keyframe is
    (R_gt R_dᵀ, s t_gt - R_gt R_dᵀ t_d). An arena of ``cfg``'s capacities
    on ``device``. Returns (arena, world points W, their (n_pts, 8) uint32
    descriptors, (s_d, R_d, t_d))."""
    from cubemapslam_tpu_torch import interop
    cam = CubemapCamera.from_config(cfg, "cpu")
    d = rng.normal(size=(n_pts, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    W = (d * rng.uniform(3, 7, (n_pts, 1))).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    s_d, r_d, t_d = LOOP_SIM3_DRIFT
    R_d = so3_exp(torch.tensor(r_d)).numpy()
    t_d = np.array(t_d, np.float32)

    K, N, L = cfg.max_keyframes, cfg.n_features, cfg.max_landmarks
    f = interop.arena_to_numpy(SM.make_arena(K, N, L, "cpu"))
    lm_of = {}
    for i in range(LOOP_KEYFRAMES):
        seg_b = i >= 10
        if 6 <= i <= 9:
            Rg, tg = loop_gt_pose(5)
            tg = tg + np.array([0, 0.3 * (i - 5), 0], np.float32)
        else:
            Rg, tg = loop_gt_pose(i - 10 if seg_b else i)
        pc = (Rg @ W.T).T + tg                      # the true camera points
        uv, face = (x.numpy() for x in C.ray_to_cubemap(
            cam, torch.as_tensor(pc, dtype=torch.float32)))
        rays = pc / np.linalg.norm(pc, axis=1, keepdims=True)
        vis = np.nonzero(face >= 0)[0]
        if 6 <= i <= 9:
            vis = vis[:40]
        vis = vis[:N]
        if seg_b:
            f["kf_R"][i] = Rg @ R_d.T
            f["kf_t"][i] = s_d * tg - Rg @ R_d.T @ t_d
        else:
            f["kf_R"][i], f["kf_t"][i] = Rg, tg
        n = len(vis)
        f["kf_uv"][i, :n] = uv[vis]
        f["kf_rays"][i, :n] = rays[vis]
        f["kf_face"][i, :n] = face[vis]
        f["kf_desc"][i, :n] = desc[vis]
        f["kf_kp_valid"][i, :n] = True
        f["kf_level"][i] = 0
        f["kf_angle"][i] = 0.0
        for j, p in enumerate(vis):
            key = (int(p), seg_b)
            if key not in lm_of:
                slot = lm_of[key] = len(lm_of)
                f["lm_pos"][slot] = (s_d * (R_d @ W[p]) + t_d) if seg_b \
                    else W[p]
                f["lm_valid"][slot] = True
                f["lm_desc"][slot] = desc[p]
                f["lm_first_kf"][slot] = i
            f["kf_obs_lm"][i, j] = lm_of[key]
        f["kf_valid"][i] = True
        f["kf_frame_id"][i] = i
    return (interop.arena_from_numpy(f, device), W, desc,
            (s_d, R_d, t_d))


# ---------------------------------------------------------------------------
# A map for MapTracker
# ---------------------------------------------------------------------------

class BuiltMap(NamedTuple):
    """What ``build_map`` made: the keyframes' frame indices (slot k holds
    frame ``frames[k]``), the live landmark count, and the per-keyframe
    counts of keypoints linked to existing landmarks and of new ones."""

    frames: Tuple[int, ...]
    n_landmarks: int
    linked: Tuple[int, ...]
    created: Tuple[int, ...]


def _depth_at(render: Renderer, depth: np.ndarray, rays: np.ndarray,
              ok: np.ndarray) -> np.ndarray:
    """Distance along each camera ray from the rendered depth, read at the
    nearest fisheye pixel, or at its nearest billboard pixel where that is
    background (a corner of a billboard's outline). Kept only where the
    billboard pixels of the 3x3 neighbourhood (at least 3) lie on one
    billboard, within 2%; 0 elsewhere."""
    uv = C.ray_to_img(render.cam, torch.as_tensor(rays)).numpy()
    u = np.round(uv[:, 0]).astype(np.int64)
    v = np.round(uv[:, 1]).astype(np.int64)
    ok = ok & (u >= 1) & (v >= 1) & (u < render.W - 1) & (v < render.H - 1)
    u, v = np.where(ok, u, 1), np.where(ok, v, 1)
    nb = np.stack([depth[v + dy, u + dx] for dy in (-1, 0, 1)
                   for dx in (-1, 0, 1)], axis=1)
    on = nb > 0
    lo = np.where(on, nb, np.inf).min(axis=1)
    hi = np.where(on, nb, 0.0).max(axis=1)
    one = (on.sum(axis=1) >= 3) & (hi <= 1.02 * lo)
    d = np.where(nb[:, 4] > 0, nb[:, 4], lo)
    return np.where(ok & one, d, 0.0).astype(np.float32)


def _drop_false_links(tracker, kp: Keypoints, assoc, R, t):
    """Unlink the keypoints whose landmark reprojects, at the keyframe's
    true pose, beyond the monocular chi2 gate: the angle between the
    keypoint's ray and the landmark's direction, in face pixels at the
    keypoint's level, squared against ``chi2_mono``."""
    arena, cfg = tracker.arena, tracker.cfg
    Xc = se3_apply(R, t, arena.lm_pos[assoc.clamp(min=0)])
    cos = (Xc / Xc.norm(dim=-1, keepdim=True).clamp(min=1e-12)
           * kp.rays).sum(dim=-1)
    sf = tracker.kernels.scale_factors[kp.level.clamp(0, cfg.n_levels - 1)]
    px = torch.acos(cos.clamp(-1.0, 1.0)) * tracker.cam.fxycxy[0] / sf
    return torch.where((assoc >= 0) & (px * px > cfg.chi2_mono),
                       SM.NO_LM, assoc)


def build_map(tracker, world, poses, n_keyframes: int,
              kf_stride: int = 1) -> BuiltMap:
    """Fill ``tracker.arena`` with ``n_keyframes`` keyframes rendered at
    ``poses[0], poses[kf_stride], ...`` and seed the tracker with the last
    of them as its last frame.

    Each keyframe is rendered, warped and extracted with the tracker's own
    stages. Its keypoints are linked first to existing landmarks, by the
    port's ``search_by_projection`` at the keyframe's pose (radius
    ``LINK_RADIUS_PX``, levels -1/+1 around each landmark's predicted
    level), keeping the links inside the monocular chi2 gate at that pose; the
    remaining valid keypoints with a rendered depth become new
    landmarks, back-projected at that depth. Every keyframe goes in through
    ``TrackingKernels.insert_keyframe``; the build ends with
    ``update_landmark_stats`` and the graph cache. ``world`` is
    ``make_world``'s (pts, patches). Deterministic for a given world."""
    pts, patches = world
    k_ops, arena, dev = tracker.kernels, tracker.arena, tracker.device
    cfg, N, L = tracker.cfg, arena.n_feat, arena.n_lm_cap
    render = Renderer(tracker.cam, cfg)
    n_lm = 0
    frames, linked, created = [], [], []
    for slot in range(n_keyframes):
        fi = slot * kf_stride
        R_np, t_np = poses[fi]
        img, depth = render.render(pts, patches, R_np, t_np)
        kp = tracker.extract(tracker.warp(torch.as_tensor(to_u8(img),
                                                          device=dev)))
        R = torch.as_tensor(R_np, dtype=torch.float32, device=dev)
        t = torch.as_tensor(t_np, dtype=torch.float32, device=dev)
        assoc = torch.full((N,), SM.NO_LM, dtype=torch.int64, device=dev)
        if n_lm:
            Xc = se3_apply(R, t, arena.lm_pos[:n_lm])
            lvl = SM.predict_scale(torch.linalg.norm(Xc, dim=-1),
                                   arena.lm_max_dist[:n_lm],
                                   k_ops.log_scale, cfg.n_levels)
            res = search_by_projection(
                Xc, arena.lm_desc[:n_lm], lvl, arena.lm_valid[:n_lm], kp,
                tracker.cam, k_ops.scale_factors, LINK_RADIUS_PX,
                level_lo_off=-1, level_hi_off=1, th=k_ops.th_high)
            ids = torch.arange(n_lm, device=dev)
            assoc = assoc.scatter_reduce(
                0, res.idx, torch.where(res.ok, ids, SM.NO_LM),
                reduce="amax", include_self=True)
            assoc = _drop_false_links(tracker, kp, assoc, R, t)
        free = (kp.valid & (assoc < 0)).cpu().numpy()
        dist = _depth_at(render, depth, kp.rays.cpu().numpy(), free)
        new = np.nonzero(dist > 0)[0][:L - n_lm]
        if len(new):
            rows = torch.as_tensor(new, device=dev)
            ids = torch.arange(n_lm, n_lm + len(new), device=dev)
            d = torch.as_tensor(dist[new], device=dev)
            Xc = kp.rays[rows] * d[:, None]
            arena.lm_pos[ids] = (Xc - t) @ R          # R^T (Xc - t)
            arena.lm_valid[ids] = True
            arena.lm_desc[ids] = kp.desc[rows]
            arena.lm_first_kf[ids] = slot
            arena.lm_birth[ids] = slot
            arena.lm_first_frame[ids] = fi
            assoc[rows] = ids
        linked.append(int((assoc >= 0).sum()) - len(new))
        created.append(len(new))
        n_lm += len(new)
        outlier = torch.zeros(N, dtype=torch.bool, device=dev)
        k_ops.insert_keyframe(arena, slot, kp, assoc, outlier, R, t, fi,
                              fi / cfg.fps)
        frames.append(fi)
    SM.update_landmark_stats(arena, k_ops.scale_factors)
    tracker.seed(arena, kp, assoc, outlier, R, t, ref_kf=n_keyframes - 1,
                 frame_id=frames[-1], timestamp=frames[-1] / cfg.fps)
    return BuiltMap(tuple(frames), n_lm, tuple(linked), tuple(created))


def arena_before_last_mapping(slam, world, poses):
    """Drive ``slam`` (a ``CubemapSLAM``) over fisheye frames rendered at
    ``poses`` from the first, and return what its last mapping step was
    given: (a copy of the arena on the CPU, the new keyframe's slot, the
    keyframe counter, the keyframe's frame id). For the mapping checks of
    the tests and ``chip_smoke.py``."""
    got = []
    step = slam._local_mapping

    def record(slot, *args):
        got.append((slam.arena.to("cpu"), slot, slam.n_kf,
                    slam.last_kf_frame_id))
        step(slot, *args)

    slam._local_mapping = record
    render = Renderer(slam.cam, slam.cfg)
    for k, (R, t) in enumerate(poses):
        slam.track_fisheye(to_u8(render.render(*world, R, t)[0]),
                           k / slam.cfg.fps)
    del slam._local_mapping
    return got[-1]
