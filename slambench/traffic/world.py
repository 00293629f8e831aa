"""The billboard world, its trajectories and its renderers.

``make_world``, ``forward_trajectory``, ``loop_trajectory`` and
``HostRenderer`` are a frozen copy of the port's
``cubemapslam_tpu_torch/runtime/synthetic.py`` (itself a copy of the JAX
package's ``synth.py``): the same draws from the same generator, so one
seed gives one world. ``render_frames`` is the same ray-traced compositing
batched on the card: each billboard is drawn over a square window around
its projected centre, and a pixel keeps the brightest billboard sample, the
background included (``max`` does not depend on the order, so scatter-amax
over all windows of all frames at once gives what the host loop gives).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slambench.reference import camera as C

PATCH = 14          # texture patch side (texels)
BACKGROUND = 20.0   # grey level where no billboard is drawn


def make_world(rng: np.random.Generator, n: int = 500, r_lo: float = 2.5,
               r_hi: float = 6.0, centers: Optional[np.ndarray] = None,
               fx: float = 80.0) -> Tuple[np.ndarray, Dict]:
    """Random textured billboards on shells around the trajectory: (n, 3)
    centres and the textures, normals, tangent frames and world sizes.
    ``fx`` is the face focal length the billboards are sized for."""
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


def _yaw(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                    np.float32)


def forward_trajectory(n_frames: int, step: float = 0.12,
                       yaw_rate: float = 0.004
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Forward and slightly lateral motion with a small yaw, as
    world->camera (R, t) poses."""
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
    revolutions, as world->camera (R, t) poses; ``facing="tangent"`` points
    the optical axis along the direction of travel."""
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


def to_u8(img: np.ndarray) -> np.ndarray:
    """A rendered float frame as the uint8 image a camera delivers."""
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


class HostRenderer:
    """The frozen host renderer: one billboard at a time, in numpy."""

    def __init__(self, cam: C.Camera):
        self.cam = cam
        self.H, self.W = cam.fisheye_h, cam.fisheye_w
        uu, vv = np.meshgrid(np.arange(self.W, dtype=np.float32),
                             np.arange(self.H, dtype=np.float32))
        uv = torch.stack([torch.as_tensor(uu), torch.as_tensor(vv)], dim=-1)
        self.rays_img = C.img_to_ray(cam, uv).numpy()
        self.fx = cam.fisheye_px_per_rad

    def _project(self, pc: np.ndarray):
        d = np.linalg.norm(pc, axis=-1)
        vis = pc[:, 2] / np.maximum(d, 1e-12) >= np.float32(self.cam.cos_fov)
        uv = C.ray_to_img(self.cam, torch.as_tensor(pc)).numpy()
        vis &= ((uv[:, 0] >= 0) & (uv[:, 0] < self.W)
                & (uv[:, 1] >= 0) & (uv[:, 1] < self.H))
        return uv, vis

    def render(self, pts: np.ndarray, patches: Dict, R: np.ndarray,
               t: np.ndarray) -> np.ndarray:
        """One (H, W) float32 frame at the world->camera pose (R, t)."""
        img = np.full((self.H, self.W), BACKGROUND, np.float32)
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
            img[y0:y1, x0:x1] = np.where(inside, np.maximum(region, val),
                                         region)
        return img


# window sides are padded up to one of these, so that one batch holds
# windows of like size
_SIDES = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
# window pixels evaluated in one batch
_BATCH_PIXELS = 1 << 23


def render_frames(cam: C.Camera, world, poses, device,
                  frames_per_batch: int = 32) -> torch.Tensor:
    """Every pose's frame as (n, H, W) uint8 on the host, rendered on
    ``device`` in float32 (``HostRenderer.render`` followed by ``to_u8``)."""
    pts_np, patches = world
    f32 = dict(dtype=torch.float32, device=device)
    H, W = cam.fisheye_h, cam.fisheye_w
    uu, vv = torch.meshgrid(torch.arange(W, **f32), torch.arange(H, **f32),
                            indexing="xy")
    rays_img = C.img_to_ray(cam, torch.stack([uu, vv], dim=-1))
    rays_flat = rays_img.reshape(-1, 3)
    pts = torch.as_tensor(pts_np, **f32)
    tex = torch.as_tensor(np.ascontiguousarray(patches["tex"]), **f32)
    tex_flat = tex.reshape(len(pts_np), -1)
    nrm, e1, e2 = (torch.as_tensor(patches[k], **f32)
                   for k in ("n", "e1", "e2"))
    sizes = torch.as_tensor(patches["size"], **f32)
    fx = torch.tensor(cam.fisheye_px_per_rad, **f32)
    Rs = torch.as_tensor(np.stack([p[0] for p in poses]), **f32)
    ts = torch.as_tensor(np.stack([p[1] for p in poses]), **f32)
    out = torch.empty((len(poses), H, W), dtype=torch.uint8)
    for f0 in range(0, len(poses), frames_per_batch):
        R, t = Rs[f0:f0 + frames_per_batch], ts[f0:f0 + frames_per_batch]
        nf = R.shape[0]
        img = torch.full((nf * H * W,), BACKGROUND, **f32)
        pc = torch.einsum("fij,nj->fni", R, pts) + t[:, None, :]
        d = torch.linalg.norm(pc, dim=-1)
        vis = pc[..., 2] / d.clamp(min=1e-12) >= np.float32(cam.cos_fov)
        uv = C.ray_to_img(cam, pc)
        vis &= ((uv[..., 0] >= 0) & (uv[..., 0] < W) & (uv[..., 1] >= 0)
                & (uv[..., 1] < H))
        half = torch.ceil(0.75 * sizes / d * fx).to(torch.int64) + 2
        u0 = torch.round(uv[..., 0]).to(torch.int64)
        v0 = torch.round(uv[..., 1]).to(torch.int64)
        vis &= ((u0 - half >= 0) & (v0 - half >= 0) & (u0 + half + 1 <= W)
                & (v0 + half + 1 <= H))
        fi, bi = torch.nonzero(vis, as_tuple=True)
        side = 2 * half[fi, bi] + 1
        bucket = torch.bucketize(side, torch.tensor(_SIDES, device=device))
        for b in torch.unique(bucket).tolist():
            S = _SIDES[b]
            sel = torch.nonzero(bucket == b, as_tuple=True)[0]
            step = max(1, _BATCH_PIXELS // (S * S))
            for s0 in range(0, len(sel), step):
                j = sel[s0:s0 + step]
                _draw(img, fi[j], bi[j], half[fi[j], bi[j]], u0[fi[j], bi[j]],
                      v0[fi[j], bi[j]], pc[fi[j], bi[j]], R[fi[j]], S,
                      rays_flat, nrm, e1, e2, sizes, tex_flat, H, W)
        out[f0:f0 + nf] = torch.clamp(torch.round(img), 0, 255).to(
            torch.uint8).reshape(nf, H, W).cpu()
    return out


def _draw(img, fi, bi, half, u0, v0, pc, R, S, rays_flat, nrm, e1, e2,
          sizes, tex_flat, H, W):
    """Composite the windows of billboards ``bi`` in frames ``fi`` (each
    window at most S px a side) into the flat frame stack ``img``."""
    dev = img.device
    a = torch.arange(S, device=dev)
    side = 2 * half + 1
    x = u0[:, None] - half[:, None] + a                   # (m, S)
    y = v0[:, None] - half[:, None] + a
    inwin = (a < side[:, None])
    ok2 = inwin[:, None, :] & inwin[:, :, None]           # (m, S, S) [y, x]
    xc = x.clamp(0, W - 1)
    yc = y.clamp(0, H - 1)
    pix = yc[:, :, None] * W + xc[:, None, :]              # (m, S, S)
    rays = rays_flat[pix]                                  # (m, S, S, 3)
    n_c = torch.einsum("mij,mj->mi", R, nrm[bi])
    e1_c = torch.einsum("mij,mj->mi", R, e1[bi])
    e2_c = torch.einsum("mij,mj->mi", R, e2[bi])
    denom = (rays * n_c[:, None, None, :]).sum(-1)
    denom_safe = torch.where(denom.abs() > 1e-6, denom,
                             torch.full_like(denom, 1e-6))
    lam = (pc * n_c).sum(-1)[:, None, None] / denom_safe
    rel = rays * lam[..., None] - pc[:, None, None, :]
    sz = sizes[bi][:, None, None]
    tu = (rel * e1_c[:, None, None, :]).sum(-1) / sz + 0.5
    tv = (rel * e2_c[:, None, None, :]).sum(-1) / sz + 0.5
    inside = (ok2 & (lam > 0) & (denom > 1e-6) & (tu >= 0) & (tu < 1)
              & (tv >= 0) & (tv < 1))
    px = torch.clamp(tu * (PATCH - 1), 0, PATCH - 1.001)
    py = torch.clamp(tv * (PATCH - 1), 0, PATCH - 1.001)
    xi = px.to(torch.int64)
    yi = py.to(torch.int64)
    fxp = px - xi
    fyp = py - yi
    xn = torch.clamp(xi + 1, max=PATCH - 1)
    yn = torch.clamp(yi + 1, max=PATCH - 1)
    T = tex_flat[bi]                                       # (m, PATCH^2)
    flat = T.shape[1]

    def tx(yy, xx):
        return torch.gather(T, 1, (yy * PATCH + xx).reshape(len(bi), -1)
                            .clamp(0, flat - 1)).reshape(yy.shape)

    val = (tx(yi, xi) * (1 - fxp) * (1 - fyp) + tx(yi, xn) * fxp * (1 - fyp)
           + tx(yn, xi) * (1 - fxp) * fyp + tx(yn, xn) * fxp * fyp)
    dst = fi[:, None, None] * (H * W) + pix
    img.scatter_reduce_(0, dst[inside], val[inside], reduce="amax",
                        include_self=True)
