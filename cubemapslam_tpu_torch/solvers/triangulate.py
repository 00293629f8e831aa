"""Two-ray linear triangulation, batched.

Counterpart of ``cubemapslam_tpu/solvers/triangulate.py:18``. The constraint
"P_i X is parallel to ray_i" is written as the cross-product rows
[ray]_x P_i, a (6,4) system A whose least-squares null vector is the
homogeneous point.

The JAX package takes that null vector from a batched SVD of A. On a CUDA
tensor ``torch.linalg.svd`` (and ``eigh``) reads an error flag back to the
host, which would make every mapping step wait for the card. Here the null
vector is the eigenvector of the smallest eigenvalue of the 4x4 normal
matrix AᵀA, found by cyclic Jacobi rotations in float64: a fixed count of
sweeps, no host read, and (in float64, even with the squared condition
number) closer to the exact null vector than a float32 SVD of A.

On CUDA tensors every form is one launch of ``csrc/triangulate.cu`` (one
thread a row of B pose pairs x N correspondences, the whole solve in
float64 registers), or it raises; ``TRIANGULATE.launches`` counts the
launches. On CPU tensors each takes its plain version.

- ``triangulate_rays``: one pair; on CPU tensors
  ``triangulate_rays_matmul``.
- ``triangulate_pairs``: B pairs over shared rays in one launch (the
  two-view reconstruction's 4 hypotheses); on CPU tensors
  ``triangulate_rays_matmul`` a pair.
- ``triangulate_gated``: the mapping step's candidates against its B
  neighbours in one launch, with the gates of
  ``MappingKernels.triangulate_with_neighbor`` in the kernel; on CPU
  tensors ``triangulate_gated_ordered``.
- ``triangulate_rays_matmul``: batched 4x4 products and ``null_vector4``,
  the CPU's path.
- ``triangulate_rays_ordered`` and ``triangulate_gated_ordered``: the
  kernel's arithmetic in plain PyTorch, in the kernel's order, on any
  device: the entries of A and M = AᵀA written out, each rotation updating
  rows p, q then columns p, q of M and columns p, q of V, the argmin and
  the division written out; the gates as elementwise float32 operations
  (no ``@``, ``einsum`` or ``linalg.norm``, which would round in another
  order). They hold the kernel bitwise on the card and that order against
  JAX on the CPU; nothing on the main path calls them while a card is
  present.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cubemapslam_tpu_torch._build import CudaKernel, require_cuda
from cubemapslam_tpu_torch.geometry import hat

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
JACOBI_SWEEPS = 6
W_FLOOR = 1e-12       # |w| below this divides by W_FLOOR
TRI_THREADS = 32      # the kernel's block: N = 2000 is 63 blocks a pair

_P = ctypes.c_void_p


class _GateArgs(ctypes.Structure):
    """``GateArgs`` of ``csrc/triangulate.cu``, field for field."""
    _fields_ = [(name, _P) for name in (
        "kf_rays", "kf_uv", "kf_level", "kf_R", "kf_t", "k_new", "nb", "idx",
        "match", "fxycxy", "face_wh", "cos_fov", "level_sigma2",
        "scale_factors", "ok", "cos_par", "gates")] + [
        ("n_levels", ctypes.c_int), ("ratio", ctypes.c_float)]


TRIANGULATE = CudaKernel("triangulate.cu", "triangulate_launch",
                         [_P] * 5 + [ctypes.POINTER(_GateArgs), ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int])


class Keyframes(NamedTuple):
    """The keyframe tables the gated form reads (the map arena's): rays
    (K,N,3), uv (K,N,2), R (K,3,3) and t (K,3) float32, level (K,N)
    int64."""
    rays: torch.Tensor
    uv: torch.Tensor
    level: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor


class GateConstants(NamedTuple):
    """The mapping gates' constants, as the camera and the mapping kernels
    hold them: ``fxycxy`` (4,), ``face_wh`` (2,), ``cos_fov_th`` () and the
    per-level ``level_sigma2`` and ``scale_factors`` (L,), float32
    tensors; ``ratio`` the scale test's 1.5 * scale_factor, a Python float
    that rounds to float32 as a PyTorch scalar does."""
    fxycxy: torch.Tensor
    face_wh: torch.Tensor
    cos_fov_th: torch.Tensor
    level_sigma2: torch.Tensor
    scale_factors: torch.Tensor
    ratio: float


class Candidates(NamedTuple):
    """The gated form's result for B pairs of N rows: world points ``Xw``
    (B,N,3), their mask ``ok`` (B,N), the parallax cosine ``cos_par`` (B,N)
    and each pair's ``gates`` (B,4) int64 [raw matches, after parallax,
    after depth, after chi2]."""
    Xw: torch.Tensor
    ok: torch.Tensor
    cos_par: torch.Tensor
    gates: torch.Tensor


def _rotate(M: torch.Tensor, V: torch.Tensor, p: int, q: int):
    """One Jacobi rotation zeroing M[..., p, q] of the symmetric (...,4,4)
    ``M``, accumulated into the eigenvector columns ``V``."""
    app, aqq, apq = M[..., p, p], M[..., q, q], M[..., p, q]
    nz = apq != 0
    theta = (aqq - app) / (2.0 * torch.where(nz, apq, torch.ones_like(apq)))
    sgn = torch.where(theta >= 0, 1.0, -1.0).to(M.dtype)
    t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
    t = torch.where(nz, t, torch.zeros_like(t))
    c = 1.0 / torch.sqrt(t * t + 1.0)
    s = t * c
    J = torch.eye(4, dtype=M.dtype, device=M.device).expand(
        M.shape).clone()
    J[..., p, p] = c
    J[..., q, q] = c
    J[..., p, q] = s
    J[..., q, p] = -s
    return J.transpose(-1, -2) @ M @ J, V @ J


def null_vector4(M: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (...,4,4)
    ``M`` (float64), by ``JACOBI_SWEEPS`` cyclic Jacobi sweeps."""
    V = torch.eye(4, dtype=M.dtype, device=M.device).expand(M.shape).clone()
    for _ in range(JACOBI_SWEEPS):
        for p, q in _PAIRS:
            M, V = _rotate(M, V, p, q)
    lam = torch.diagonal(M, dim1=-2, dim2=-1)
    k = torch.argmin(lam, dim=-1)                     # first minimum
    return torch.take_along_dim(V, k[..., None, None].expand(
        *k.shape, 4, 1), dim=-1)[..., 0]


def triangulate_rays(rays1: torch.Tensor, rays2: torch.Tensor,
                     R21: torch.Tensor, t21: torch.Tensor) -> torch.Tensor:
    """Triangulate N correspondences.

    rays1/rays2: (N,3) unit bearings in each camera frame. (R21, t21) maps
    frame-1 points to frame 2. Returns (N,3) float32 points in frame 1. CPU
    tensors take ``triangulate_rays_matmul``; CUDA tensors the kernel."""
    if _on_cpu(rays1, rays2, R21, t21):
        return triangulate_rays_matmul(rays1, rays2, R21, t21)
    return triangulate_pairs_cuda(rays1, rays2, R21[None], t21[None])[0]


def triangulate_pairs(rays1: torch.Tensor, rays2: torch.Tensor,
                      R21s: torch.Tensor, t21s: torch.Tensor) -> torch.Tensor:
    """``triangulate_rays`` of the same N correspondences under B pairs
    (R21s (B,3,3), t21s (B,3)): (B,N,3). CPU tensors take
    ``triangulate_rays_matmul`` a pair; CUDA tensors one launch."""
    if _on_cpu(rays1, rays2, R21s, t21s):
        return torch.stack([triangulate_rays_matmul(rays1, rays2, R, t)
                            for R, t in zip(R21s, t21s)])
    return triangulate_pairs_cuda(rays1, rays2, R21s, t21s)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def _check(name: str, want: dict) -> None:
    """Raise unless each named tensor has its (shape, dtype)."""
    for key, (x, shape, dtype) in want.items():
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {tuple(shape)} {dtype}, "
                             f"got {tuple(x.shape)} {x.dtype}")


def _check_rows(name: str, n: int, pairs: int) -> None:
    if n * max(pairs, 1) >= 2 ** 31 or pairs > 65535:
        raise ValueError(f"{name} takes fewer than 2^31 rows and at most "
                         f"65535 pairs, got {pairs} x {n}")


def triangulate_pairs_cuda(rays1: torch.Tensor, rays2: torch.Tensor,
                           R21s: torch.Tensor, t21s: torch.Tensor,
                           threads: int = TRI_THREADS) -> torch.Tensor:
    """One launch of the triangulation kernel (blocks of ``threads``):
    float32 rays1, rays2 (N,3) shared by B pairs R21s (B,3,3), t21s (B,3),
    all contiguous on one CUDA device. Allocates the (B,N,3) float32
    output, makes no other device operation and reads nothing to the host;
    N = 0 or B = 0 launches nothing."""
    name = "triangulate_pairs"
    require_cuda(name, rays1, rays2, R21s, t21s)
    n = rays1.shape[0] if rays1.dim() == 2 else -1
    B = R21s.shape[0] if R21s.dim() == 3 else -1
    f32 = torch.float32
    _check(name, {"rays1": (rays1, (n, 3), f32), "rays2": (rays2, (n, 3), f32),
                  "R21": (R21s, (B, 3, 3), f32), "t21": (t21s, (B, 3), f32)})
    _check_rows(name, n, B)
    out = torch.empty((B, n, 3), dtype=f32, device=rays1.device)
    if n and B:
        TRIANGULATE(rays1.data_ptr(), rays2.data_ptr(), R21s.data_ptr(),
                    t21s.data_ptr(), out.data_ptr(), None, n, B, threads)
    return out


def triangulate_gated(kf: Keyframes, k_new: torch.Tensor,
                      nb_idx: torch.Tensor, idx: torch.Tensor,
                      match_ok: torch.Tensor, R21s: torch.Tensor,
                      t21s: torch.Tensor, consts: GateConstants
                      ) -> Candidates:
    """The candidates of new keyframe ``k_new`` (a 1-element int64 slot)
    against its B neighbours ``nb_idx`` (B,) int64: feature i of k_new
    matched to feature ``idx[b, i]`` of neighbour b where ``match_ok[b,
    i]`` (both (B,N), from the epipolar search), under the pairs' (R21s,
    t21s) (B,3,3), (B,3). Triangulates every row and gates it as
    ``MappingKernels.triangulate_with_neighbor`` does: the finite test,
    parallax, depth, both FOV cones, both reprojection chi2 tests, the
    scale test; the world point by k_new's pose. CPU tensors take
    ``triangulate_gated_ordered``; CUDA tensors one launch."""
    args = (kf, k_new, nb_idx, idx, match_ok, R21s, t21s, consts)
    if _on_cpu(*kf, k_new, nb_idx, idx, match_ok, R21s, t21s,
               *consts[:5]):
        return triangulate_gated_ordered(*args)
    return triangulate_gated_cuda(*args)


def triangulate_gated_cuda(kf: Keyframes, k_new: torch.Tensor,
                           nb_idx: torch.Tensor, idx: torch.Tensor,
                           match_ok: torch.Tensor, R21s: torch.Tensor,
                           t21s: torch.Tensor, consts: GateConstants,
                           threads: int = TRI_THREADS) -> Candidates:
    """One launch of the triangulation kernel's gated form (blocks of
    ``threads``) on contiguous tensors of one CUDA device, shaped as
    ``triangulate_gated`` says. Allocates the outputs and the zeroed
    counts (one fill), reads nothing to the host; N = 0 or B = 0 launches
    nothing. ``idx`` must lie in [0, N) and the slots in [0, K)."""
    name = "triangulate_gated"
    tensors = (*kf, k_new, nb_idx, idx, match_ok, R21s, t21s, *consts[:5])
    require_cuda(name, *tensors)
    K, n = kf.rays.shape[:2] if kf.rays.dim() == 3 else (-1, -1)
    B = nb_idx.shape[0] if nb_idx.dim() == 1 else -1
    L = consts.level_sigma2.shape[0] if consts.level_sigma2.dim() == 1 else -1
    f32, i64 = torch.float32, torch.int64
    _check(name, {
        "kf.rays": (kf.rays, (K, n, 3), f32), "kf.uv": (kf.uv, (K, n, 2), f32),
        "kf.level": (kf.level, (K, n), i64), "kf.R": (kf.R, (K, 3, 3), f32),
        "kf.t": (kf.t, (K, 3), f32), "k_new": (k_new, (1,), i64),
        "nb_idx": (nb_idx, (B,), i64), "idx": (idx, (B, n), i64),
        "match_ok": (match_ok, (B, n), torch.bool),
        "R21s": (R21s, (B, 3, 3), f32), "t21s": (t21s, (B, 3), f32),
        "fxycxy": (consts.fxycxy, (4,), f32),
        "face_wh": (consts.face_wh, (2,), f32),
        "cos_fov_th": (consts.cos_fov_th, (), f32),
        "level_sigma2": (consts.level_sigma2, (max(L, 1),), f32),
        "scale_factors": (consts.scale_factors, (max(L, 1),), f32)})
    _check_rows(name, n, B)
    dev = kf.rays.device
    out = Candidates(
        Xw=torch.empty((B, n, 3), dtype=f32, device=dev),
        ok=torch.empty((B, n), dtype=torch.bool, device=dev),
        cos_par=torch.empty((B, n), dtype=f32, device=dev),
        gates=torch.zeros((B, 4), dtype=i64, device=dev))
    if n and B:
        g = _GateArgs(*(x.data_ptr() for x in (
            *kf, k_new, nb_idx, idx, match_ok, *consts[:5], out.ok,
            out.cos_par, out.gates)), L, consts.ratio)
        TRIANGULATE(None, None, R21s.data_ptr(), t21s.data_ptr(),
                    out.Xw.data_ptr(), ctypes.byref(g), n, B, threads)
    return out


def triangulate_rays_matmul(rays1: torch.Tensor, rays2: torch.Tensor,
                            R21: torch.Tensor, t21: torch.Tensor
                            ) -> torch.Tensor:
    """``triangulate_rays`` by batched products: A from ``hat`` products,
    AᵀA by a batched product, ``null_vector4``; on any device (the CPU's
    path, and what the kernel replaced on the card)."""
    f64 = torch.float64
    r1, r2 = rays1.to(f64), rays2.to(f64)
    P1 = torch.cat([torch.eye(3, dtype=f64, device=r1.device),
                    torch.zeros(3, 1, dtype=f64, device=r1.device)], dim=1)
    P2 = torch.cat([R21.to(f64), t21.to(f64).reshape(3, 1)], dim=1)
    A = torch.cat([hat(r1) @ P1, hat(r2) @ P2], dim=-2)      # (N,6,4)
    X = null_vector4(A.transpose(-1, -2) @ A)                # (N,4)
    w = X[:, 3]
    w_safe = torch.where(w.abs() < W_FLOOR, torch.full_like(w, W_FLOOR), w)
    return (X[:, :3] / w_safe[:, None]).to(rays1.dtype)


def normal_matrices(rays1: torch.Tensor, rays2: torch.Tensor,
                    R21: torch.Tensor, t21: torch.Tensor) -> torch.Tensor:
    """The (..., N,4,4) float64 normal matrices AᵀA as the kernel forms
    them: rows 0-2 of A are hat(r1) with a zero fourth column, row 3 + i
    sums the two non-zero terms of row i of hat(r2) times [R21 | t21], and
    each entry of M adds the six row products left to right. Rays (...,
    N,3) and the pairs' R21 (...,3,3), t21 (...,3) broadcast over the
    leading dimensions."""
    f64 = torch.float64
    lead = torch.broadcast_shapes(rays1.shape[:-2], rays2.shape[:-2],
                                  R21.shape[:-2], t21.shape[:-1])
    n = rays1.shape[-2]
    r1 = rays1.to(f64).expand(*lead, n, 3)
    r2 = rays2.to(f64).expand(*lead, n, 3)
    P = torch.cat([R21.to(f64), t21.to(f64)[..., None]], dim=-1)
    P = P.expand(*lead, 3, 4)[..., None, :, :]                # (...,1,3,4)
    x1, y1, z1 = r1[..., 0], r1[..., 1], r1[..., 2]
    x2, y2, z2 = r2[..., 0, None], r2[..., 1, None], r2[..., 2, None]
    zero = torch.zeros_like(x1)
    A = torch.stack([
        torch.stack([zero, -z1, y1, zero], -1),
        torch.stack([z1, zero, -x1, zero], -1),
        torch.stack([-y1, x1, zero, zero], -1),
        (-z2) * P[..., 1, :] + y2 * P[..., 2, :],
        z2 * P[..., 0, :] + (-x2) * P[..., 2, :],
        (-y2) * P[..., 0, :] + x2 * P[..., 1, :]], -2)      # (...,N,6,4)
    prod = A[..., :, :, None] * A[..., :, None, :]           # (...,N,6,4,4)
    M = prod[..., 0, :, :]
    for r in range(1, 6):
        M = M + prod[..., r, :, :]
    return M


def triangulate_rays_ordered(rays1: torch.Tensor, rays2: torch.Tensor,
                             R21: torch.Tensor, t21: torch.Tensor
                             ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in the kernel's order, on
    any device (float32 in and out, float64 inside): ``normal_matrices``,
    ``JACOBI_SWEEPS`` sweeps of two-sided rotations on rows then columns p,
    q, the first smallest diagonal entry (a NaN the smallest), the division
    by w. Every step is one elementwise operation, so each value rounds as
    the kernel's does. One pair gives (N,3); B pairs (R21 (B,3,3), t21
    (B,3), rays (N,3) or (B,N,3)) give (B,N,3), bitwise the B one-pair
    calls."""
    f64 = torch.float64
    M = normal_matrices(rays1, rays2, R21, t21)
    V = torch.eye(4, dtype=f64, device=M.device).expand(M.shape).clone()
    one = torch.ones(M.shape[:-2], dtype=f64, device=M.device)
    for _ in range(JACOBI_SWEEPS):
        for p, q in _PAIRS:
            app, aqq, apq = M[..., p, p], M[..., q, q], M[..., p, q]
            nz = apq != 0
            theta = (aqq - app) / (2.0 * torch.where(nz, apq, one))
            sgn = torch.where(theta >= 0, one, -one)
            t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(nz, t, torch.zeros_like(t))
            c = one / torch.sqrt(t * t + 1.0)
            s = t * c
            c, s = c[..., None], s[..., None]
            mp, mq = M[..., p, :].clone(), M[..., q, :].clone()
            M[..., p, :] = c * mp - s * mq                   # J^T M
            M[..., q, :] = s * mp + c * mq
            mp, mq = M[..., :, p].clone(), M[..., :, q].clone()
            M[..., :, p] = c * mp - s * mq                   # (J^T M) J
            M[..., :, q] = s * mp + c * mq
            vp, vq = V[..., :, p].clone(), V[..., :, q].clone()
            V[..., :, p] = c * vp - s * vq                   # V J
            V[..., :, q] = s * vp + c * vq
    best, X = M[..., 0, 0], V[..., :, 0]
    for k in range(1, 4):
        d = M[..., k, k]
        take = ~torch.isnan(best) & (torch.isnan(d) | (d < best))
        best = torch.where(take, d, best)
        X = torch.where(take[..., None], V[..., :, k], X)
    w = X[..., 3]
    w = torch.where(w.abs() < W_FLOOR, torch.full_like(w, W_FLOOR), w)
    return (X[..., :3] / w[..., None]).to(torch.float32)


def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def _to_cubemap(consts: GateConstants, x, y, z):
    """``camera.ray_to_cubemap`` as the kernel writes it out: (u, v, valid)
    of rig points (x, y, z); u and v are meaningful where valid. The face
    rotation's entries are 0 and +-1, so its moves and negations give the
    rotation's products exactly."""
    ax, ay, az = x.abs(), y.abs(), z.abs()
    faces = (                                   # in the octant tests' order
        ((z > 0) & (ax <= z) & (ay <= z), (x, y, z), (1.0, 1.0)),     # front
        ((x > 0) & (ay <= x) & (az <= x), (-z, y, x), (2.0, 1.0)),    # right
        ((x < 0) & (ay <= -x) & (az <= -x), (z, y, -x), (0.0, 1.0)),  # left
        ((y > 0) & (ax <= y) & (az <= y), (x, -z, y), (1.0, 2.0)),    # lower
        ((y < 0) & (ax <= -y) & (az <= -y), (x, z, -y), (1.0, 0.0)))  # upper
    has = torch.zeros_like(x, dtype=torch.bool)
    lx, ly, lz = x, y, z
    ox = oy = torch.ones_like(x)
    for cond, (fx_, fy_, fz_), (o_x, o_y) in reversed(faces):
        lx = torch.where(cond, fx_, lx)
        ly = torch.where(cond, fy_, ly)
        lz = torch.where(cond, fz_, lz)
        ox = torch.where(cond, o_x, ox)
        oy = torch.where(cond, o_y, oy)
        has = has | cond
    fx, fy, cx, cy = consts.fxycxy.unbind()
    W, H = consts.face_wh.unbind()
    zs = torch.where(lz == 0, torch.full_like(lz, 1e-14), lz)
    up = lx * fx / zs + cx
    vp = ly * fy / zs + cy
    valid = has & (up >= 0) & (up < W) & (vp >= 0) & (vp < H)
    return up + ox * W, vp + oy * H, valid


def triangulate_gated_ordered(kf: Keyframes, k_new: torch.Tensor,
                              nb_idx: torch.Tensor, idx: torch.Tensor,
                              match_ok: torch.Tensor, R21s: torch.Tensor,
                              t21s: torch.Tensor, consts: GateConstants
                              ) -> Candidates:
    """``triangulate_gated`` in plain PyTorch, in the kernel's order, on
    any device: the gathers, ``triangulate_rays_ordered`` of the B pairs,
    then each gate of ``MappingKernels.triangulate_with_neighbor`` as
    elementwise float32 operations (products of a 3x3 by a 3-vector and
    norms written out, each sum left to right), so that each value rounds
    as the kernel's does."""
    k1 = k_new.reshape(1)
    row1 = [x.index_select(0, k1)[0] for x in kf]      # k_new's rows
    rays1, uv1, lev1, R1, t1 = row1
    at = (nb_idx[:, None], idx)
    rays2, uv2, lev2 = kf.rays[at], kf.uv[at], kf.level[at]   # (B,N,..)
    X1 = triangulate_rays_ordered(rays1, rays2, R21s, t21s)
    x, y, z = X1.unbind(-1)
    R = R21s[:, None]                                  # (B,1,3,3)
    t = t21s[:, None]                                  # (B,1,3)
    ok = match_ok & torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    # parallax between the viewing rays in frame 1
    r1x, r1y, r1z = rays1.unbind(-1)
    r2x, r2y, r2z = rays2.unbind(-1)
    q = [r2x * R[..., 0, j] + r2y * R[..., 1, j] + r2z * R[..., 2, j]
         for j in range(3)]
    cos_par = r1x * q[0] + r1y * q[1] + r1z * q[2]
    ok = ok & (cos_par < 0.9998)
    n_par = ok.sum(-1)
    d1 = _norm3(x, y, z)
    base = _norm3(t[..., 0], t[..., 1], t[..., 2])
    ok = ok & (d1 <= 50.0 * base)
    n_depth = ok.sum(-1)
    # FOV cones in both frames
    ok = ok & (z / torch.clamp(d1, min=1e-12) > consts.cos_fov_th)
    x2, y2, z2 = ((R[..., a, 0] * x + R[..., a, 1] * y + R[..., a, 2] * z)
                  + t[..., a] for a in range(3))
    d2 = _norm3(x2, y2, z2)
    ok = ok & (z2 / torch.clamp(d2, min=1e-12) > consts.cos_fov_th)
    # reprojection chi2 in both frames
    top = consts.level_sigma2.shape[0] - 1
    l1, l2 = lev1.clamp(0, top), lev2.clamp(0, top)
    for (px, py, pz), uv, lev in (((x, y, z), uv1, l1),
                                  ((x2, y2, z2), uv2, l2)):
        u, v, valid = _to_cubemap(consts, px, py, pz)
        du, dv = u - uv[..., 0], v - uv[..., 1]
        ok = ok & valid & (du * du + dv * dv
                           <= 5.991 * consts.level_sigma2[lev])
    n_chi2 = ok.sum(-1)
    # scale consistency
    rd = d2 / torch.clamp(d1, min=1e-12)
    ro = consts.scale_factors[l1] / consts.scale_factors[l2]
    ok = ok & (rd * consts.ratio > ro) & (rd < ro * consts.ratio)
    # world coordinates
    e = (x - t1[0], y - t1[1], z - t1[2])
    Xw = torch.stack([e[0] * R1[0, j] + e[1] * R1[1, j] + e[2] * R1[2, j]
                      for j in range(3)], -1)
    gates = torch.stack([match_ok.sum(-1), n_par, n_depth, n_chi2], -1)
    return Candidates(Xw=Xw, ok=ok, cos_par=cos_par, gates=gates)
