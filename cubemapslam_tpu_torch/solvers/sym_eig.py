"""Batched symmetric eigen-solves without a host read.

The counterpart of ``jnp.linalg.eigh`` at the call sites of the bearing EPnP
(``cubemapslam_tpu/solvers/pnp.py:51, :133``) and of Horn's alignment
(``cubemapslam_tpu/solvers/horn.py:46``) in the EPnP of the JAX package's
compiled relocalization program and in the Sim3 RANSAC of loop closing
(``cubemapslam_tpu/solvers/sim3.py:66, :76``): ``solvers/pnp.py``'s six solves
a call and ``solvers/sim3.py``'s two (the hypotheses' (n_iters, 4, 4) and
the refit's 4x4), which ``runtime/fused_reloc.py`` and
``runtime/fused_loop.py`` capture in CUDA graphs; and of ``jnp.linalg.svd``
in the two-view initialization (``cubemapslam_tpu/solvers/essential.py:42,
:44, :100``): ``solvers/essential.py``'s three solves an attempt (the
(n_iters, 9, 9) float64 normal matrices of the 8-point sets, the
(n_iters, 3, 3) EᵀE of their rank-2 projection and the best E's 3x3),
which ``runtime/fused_init.py`` captures. ``torch.linalg.eigh`` and
``torch.linalg.svd`` read cuSOLVER's error flag back to the host on a CUDA
tensor, so the card waits at every call and no CUDA graph can hold one.

- ``sym_eig``: (..., n, n) float32 or float64 symmetric (the lower
  triangle is read) -> ascending eigenvalues (..., n) and the eigenvectors
  as columns (..., n, n), float32. On a CUDA tensor one launch of
  ``csrc/sym_eig.cu`` (n in ``SYM_EIG_SIZES``; ``SYM_EIG.launches`` counts
  them), or it raises; on a CPU tensor ``eigh_nan`` in the input's dtype,
  rounded to float32. A matrix with a non-finite entry gives NaN results
  and raises nothing on either device.
- ``eigh_nan``: ``torch.linalg.eigh`` where a non-finite matrix is solved
  as the identity and its results replaced by NaN, as JAX's are (LAPACK and
  cuSOLVER would raise); the CPU's path.
- ``sym_eig_ordered``: the kernel's Jacobi in float64 (the source has the
  method; a float32 input is widened exactly, a float64 one read as it is)
  in plain PyTorch, in the kernel's order, on any device: the
  round-robin ``schedule`` (n/2 disjoint rotations a step, n - 1 steps a
  sweep, n rounded up to even), each step's angles from the pivots as the
  step found them, ``JᵀAJ`` by an entry formula symmetric in (i, j) so A
  stays exactly symmetric, the shuffle-tree sums (``_tree``), the stable
  order and the sign rule, written out as elementwise operations so that
  each value rounds as the kernel's does (the square root IEEE-rounded on
  the host too). It holds the kernel bitwise on the card, a lane-by-lane
  scalar emulation of the kernel bitwise and the method against JAX on the
  CPU; nothing on the main path calls it.

The Jacobi solve stops a matrix when the sum of its squared entries above
the diagonal is at most ``EPS ** 2`` times the sum of all its squared
entries, or after ``MAX_SWEEPS`` sweeps; the result is rounded to float32,
far above that ``EPS``. Eigenvectors of a repeated eigenvalue (the
4-dimensional null space of a minimal set's MᵀM) are a basis of their space
that differs between solvers; only the space is shared.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from cubemapslam_tpu_torch._build import CudaKernel, require_cuda

SYM_EIG_SIZES = (3, 4, 9, 12)
# the input types the kernel reads
SYM_EIG_DTYPES = (torch.float32, torch.float64)
MAX_SWEEPS = 20
EPS = 1e-12

_P, _I = ctypes.c_void_p, ctypes.c_int

SYM_EIG = CudaKernel("sym_eig.cu", "sym_eig_launch",
                     [_P, _P, _P, _I, _I, _I, _I, ctypes.c_double])


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE round-to-nearest float64 square root, as the kernel's: PyTorch's
    on the card; numpy's on the host, where PyTorch's vectorized float64
    square root misses it in about 1% of values."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _nonfinite(A: torch.Tensor) -> torch.Tensor:
    return ~torch.isfinite(A).all(dim=-1).all(dim=-1)


def eigh_nan(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of symmetric (..., n, n) that gives NaN for a
    non-finite matrix, as JAX's does, where LAPACK and cuSOLVER would
    raise: such a matrix is solved as the identity and its results
    replaced by NaN."""
    bad = _nonfinite(A)
    evals, evecs = torch.linalg.eigh(
        torch.where(bad[..., None, None], _eye(A.shape[-1], A), A))
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(bad[..., None], nan, evals),
            torch.where(bad[..., None, None], nan, evecs))


def sym_eig(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) and eigenvectors (columns), float32, of
    symmetric (..., n, n) float32 or float64 ``A``: a CPU tensor takes
    ``eigh_nan`` in its dtype, a CUDA tensor the kernel."""
    if A.device.type == "cpu":
        return tuple(x.to(torch.float32) for x in eigh_nan(A))
    return sym_eig_cuda(A)


def sym_eig_cuda(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel over the matrices of (..., n, n) float32 or
    float64 ``A`` on a CUDA device (n in ``SYM_EIG_SIZES``; a strided input
    is made contiguous), float32 results. Allocates the outputs, makes no
    other device operation and reads nothing to the host; an empty batch
    launches nothing."""
    n = A.shape[-1] if A.dim() >= 2 else -1
    if A.dim() < 2 or A.shape[-2] != n or n not in SYM_EIG_SIZES \
            or A.dtype not in SYM_EIG_DTYPES:
        raise ValueError(f"sym_eig takes (..., n, n) float32 or float64 "
                         f"with n in {SYM_EIG_SIZES}, got {tuple(A.shape)} "
                         f"{A.dtype}")
    lead = A.shape[:-2]
    A = A.reshape(-1, n, n).contiguous()
    require_cuda("sym_eig", A)
    B = A.shape[0]
    if B >= 2 ** 31:
        raise ValueError(f"sym_eig takes fewer than 2^31 matrices, got {B}")
    evals = torch.empty((B, n), dtype=torch.float32, device=A.device)
    evecs = torch.empty((B, n, n), dtype=torch.float32, device=A.device)
    if B:
        SYM_EIG(A.data_ptr(), evals.data_ptr(), evecs.data_ptr(), B, n,
                int(A.dtype == torch.float64), MAX_SWEEPS, EPS * EPS)
    return evals.reshape(*lead, n), evecs.reshape(*lead, n, n)


def schedule(n: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """The kernel's round-robin sweep at size n: ``NP - 1`` steps of
    ``NP / 2`` disjoint pairs (p, q), p < q, over the indices 0 .. NP - 1,
    where NP is n rounded up to even (at odd n the index n is a dummy whose
    pairs never rotate). Step s pairs NP - 1 with s and i with j where
    i + j = 2 s modulo NP - 1: every pair once a sweep."""
    m = n + n % 2 - 1
    return tuple(((s, m),) + tuple(
        (min((s - k) % m, (s + k) % m), max((s - k) % m, (s + k) % m))
        for k in range(1, (m + 1) // 2)) for s in range(m))


def _tree(x: torch.Tensor) -> torch.Tensor:
    """The kernel's shuffle-tree sum of per-lane values ``x`` (B, L), L <= 32
    (the other lanes hold 0): each of 32 lanes adds its xor-16, then xor-8,
    xor-4, xor-2 and xor-1 neighbour's value to its own; lane 0's value
    (every lane's: each sum's two terms are the same in both lanes)."""
    x = torch.cat([x, x.new_zeros(x.shape[0], 32 - x.shape[1])], dim=1)
    lane = torch.arange(32, device=x.device)
    for m in (16, 8, 4, 2, 1):
        x = x + x[:, lane ^ m]
    return x[:, 0]


def sym_eig_ordered(A: torch.Tensor, counts: bool = False):
    """The kernel's arithmetic in plain PyTorch, in its order, on any device
    (float32 or float64 in, float64 inside, float32 out): the lower
    triangle mirrored into an NP x NP matrix (zero padded at odd n), the sums of squares a row
    added left to right and the rows by ``_tree``, each step of each sweep
    (``schedule``) applied to a matrix that is not done: every pair's angle
    from the pivots as the step found them, then ``JᵀAJ`` entry by entry
    and ``VJ``, a skipped pair rotating by the identity; then the stable
    order and the sign rule. With ``counts`` it also returns, a matrix, the
    rotations applied, the sweeps begun and the steps made (int64), for the
    kernel's bound. Reads the host once a sweep, to stop when every matrix
    is done."""
    f64 = torch.float64
    n = A.shape[-1]
    NP = n + n % 2
    lead = A.shape[:-2]
    A = A.reshape(-1, n, n)
    B, dev = A.shape[0], A.device
    bad = _nonfinite(A)
    low = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    S = torch.where(low, A, A.transpose(-1, -2)).to(f64)
    S = torch.where(bad[:, None, None], _eye(n, S), S)
    nrm = torch.zeros(B, n, dtype=f64, device=dev)
    for j in range(n):
        nrm = nrm + S[:, :, j] * S[:, :, j]
    tol2 = (EPS * EPS) * _tree(nrm)
    skip2 = (tol2 / (n * (n - 1) // 2))[:, None]
    S = torch.nn.functional.pad(S, (0, NP - n, 0, NP - n))
    V = _eye(NP, S).expand(B, NP, NP).clone()
    lane = torch.arange(n, device=dev)
    one = torch.ones((), dtype=f64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    rotations = torch.zeros(B, dtype=torch.int64, device=dev)
    sweeps = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(MAX_SWEEPS):
        off = torch.zeros(B, n, dtype=f64, device=dev)
        for j in range(n):
            off = torch.where(j > lane, off + S[:, :n, j] * S[:, :n, j], off)
        active = active & ~(_tree(off) <= tol2)
        if not bool(active.any()):
            break
        sweeps += active
        for pairs in schedule(n):
            P = torch.tensor([p for p, _ in pairs], device=dev)
            Q = torch.tensor([q for _, q in pairs], device=dev)
            part = torch.empty(NP, dtype=torch.int64, device=dev)
            part[P], part[Q] = Q, P
            app, aqq, apq = S[:, P, P], S[:, Q, Q], S[:, P, Q]
            do = ~(apq * apq <= skip2)
            theta = (aqq - app) / (2.0 * apq)
            sgn = torch.where(theta >= 0, one, -one)
            t = sgn / (theta.abs() + _sqrt(theta * theta + 1.0))
            c = one / _sqrt(t * t + 1.0)
            s = t * c
            t = torch.where(do, t, 0.0)
            c = torch.where(do, c, one)
            s = torch.where(do, s, 0.0)
            u = torch.empty(B, NP, dtype=f64, device=dev)
            w = torch.empty_like(u)
            u[:, P], u[:, Q], w[:, P], w[:, Q] = c, c, -s, s
            ui, uj, wi, wj = u[:, :, None], u[:, None, :], w[:, :, None], \
                w[:, None, :]
            rows = S[:, part, :]
            new = ((ui * uj) * S + (wi * wj) * rows[:, :, part]) \
                + ((ui * wj) * S[:, :, part] + (wi * uj) * rows)
            piv = torch.where(do, 0.0, apq)
            new[:, P, Q] = piv
            new[:, Q, P] = piv
            new[:, P, P] = app - t * apq
            new[:, Q, Q] = aqq + t * apq
            cc, ss = c[:, None, :], s[:, None, :]
            vp, vq = V[:, :, P], V[:, :, Q]
            newV = torch.empty_like(V)
            newV[:, :, P] = cc * vp - ss * vq
            newV[:, :, Q] = ss * vp + cc * vq
            on = active[:, None, None]
            S = torch.where(on, new, S)
            V = torch.where(on, newV, V)
            rotations += (do & active[:, None]).sum(dim=-1)
            steps += active
    d, V = torch.diagonal(S, dim1=-2, dim2=-1)[:, :n], V[:, :n, :n]
    idx = torch.arange(n, device=dev)
    before = (d[:, None, :] < d[:, :, None]) \
        | ((d[:, None, :] == d[:, :, None]) & (idx[None, :] < idx[:, None]))
    rank = before.sum(dim=-1)                                 # of column j
    perm = torch.empty_like(rank).scatter_(1, rank, idx.expand(B, n))
    evals = torch.gather(d, 1, perm)
    V = torch.gather(V, 2, perm[:, None, :].expand(B, n, n))
    best, piv = V[:, 0, :].abs(), V[:, 0, :]
    for r in range(1, n):
        take = V[:, r, :].abs() > best
        best = torch.where(take, V[:, r, :].abs(), best)
        piv = torch.where(take, V[:, r, :], piv)
    V = torch.where((piv < 0)[:, None, :], -V, V)
    f32 = torch.float32
    nan = torch.full((), float("nan"), dtype=f32, device=dev)
    evals = torch.where(bad[:, None], nan, evals.to(f32))
    evecs = torch.where(bad[:, None, None], nan, V.to(f32))
    out = (evals.reshape(*lead, n), evecs.reshape(*lead, n, n))
    if counts:
        out += (rotations.reshape(lead), sweeps.reshape(lead),
                steps.reshape(lead))
    return out
