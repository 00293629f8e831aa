"""Horn 1987 closed-form absolute orientation, batched
(``cubemapslam_tpu/solvers/horn.py:18``): the optimal rotation is the
eigenvector of the largest eigenvalue of the 4x4 quaternion N-matrix built
from the cross-covariance of the demeaned point sets. The eigen-solve is
``eigh``: ``torch.linalg.eigh`` by default (the trajectory alignment),
which waits for the card on a CUDA tensor; the bearing EPnP and the Sim3
RANSAC of loop closing pass ``solvers.sym_eig``'s solve, which does
not."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from cubemapslam_tpu_torch.geometry import quat_to_rot


def horn_alignment(p_to: torch.Tensor, p_from: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   fix_scale: bool = False,
                   eigh: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve p_to ~= s R p_from + t in closed form.

    p_to/p_from: (...,N,3); weights (...,N) optional {0,1} mask; ``eigh``
    the symmetric eigen-solve of the (...,4,4) N-matrix, eigenvalues
    ascending (``torch.linalg.eigh`` when None). Returns (s (...,), R
    (...,3,3), t (...,3))."""
    if weights is None:
        weights = torch.ones(p_to.shape[:-1], dtype=p_to.dtype,
                             device=p_to.device)
    w = weights[..., None]
    wsum = torch.clamp(w.sum(dim=-2), min=1e-12)
    c_to = (p_to * w).sum(dim=-2) / wsum[..., 0:1]
    c_from = (p_from * w).sum(dim=-2) / wsum[..., 0:1]
    q_to = (p_to - c_to[..., None, :]) * w
    q_from = (p_from - c_from[..., None, :]) * w
    S = torch.einsum("...ni,...nj->...ij", q_from, q_to)
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1),
    ], -2)
    _, evecs = (torch.linalg.eigh if eigh is None else eigh)(N)
    q_wxyz = evecs[..., :, 3]                  # largest eigenvalue
    q_xyzw = torch.cat([q_wxyz[..., 1:], q_wxyz[..., 0:1]], -1)
    R = quat_to_rot(q_xyzw)
    rot_from = torch.einsum("...ij,...nj->...ni", R, q_from)
    if fix_scale:
        s = torch.ones(p_to.shape[:-2], dtype=p_to.dtype, device=p_to.device)
    else:
        num = (q_to * rot_from).sum(dim=(-1, -2))
        den = torch.clamp((q_from * q_from).sum(dim=(-1, -2)), min=1e-12)
        s = num / den
    t = c_to - s[..., None] * torch.einsum("...ij,...j->...i", R, c_from)
    return s, R, t
