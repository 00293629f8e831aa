"""Minimal-set sampling for batched RANSAC (``cubemapslam_tpu/solvers/
sampling.py:9-25``)."""

from __future__ import annotations

import torch


def sample_minimal_sets(generator: torch.Generator, valid: torch.Tensor,
                        n_iters: int, k: int) -> torch.Tensor:
    """Draw ``n_iters`` index sets of size ``k`` without replacement from the
    valid entries of a fixed-size pool: each set is the top-k of i.i.d.
    uniform scores, drawn from ``generator`` (on ``valid``'s device), with
    invalid entries at -inf. Ties fall to the lower index (a stable sort),
    so with fewer than ``k`` valid entries a set takes invalid ones in index
    order (the caller gates on enough matches). Returns (n_iters, k)
    int64."""
    n = valid.shape[0]
    scores = torch.rand((n_iters, n), generator=generator,
                        device=valid.device)
    scores = torch.where(valid[None, :], scores,
                         torch.full_like(scores, float("-inf")))
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    return idx[:, :k]
