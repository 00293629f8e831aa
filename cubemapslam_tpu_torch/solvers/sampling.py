"""Minimal-set sampling for batched RANSAC (``cubemapslam_tpu/solvers/
sampling.py:9-25``), in two steps: the draw of uniform scores from a
generator (``draw_scores``) and the selection of the sets from the scores
(``select_minimal_sets``), which reads nothing from a generator, so that a
captured CUDA graph can hold it while the draws stay outside."""

from __future__ import annotations

import torch


def draw_scores(generator: torch.Generator, n_iters: int, n: int,
                device) -> torch.Tensor:
    """(n_iters, n) i.i.d. uniform float32 scores, drawn from ``generator``
    on the generator's own device and moved to ``device`` (a stream depends
    on the device that draws it, so a host generator gives a card the
    host's scores)."""
    return torch.rand((n_iters, n), generator=generator,
                      device=generator.device).to(device)


def select_minimal_sets(scores: torch.Tensor, valid: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Each row's set: the top-k of its scores over the valid entries, the
    invalid ones at -inf. Ties fall to the lower index (a stable sort), so
    with fewer than ``k`` valid entries a set takes invalid ones in index
    order (the caller gates on enough matches). Returns (n_iters, k)
    int64."""
    scores = torch.where(valid[None, :], scores,
                         torch.full_like(scores, float("-inf")))
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    return idx[:, :k]


def sample_minimal_sets(generator: torch.Generator, valid: torch.Tensor,
                        n_iters: int, k: int) -> torch.Tensor:
    """Draw ``n_iters`` index sets of size ``k`` without replacement from the
    valid entries of a fixed-size pool: ``draw_scores`` on ``valid``'s
    device, then ``select_minimal_sets``. Returns (n_iters, k) int64."""
    return select_minimal_sets(
        draw_scores(generator, n_iters, valid.shape[0], valid.device),
        valid, k)
