"""Place recognition: the binary vocabulary tree and dense bag-of-words rows.

Counterpart of ``cubemapslam_tpu/place.py``. The vocabulary is a complete
k-ary tree of binary centers, trained by hierarchical binary k-medians
(majority-bit centroids); a descriptor's word is found by a fixed-depth
argmin-Hamming descent over each node's k children. A keyframe's BoW row is
a dense L1-normalized tf-idf vector, the DBoW2 L1 score of a query against
every keyframe is one broadcast reduction, and candidate selection
(DetectRelocalizationCandidates / DetectLoopCandidates) is masked vector
math with the covisibility-group accumulation as one float32 product.

Centers are (k^(l+1), 8) int64 words on the device (the JAX package's
uint32 words); each level's bits are unpacked once, when the vocabulary is
made, not on every ``word_ids`` call. The trainer is a numpy copy of the
JAX package's, with the same ``np.random.RandomState(seed)`` draws, so the
same descriptors give bit-identical centers and idf. ``save_vocabulary`` /
``load_vocabulary`` use the JAX package's npz format, so a file written by
either package loads in the other.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from cubemapslam_tpu_torch import matching as M


class Vocabulary:
    """A complete k-ary tree: level l holds k^(l+1) centers as (.., 8) int64
    words (``centers``) and as (.., 256) float32 bits (``bits``); ``idf``
    is (n_words,) float32."""

    def __init__(self, centers: Sequence[torch.Tensor], idf: torch.Tensor,
                 k: int, depth: int):
        self.centers: Tuple[torch.Tensor, ...] = tuple(centers)
        self.idf = idf
        self.k = int(k)
        self.depth = int(depth)
        self.bits = tuple(M.unpack_descriptors(c) for c in self.centers)

    @property
    def n_words(self) -> int:
        return self.centers[-1].shape[0]

    def to(self, device) -> "Vocabulary":
        return Vocabulary([c.to(device) for c in self.centers],
                          self.idf.to(device), self.k, self.depth)


# ---------------------------------------------------------------------------
# Training (numpy, on the host; place.py:47-111)
# ---------------------------------------------------------------------------

def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,8),(M,8) uint32 -> (N,M) int popcount distances (numpy)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Majority bit vector of (N,8) uint32 descriptors."""
    bits = np.unpackbits(desc.view(np.uint8), axis=-1,
                         bitorder="little")          # (N,256)
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


def _kmedians(desc: np.ndarray, k: int, rs: np.random.RandomState,
              n_iter: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Binary k-medians. Returns (centers (k,8), assignment (N,))."""
    n = desc.shape[0]
    if n == 0:
        return np.zeros((k, 8), np.uint32), np.zeros(0, np.int64)
    init = rs.choice(n, size=min(k, n), replace=False)
    centers = desc[init]
    if centers.shape[0] < k:
        centers = np.concatenate(
            [centers, centers[rs.randint(0, centers.shape[0],
                                         k - centers.shape[0])]])
    for _ in range(n_iter):
        d = _hamming_np(desc, centers)
        assign = d.argmin(1)
        for c in range(k):
            sel = desc[assign == c]
            if len(sel) > 0:
                centers[c] = _majority_center(sel)
    d = _hamming_np(desc, centers)
    return centers.astype(np.uint32), d.argmin(1)


def _device(device) -> torch.device:
    """``None`` is the first CUDA card, as for the runtime's entry points
    (``runtime.frame_step.resolve_device``, imported here at the call: the
    runtime package imports this module)."""
    from cubemapslam_tpu_torch.runtime.frame_step import resolve_device
    return resolve_device(device)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 3,
                     seed: int = 0, max_train: int = 60000,
                     device=None) -> Vocabulary:
    """Hierarchical binary k-medians (TemplatedVocabulary::create analog) on
    (N,8) uint32 descriptors, on the host. Returns a Vocabulary of k^depth
    words on ``device`` (the card unless ``"cpu"`` is passed)."""
    rs = np.random.RandomState(seed)
    desc = np.asarray(descriptors, np.uint32)
    if desc.shape[0] > max_train:
        desc = desc[rs.choice(desc.shape[0], max_train, replace=False)]
    groups = [desc]
    levels = []
    for _ in range(depth):
        centers_lvl = []
        next_groups = []
        for g in groups:
            c, a = _kmedians(g, k, rs)
            centers_lvl.append(c)
            for j in range(k):
                next_groups.append(g[a == j] if len(g) else g)
        levels.append(np.concatenate(centers_lvl))
        groups = next_groups
    # idf from training term frequencies (TemplatedVocabulary::setWeights)
    counts = np.array([max(len(g), 1) for g in groups], np.float64)
    idf = np.log(desc.shape[0] / counts)
    return vocabulary_from_numpy(levels, idf.astype(np.float32), k, depth,
                                 device)


def vocabulary_from_numpy(centers: Sequence[np.ndarray], idf: np.ndarray,
                          k: int, depth: int, device=None) -> Vocabulary:
    """Per-level (.., 8) uint32 centers and the idf -> a Vocabulary on
    ``device`` (the card unless ``"cpu"`` is passed)."""
    device = _device(device)
    return Vocabulary(
        [torch.as_tensor(np.asarray(c, np.uint32).astype(np.int64),
                         device=device) for c in centers],
        torch.as_tensor(np.asarray(idf, np.float32), device=device), k, depth)


def save_vocabulary(vocab: Vocabulary, path: str) -> None:
    """Write one npz in the JAX package's format (``place.py:132-140``)."""
    data = {f"centers_{i}": c.cpu().numpy().astype(np.uint32)
            for i, c in enumerate(vocab.centers)}
    data["idf"] = vocab.idf.cpu().numpy()
    data["k"] = np.int64(vocab.k)
    data["depth"] = np.int64(vocab.depth)
    np.savez_compressed(path, **data)


def load_vocabulary(path: str, device=None) -> Vocabulary:
    """A vocabulary written by ``save_vocabulary`` (or the JAX package's), on
    ``device`` (the card unless ``"cpu"`` is passed)."""
    with np.load(path) as z:
        depth = int(z["depth"])
        return vocabulary_from_numpy([z[f"centers_{i}"] for i in range(depth)],
                                     z["idf"], int(z["k"]), depth, device)


# ---------------------------------------------------------------------------
# Lookup and scoring (on the device)
# ---------------------------------------------------------------------------

def word_ids(vocab: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """(N,8) int64 words -> (N,) int64 word ids by the fixed-depth
    argmin-Hamming descent: each level compares a descriptor with its
    node's k children only. Ties go to the first child, as ``jnp.argmin``
    takes them."""
    bits = M.unpack_descriptors(desc)                      # (N,256)
    children = torch.arange(vocab.k, device=desc.device)
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for cb in vocab.bits:
        base = node * vocab.k
        cand = cb[base[:, None] + children[None, :]]       # (N,k,256)
        dk = (cand - bits[:, None, :]).abs().sum(dim=-1)
        node = base + torch.argmin(dk, dim=1)
    return node


def bow_vectors(vocab: Vocabulary, desc: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """L1-normalized tf-idf rows (S, n_words) of S descriptor sets
    (S, N, 8) with validity (S, N): the term counts are an ``index_add`` of
    the valid flags."""
    S, N = valid.shape
    W = vocab.n_words
    w = word_ids(vocab, desc.reshape(S * N, 8)).reshape(S, N)
    flat = w + torch.arange(S, device=w.device)[:, None] * W
    tf = torch.zeros(S * W, dtype=torch.float32, device=w.device)
    tf.index_add_(0, flat.reshape(-1), valid.reshape(-1).to(torch.float32))
    v = tf.reshape(S, W) * vocab.idf
    return v / torch.clamp(v.abs().sum(dim=1, keepdim=True), min=1e-12)


def bow_vector(vocab: Vocabulary, desc: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """The (n_words,) BoW row of one descriptor set (``place.py:151-157``)."""
    return bow_vectors(vocab, desc[None], valid[None])[0]


def bow_scores(query: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score of ``query`` (W,) against each row of ``table``
    (K,W): sum_i min(q_i, t_i), in [0, 1]."""
    return torch.minimum(query[None, :], table).sum(dim=1)


def common_words(query: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(K,) count of the words ``query`` shares with each row."""
    return ((query[None, :] > 0) & (table > 0)).sum(dim=1)


def detect_candidates(query_bow: torch.Tensor, bow_table: torch.Tensor,
                      kf_valid: torch.Tensor, exclude: torch.Tensor,
                      covis: torch.Tensor, min_score: float,
                      top_k: int = 8):
    """Loop / relocalization candidates (``place.py:171-209``,
    KeyFrameDatabase.cpp:81-202): eligible keyframes share more than 0.8 of
    the best count of common words and score at least ``min_score``; each
    one's score is summed over its top-10 covisible group, groups above
    0.75 of the best sum are kept, and each kept group gives its
    best-scoring eligible member. ``exclude`` (K,) bool removes keyframes
    (the query's covisible set for loops, none for relocalization).

    Returns (cand_idx (top_k,) int64, cand_ok (top_k,) bool). Stable sorts
    stand where JAX ties go to the lower index (``argsort``, ``top_k``), and
    the group sum is a float32 product (TF32 is off in this package)."""
    K = bow_table.shape[0]
    dev = bow_table.device
    cw = common_words(query_bow, bow_table)
    eligible = kf_valid & ~exclude & (cw > 0)
    max_cw = torch.where(eligible, cw, torch.zeros_like(cw)).max()
    eligible &= cw > 0.8 * max_cw
    scores = bow_scores(query_bow, bow_table)
    eligible &= scores >= min_score
    # accumulate the scores over each keyframe's top-10 covisible group
    order = torch.sort(covis, dim=1, descending=True, stable=True)[1]
    nb_rank = order[:, :10]
    nb_mask = torch.zeros(K, K, dtype=torch.bool, device=dev).scatter_(
        1, nb_rank, torch.take_along_dim(covis, nb_rank, dim=1) > 0)
    nb_mask |= torch.eye(K, dtype=torch.bool, device=dev)
    s_elig = torch.where(eligible, scores, torch.zeros_like(scores))
    acc = nb_mask.to(torch.float32) @ s_elig
    acc = torch.where(eligible, acc, torch.full_like(acc, -1.0))
    ok = eligible & (acc > 0.75 * acc.max())
    # the best-scoring member of each accepted group, not its anchor
    member = torch.where(nb_mask & eligible[None, :], scores[None, :],
                         torch.full((), -1.0, device=dev))
    best_member = torch.argmax(member, dim=1)       # the first maximum
    val = torch.full((K,), -1.0, device=dev).scatter_reduce(
        0, torch.where(ok, best_member, torch.zeros_like(best_member)),
        torch.where(ok, acc, torch.full_like(acc, -1.0)), reduce="amax",
        include_self=True)
    top_val, top_idx = torch.sort(val, descending=True, stable=True)
    return top_idx[:top_k], top_val[:top_k] > 0
