"""Port parity: place recognition (``cubemapslam_tpu_torch/place.py``)
against ``cubemapslam_tpu/place.py``.

* The vocabulary trainer, a numpy copy, is bit-identical on seeded
  descriptors (k=4, depth 3): every level's centers and the idf.
* ``word_ids`` is exactly equal with the repo's pretrained vocabulary
  (``artifacts/vocab_synth_10k.npz``, k=10, depth 4) on 500 seeded
  descriptors; ``bow_vector``, ``bow_scores`` and ``common_words`` within
  1e-6 (the L1 normalization sums in another order).
* ``detect_candidates`` returns the same candidate slots and flags on a
  seeded K=32 table whose covisibility has ties: one query's keyframes are
  perturbed copies of it, so the kept groups sit far from the 0.75 and 0.8
  thresholds.
* A vocabulary saved by either package loads in the other.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import place as JP
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch import place as TP

ARTIFACT = pathlib.Path(__file__).resolve().parents[1] / "artifacts" / \
    "vocab_synth_10k.npz"


def rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def perturb(desc, rng, k):
    out = desc.copy()
    for i in range(len(out)):
        for _ in range(k):
            out[i, rng.integers(0, 8)] ^= np.uint32(1) << np.uint32(
                rng.integers(0, 32))
    return out


def words(d):
    return interop.desc_from_numpy(d)


@pytest.fixture(scope="module")
def vocabs():
    return (JP.load_vocabulary(str(ARTIFACT)),
            TP.load_vocabulary(str(ARTIFACT), "cpu"))


def test_trainer_bit_identical():
    desc = rand_desc(np.random.default_rng(0), 700)
    vj = JP.train_vocabulary(desc, k=4, depth=3, seed=3)
    vt = TP.train_vocabulary(desc, k=4, depth=3, seed=3, device="cpu")
    assert vt.n_words == vj.n_words == 64
    tn = interop.vocab_to_numpy(vt)
    for cj, ct in zip(vj.centers, tn["centers"]):
        assert ct.dtype == np.uint32
        np.testing.assert_array_equal(ct, np.asarray(cj))
    np.testing.assert_array_equal(tn["idf"], np.asarray(vj.idf))


def test_word_ids_exact(vocabs):
    vj, vt = vocabs
    desc = rand_desc(np.random.default_rng(1), 500)
    # near-copies of centers too, where children tie more often
    near = perturb(np.asarray(vj.centers[-1])[:100], np.random.default_rng(2),
                   3)
    for d in (desc, near):
        np.testing.assert_array_equal(
            TP.word_ids(vt, words(d)).numpy(),
            np.asarray(JP.word_ids(vj, jnp.asarray(d))))


def test_bow_vector_scores_common_words(vocabs):
    vj, vt = vocabs
    rng = np.random.default_rng(3)
    sets = [rand_desc(rng, 400)]
    sets.append(perturb(sets[0], rng, 4))
    sets += [rand_desc(rng, 400) for _ in range(3)]
    valid = rng.uniform(size=(len(sets), 400)) < 0.9
    bj = np.stack([np.asarray(JP.bow_vector(vj, jnp.asarray(d),
                                            jnp.asarray(v)))
                   for d, v in zip(sets, valid)])
    bt = torch.stack([TP.bow_vector(vt, words(d), torch.as_tensor(v))
                      for d, v in zip(sets, valid)])
    np.testing.assert_allclose(bt.numpy(), bj, atol=1e-6)
    # the batched rows are the same rows
    np.testing.assert_allclose(
        TP.bow_vectors(vt, words(np.stack(sets)), torch.as_tensor(valid))
        .numpy(), bt.numpy(), atol=1e-7)
    sj = np.asarray(JP.bow_scores(jnp.asarray(bj[0]), jnp.asarray(bj)))
    st = TP.bow_scores(bt[0], bt).numpy()
    np.testing.assert_allclose(st, sj, atol=1e-6)
    assert abs(st[0] - 1.0) < 1e-5 and st[1] > st[2]
    np.testing.assert_array_equal(
        TP.common_words(bt[0], bt).numpy(),
        np.asarray(JP.common_words(jnp.asarray(bj[0]), jnp.asarray(bj))))


@pytest.mark.parametrize("exclude_some", [False, True])
def test_detect_candidates(vocabs, exclude_some):
    vj, vt = vocabs
    rng = np.random.default_rng(4)
    K = 32
    query = rand_desc(rng, 300)
    kf = [rand_desc(rng, 300) for _ in range(K)]
    for s, flips in ((5, 1), (6, 2), (17, 1), (23, 2)):
        kf[s] = perturb(query, rng, flips)
    table = np.stack([np.asarray(JP.bow_vector(vj, jnp.asarray(d),
                                               jnp.ones(300, bool)))
                      for d in kf])
    table[30:] = 0.0                          # two empty slots
    qb = np.asarray(JP.bow_vector(vj, jnp.asarray(perturb(query, rng, 1)),
                                  jnp.ones(300, bool)))
    kf_valid = np.ones(K, bool)
    kf_valid[[30, 31, 11]] = False
    # covisibility with ties: small integer weights, symmetric
    covis = rng.integers(0, 4, (K, K)).astype(np.int32)
    covis = np.triu(covis, 1)
    covis = covis + covis.T
    covis[5, 6] = covis[6, 5] = 40            # two groups: 5 and 6,
    covis[17, 23] = covis[23, 17] = 40        # 17 and 23
    exclude = np.zeros(K, bool)
    if exclude_some:
        exclude[[17, 2]] = True            # 23 alone: one group left
    idx_j, ok_j = JP.detect_candidates(
        jnp.asarray(qb), jnp.asarray(table), jnp.asarray(kf_valid),
        jnp.asarray(exclude), jnp.asarray(covis), jnp.float32(0.0))
    idx_t, ok_t = TP.detect_candidates(
        torch.as_tensor(qb), torch.as_tensor(table),
        torch.as_tensor(kf_valid), torch.as_tensor(exclude),
        torch.as_tensor(covis.astype(np.int64)), 0.0)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(idx_t.numpy()[ok_j],
                                  np.asarray(idx_j)[ok_j])
    assert ok_j.sum() >= (1 if exclude_some else 2)
    assert set(np.asarray(idx_j)[ok_j]) <= {5, 6, 17, 23}


def test_vocabulary_files_cross(tmp_path):
    desc = rand_desc(np.random.default_rng(5), 600)
    vj = JP.train_vocabulary(desc, k=5, depth=2, seed=1)
    vt = TP.train_vocabulary(desc, k=5, depth=2, seed=2, device="cpu")
    JP.save_vocabulary(vj, str(tmp_path / "jax.npz"))
    TP.save_vocabulary(vt, str(tmp_path / "torch.npz"))
    from_j = TP.load_vocabulary(str(tmp_path / "jax.npz"), "cpu")
    from_t = JP.load_vocabulary(str(tmp_path / "torch.npz"))
    q = rand_desc(np.random.default_rng(6), 200)
    np.testing.assert_array_equal(
        TP.word_ids(from_j, words(q)).numpy(),
        np.asarray(JP.word_ids(vj, jnp.asarray(q))))
    np.testing.assert_array_equal(
        np.asarray(JP.word_ids(from_t, jnp.asarray(q))),
        TP.word_ids(vt, words(q)).numpy())
    assert from_t.k == 5 and from_t.depth == 2
    np.testing.assert_array_equal(np.asarray(from_t.idf), vt.idf.numpy())
