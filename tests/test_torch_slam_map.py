"""Port parity for the map arena (``cubemapslam_tpu_torch.slam_map``).

Every case starts from one arena of the JAX package's
``dist.make_synthetic_arena`` at small size, with seeded pyramid levels,
descriptor noise, a dead keyframe, dead landmarks and shuffled frame ids so
that every mask and tie-break is exercised, carried across with
``interop.arena_from_numpy``.

Tolerances: the incidence, observation counts, covisibility, reference
keyframes, ``predict_scale`` and the redundancy scores are integers and
must be exactly equal;
the statistics updates give normals and depth bands within 1e-5 (float
sums in another order) and descriptors bitwise equal. The read-free
statistics over every slot of the observation table (at three block sizes
of the descriptor bits) are bitwise the compacted ones.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import dist as JD
from cubemapslam_tpu import slam_map as JSM
from cubemapslam_tpu.camera import CubemapCamera as JCamera
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch import slam_map as SM

SMALL = dict(cube_face_w=128, cube_face_h=128, n_features=256, n_levels=4)


@pytest.fixture(scope="module")
def arena_np():
    """The JAX synthetic arena as numpy leaves, roughened."""
    cfg = JConfig(**SMALL)
    a = JD.make_synthetic_arena(cfg, JCamera.from_config(cfg), n_kf=12,
                                n_pts=256, seed=3)
    f = {k: np.array(v) for k, v in a._asdict().items()}
    rng = np.random.default_rng(7)
    K, N = f["kf_valid"].shape[0], f["kf_uv"].shape[1]
    f["kf_level"] = rng.integers(0, 4, (K, N)).astype(np.int32)
    flips = rng.random((K, N, 8, 32)) < 0.15
    noise = (flips * (np.uint32(1) << np.arange(32, dtype=np.uint32))).sum(
        axis=-1).astype(np.uint32)
    f["kf_desc"] = f["kf_desc"] ^ noise
    f["kf_valid"][5] = False
    f["lm_valid"][rng.choice(256, 20, replace=False)] = False
    f["kf_frame_id"] = rng.permutation(K).astype(np.int32) * 3
    f["lm_first_kf"] = rng.integers(-1, K, f["lm_valid"].shape[0]).astype(
        np.int32)
    f["kf_kp_valid"][2, :40] = False
    return f


def jax_arena(f):
    return JSM.MapArena(**{k: jnp.asarray(v) for k, v in f.items()})


def test_make_arena_matches_jax():
    ours = interop.arena_to_numpy(SM.make_arena(5, 7, 11, "cpu"))
    ref = {k: np.asarray(v)
           for k, v in JSM.make_arena(5, 7, 11)._asdict().items()}
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    a = SM.make_arena(5, 7, 11, "cpu")
    assert (a.n_kf_cap, a.n_feat, a.n_lm_cap) == (5, 7, 11)
    assert a.lm_visible.dtype == torch.int64 and a.kf_desc.dtype == torch.int64


def test_arena_round_trip(arena_np):
    back = interop.arena_to_numpy(interop.arena_from_numpy(arena_np))
    for k, v in arena_np.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("what", ["incidence", "counts", "covisibility",
                                  "reference_keyframes"])
def test_graph_views_exact(arena_np, what):
    ja = jax_arena(arena_np)
    ta = interop.arena_from_numpy(arena_np)
    if what == "incidence":
        ref, ours = JSM.incidence_matrix(ja), SM.incidence_matrix(ta)
    elif what == "counts":
        ref, ours = JSM.observation_counts(ja), SM.observation_counts(ta)
    elif what == "covisibility":
        ref, ours = JSM.covisibility_matrix(ja), SM.covisibility_matrix(ta)
    else:
        K, N = ta.n_kf_cap, ta.n_feat
        jseg, jlive = JSM._flat_obs(ja)
        ref = JSM.reference_keyframes(
            ja, jseg, jlive, jnp.repeat(jnp.arange(K, dtype=jnp.int32), N))
        seg, live = SM._flat_obs(ta)
        ours = SM.reference_keyframes(
            ta, seg, live, torch.arange(K).repeat_interleave(N))
    ref = np.asarray(ref).astype(np.float64)
    assert ref.any()
    np.testing.assert_array_equal(ours.numpy().astype(np.float64), ref)


def _check_stats(ours: SM.MapArena, ref):
    o = interop.arena_to_numpy(ours)
    for k in ("lm_normal", "lm_min_dist", "lm_max_dist"):
        np.testing.assert_allclose(o[k], np.asarray(getattr(ref, k)),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(o["lm_desc"], np.asarray(ref.lm_desc))


def test_update_landmark_stats(arena_np):
    sf = np.asarray(JConfig(**SMALL).scale_factors, np.float32)
    ref = JSM.update_landmark_stats(jax_arena(arena_np), jnp.asarray(sf))
    ta = interop.arena_from_numpy(arena_np)
    out = SM.update_landmark_stats(ta, torch.as_tensor(sf))
    assert out is ta                      # in place
    _check_stats(ta, ref)
    assert not np.array_equal(np.asarray(ref.lm_desc), arena_np["lm_desc"])


@pytest.mark.parametrize("block", [None, 1000, SM.STATS_ROW_BLOCK])
def test_update_landmark_stats_all_bitwise(arena_np, block, monkeypatch):
    """The read-free form over every slot of the observation table, its
    descriptor bits unpacked ``block`` rows at a time (all at once for
    None), bitwise equal to ``update_landmark_stats`` (the live rows
    compacted by a host read), from cleared statistics and with a fifth of
    the observations dead; it calls no ``nonzero``."""
    sf = torch.as_tensor(np.asarray(JConfig(**SMALL).scale_factors,
                                    np.float32))
    base = interop.arena_from_numpy(arena_np)
    dead = torch.as_tensor(np.random.default_rng(6).random(
        base.kf_obs_lm.shape) < 0.2)
    base.kf_obs_lm.masked_fill_(dead, SM.NO_LM)
    for t in (base.lm_normal, base.lm_min_dist, base.lm_max_dist,
              base.lm_desc):
        t.zero_()
    ref = SM.MapArena(*(x.clone() for x in base))
    SM.update_landmark_stats(ref, sf)

    def no_read(*args, **kwargs):
        raise AssertionError("nonzero reads the host")

    monkeypatch.setattr(torch.Tensor, "nonzero", no_read)
    monkeypatch.setattr(SM, "STATS_ROW_BLOCK", block)
    out = SM.update_landmark_stats_all(base, sf)
    assert out is base
    for name in ("lm_normal", "lm_min_dist", "lm_max_dist", "lm_desc"):
        a, b = getattr(base, name), getattr(ref, name)
        assert a.numpy().tobytes() == b.numpy().tobytes(), name
    assert (ref.lm_desc != 0).any()


@pytest.mark.parametrize("max_touched,max_obs",
                         [(16384, 131072), (40, 4000), (16384, 300)])
def test_update_landmark_stats_touched(arena_np, max_touched, max_obs):
    """The second case overflows the touched set, the third the
    observations (every landmark's list is cut, so none is written)."""
    sf = np.asarray(JConfig(**SMALL).scale_factors, np.float32)
    touched = np.random.default_rng(5).random(
        arena_np["lm_valid"].shape[0]) < 0.4
    ref = JSM.update_landmark_stats_touched(
        jax_arena(arena_np), jnp.asarray(sf), jnp.asarray(touched),
        max_touched=max_touched, max_obs=max_obs)
    ta = interop.arena_from_numpy(arena_np)
    SM.update_landmark_stats_touched(ta, torch.as_tensor(sf),
                                     torch.as_tensor(touched),
                                     max_touched=max_touched,
                                     max_obs=max_obs)
    _check_stats(ta, ref)
    changed = np.any(np.asarray(ref.lm_normal) != arena_np["lm_normal"],
                     axis=1)
    assert changed.sum() <= min(max_touched, touched.sum())
    assert (changed.sum() > 0) == (max_obs > 300)


def test_predict_scale_exact():
    rng = np.random.default_rng(2)
    dist = rng.uniform(0.5, 12.0, 4096).astype(np.float32)
    max_dist = rng.uniform(0.5, 12.0, 4096).astype(np.float32)
    log_s = float(np.log(np.float32(1.2)))
    ref = JSM.predict_scale(jnp.asarray(dist), jnp.asarray(max_dist), log_s,
                            8)
    ours = SM.predict_scale(torch.as_tensor(dist), torch.as_tensor(max_dist),
                            log_s, 8)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert len(np.unique(np.asarray(ref))) == 8


def test_redundant_keyframe_scores_exact(arena_np):
    n_red, n_tot = SM.redundant_keyframe_scores(
        interop.arena_from_numpy(arena_np))
    j_red, j_tot = JSM.redundant_keyframe_scores(jax_arena(arena_np))
    np.testing.assert_array_equal(n_red.numpy(), np.asarray(j_red))
    np.testing.assert_array_equal(n_tot.numpy(), np.asarray(j_tot))
    # both outcomes occur on this arena
    assert 0 < int(n_red.sum()) < int(n_tot.sum())
