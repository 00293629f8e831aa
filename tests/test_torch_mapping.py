"""Port parity: local mapping (``MappingKernels``) and ``apply_redirect``.

The map is the port's own: ``CubemapSLAM`` on the CPU runs 9 rendered
fisheye frames of a forward trajectory through a seeded billboard world
at the small configuration of ``tests/test_e2e.py`` (160^2 faces, 600
features, 3 levels, K=24, L=4096), and the arena is taken just before its
last mapping step (the new keyframe in slot 5, 6 keyframes live). Both
packages then run each stage on that arena (``interop.arena_to_numpy``).

Tolerances. Without BA every table is exactly equal (the integer views,
descriptors, and the float tables to 1e-5). After ``local_ba`` or
``ba_step`` the integer views and the descriptors are still exactly equal
but for the observation table, where the BA's chi2 cut may flip an edge at
its threshold (at most 2 or 0.5% of the live observations), and the
descriptors of a flipped edge's landmarks. Keyframe poses within 1e-4;
every landmark that 2 or more live keyframes observe points the same way
from each of them within 2e-3 rad (0.16 px at this face's focal length)
and lies within 2e-3 of JAX's for 99% of them and 2e-2 for all (its depth
bands within 3e-2): float32 LM over 15 iterations rounds differently in
the two packages. ``mapping_step`` with its BA is held more loosely, for
the reason its test gives. These runs use a BA window of 5 cameras.

``mapping_step`` and ``ba_step`` also take the slot, the keyframe counter
and the frame id as 0-d tensors (as the captured mapping graphs give them):
every table and the diagnostics bitwise the calls with ints, and against
JAX at the same tolerances.

On the card ``mapping_step`` triangulates and gates its 6 neighbours in
one ``triangulate_gated`` launch; here that branch runs on the CPU (its
device condition lifted by a monkeypatch, the launch's plain version
``triangulate_gated_ordered`` in the kernel's order), held to JAX as
``test_mapping_step`` holds the pair-by-pair path, and to that path:
the same diagnostics and integer tables.

``fuse_pair``'s rule for duplicate scatter indices differs from the JAX
package's (a merge's write wins; of two merges with one loser, the later
row): the parity arena has no merge whose loser is landmark 0, and
``test_fuse_pair_merge_rule`` holds the rule itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import slam_map as JSM
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.runtime.mapping import MappingKernels as JMK
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime import mapping as TMAP
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM

E2E = dict(cube_face_w=160, cube_face_h=160, n_features=600, n_levels=3,
           max_keyframes=24, max_landmarks=4096, min_init_keypoints=80,
           min_init_matches=60, min_track_inliers=20, fps=5.0)
INTEGER = ("kf_valid", "kf_frame_id", "kf_face", "kf_level", "kf_desc",
           "kf_kp_valid", "kf_obs_lm", "lm_valid", "lm_desc", "lm_visible",
           "lm_found", "lm_first_kf", "lm_birth", "lm_first_frame")
MAX_CAMS = 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores, where more
    threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def snap():
    """The arena before the last mapping step of a 9-frame run, with that
    step's (slot, keyframe counter, frame id)."""
    poses = S.forward_trajectory(9)
    world = S.make_world(np.random.default_rng(5), n=600,
                         centers=S.camera_centres(poses), fx=80.0)
    arena, slot, n_kf, fid = S.arena_before_last_mapping(
        CubemapSLAM(TConfig(**E2E), device="cpu"), world, poses)
    arena = interop.arena_to_numpy(arena)
    jcfg = JConfig(**E2E)
    return dict(arena=arena, slot=slot, n_kf=n_kf, fid=fid,
                jm=JMK(jcfg, JCam.from_config(jcfg)),
                tm=MappingKernels(TConfig(**E2E), device="cpu"))


@pytest.fixture(scope="module")
def jax_results():
    """The JAX calls' results, shared by the tests that hold the port's
    int and tensor calls against them."""
    return {}


def jax_mapping_step(snap, cache, run_ba):
    key = ("mapping_step", run_ba)
    if key not in cache:
        cache[key] = snap["jm"].mapping_step(
            ja(snap["arena"]), jnp.int32(snap["slot"]),
            jnp.int32(snap["n_kf"]), jnp.int32(snap["fid"]),
            max_cams=MAX_CAMS, run_ba=run_ba)
    return cache[key]


def culled_arena(snap, culled):
    arena = dict(snap["arena"])
    if culled:
        arena["kf_valid"] = arena["kf_valid"].copy()
        arena["kf_valid"][snap["slot"]] = False
    return arena


def jax_ba_step(snap, cache, culled):
    key = ("ba_step", culled)
    if key not in cache:
        cache[key] = snap["jm"].ba_step(ja(culled_arena(snap, culled)),
                                        jnp.int32(snap["slot"]),
                                        max_cams=MAX_CAMS)
    return cache[key]


def device_scalars(*xs):
    return tuple(torch.tensor(x, dtype=torch.int64) for x in xs)


def assert_same_arena(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def ja(arena):
    return JSM.MapArena(**{k: jnp.asarray(v) for k, v in arena.items()})


def ta(arena):
    return interop.arena_from_numpy(arena)


def assert_arena(t_arena, j_arena, after_ba=False):
    t = interop.arena_to_numpy(t_arena)
    j = {k: np.asarray(v) for k, v in j_arena._asdict().items()}
    # BA's chi2 cut may flip an observation at its threshold; the landmarks
    # of a flipped edge may then differ in their descriptor and statistics
    diff = t["kf_obs_lm"] != j["kf_obs_lm"]
    assert diff.sum() <= (max(2, 0.005 * (j["kf_obs_lm"] >= 0).sum())
                          if after_ba else 0)
    flipped = np.zeros(len(t["lm_valid"]), bool)
    for lm in (t["kf_obs_lm"][diff], j["kf_obs_lm"][diff]):
        flipped[lm[lm >= 0]] = True
    for k in INTEGER:
        if k == "kf_obs_lm":
            continue
        a, b = (t[k], j[k]) if k != "lm_desc" else (t[k][~flipped],
                                                      j[k][~flipped])
        np.testing.assert_array_equal(a, b, err_msg=k)
    if not after_ba:
        for k in t:
            np.testing.assert_allclose(t[k], j[k], atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        return
    for k in ("kf_R", "kf_t"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-4, err_msg=k)
    obs = t["kf_obs_lm"][t["kf_valid"]]
    obs = obs[obs >= 0]
    held = (np.bincount(obs, minlength=len(t["lm_valid"])) >= 2) \
        & t["lm_valid"] & ~flipped
    assert held.sum() > 100
    # the direction of each landmark from every keyframe that observes it
    worst = np.zeros(len(held))
    for k in np.nonzero(t["kf_valid"])[0]:
        lm = t["kf_obs_lm"][k]
        lm = lm[(lm >= 0) & held[np.maximum(lm, 0)]]
        a = t["lm_pos"][lm] @ t["kf_R"][k].T + t["kf_t"][k]
        b = j["lm_pos"][lm] @ j["kf_R"][k].T + j["kf_t"][k]
        cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) \
            / np.linalg.norm(b, axis=1)
        worst[lm] = np.maximum(worst[lm], np.arccos(np.clip(cos, -1, 1)))
    assert worst.max() < 2e-3, worst.max()
    d = np.abs(t["lm_pos"] - j["lm_pos"]).max(axis=1)[held]
    assert np.quantile(d, 0.99) < 2e-3 and d.max() < 2e-2, d.max()
    for k in ("lm_min_dist", "lm_max_dist"):
        np.testing.assert_allclose(t[k][held], j[k][held], rtol=0,
                                   atol=3e-2, err_msg=k)


def test_apply_redirect():
    rng = np.random.default_rng(0)
    arena = {k: v for k, v in interop.arena_to_numpy(
        SM.make_arena(4, 32, 64, "cpu")).items()}
    arena["kf_obs_lm"] = rng.integers(-1, 64, (4, 32)).astype(np.int32)
    red = np.arange(64, dtype=np.int32)
    red[rng.integers(0, 64, 10)] = rng.integers(0, 64, 10)
    out = SM.apply_redirect(ta(arena), torch.as_tensor(red.astype(np.int64)))
    ref = JSM.apply_redirect(ja(arena), jnp.asarray(red))
    np.testing.assert_array_equal(out.kf_obs_lm.numpy(),
                                  np.asarray(ref.kf_obs_lm))


def test_map_is_a_mapping_case(snap):
    a = snap["arena"]
    assert snap["slot"] == 5 and a["kf_valid"].sum() == 6
    assert (a["kf_obs_lm"][snap["slot"]] < 0).sum() > 100   # free features


def test_cull_map_points(snap):
    t, nt = snap["tm"].cull_map_points(ta(snap["arena"]), snap["n_kf"])
    j, nj = snap["jm"].cull_map_points(ja(snap["arena"]),
                                       jnp.int32(snap["n_kf"]))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert_arena(t, j)
    assert int(np.asarray(nj).sum()) > 0


@pytest.mark.parametrize("back", [1, 2])
def test_triangulate_with_neighbor(snap, back):
    slot = snap["slot"]
    Xt, okt, idxt, cost, gt = snap["tm"].triangulate_with_neighbor(
        ta(snap["arena"]), slot, slot - back)
    Xj, okj, idxj, cosj, gj = snap["jm"].triangulate_with_neighbor(
        ja(snap["arena"]), jnp.int32(slot), jnp.int32(slot - back))
    okj = np.asarray(okj)
    assert okj.sum() > 20
    np.testing.assert_array_equal(okt.numpy(), okj)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(idxt.numpy()[okj], np.asarray(idxj)[okj])
    np.testing.assert_allclose(Xt.numpy()[okj], np.asarray(Xj)[okj],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cosj), atol=1e-6)


def candidates(snap, nbs):
    """Stacked triangulation candidates of the new keyframe against
    ``nbs`` (the port's, which the test above holds to JAX), with at most
    one neighbour per feature."""
    slot, tm = snap["slot"], snap["tm"]
    out = [tm.triangulate_with_neighbor(ta(snap["arena"]), slot, int(nb))
           for nb in nbs]
    Xw, ok, idx2 = (torch.stack([o[i] for o in out]).numpy()
                    for i in range(3))
    first = np.cumsum(ok, axis=0) == 1
    return Xw, ok & first, idx2


def test_commit_new_landmarks_multi(snap):
    slot = snap["slot"]
    nbs = np.array([slot - 1, slot - 2, slot - 3], np.int32)
    Xw, ok, idx2 = candidates(snap, nbs)
    assert ok.sum() > 50
    t, nt = snap["tm"].commit_new_landmarks_multi(
        ta(snap["arena"]), slot, torch.as_tensor(nbs.astype(np.int64)),
        torch.as_tensor(Xw), torch.as_tensor(ok), torch.as_tensor(idx2),
        snap["n_kf"] - 1, snap["fid"])
    j, nj = snap["jm"].commit_new_landmarks_multi(
        ja(snap["arena"]), jnp.int32(slot), jnp.asarray(nbs),
        jnp.asarray(Xw), jnp.asarray(ok), jnp.asarray(idx2.astype(np.int32)),
        jnp.int32(snap["n_kf"] - 1), jnp.int32(snap["fid"]))
    assert int(nt) == int(nj) == ok.sum()
    assert_arena(t, j)


def test_commit_new_landmarks(snap):
    slot = snap["slot"]
    Xw, ok, idx2 = candidates(snap, [slot - 1])
    args = (Xw[0], ok[0], idx2[0])
    t, nt = snap["tm"].commit_new_landmarks(
        ta(snap["arena"]), slot, slot - 1, *map(torch.as_tensor, args),
        snap["n_kf"] - 1, snap["fid"])
    j, nj = snap["jm"].commit_new_landmarks(
        ja(snap["arena"]), slot, slot - 1, jnp.asarray(args[0]),
        jnp.asarray(args[1]), jnp.asarray(args[2].astype(np.int32)),
        snap["n_kf"] - 1, snap["fid"])
    assert int(nt) == int(nj) > 20
    assert_arena(t, j)


@pytest.mark.parametrize("pair", [(0, 1), (1, 0), (0, 2)])
@pytest.mark.parametrize("defer", [False, True])
def test_fuse_pair(snap, pair, defer):
    """Slots (new, new - 1) both ways, and (new, new - 2)."""
    slot = snap["slot"]
    src, dst = (slot - pair[0], slot - pair[1])
    cnt = SM.observation_counts(ta(snap["arena"]))
    t = snap["tm"].fuse_pair(ta(snap["arena"]), src, dst, cnt=cnt,
                             defer_redirect=defer)
    j = snap["jm"].fuse_pair(ja(snap["arena"]), jnp.int32(src),
                             jnp.int32(dst),
                             cnt=jnp.asarray(cnt.numpy().astype(np.int32)),
                             defer_redirect=defer)
    if defer:
        (t, rt), (j, rj) = t, j
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        assert int(rt[0]) == 0          # landmark 0 is no merge's loser
    assert_arena(t, j)
    before = snap["arena"]["kf_obs_lm"][dst]
    changed = (interop.arena_to_numpy(t)["kf_obs_lm"][dst] != before).sum()
    merged = (~interop.arena_to_numpy(t)["lm_valid"]
              & snap["arena"]["lm_valid"]).sum()
    assert changed + merged > 0


def test_fuse_pair_merge_rule():
    """The rule where the JAX package leaves duplicate scatter indices to
    scatter order: landmark 0 as a merge's loser is redirected and killed
    (a non-merge row never overwrites it), and of two merges with one loser
    (landmark 7, held by source features 1 and 2) the later row wins."""
    K, N, L = 2, 3, 16
    a = SM.make_arena(K, N, L, "cpu")
    rays = torch.tensor([[0.0, 0.0, 1.0], [0.3, 0.0, 0.954],
                         [0.0, 0.3, 0.954]])
    rays = rays / rays.norm(dim=1, keepdim=True)
    desc = torch.as_tensor(np.random.default_rng(1).integers(
        0, 2 ** 32, (N, 8)).astype(np.int64))
    for k in range(K):
        a.kf_valid[k] = True
        a.kf_rays[k] = rays
        a.kf_desc[k] = desc
        a.kf_kp_valid[k] = True
        a.kf_face[k] = 0
    # source features observe (5, 7, 7); target features (0, 8, 9)
    a.kf_obs_lm[0] = torch.tensor([5, 7, 7])
    a.kf_obs_lm[1] = torch.tensor([0, 8, 9])
    src_lm = {0: 5, 1: 7, 2: 7}
    for i, lm in list(src_lm.items()) + [(0, 0), (1, 8), (2, 9)]:
        a.lm_pos[lm] = rays[i] * 5.0
        a.lm_desc[lm] = desc[i]
    for lm in (0, 5, 7, 8, 9):
        a.lm_valid[lm] = True
        a.lm_max_dist[lm] = 5.0
        a.lm_min_dist[lm] = 1.0
    cnt = torch.zeros(L, dtype=torch.int64)
    cnt[torch.tensor([5, 8, 9])] = 3            # they win; 0 and 7 lose
    cnt[torch.tensor([0, 7])] = 1
    cfg = TConfig(cube_face_w=128, cube_face_h=128, n_features=N,
                  n_levels=4, max_keyframes=K, max_landmarks=L)
    mk = MappingKernels(cfg, device="cpu")
    a, red = mk.fuse_pair(a, 0, 1, cnt=cnt, defer_redirect=True)
    assert int(red[0]) == 5 and not bool(a.lm_valid[0])
    assert int(red[7]) == 9 and not bool(a.lm_valid[7])
    assert bool(a.lm_valid[5]) and bool(a.lm_valid[8])
    assert bool(a.lm_valid[9])
    keep = [i for i in range(L) if i not in (0, 7)]
    assert red[keep].tolist() == keep


def test_local_ba(snap):
    slot = snap["slot"]
    t, touched_t = snap["tm"].local_ba(ta(snap["arena"]), slot, MAX_CAMS)
    j, touched_j = snap["jm"].local_ba(ja(snap["arena"]), slot, MAX_CAMS)
    np.testing.assert_array_equal(touched_t.numpy(), np.asarray(touched_j))
    assert_arena(t, j, after_ba=True)
    assert not np.array_equal(interop.arena_to_numpy(t)["kf_R"],
                              snap["arena"]["kf_R"])


@pytest.mark.parametrize("run_ba", [False, True])
def test_mapping_step(snap, jax_results, run_ba):
    """Without BA, every table exactly equal. With BA (run on the arena
    the step has just grown by a hundred two-view landmarks) the JAX
    package's own result changes with the number of CPU cores it runs on:
    its LM accepts or rejects each step on a float32 cost sum, and these
    new, weakly held landmarks let the two paths part. So the step is held
    to what that leaves: the diagnostics but the new keyframe's live count
    exactly, keyframes and landmark flags and counters exactly, at most 5%
    of the live observations cut differently, poses within 2e-2. The BA
    itself is held tightly by ``test_local_ba`` and ``test_ba_step``."""
    slot, n_kf, fid = snap["slot"], snap["n_kf"], snap["fid"]
    t, info_t = snap["tm"].mapping_step(ta(snap["arena"]), slot, n_kf, fid,
                                        max_cams=MAX_CAMS, run_ba=run_ba)
    check_mapping_step(t, info_t, *jax_mapping_step(snap, jax_results,
                                                    run_ba), run_ba)


def check_mapping_step(t, info_t, j, info_j, run_ba):
    """``test_mapping_step``'s comparison of the port's step with JAX's."""
    info_j, info_t = np.asarray(info_j), info_t.numpy()
    assert info_j[2] > 50                     # n_new: triangulated
    if not run_ba:
        np.testing.assert_array_equal(info_t, info_j)
        assert_arena(t, j)
        return
    exact = [i for i in range(12) if i != 4]  # 4: the new row's live count
    np.testing.assert_array_equal(info_t[exact], info_j[exact])
    tn = interop.arena_to_numpy(t)
    jn = {k: np.asarray(v) for k, v in j._asdict().items()}
    for k in INTEGER:
        if k not in ("kf_obs_lm", "lm_desc"):
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
    live = (jn["kf_obs_lm"] >= 0).sum()
    assert (tn["kf_obs_lm"] != jn["kf_obs_lm"]).sum() <= 0.05 * live
    for k in ("kf_R", "kf_t"):
        np.testing.assert_allclose(tn[k], jn[k], atol=2e-2, err_msg=k)


@pytest.mark.parametrize("slots", ["ints", "tensors"])
def test_mapping_step_one_launch(snap, jax_results, slots, monkeypatch):
    """The card's branch of ``mapping_step`` (the pairs' searches, one
    ``triangulate_gated`` call for all neighbours) run on the CPU, without
    BA, with the slot, counter and frame id as ints and as 0-d tensors:
    against JAX as ``test_mapping_step`` holds it (every table, the
    diagnostics exactly), and against the pair-by-pair CPU path (the same
    diagnostics, the same integer tables)."""
    args = (snap["slot"], snap["n_kf"], snap["fid"])
    pair, info_pair = snap["tm"].mapping_step(ta(snap["arena"]), *args,
                                              max_cams=MAX_CAMS, run_ba=False)
    calls = []
    inner = TMAP.triangulate_gated

    def counted(*a):
        calls.append(a[3].shape)
        return inner(*a)

    monkeypatch.setattr(TMAP, "_one_launch_gates", lambda device: True)
    monkeypatch.setattr(TMAP, "triangulate_gated", counted)
    if slots == "tensors":
        args = device_scalars(*args)
    t, info_t = snap["tm"].mapping_step(ta(snap["arena"]), *args,
                                        max_cams=MAX_CAMS, run_ba=False)
    assert calls == [(6, E2E["n_features"])]
    assert torch.equal(info_t, info_pair)
    for k in INTEGER:
        assert torch.equal(getattr(t, k), getattr(pair, k)), k
    check_mapping_step(t, info_t, *jax_mapping_step(snap, jax_results,
                                                    False), False)


@pytest.mark.parametrize("run_ba", [False, True])
def test_mapping_step_device_scalars(snap, jax_results, run_ba):
    """The slot, keyframe counter and frame id as 0-d tensors: every table
    and the diagnostics bitwise the call with ints, and against JAX as
    ``test_mapping_step`` holds it."""
    args = (snap["slot"], snap["n_kf"], snap["fid"])
    outs = [snap["tm"].mapping_step(ta(snap["arena"]), *a, max_cams=MAX_CAMS,
                                    run_ba=run_ba)
            for a in (args, device_scalars(*args))]
    (t_int, info_int), (t, info_t) = outs
    assert_same_arena(t_int, t)
    assert torch.equal(info_int, info_t)
    check_mapping_step(t, info_t, *jax_mapping_step(snap, jax_results,
                                                    run_ba), run_ba)


@pytest.mark.parametrize("culled", [False, True])
def test_ba_step(snap, jax_results, culled):
    """On the new keyframe, and on a slot culled meanwhile (a no-op)."""
    arena = culled_arena(snap, culled)
    t = snap["tm"].ba_step(ta(arena), snap["slot"], max_cams=MAX_CAMS)
    check_ba_step(t, jax_ba_step(snap, jax_results, culled), arena, culled)


def check_ba_step(t, j, arena, culled):
    """``test_ba_step``'s comparison of the port's step with JAX's."""
    assert_arena(t, j, after_ba=not culled)
    if culled:
        for k, v in interop.arena_to_numpy(t).items():
            np.testing.assert_array_equal(v, arena[k], err_msg=k)


@pytest.mark.parametrize("culled", [False, True])
def test_ba_step_device_scalars(snap, jax_results, culled):
    """The slot as a 0-d tensor, on the new keyframe and on a culled slot:
    every table bitwise the call with an int, and against JAX as
    ``test_ba_step`` holds it."""
    arena = culled_arena(snap, culled)
    t_int = snap["tm"].ba_step(ta(arena), snap["slot"], max_cams=MAX_CAMS)
    t = snap["tm"].ba_step(ta(arena), *device_scalars(snap["slot"]),
                           max_cams=MAX_CAMS)
    assert_same_arena(t_int, t)
    check_ba_step(t, jax_ba_step(snap, jax_results, culled), arena, culled)


def test_cull_keyframes(snap):
    """Three copies of keyframe 2 make redundant keyframes: culled one at
    a time, the redundancy recomputed between culls."""
    arena, slot = dict(snap["arena"]), snap["slot"]
    arena = {k: v.copy() for k, v in arena.items()}
    for i, dst in enumerate((6, 7, 8)):
        for k in arena:
            if k.startswith("kf_"):
                arena[k][dst] = arena[k][2]
        arena["kf_frame_id"][dst] = 20 + i
    t, nt = snap["tm"].cull_keyframes(ta(arena), slot)
    j, nj = snap["jm"].cull_keyframes(ja(arena), slot)
    assert int(nt) == int(nj) >= 2
    np.testing.assert_array_equal(t.kf_valid.numpy(), np.asarray(j.kf_valid))


@pytest.mark.parametrize("back", [1, 3])
def test_keyframe_views_and_relative_geometry(snap, back):
    """``_kf_keypoints`` and ``_relative_geometry`` of (new, new - back):
    the keypoint view exactly equal, R21 / t21 / E12 within 1e-6."""
    from cubemapslam_tpu.runtime import mapping as JMAP
    from cubemapslam_tpu_torch.runtime import mapping as TMAP
    slot, a = snap["slot"], snap["arena"]
    kt = TMAP._kf_keypoints(ta(a), slot - back)
    kj = JMAP._kf_keypoints(ja(a), slot - back)
    for name, x in interop.keypoints_to_numpy(kt).items():
        np.testing.assert_array_equal(x, np.asarray(getattr(kj, name)),
                                      err_msg=name)
    gt = TMAP._relative_geometry(ta(a), slot, slot - back)
    gj = JMAP._relative_geometry(ja(a), slot, slot - back)
    for x, y in zip(gt, gj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
