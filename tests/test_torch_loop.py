"""Port parity: loop closing (``runtime/loop_closing.py``).

One constructed-drift arena at the small configuration of
``tests/test_loop.py`` (K=64, N=600, L=8192; 14 keyframes, segment B under
a Sim3 drift) is built with the port's ``synthetic.build_drifted_loop_arena``
and carried to JAX (``interop.arena_to_numpy``), with its landmark
statistics computed so that the projection stages have depth bands. Every
``LoopKernels`` stage runs on it in both packages, with the current keyframe
13, the loop keyframe 3 and the true S_cl = (1.06, I, 0) perturbed by about
0.3%; the stages after the Sim3 refinement take JAX's refined S_cl in both
packages. The refinement's scale is free on this exact scene (t = 0), so it
is held to 0.1, its R and t to 1e-4. Tolerances: integer outputs and
integer arena tables exactly equal, floats within 1e-4, but for the
landmark positions after the pose graph, within 1e-4 + 3e-4 of their
distance from the origin: each moves with its keyframe's Sim3, whose scale
agrees within 1e-4 (the Sim3 log/exp chain and the LU solve of the dense
normal matrix round differently in float32). The JAX package leaves
the redirect of a merge whose loser is landmark 0 to scatter order; the
port's rule (a merge's write wins; of two merges with one loser, the later
row) is held by ``test_loser_zero_rule``, and the parity arena has no such
merge. The consistency bookkeeping of ``process`` is held on fed candidate
groups, and the constructed-drift closure of ``tests/test_loop.py:173-208``
(slow-marked there) to its outcome: closed, segment-B error below 0.6 of its
value before. The same closure with the solvers' iterations through
``CapturedLoop`` (the default), with ``LoopCloser.graphs`` off and with a
system's ``stage_times`` set: every arena table bitwise the closure with
the loops as they were (``tests/torch_parent_loops.py``), and no
``CapturedLoop`` made under the eager switch. The stages of DetectLoop and
ComputeSim3 with each slot as a 0-d tensor (what ``FusedLoop``'s graphs
pass) bitwise equal to the calls with Python ints. The closure and
``_compute_sim3`` through ``FusedLoop`` (its card condition lifted, so its
graphs D, M and S run eagerly on their static buffers): bitwise equal to
the eager path, with the generator in the same state and two reads fewer;
a replaced arena or BoW table raises; ``CubemapSLAM.drop_graphs`` and
``reset`` forget the ``FusedLoop``. CorrectLoop's stages (``loop_fuse``,
``_propagate`` with past loop edges in its buffers,
``loop_member_landmarks``, ``search_and_fuse``) with 0-d tensor slots
bitwise equal to the int calls; ``search_and_fuse`` over
``corrected_slots``' 16 masked slots bitwise the host list; the edge
capacity; the closure through the system's ``FusedCorrect`` (graphs C, the
padded Gauss-Newton step and F, eagerly on their static buffers) bitwise
equal to ``LoopCloser.graphs`` off, with no and with two past loop edges,
again on the restored arena with the other list (the static buffers
rewritten), and raising on a replaced arena. The global BA: its edge
capacity, the write-back with padded rows (their verdicts land on a dump
slot, so the last live edge keeps its own), and ``FusedGlobalBA`` (graphs
B, P, L, X and W, eagerly on their static buffers) bitwise equal to the
eager ``_global_ba`` at the capacity and at all K*N slots, again on the
restored arena.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import slam_map as JSM
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.runtime import loop_closing as JL
from cubemapslam_tpu_torch import dist as TD
from cubemapslam_tpu_torch import geometry as TG
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch import place as PL
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.optim import ba as TB
from cubemapslam_tpu_torch.runtime import fused_loop as FL
from cubemapslam_tpu_torch.runtime import loop_closing as TL
from cubemapslam_tpu_torch.runtime import synthetic as S

import torch_parent_loops as PARENT

SMALL = dict(cube_face_w=160, cube_face_h=160, n_features=600, n_levels=3,
             max_keyframes=64, max_landmarks=8192, min_init_keypoints=80,
             min_init_matches=60, init_min_triangulated=40,
             init_good_ratio=0.75, min_track_inliers=20,
             min_track_inliers_after_reloc=30, fps=5.0)
K_CUR, K_LOOP = 13, 3
INTEGER = ("kf_valid", "kf_frame_id", "kf_face", "kf_level", "kf_desc",
           "kf_kp_valid", "kf_obs_lm", "lm_valid", "lm_desc", "lm_visible",
           "lm_found", "lm_first_kf", "lm_birth", "lm_first_frame")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(x):
    a = np.array(x)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def jarena(f):
    return JSM.MapArena(**{k: jnp.asarray(v) for k, v in f.items()})


def snapshot(arena):
    """A numpy copy of a port or JAX arena, by field name."""
    if isinstance(arena, JSM.MapArena):
        return {k: np.array(v) for k, v in arena._asdict().items()}
    return {k: np.array(v) for k, v in interop.arena_to_numpy(arena).items()}


def same_arena(a, b_all, atol=1e-4, lm_rtol=0.0):
    for name in a:
        b = b_all[name]
        if name in INTEGER:
            np.testing.assert_array_equal(a[name], b, err_msg=name)
        else:
            np.testing.assert_allclose(
                a[name], b, atol=atol, err_msg=name,
                rtol=lm_rtol if name == "lm_pos" else 0.0)


@pytest.fixture(scope="module")
def case():
    tcfg, jcfg = TConfig(**SMALL), JConfig(**SMALL)
    arena, W, desc, _ = S.build_drifted_loop_arena(
        tcfg, np.random.default_rng(42))
    SM.update_landmark_stats(arena, torch.tensor(tcfg.scale_factors))
    tk = TL.LoopKernels(tcfg, TCam.from_config(tcfg, "cpu"))
    jk = JL.LoopKernels(jcfg, JCam.from_config(jcfg))
    voc = PL.train_vocabulary(desc, k=8, depth=3, device="cpu")
    bow = torch.zeros(tcfg.max_keyframes, voc.n_words)
    for i in range(S.LOOP_KEYFRAMES):
        bow[i] = PL.bow_vector(voc, arena.kf_desc[i], arena.kf_kp_valid[i])
    # the true S_cl maps the loop keyframe's camera frame into the current
    # one's: (s_d, I, 0); perturbed by about 0.3%
    s_cl = torch.tensor(1.06 * 1.003)
    R_cl = TG.so3_exp(torch.tensor([0.002, -0.001, 0.0015]))
    t_cl = torch.tensor([0.004, -0.003, 0.002])
    return dict(tcfg=tcfg, jcfg=jcfg, arena=arena,
                f=interop.arena_to_numpy(arena), tk=tk, jk=jk, bow=bow,
                sim3=(s_cl, R_cl, t_cl))


def jsim3(sim3):
    return tuple(jnp.asarray(x.numpy()) for x in sim3)


@pytest.fixture(scope="module")
def matched(case):
    tk, jk, f = case["tk"], case["jk"], case["f"]
    ti, tok = tk.match_kf_pair(case["arena"], K_CUR, K_LOOP)
    ji, jok = jk.match_kf_pair(jarena(f), jnp.int32(K_CUR),
                               jnp.int32(K_LOOP))
    return (ti, tok), (ji, jok)


SLOT_KINDS = ("int", "tensor")


def slot(kind, k):
    """A keyframe slot as a Python int or as a 0-d tensor (what
    ``FusedLoop``'s graphs pass)."""
    return k if kind == "int" else torch.tensor(k)


def same_bits(a, b):
    """Two stage outputs (tensors or tuples of them) bitwise equal."""
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        same_bits(x, y)


@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_detect_candidates_fused(case, kind):
    ti, tok, tg = case["tk"].detect_candidates_fused(
        case["arena"], case["bow"], slot(kind, K_CUR))
    if kind == "tensor":
        same_bits((ti, tok, tg), case["tk"].detect_candidates_fused(
            case["arena"], case["bow"], K_CUR))
    ji, jok, jg = case["jk"].detect_candidates_fused(
        jarena(case["f"]), jnp.asarray(case["bow"].numpy()),
        jnp.int32(K_CUR))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = tok.numpy()
    assert ok.any()
    np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok])
    np.testing.assert_array_equal(tg.numpy()[ok], np.asarray(jg)[ok])
    # segment A keyframes are candidates; the covisible segment B is not
    assert set(ti.numpy()[ok].tolist()) <= set(range(10))


@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_match_and_sim3_candidates(case, matched, kind):
    """With 0-d tensor slots each stage (and ``LoopKernels.sim3_ransac`` on
    given scores) is bitwise the int call."""
    (ti, tok), (ji, jok) = matched
    kc, kl = slot(kind, K_CUR), slot(kind, K_LOOP)
    if kind == "tensor":
        same_bits(case["tk"].match_kf_pair(case["arena"], kc, kl), (ti, tok))
        scores = torch.rand((case["tcfg"].sim3_ransac_iters, ti.shape[0]),
                            generator=torch.Generator().manual_seed(3))
        same_bits(*(case["tk"].sim3_ransac(case["arena"], a, b, ti, tok,
                                           None, scores=scores)
                    for a, b in ((kc, kl), (K_CUR, K_LOOP))))
    ok = tok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jok))
    assert ok.sum() >= 20
    np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok])
    tc = case["tk"].sim3_candidates(case["arena"], kc, kl, ti, tok)
    if kind == "tensor":
        same_bits(tc, case["tk"].sim3_candidates(case["arena"], K_CUR,
                                                 K_LOOP, ti, tok))
    jc = case["jk"].sim3_candidates(jarena(case["f"]), jnp.int32(K_CUR),
                                    jnp.int32(K_LOOP), ji, jok)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok],
                                   atol=1e-4)


@pytest.fixture(scope="module")
def refined(case, matched):
    (ti, tok), (ji, jok) = matched
    tk, jk = case["tk"], case["jk"]
    ja = jarena(case["f"])
    sim3 = case["sim3"]
    # widen the matches with the RANSAC inliers' stand-in: every 3rd match
    keep = torch.arange(ti.shape[0]) % 3 == 0
    ti2, tok2 = tk.search_by_sim3(case["arena"], K_CUR, K_LOOP, *sim3, ti,
                                  tok & keep)
    ji2, jok2 = jk.search_by_sim3(ja, jnp.int32(K_CUR), jnp.int32(K_LOOP),
                                  *jsim3(sim3), ji,
                                  jok & jnp.asarray(keep.numpy()))
    tr = tk.refine_sim3(case["arena"], K_CUR, K_LOOP, ti2, tok2, *sim3)
    jr = jk.refine_sim3(ja, jnp.int32(K_CUR), jnp.int32(K_LOOP), ji2, jok2,
                        *jsim3(sim3))
    return (ti2, tok2, tr), (ji2, jok2, jr), keep


@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_search_by_sim3_and_refine(case, matched, refined, kind):
    (ti, tok, tr), (ji, jok, jr), keep = refined
    if kind == "tensor":
        (t0, tok0), _ = matched
        kc, kl = slot(kind, K_CUR), slot(kind, K_LOOP)
        wide = case["tk"].search_by_sim3(case["arena"], kc, kl,
                                         *case["sim3"], t0, tok0 & keep)
        same_bits(wide, (ti, tok))
        same_bits(case["tk"].refine_sim3(case["arena"], kc, kl, ti, tok,
                                         *case["sim3"]), tr)
    ok = tok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jok))
    np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok])
    assert ok.sum() > 2 * (ok & keep.numpy()).sum()   # the widening added
    # S_cl's scale is free here (t = 0 and every match exact), so only R
    # and t are held to 1e-4, the scale to 0.1
    np.testing.assert_allclose(float(tr[0]), float(jr[0]), atol=0.1)
    for a, b in zip(tr[1:3], jr[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_array_equal(tr[3].numpy(), np.asarray(jr[3]))
    assert int(tr[4]) == int(jr[4]) >= 20
    # the refinement finds the true rotation of S_cl = (1.06, I, 0) (with
    # t = 0 the projections leave the scale free)
    assert float(torch.linalg.norm(TG.so3_log(tr[1]))) < 1e-3
    assert float(torch.linalg.norm(tr[2])) < 1e-2


def jax_sim3(jr):
    """JAX's refined S_cl as port tensors: the stages after the refinement
    run on the same Sim3 in both packages."""
    return tuple(torch.as_tensor(np.array(x)) for x in jr[:3])


@pytest.fixture(scope="module")
def projected(case, refined):
    (ti, tok, tr), (ji, jok, jr), _ = refined
    ta = case["tk"].scw_project(case["arena"], K_CUR, K_LOOP, *jax_sim3(jr),
                                ti, tok & tr[3])
    ja = case["jk"].scw_project(jarena(case["f"]), jnp.int32(K_CUR),
                                jnp.int32(K_LOOP), *jr[:3], ji,
                                jok & jr[3])
    return ta, ja


@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_scw_project(case, refined, projected, kind):
    """Also ``LoopKernels.scw_gate`` (the covisibility matrix and the
    current keyframe's covisible set around it) against the stage and the
    eager loop closer's set."""
    (ta, tn), (ja, jn) = projected
    (ti, tok, tr), (_, _, jr), _ = refined
    kc, kl = slot(kind, K_CUR), slot(kind, K_LOOP)
    args = (case["arena"], kc, kl, jax_sim3(jr), ti, tok & tr[3])
    ga, gn, neigh = case["tk"].scw_gate(*args)
    same_bits((ga, gn), (ta, tn))
    covis = SM.covisibility_matrix(case["arena"])
    same_bits(neigh, (covis[K_CUR] >= case["tcfg"].covisibility_weight_th)
              & case["arena"].kf_valid)
    if kind == "tensor":
        same_bits(case["tk"].scw_project(*args[:3], *args[3], *args[4:]),
                  (ta, tn))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert int(tn) == int(jn) >= 40


def test_loop_member_landmarks(case):
    ts, tok = case["tk"].loop_member_landmarks(case["arena"], 4096, K_LOOP)
    js, jok = case["jk"].loop_member_landmarks(jarena(case["f"]), 4096,
                                               jnp.int32(K_LOOP))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tok.numpy().sum() > 100


@pytest.fixture(scope="module")
def corrected(case, refined, projected):
    """loop_fuse, propagate_and_pose_graph and search_and_fuse in turn on a
    copy of the arena, each stage's arena kept for its test."""
    (_, _, tr), (_, _, jr), _ = refined
    (ta, _), (ja_assoc, _) = projected
    tk, jk = case["tk"], case["jk"]
    cfg = case["tcfg"]
    ta_ = interop.arena_from_numpy(case["f"])
    ja_ = jarena(case["f"])
    covis = SM.covisibility_matrix(ta_)
    neigh_pre = (covis[K_CUR] >= cfg.covisibility_weight_th) & ta_.kf_valid
    out = {}
    tk.loop_fuse(ta_, K_CUR, ta)
    ja_ = jk.loop_fuse(ja_, jnp.int32(K_CUR), ja_assoc)
    out["loop_fuse"] = (snapshot(ta_), snapshot(ja_))
    tk.propagate_and_pose_graph(ta_, K_CUR, K_LOOP, *jax_sim3(jr), neigh_pre,
                                [])
    ja_ = jk.propagate_and_pose_graph(
        ja_, jnp.int32(K_CUR), jnp.int32(K_LOOP), *jr[:3],
        jnp.asarray(neigh_pre.numpy()), jnp.zeros(16, jnp.int32),
        jnp.zeros(16, jnp.int32), jnp.zeros(16, bool))
    out["pose_graph"] = (snapshot(ta_), snapshot(ja_))
    neigh = [K_CUR] + [i for i in np.nonzero(neigh_pre.numpy())[0][:15]
                       if i != K_CUR]
    ni = np.zeros(16, np.int32)
    nv = np.zeros(16, bool)
    ni[:len(neigh)], nv[:len(neigh)] = neigh, True
    sel, sel_ok = tk.loop_member_landmarks(ta_, 4096, K_LOOP)
    tk.search_and_fuse(ta_, [int(i) for i in neigh], sel, sel_ok)
    jsel, jsel_ok = jk.loop_member_landmarks(ja_, 4096, jnp.int32(K_LOOP))
    ja_ = jk.search_and_fuse(ja_, jnp.asarray(ni), jnp.asarray(nv), jsel,
                             jsel_ok)
    out["search_and_fuse"] = (snapshot(ta_), snapshot(ja_))
    return out


@pytest.mark.parametrize("stage", ["loop_fuse", "pose_graph",
                                   "search_and_fuse"])
def test_correction_stages(case, corrected, stage):
    f, ja = corrected[stage]
    # after the pose graph a landmark moves with its keyframe's Sim3, whose
    # scale agrees within 1e-4: 3e-4 relative at the depths of 3-7
    same_arena(f, ja, lm_rtol=0.0 if stage == "loop_fuse" else 3e-4)
    before = case["f"]
    if stage == "loop_fuse":
        # the current keyframe now observes loop landmarks, whose segment-B
        # duplicates were killed
        assert (f["kf_obs_lm"] != before["kf_obs_lm"]).any()
        assert f["lm_valid"].sum() < before["lm_valid"].sum()
    elif stage == "pose_graph":
        assert np.abs(f["kf_t"][10:14] - before["kf_t"][10:14]).max() > 0.05
        np.testing.assert_array_equal(f["kf_t"][K_LOOP],
                                      before["kf_t"][K_LOOP])


def test_loser_zero_rule():
    """Where the JAX package leaves the result to scatter order: in
    ``loop_fuse`` landmark 0 as a merge's loser is redirected to the loop
    landmark and killed (the non-merge rows never overwrite its redirect),
    and of two merges with one loser (landmark 7, held by features 2 and 3)
    the later row wins."""
    a = SM.make_arena(2, 5, 16, "cpu")
    a.kf_valid[:] = True
    a.kf_kp_valid[:] = True
    a.kf_obs_lm[0] = torch.tensor([0, 7, 7, 7, 4])
    a.kf_obs_lm[1] = torch.tensor([0, 7, 4, 6, -1])
    a.lm_valid[[0, 4, 5, 6, 7, 9, 11]] = True
    loop_assoc = torch.tensor([5, -1, 9, 11, 4])
    cfg = TConfig(**SMALL)
    tk = TL.LoopKernels(cfg, TCam.from_config(cfg, "cpu"))
    tk.loop_fuse(a, 0, loop_assoc)
    # feature 2 keeps its own loop landmark 9; feature 1 (no loop match)
    # follows landmark 7's redirect to 11, the later merge's winner
    assert a.kf_obs_lm[0].tolist() == [5, 11, 9, 11, 4]
    assert a.kf_obs_lm[1].tolist() == [5, 11, 4, 6, -1]
    valid = a.lm_valid.nonzero()[:, 0].tolist()
    assert valid == [4, 5, 6, 9, 11]


def fed_detection(groups_seq, K):
    """Stand-ins for detect_candidates_fused that return the fed candidate
    groups, one call after another: (port function, JAX function)."""
    calls = iter(groups_seq)
    calls_j = iter(groups_seq)

    def rows(cands):
        idx = np.zeros(8, np.int64)
        ok = np.zeros(8, bool)
        g = np.zeros((8, K), bool)
        for r, (c, members) in enumerate(cands):
            idx[r], ok[r] = c, True
            g[r, list(members)] = True
            g[r, c] = True
        return idx, ok, g

    def port(arena, bow, slot, covis=None):
        return tuple(torch.as_tensor(x) for x in rows(next(calls)))

    def jax_(arena, bow, slot):
        return tuple(jnp.asarray(x) for x in rows(next(calls_j)))
    return port, jax_


def test_consistency_bookkeeping(case):
    """``process`` on fed candidate groups at consistency_th = 3: the
    consistent groups and their streaks, and the candidates sent to
    ComputeSim3, equal to JAX's over a sequence that builds a streak, loses
    a group, is reset by a keyframe without candidates and builds again."""
    K = case["tcfg"].max_keyframes
    seq = [[(3, {2, 4})],
           [(4, {3, 5}), (20, {21})],
           [(5, {4, 6})],
           [(2, {1, 3}), (30, {31})],
           [],
           [(6, {5})],
           [(5, {6}), (7, {8})],
           [(5, {4}), (8, {7})],
           [(4, {5})]]
    port, jfun = fed_detection(seq, K)
    lc = TL.LoopCloser(case["tcfg"], case["tk"].cam)
    jlc = JL.LoopCloser(case["jcfg"], case["jk"].cam, None, None)
    lc.k.detect_candidates_fused = port
    jlc.k = types.SimpleNamespace(detect_candidates_fused=jfun)
    tried, jtried = [], []
    lc._try_close = lambda system, k_cur, k_loop: tried.append(k_loop)
    jlc._try_close = lambda system, k_cur, k_loop: jtried.append(k_loop)
    system = types.SimpleNamespace(arena=None, n_kf=20, bow_table=None)
    for n in range(len(seq)):
        lc.process(system, 0)
        jlc.process(system, 0)
        assert lc.consistent_groups == [
            (set(int(x) for x in g), s) for g, s in jlc.consistent_groups], n
        assert tried == jtried, n
    # the first streak breaks at 2, the second reaches 3 on the last call
    assert tried == [4]


def test_closes_constructed_drift():
    """The constructed-drift closure of ``tests/test_loop.py:173-208`` on
    the port: ``process`` on slots 12 then 13 at consistency_th = 1 closes
    the loop, and the summed segment-B centre error falls below 0.6 of its
    value before. The closure's host reads on the CPU: detection, the match
    count, the RANSAC verdict, the refined count, the S_cw count, the pose
    graph's edge count, the landmark statistics' live count and the global
    BA's live-edge count; the Sim3 RANSAC's eigen-solves wait for nothing
    (``sim3.EIGH_WAITS`` = 0)."""
    cfg = TConfig(**SMALL)
    arena, W, desc, _ = S.build_drifted_loop_arena(
        cfg, np.random.default_rng(42))
    cam = TCam.from_config(cfg, "cpu")
    voc = PL.train_vocabulary(desc, k=8, depth=3, device="cpu")
    bow = torch.zeros(cfg.max_keyframes, voc.n_words)
    for i in range(S.LOOP_KEYFRAMES):
        bow[i] = PL.bow_vector(voc, arena.kf_desc[i], arena.kf_kp_valid[i])
    system = types.SimpleNamespace(
        arena=arena, n_kf=S.LOOP_KEYFRAMES, bow_table=bow,
        generator=torch.Generator().manual_seed(0))
    lc = TL.LoopCloser(cfg, cam)
    lc.consistency_th = 1
    t_before = arena.kf_t.clone().numpy()
    closed = [lc.process(system, slot) for slot in (12, 13)]
    assert closed == [False, True], closed
    assert (lc.reads, lc.eigh_waits) == (8, 0)
    assert set(lc.timings) == {"detect", "sim3", "correct", "gba"}
    t_after = system.arena.kf_t.numpy()
    gt = [S.loop_gt_pose(i - 10)[1] for i in range(10, 14)]
    err_before = sum(np.linalg.norm(t_before[i] - gt[i - 10])
                     for i in range(10, 14))
    err_after = sum(np.linalg.norm(t_after[i] - gt[i - 10])
                    for i in range(10, 14))
    assert err_after < 0.6 * err_before, (err_before, err_after)
    assert lc.loop_edges == [(13, int(lc.loop_edges[0][1]))]
    assert lc.loop_edges[0][1] < 10


# ---------------------------------------------------------------------------
# The closure's two solves through CapturedLoop, and the eager switch
# ---------------------------------------------------------------------------

CLOSURE_MODES = ("parent_loops", "graphs", "graphs_off", "stage_times")


def _parent_pose_graph(*args, n_iters, loop):
    return PARENT.optimize_essential_graph(*args, n_iters=n_iters)


class _ParentGlobalBA:
    """The global BA as the loop closer ran it before its solve took a
    ``FusedGlobalBA``: the K*N problem's live edges compacted, solved by
    the parent loop, and written back. Captures nothing."""

    captures = replays = 0
    capture_ms = capture_mib = 0.0

    def __init__(self, k, graphs=True):
        self.k = k

    def solve(self, system, phase_iters, cg_iters):
        arena, k = system.arena, self.k
        prob = TD.global_ba_problem_from_arena(k.cam, arena,
                                               k.inv_level_sigma2)
        keep = prob.obs_valid.nonzero()[:, 0]
        live = prob._replace(**{f: getattr(prob, f)[keep]
                                for f in TD.EDGE_FIELDS})
        out, inl = PARENT.bundle_adjust_cg(k.cam, live, phase_iters,
                                           TB.CHI2_TH, cg_iters)
        TL.LoopKernels.write_global_ba(arena, out, inl, keep,
                                       prob.obs_valid)


@pytest.fixture(scope="module")
def closures():
    """The constructed-drift closure (``process`` on slots 12 then 13 at
    consistency_th = 1) four times from one arena: with the solvers' loops
    as they were (``torch_parent_loops`` patched into the loop module),
    through ``CapturedLoop`` and a ``FusedGlobalBA`` made for the solve
    (the default), with ``LoopCloser.graphs`` off and with a system whose
    ``stage_times`` is set. Each mode's arena, the closer and the
    ``CapturedLoop`` objects made (with their iterations) and the
    ``graphs`` asked of each ``FusedGlobalBA`` made."""
    cfg = TConfig(**SMALL)
    arena, W, desc, _ = S.build_drifted_loop_arena(
        cfg, np.random.default_rng(42))
    voc = PL.train_vocabulary(desc, k=8, depth=3, device="cpu")
    bow = torch.zeros(cfg.max_keyframes, voc.n_words)
    for i in range(S.LOOP_KEYFRAMES):
        bow[i] = PL.bow_vector(voc, arena.kf_desc[i], arena.kf_kp_valid[i])
    out = {}
    for mode in CLOSURE_MODES:
        made, asked = [], []

        class Recorded(TL.CapturedLoop):
            def __init__(self, device):
                super().__init__(device)
                self.iterations = 0
                made.append(self)

            def repeat(self, name, body, n):
                self.iterations += n
                super().repeat(name, body, n)

        class RecordedGBA(FL.FusedGlobalBA):
            def __init__(self, k, graphs=True):
                super().__init__(k, graphs)
                asked.append(graphs)

        system = types.SimpleNamespace(
            arena=SM.MapArena(*(x.clone() for x in arena)),
            n_kf=S.LOOP_KEYFRAMES, bow_table=bow,
            generator=torch.Generator().manual_seed(0))
        if mode == "stage_times":
            system.stage_times = {}
        lc = TL.LoopCloser(cfg, TCam.from_config(cfg, "cpu"))
        lc.consistency_th = 1
        lc.graphs = mode != "graphs_off"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TL, "CapturedLoop", Recorded)
            mp.setattr(TL, "FusedGlobalBA", RecordedGBA)
            if mode == "parent_loops":
                mp.setattr(TL, "optimize_essential_graph", _parent_pose_graph)
                mp.setattr(TL, "FusedGlobalBA", _ParentGlobalBA)
            closed = [lc.process(system, slot) for slot in (12, 13)]
        out[mode] = (closed, snapshot(system.arena), lc, (made, asked))
    return out


@pytest.mark.parametrize("mode", CLOSURE_MODES[1:])
def test_closure_loops_bitwise_parent_loops(closures, mode):
    """The tier-1-size closure with the pose graph's iterations on fixed
    state tensors (through ``CapturedLoop``, eager on the CPU, or as a
    Python loop) and the global BA through a ``FusedGlobalBA`` (its parts
    eager on the CPU, or as called): it closes, and every arena table is
    bitwise the closure with the loops as they were, with the same host
    reads and eigen-solve waits and no capture."""
    closed, arena, lc, _ = closures[mode]
    p_closed, p_arena, p_lc, _ = closures["parent_loops"]
    assert closed == p_closed == [False, True]
    for name, a in arena.items():
        b = p_arena[name]
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    assert (lc.reads, lc.eigh_waits) == (p_lc.reads, p_lc.eigh_waits)
    assert lc.capture_waits == 0 and lc.graph_counts["captures"] == 0


@pytest.mark.parametrize("mode", CLOSURE_MODES[1:])
def test_eager_switch_runs_no_capture(closures, mode):
    """On a system that hands out no ``FusedLoop`` the closure makes one
    ``CapturedLoop`` for the pose graph's 12 iterations and one
    ``FusedGlobalBA`` that may capture for the global BA by default; with
    ``LoopCloser.graphs`` off, or a system that times its stages, it makes
    no ``CapturedLoop`` and a ``FusedGlobalBA`` with ``graphs=False``, so
    nothing can be captured."""
    _, _, _, (made, asked) = closures[mode]
    if mode == "graphs":
        assert [m.iterations for m in made] == [TL.POSE_GRAPH_ITERS]
        assert all(m.captures == m.replays == 0 for m in made)
        assert asked == [True]
    else:
        assert made == [] and asked == [False]



# ---------------------------------------------------------------------------
# DetectLoop and ComputeSim3 through FusedLoop (eagerly on the CPU)
# ---------------------------------------------------------------------------

class CPUGraphSystem(FL.LoopGraphOwner):
    """A loop-closing system that hands its loop closer a ``FusedLoop`` on
    the CPU too, whose parts then run eagerly on their static buffers."""

    fused_loop_for = FL.LoopGraphOwner.own_fused_loop

    def __init__(self, **fields):
        self.__dict__.update(fields)


@pytest.fixture(scope="module")
def drift():
    """The constructed-drift arena with its BoW rows, and a maker of
    systems on copies of it, each with a generator seeded 0: with
    ``fused`` one that hands out a ``FusedLoop`` (``CPUGraphSystem``), else
    one that hands out none."""
    cfg = TConfig(**SMALL)
    arena, _, desc, _ = S.build_drifted_loop_arena(
        cfg, np.random.default_rng(42))
    voc = PL.train_vocabulary(desc, k=8, depth=3, device="cpu")
    bow = torch.zeros(cfg.max_keyframes, voc.n_words)
    for i in range(S.LOOP_KEYFRAMES):
        bow[i] = PL.bow_vector(voc, arena.kf_desc[i], arena.kf_kp_valid[i])

    def system(fused):
        return (CPUGraphSystem if fused else types.SimpleNamespace)(
            arena=SM.MapArena(*(x.clone() for x in arena)),
            n_kf=S.LOOP_KEYFRAMES, bow_table=bow.clone(),
            generator=torch.Generator().manual_seed(0))
    return cfg, system


def closer(cfg):
    """A ``LoopCloser`` at consistency_th = 1."""
    lc = TL.LoopCloser(cfg, TCam.from_config(cfg, "cpu"))
    lc.consistency_th = 1
    return lc


def test_fused_loop_closure_bitwise_eager(drift):
    """The constructed-drift closure with DetectLoop and ComputeSim3 through
    ``FusedLoop`` (graphs D, M and S run eagerly on their static buffers
    on the CPU): it closes, every arena table is bitwise the eager
    closure's, the generator is left in the same state, and ComputeSim3
    reads twice where the eager path reads 4 times."""
    cfg, make = drift
    out = {}
    for fused in (False, True):
        system, lc = make(fused), closer(cfg)
        closed = [lc.process(system, slot) for slot in (12, 13)]
        out[fused] = (closed, snapshot(system.arena),
                      system.generator.get_state(), lc, system)
    (e_closed, e_arena, e_gen, e_lc, e_sys), \
        (g_closed, g_arena, g_gen, g_lc, g_sys) = out[False], out[True]
    assert e_closed == g_closed == [False, True]
    for name, a in e_arena.items():
        assert a.tobytes() == g_arena[name].tobytes(), name
    assert torch.equal(e_gen, g_gen)
    assert not hasattr(e_sys, "fused_loop")
    fl = g_sys.fused_loop
    assert isinstance(fl, FL.FusedLoop)
    assert set(fl.outputs) == {"d", "m", "s"}
    assert fl.captures == fl.replays == 0
    fc = fl.correction
    assert set(fc.outputs) == {"c", "g256", "f"} and fc.capacities == [256]
    assert fc.captures == fc.replays == 0
    fg = fl.global_ba
    cap = TL.LoopKernels.ba_edge_capacity(int(fg.outputs["b"][-1]),
                                          64 * 600)
    assert fg.capacities == [cap]
    assert set(fg.outputs) == {"b"} | {f"{g}{cap}" for g in "plxw"}
    assert fg.captures == fg.replays == 0
    # ComputeSim3 2 reads fewer, CorrectLoop 1 (the statistics' live count)
    assert (e_lc.reads, g_lc.reads) == (8, 5)
    assert e_lc.eigh_waits == g_lc.eigh_waits == 0
    assert g_lc.loop_edges == e_lc.loop_edges


@pytest.mark.parametrize("k_loop", [K_LOOP, 40])
def test_fused_compute_sim3_bitwise_eager(drift, k_loop):
    """``_compute_sim3`` of the current keyframe against the loop keyframe
    (which passes every gate) and against an empty slot (no match, so no
    draw): through ``FusedLoop`` the same S_cl, loop associations and
    covisible set, and the same ``sim3_trace`` (the RANSAC's Sim3 and
    counts, the refinement), bitwise, and the generator in the same
    state."""
    cfg, make = drift
    res = {}
    for fused in (False, True):
        system, lc = make(fused), closer(cfg)
        res[fused] = (lc._compute_sim3(system, K_CUR, k_loop),
                      system.generator.get_state(), lc.sim3_trace)
    (e, e_gen, e_tr), (g, g_gen, g_tr) = res[False], res[True]
    assert torch.equal(e_gen, g_gen)
    if k_loop != K_LOOP:
        assert e is None and g is None and e_tr == g_tr == {}
        assert torch.equal(e_gen, torch.Generator().manual_seed(0)
                           .get_state())
        return
    assert e is not None and g is not None
    same_bits(e[:3], g[:3])
    assert e[3] == g[3] and len(e[3]) > 0
    assert set(e_tr) == set(g_tr) == {"ransac", "ransac_inliers", "widened",
                                      "refined"}
    for key in e_tr:
        same_bits(e_tr[key], g_tr[key])


def test_fused_loop_moved_tables_raise(drift):
    """After ``FusedLoop`` ran, a replaced arena or BoW table raises."""
    cfg, make = drift
    for field in ("arena", "bow_table"):
        system, lc = make(True), closer(cfg)
        lc.process(system, 12)
        if field == "arena":
            system.arena = SM.MapArena(*(x.clone() for x in system.arena))
        else:
            system.bow_table = system.bow_table.clone()
        with pytest.raises(RuntimeError, match="moved"):
            lc.process(system, 13)


def test_drop_graphs_forgets_fused_loop():
    """``CubemapSLAM`` owns its ``FusedLoop``: ``drop_graphs`` and ``reset``
    forget it."""
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    slam = CubemapSLAM(TConfig(**SMALL), device="cpu")
    assert slam.fused_loop is None
    assert slam.fused_loop_for(slam.loop_closer.k) is None    # on the CPU
    for drop in (slam.drop_graphs, slam.reset):
        fl = slam.own_fused_loop(slam.loop_closer.k)
        assert slam.fused_loop is fl
        drop()
        assert slam.fused_loop is None


def test_fused_loop_serves_closers_of_one_configuration(drift):
    """The system's ``FusedLoop`` keeps the ``LoopKernels`` it was made with
    (its graphs read their tensors): a later closer of the same
    configuration runs on it and closes bitwise as one closer does; a
    closer of another configuration raises."""
    cfg, make = drift
    one, two = make(True), make(True)
    lc = closer(cfg)
    for slot in (12, 13):
        lc.process(one, slot)
    first = closer(cfg)
    first.process(two, 12)
    later = closer(cfg)
    later.consistent_groups = first.consistent_groups
    assert later.process(two, 13)
    assert two.fused_loop.k is first.k
    same_bits(tuple(one.arena), tuple(two.arena))
    other = closer(dataclasses.replace(cfg, th_low=cfg.th_low - 1))
    with pytest.raises(RuntimeError, match="configuration"):
        other.process(two, 13)


# ---------------------------------------------------------------------------
# CorrectLoop's stages with device slots, and through FusedCorrect
# ---------------------------------------------------------------------------

PAST_LOOPS = [(12, 2), (11, 1)]


def arena_copy(arena):
    return SM.MapArena(*(x.clone() for x in arena))


@pytest.fixture(scope="module")
def before_correct(case, refined, projected):
    """The parity arena, the refined S_cl of JAX, loop_assoc and the current
    keyframe's pre-fusion covisible set: the inputs of the correction."""
    (_, _, _), (_, _, jr), _ = refined
    (ta, _), _ = projected
    arena = interop.arena_from_numpy(case["f"])
    covis = SM.covisibility_matrix(arena)
    neigh_pre = (covis[K_CUR] >= case["tcfg"].covisibility_weight_th) \
        & arena.kf_valid
    return arena, jax_sim3(jr), ta, neigh_pre


def _stage(case, before, stage, kc, kl):
    """Run one correction stage on a copy of the arena with the slots kc,
    kl: (its outputs, the arena after it)."""
    tk = case["tk"]
    arena, sim3, assoc, neigh_pre = before
    a = arena_copy(arena)
    if stage == "loop_fuse":
        out = ()
        tk.loop_fuse(a, kc, assoc)
    elif stage == "propagate":
        tk.loop_fuse(a, K_CUR, assoc)
        own, lm_pos, state, fixed, edges = tk._propagate(
            a, kc, kl, *sim3, neigh_pre, *tk.fill_loop_edges(
                PAST_LOOPS, tk.loop_edge_buffers("cpu")))
        out = (own, lm_pos, *state, fixed, *edges)
    elif stage == "loop_member_landmarks":
        out = tk.loop_member_landmarks(a, 4096, kl)
    else:
        tk.loop_fuse(a, K_CUR, assoc)
        tk.propagate_and_pose_graph(a, K_CUR, K_LOOP, *sim3, neigh_pre, [])
        sel, sel_ok = tk.loop_member_landmarks(a, 4096, K_LOOP)
        neigh = [K_CUR] + np.nonzero(neigh_pre.numpy())[0][:15].tolist()
        kind = "tensor" if torch.is_tensor(kc) else "int"
        tk.search_and_fuse(a, [slot(kind, k) for k in neigh], sel, sel_ok)
        out = ()
    return out, a


@pytest.mark.parametrize("stage", ["loop_fuse", "propagate",
                                   "loop_member_landmarks",
                                   "search_and_fuse"])
def test_correction_stage_tensor_slots(case, before_correct, stage):
    """Each correction stage with its slots as 0-d tensors (what graphs C
    and F pass) bitwise the stage with Python ints: its outputs and every
    arena table after it (``_propagate`` with two past loop edges in its
    buffers, ``search_and_fuse`` over the slots as tensors)."""
    out_i, a_i = _stage(case, before_correct, stage, K_CUR, K_LOOP)
    out_t, a_t = _stage(case, before_correct, stage, torch.tensor(K_CUR),
                        torch.tensor(K_LOOP))
    same_bits(out_t, out_i)
    same_bits(tuple(a_t), tuple(a_i))
    if stage != "loop_member_landmarks":
        assert not all(torch.equal(x, y) for x, y in
                       zip(a_i, before_correct[0]))


def test_search_and_fuse_masked_slots(case, before_correct):
    """``corrected_slots`` gives JAX's 16 slots (the current keyframe, its
    pre-fusion covisible set, masked slots after them), and
    ``search_and_fuse`` over them, masked slots included, is bitwise the
    call on the host list; a masked slot writes back its row unchanged."""
    tk = case["tk"]
    arena, sim3, assoc, neigh_pre = before_correct
    a = arena_copy(arena)
    tk.loop_fuse(a, K_CUR, assoc)
    tk.propagate_and_pose_graph(a, K_CUR, K_LOOP, *sim3, neigh_pre, [])
    sel, sel_ok = tk.loop_member_landmarks(a, 4096, K_LOOP)
    host = [K_CUR] + [int(i) for i in np.nonzero(neigh_pre.numpy())[0][:15]
                      if i != K_CUR]
    slots, ok = tk.corrected_slots(a, torch.tensor(K_CUR), neigh_pre)
    assert slots.shape == ok.shape == (TL.MAX_NEIGH,)
    assert slots[ok].tolist() == host and 1 < len(host) < TL.MAX_NEIGH
    assert not ok[len(host):].any()
    by_host, by_slots = arena_copy(a), arena_copy(a)
    tk.search_and_fuse(by_host, host, sel, sel_ok)
    tk.search_and_fuse(by_slots, slots, sel, sel_ok, ok)
    same_bits(tuple(by_slots), tuple(by_host))
    assert not torch.equal(by_host.kf_obs_lm, a.kf_obs_lm)
    # every slot masked: nothing changes
    masked = arena_copy(a)
    tk.search_and_fuse(masked, slots, sel, sel_ok, torch.zeros_like(ok))
    same_bits(tuple(masked), tuple(a))


@pytest.mark.parametrize("count,cap", [(0, 256), (59, 256), (256, 256),
                                       (257, 512), (3000, 4096),
                                       (4177, 4177)])
def test_edge_capacity(count, cap):
    """The pose graph's padded edge count: the next power of two at or
    above the live count, at least 256, at most every edge (4177 at
    K = 64)."""
    assert TL.LoopKernels.edge_capacity(count, 64 + 64 * 64 + 17) == cap


def fused_closure(cfg, system, past, graphs=True):
    """``process`` on slots 12 and 13 with the past loop edges ``past``
    (``LoopCloser.graphs`` as given): (what each call returned, the
    closer)."""
    lc = closer(cfg)
    lc.graphs = graphs
    lc.loop_edges = list(past)
    return [lc.process(system, s) for s in (12, 13)], lc


@pytest.mark.parametrize("past", [[], PAST_LOOPS])
def test_fused_correct_bitwise_eager(drift, past):
    """CorrectLoop through the system's ``FusedCorrect`` (graph C, the
    problem at the edge capacity in static buffers, the Gauss-Newton step
    12 times, graph F; eagerly on their static buffers on the CPU) against
    ``LoopCloser.graphs`` off, with no or two past loop edges: every arena
    table bitwise, the same loop edges, one read for the correction where
    the eager path makes two; the same system's arena restored in place
    and closed again with the other list of past edges (the static buffers
    written anew) bitwise the eager closure of that list."""
    cfg, make = drift
    out = {}
    for fused in (False, True):
        system = make(fused)
        closed, lc = fused_closure(cfg, system, past, graphs=fused)
        out[fused] = (closed, snapshot(system.arena), lc, system)
    (e_closed, e_arena, e_lc, _), (g_closed, g_arena, g_lc, g_sys) = \
        out[False], out[True]
    assert e_closed == g_closed == [False, True]
    for name, a in e_arena.items():
        assert a.tobytes() == g_arena[name].tobytes(), name
    assert g_lc.loop_edges == e_lc.loop_edges == past + [(13, K_LOOP)]
    assert e_lc.reads - g_lc.reads == 3           # 2 in ComputeSim3
    fc = g_sys.fused_loop.correction
    assert fc.capacities == [256]
    assert [fc.inputs[n].tolist() for n in ("loop_i", "loop_j")] == [
        [a for a, _ in past] + [0] * (16 - len(past)),
        [b for _, b in past] + [0] * (16 - len(past))]
    # the other list of past edges on the restored arena
    other = PAST_LOOPS if not past else []
    fresh = make(False)
    for a, b in zip(g_sys.arena, fresh.arena):
        a.copy_(b)
    g_sys.generator.manual_seed(0)
    closed, _ = fused_closure(cfg, g_sys, other)
    e_sys = make(False)
    e_closed, _ = fused_closure(cfg, e_sys, other, graphs=False)
    assert closed == e_closed == [False, True]
    same_bits(tuple(g_sys.arena), tuple(e_sys.arena))
    assert int(fc.inputs["loop_ok"].sum()) == len(other)


def test_fused_correct_moved_arena_raises(drift):
    """After ``FusedCorrect`` ran, a replaced arena raises before any of its
    graphs runs."""
    cfg, make = drift
    system = make(True)
    closed, lc = fused_closure(cfg, system, [])
    assert closed == [False, True]
    fc = system.fused_loop.correction
    system.arena = SM.MapArena(*(x.clone() for x in system.arena))
    inputs = [fc.inputs[n] for n in ("s_cl", "R_cl", "t_cl")]
    with pytest.raises(RuntimeError, match="moved"):
        fc.correct(system, K_CUR, K_LOOP, inputs, fc.inputs["loop_assoc"],
                   fc.inputs["neigh_pre"], [], TL.POSE_GRAPH_ITERS)


# ---------------------------------------------------------------------------
# The global BA at an edge capacity, and through FusedGlobalBA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count,cap", [
    (0, 4096), (1, 4096), (4095, 4096), (4096, 4096), (4097, 4608),
    (8192, 8192), (8193, 9216), (20160, 20480), (32768, 32768),
    (32769, 36864), (38000, 38400), (38400, 38400)])
def test_ba_edge_capacity(count, cap):
    """The global BA's padded edge count: the live count rounded up to a
    multiple of 2^(bit_length - 4) (exact powers of two stay, one past
    them rounds up by an eighth), at least 4096, at most every slot (38,400
    at K = 64, N = 600); never more than 12.5% over a count past the
    minimum."""
    assert TL.LoopKernels.ba_edge_capacity(count, 64 * 600) == cap
    if TL.MIN_BA_EDGE_CAPACITY < count <= cap < 64 * 600:
        assert cap - count <= count / 8


@pytest.mark.parametrize("verdict", ["outlier", "inlier"])
def test_write_global_ba_padded_rows(verdict):
    """``write_global_ba`` after a solve padded past its live edges, whose
    last live edge sits in the table's last slot: that edge is unlinked
    when it is an outlier and kept when it is an inlier, whatever the
    padded rows (inactive, routed to the dump slot past the last) say;
    the other slots as their verdicts say, the poses and points written."""
    rng = np.random.default_rng(5)
    K, N, L = 3, 8, 20
    obs = torch.as_tensor(rng.integers(-1, L, (K, N)))
    obs[-1, -1] = 7
    valid = (obs >= 0).reshape(-1)
    E, count = K * N, int(valid.sum())
    z = torch.zeros(E, dtype=torch.int64)
    prob = TB.BAProblem(
        R=torch.eye(3).expand(K, 3, 3).clone(), t=torch.zeros(K, 3),
        cam_fixed=torch.zeros(K, dtype=torch.bool),
        cam_valid=torch.ones(K, dtype=torch.bool), X=torch.zeros(L, 3),
        pt_valid=torch.ones(L, dtype=torch.bool),
        obs_cam=torch.arange(K).repeat_interleave(N),
        obs_pt=obs.reshape(-1).clamp(min=0), obs_face=z,
        obs_uv=torch.zeros(E, 2), obs_inv_sigma2=torch.ones(E),
        obs_valid=valid)
    padded, keep = TL.LoopKernels.padded_ba_problem(prob, count + 5)
    assert keep[:count].tolist() == valid.nonzero()[:, 0].tolist()
    assert (keep[count:] == E).all() and keep[count - 1] == E - 1
    assert padded.obs_valid.tolist() == [True] * count + [False] * 5
    active = padded.obs_valid.clone()
    active[count - 1] = verdict == "inlier"
    active[0] = False
    arena = types.SimpleNamespace(
        n_kf_cap=K, n_feat=N, kf_R=torch.zeros(K, 3, 3),
        kf_t=torch.zeros(K, 3), lm_pos=torch.zeros(L, 3),
        kf_obs_lm=obs.clone())
    out = prob._replace(R=torch.full((K, 3, 3), 2.0),
                        t=torch.full((K, 3), 3.0), X=torch.full((L, 3), 4.0))
    TL.LoopKernels.write_global_ba(arena, out, active, keep, valid)
    want = obs.clone().reshape(-1)
    want[keep[0]] = SM.NO_LM
    if verdict == "outlier":
        want[E - 1] = SM.NO_LM
    assert arena.kf_obs_lm.reshape(-1).tolist() == want.tolist()
    assert int(arena.kf_obs_lm[-1, -1]) == (7 if verdict == "inlier"
                                            else SM.NO_LM)
    for name, v in (("kf_R", 2.0), ("kf_t", 3.0), ("lm_pos", 4.0)):
        assert (getattr(arena, name) == v).all(), name


def composed_global_ba(cfg, arena) -> None:
    """The global BA of ``arena`` in place, composed of the module's pieces
    as a plain reference: the K*N problem, the live count's capacity, the
    padded problem, ``bundle_adjust(solver="cg")`` and the write-back."""
    cam = TCam.from_config(cfg, "cpu")
    k = TL.LoopKernels(cfg, cam)
    prob = TD.global_ba_problem_from_arena(cam, arena, k.inv_level_sigma2)
    E = prob.obs_valid.shape[0]
    cap = TL.LoopKernels.ba_edge_capacity(int(prob.obs_valid.sum()), E)
    padded, keep = TL.LoopKernels.padded_ba_problem(prob, cap)
    out, active = TB.bundle_adjust(cam, padded, phase_iters=TL.GBA_PHASES,
                                   solver="cg", cg_iters=TL.GBA_CG_ITERS)
    TL.LoopKernels.write_global_ba(arena, out, active, keep, prob.obs_valid)


@pytest.mark.parametrize("cap_rule", ["capacity", "all_slots"])
def test_fused_global_ba_bitwise_eager(drift, monkeypatch, cap_rule):
    """The global BA of the constructed-drift arena through the system's
    ``FusedGlobalBA`` (graphs B, P, L, X and W, eagerly on their static
    buffers on the CPU), eagerly (``LoopCloser.graphs`` off: a
    ``FusedGlobalBA`` that runs its parts as called) and composed of the
    module's pieces (``composed_global_ba``): every arena table bitwise
    equal, one read each; the parts held at the capacity of the live count
    (4294 -> 4608) or, with the rule patched, at all 38,400 slots; the
    arena restored in place and solved again through the same object,
    bitwise the first solve."""
    if cap_rule == "all_slots":
        monkeypatch.setattr(TL.LoopKernels, "ba_edge_capacity",
                            staticmethod(lambda count, n_slots: n_slots))
    cfg, make = drift
    e_sys, g_sys, r_sys = make(False), make(True), make(False)
    initial = [x.clone() for x in g_sys.arena]
    e_lc, g_lc = closer(cfg), closer(cfg)
    e_lc.graphs = False
    e_lc._global_ba(e_sys)
    g_lc._global_ba(g_sys)
    composed_global_ba(cfg, r_sys.arena)
    same_bits(tuple(g_sys.arena), tuple(e_sys.arena))
    same_bits(tuple(g_sys.arena), tuple(r_sys.arena))
    assert not torch.equal(g_sys.arena.kf_t, initial[
        SM.MapArena._fields.index("kf_t")])
    assert e_lc.reads == g_lc.reads == 1
    assert e_lc.graph_counts["captures"] == g_lc.graph_counts["captures"] == 0
    fg = g_sys.fused_loop.global_ba
    count = int(fg.outputs["b"][-1])
    cap = 4608 if cap_rule == "capacity" else 64 * 600
    assert count == 4294 and fg.capacities == [cap]
    assert set(fg.outputs) == {"b"} | {f"{g}{cap}" for g in "plxw"}
    assert fg.captures == fg.replays == 0
    solved = [x.clone() for x in g_sys.arena]
    for a, b in zip(g_sys.arena, initial):
        a.copy_(b)
    g_lc._global_ba(g_sys)
    same_bits(tuple(g_sys.arena), tuple(solved))


def test_fused_global_ba_holds_two_capacities(drift, monkeypatch):
    """A system's ``FusedGlobalBA`` solving the constructed-drift arena,
    restored in place each time, at the edge capacities 4608, 5120, 6144
    and 5120 again (the rule patched): it holds the parts of the two
    capacities used last, so the third drops 4608's P, L, X and W, and
    the capacity used again keeps its parts and gives the bits of its
    first solve."""
    cap = [0]
    monkeypatch.setattr(TL.LoopKernels, "ba_edge_capacity",
                        staticmethod(lambda count, n_slots: cap[0]))
    cfg, make = drift
    system, lc = make(True), closer(cfg)
    initial = [x.clone() for x in system.arena]
    held, solved = [], {}
    for c in (4608, 5120, 6144, 5120):
        for a, b in zip(system.arena, initial):
            a.copy_(b)
        cap[0] = c
        lc._global_ba(system)
        fg = system.fused_loop.global_ba
        held.append(fg.capacities)
        if c in solved:
            same_bits(tuple(system.arena), solved[c])
        solved[c] = tuple(x.clone() for x in system.arena)
    assert held == [[4608], [4608, 5120], [5120, 6144], [5120, 6144]]
    assert set(fg.outputs) == {"b"} | {f"{g}{c}" for g in "plxw"
                                       for c in (5120, 6144)}
