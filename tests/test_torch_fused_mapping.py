"""The keyframe and deferred-BA frames as the captured CUDA graphs run them
(``runtime/fused_mapping.py``), held on the CPU, where each captured part
runs eagerly on the same static buffers.

``CubemapSLAM`` runs 9 rendered fisheye frames of a forward trajectory
through a seeded billboard world at the small configuration of
``tests/test_e2e.py`` (160^2 faces, 600 features, 3 levels, K=24, L=4096),
with the vocabulary trained at the initial map and trained once more when 5
keyframes are live: keyframes are inserted on frames 2, 4, 6 and 8 (slots
2 to 5) and the deferred BA runs on frames 3, 5 and 7; the retraining falls
on frame 6. It runs twice from the first frame: with ``stage_times`` set
(every part eager) and through the graph frames (``FusedStep``, then
``FusedMapping``), which the CPU never takes by itself: ``MapTracker``'s
card condition is lifted for that run.

* ``insert_keyframe`` with its slot, frame id and timestamp as 0-d tensors
  is bitwise the call with Python numbers, and against the JAX function it
  holds ``test_torch_tracking.py``'s tolerances (the written tables exactly
  equal, the refreshed statistics within 1e-5, descriptors bitwise).
  ``mapping_step`` and ``ba_step`` with tensors are in
  ``test_torch_mapping.py``.
* The graph run is bitwise the eager run at every frame (pose, row but for
  the graph counts and stage times, the last frame's tensors, the
  velocity, every arena table, the BoW table and the mapping step's
  diagnostics); graph K runs on the keyframe frames 2, 4 and 8 (frame 6
  retrains, so it runs eagerly and drops the mapping graphs), graph BA on
  frames 3, 5 and 7, and the second keyframe frame writes its own slot,
  frame id and timestamp from the static inputs.
* A moved arena, BoW table or vocabulary tensor raises; ``seed``,
  ``reset`` and ``load_map`` drop the mapping graphs; ``shutdown`` is a
  no-op.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import slam_map as JSM
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.features.extractor import Keypoints as JKeypoints
from cubemapslam_tpu.runtime.kernels import TrackingKernels as JKernels
from cubemapslam_tpu_torch import interop, serialize
from cubemapslam_tpu_torch import place as PL
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.fused_mapping import FusedMapping
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
from cubemapslam_tpu_torch.runtime.tracking import FRAME_KINDS, MapTracker
from slambench.measure.window import plain_frame

E2E = dict(cube_face_w=160, cube_face_h=160, n_features=600, n_levels=3,
           max_keyframes=24, max_landmarks=4096, min_init_keypoints=80,
           min_init_matches=60, min_track_inliers=20, fps=5.0,
           vocab_retrain_keyframes=5)
N_FRAMES = 9
KEYFRAMES = {2: 2, 4: 3, 6: 4, 8: 5}     # frame: slot
BA_FRAMES = (3, 5, 7)
RETRAIN_FRAME = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_state(slam, T):
    """A frame's outcome: its pose, its row without the graph counts and
    stage times, the last frame's tensors, the velocity, every arena table,
    the BoW table and the mapping step's diagnostics, all copied."""
    row = {k: v for k, v in slam.metrics[-1].items()
           if not k.startswith("graph_") and k != "stage_ms"}
    last, tensors = slam.last, []
    if last is not None:
        tensors = [*last.kp, last.assoc, last.outlier, last.R, last.t,
                   last.rel_R, last.rel_t]
    if slam.velocity is not None:
        tensors += list(slam.velocity)
    tables = {k: getattr(slam.arena, k).clone() for k in slam.arena._fields}
    copy = (lambda x: None if x is None else x.clone())
    return dict(T=T, row=row, last=[x.clone() for x in tensors],
                tables=tables, bow=copy(slam.bow_table),
                info=copy(slam._last_mapping_info))


@pytest.fixture(scope="module")
def runs():
    """The 9 frames eagerly and through the graph frames: per frame the
    ``frame_state``, the graph run's ``FusedMapping`` after it and the
    calls of graphs K and BA; the last arguments the eager run gave
    ``insert_keyframe``, with a copy of the arena they were given; both
    systems."""
    cfg = TConfig(**E2E)
    poses = S.forward_trajectory(N_FRAMES)
    world = S.make_world(np.random.default_rng(5), n=600,
                         centers=S.camera_centres(poses), fx=80.0)
    render = S.Renderer(CubemapCamera.from_config(cfg, "cpu"), cfg)
    frames = [S.to_u8(render.render(*world, R, t)[0]) for R, t in poses]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        for name in ("keyframe", "deferred_ba"):
            inner = getattr(FusedMapping, name)

            def spy(self, system, slot, *args, _inner=inner, _name=name):
                calls.append((system.frame_id - 1, _name, slot))
                return _inner(self, system, slot, *args)

            mp.setattr(FusedMapping, name, spy)
        for graph in (False, True):
            slam = CubemapSLAM(cfg, device="cpu")
            inserts = []
            if graph:
                # the card's graph-frame condition, on the CPU
                mp.setattr(MapTracker, "_graph_frame", lambda s: (
                    s.last is not None and s.stage_times is None))
            else:
                slam.stage_times = {}
                insert = slam.kernels.insert_keyframe

                def record(arena, *args):
                    inserts.append((interop.arena_to_numpy(
                        type(arena)(*(x.clone() for x in arena))), args))
                    return insert(arena, *args)

                slam.kernels.insert_keyframe = record
            states, owners = [], []
            for k, img in enumerate(frames):
                T = slam.track_fisheye(img, k / cfg.fps)
                states.append(frame_state(slam, T))
                owners.append(slam.fused_mapping)
            if not graph:
                del slam.kernels.insert_keyframe
            out["graph" if graph else "eager"] = dict(
                slam=slam, states=states, owners=owners,
                inserts=inserts)
        out["calls"] = calls
    return out


def test_insert_keyframe_device_scalars(runs):
    """The slot, frame id and timestamp as 0-d tensors: every table bitwise
    the call with Python numbers; and against the JAX ``insert_keyframe``,
    the tables it writes exactly equal, the refreshed statistics within
    1e-5 and their descriptors bitwise. The arena and arguments are those
    of the eager run's last insertion."""
    slam = runs["eager"]["slam"]
    before, (slot, kp, assoc, outlier, R, t, fid, ts) = \
        runs["eager"]["inserts"][-1]
    assert slot == 5 and fid == 8
    outs = []
    for as_tensors in (False, True):
        a = interop.arena_from_numpy(before)
        args = (slot, fid, ts)
        if as_tensors:
            args = (torch.tensor(slot), torch.tensor(fid),
                    torch.tensor(ts, dtype=torch.float32))
        slam.kernels.insert_keyframe(a, args[0], kp, assoc, outlier, R, t,
                                     *args[1:])
        outs.append(a)
    for f in outs[0]._fields:
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f
    jcfg = JConfig(**E2E)
    jk = JKernels(jcfg, JCam.from_config(jcfg))

    def j(x):
        x = x.numpy()
        return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)

    jkp = JKeypoints(**{k: jnp.asarray(v) for k, v in
                        interop.keypoints_to_numpy(kp).items()})
    ref = jk.insert_keyframe(
        JSM.MapArena(**{k: jnp.asarray(v) for k, v in before.items()}),
        jnp.int32(slot), jkp, j(assoc), j(outlier), j(R), j(t),
        jnp.int32(fid), jnp.float32(ts))
    ours = interop.arena_to_numpy(outs[1])
    for k, v in ref._asdict().items():
        v = np.asarray(v)
        if k in ("lm_normal", "lm_min_dist", "lm_max_dist"):
            np.testing.assert_allclose(ours[k], v, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert ours["kf_valid"][slot] and ours["kf_frame_id"][slot] == fid
    assert not np.array_equal(ours["lm_normal"], before["lm_normal"])


def test_the_sequence_is_a_mapping_case(runs):
    """Keyframes where ``KEYFRAMES`` says, the deferred BA on
    ``BA_FRAMES``, every frame after the first tracked."""
    rows = [s["row"] for s in runs["eager"]["states"]]
    assert all(r["state"] == "OK" for r in rows[1:])
    assert [i for i, r in enumerate(rows) if r.get("keyframe")] == \
        [1] + sorted(KEYFRAMES)
    assert [i for i, r in enumerate(rows) if r.get("ba")] == \
        list(BA_FRAMES)
    assert [r.get("first_free") for i, r in enumerate(rows)
            if i in KEYFRAMES] == list(KEYFRAMES.values())


@pytest.mark.parametrize("run", ["eager", "graph"])
def test_frame_kinds(runs, run):
    """Each row's ``kind``, set where the frame's branch is taken: the two
    initialization frames (the second makes the initial map), then the
    keyframe frames and the deferred-BA frames between them; none is a
    frame that only tracked, as the benchmark's ``plain_frame`` reads the
    rows too."""
    rows = [s["row"] for s in runs[run]["states"]]
    kinds = [r["kind"] for r in rows]
    assert kinds == ["init", "init"] + [
        "keyframe" if k in KEYFRAMES else "ba" for k in range(2, N_FRAMES)]
    assert set(kinds) <= set(FRAME_KINDS)
    assert not any(plain_frame(r) for r in rows)


@pytest.mark.parametrize("part", ["frames", "arena", "bow_and_mapping"])
def test_graph_frames_bitwise_eager(runs, part):
    """The graph run against the eager run at every frame: ``frames`` the
    poses, rows, last-frame tensors and velocity; ``arena`` every table;
    ``bow_and_mapping`` the BoW table and the mapping step's diagnostics."""
    for k, (e, g) in enumerate(zip(runs["eager"]["states"],
                                   runs["graph"]["states"])):
        if part == "frames":
            assert (e["T"] is None) == (g["T"] is None), k
            assert e["T"] is None or np.array_equal(e["T"], g["T"]), k
            assert e["row"] == g["row"], k
            assert len(e["last"]) == len(g["last"]), k
            assert all(torch.equal(x, y)
                       for x, y in zip(e["last"], g["last"])), k
        elif part == "arena":
            bad = [f for f in e["tables"]
                   if not torch.equal(e["tables"][f], g["tables"][f])]
            assert bad == [], (k, bad)
        else:
            for name in ("bow", "info"):
                x, y = e[name], g[name]
                assert (x is None) == (y is None), (k, name)
                assert x is None or torch.equal(x, y), (k, name)
    eager, graph = runs["eager"]["slam"], runs["graph"]["slam"]
    assert eager.trajectory and len(eager.trajectory) == \
        len(graph.trajectory)
    for (ta, Ra, tra), (tb, Rb, trb) in zip(eager.trajectory,
                                             graph.trajectory):
        assert ta == tb and np.array_equal(Ra, Rb) \
            and np.array_equal(tra, trb)


def test_graphs_run_on_the_keyframe_and_ba_frames(runs):
    """Graph K on the keyframe frames but the retraining one, graph BA on
    every deferred-BA frame, each with its slot; the eager run makes no
    ``FusedMapping`` (``stage_times`` keeps every part eager) and the CPU
    captures nothing."""
    want = [(f, "keyframe", s) for f, s in KEYFRAMES.items()
            if f != RETRAIN_FRAME]
    got = runs["graph"]["states"]
    pending = {}
    for f, slot in KEYFRAMES.items():
        pending[f + 1] = slot
    want += [(f, "deferred_ba", pending[f]) for f in BA_FRAMES]
    assert sorted(runs["calls"]) == sorted(want)
    assert all(o is None for o in runs["eager"]["owners"])
    rows = runs["graph"]["slam"].metrics
    assert all(r.get("graph_mapping_captures", 0) == 0
               and r.get("graph_mapping_replays", 0) == 0 for r in rows)
    assert len(got) == N_FRAMES


def test_second_keyframe_writes_its_own_slot(runs):
    """Each keyframe frame through graph K writes the slot, frame id and
    timestamp of its static inputs, and the static inputs hold the last
    keyframe frame's."""
    slam = runs["graph"]["slam"]
    a = slam.arena
    for f, slot in KEYFRAMES.items():
        assert bool(a.kf_valid[slot]) and int(a.kf_frame_id[slot]) == f
        assert float(a.kf_timestamp[slot]) == np.float32(f / slam.cfg.fps)
    s = slam.fused_mapping.inputs
    last = max(KEYFRAMES)
    assert int(s["slot"]) == KEYFRAMES[last]
    assert int(s["frame_id"]) == last and int(s["n_kf"]) == slam.n_kf
    assert float(s["timestamp"]) == np.float32(last / slam.cfg.fps)
    assert int(s["ba_slot"]) == KEYFRAMES[BA_FRAMES[-1] - 1]
    # the copies are the frame's own tensors, not the tracker's
    assert torch.equal(s["R"], runs["graph"]["states"][last]["tables"][
        "kf_R"][KEYFRAMES[last]])


def test_retraining_drops_the_mapping_graphs(runs):
    """The retraining keyframe frame replaces the vocabulary and the BoW
    table: it drops the system's ``FusedMapping``, and the next deferred-BA
    frame makes a new one."""
    owners = runs["graph"]["owners"]
    before = owners[RETRAIN_FRAME - 1]
    assert before is not None
    assert all(o is before for o in owners[2:RETRAIN_FRAME])
    assert owners[RETRAIN_FRAME] is None
    assert owners[RETRAIN_FRAME + 1] is not None
    assert owners[RETRAIN_FRAME + 1] is not before
    assert not runs["graph"]["slam"]._vocab_is_bootstrap


@pytest.mark.parametrize("what", ["arena", "bow_table", "vocab"])
def test_moved_tensor_raises(runs, what):
    """A ``FusedMapping`` whose arena, BoW table or vocabulary was replaced
    raises before it runs."""
    slam = runs["graph"]["slam"]
    fm = slam.fused_mapping
    keep = getattr(slam, what)
    if what == "arena":
        moved = type(keep)(*(t.clone() for t in keep))
    elif what == "vocab":
        moved = PL.Vocabulary([c.clone() for c in keep.centers],
                              keep.idf.clone(), keep.k, keep.depth)
    else:
        moved = keep.clone()
    setattr(slam, what, moved)
    try:
        with pytest.raises(RuntimeError, match="moved"):
            fm.deferred_ba(slam, 2)
        last = slam.last
        with pytest.raises(RuntimeError, match="moved"):
            fm.keyframe(slam, 6, last.kp, last.assoc, last.outlier, last.R,
                        last.t, 99, 1.0)
    finally:
        setattr(slam, what, keep)


def test_owners_drop_the_mapping_graphs(runs, tmp_path):
    """``seed``, ``reset`` and ``serialize.load_map`` drop the mapping
    graphs with the tracked frame's."""
    src = runs["eager"]["slam"]
    cfg = src.cfg
    slam = CubemapSLAM(cfg, device="cpu")
    slam._fused_mapping = FusedMapping(slam)
    last = src.last
    slam.seed(src.arena.to("cpu"), last.kp, last.assoc, last.outlier,
              last.R, last.t, last.ref_kf, frame_id=last.frame_id)
    assert slam.fused_mapping is None
    slam._fused_mapping = FusedMapping(slam)
    slam.reset()
    assert slam.fused_mapping is None
    path = str(tmp_path / "map.npz")
    serialize.save_map(src, path)
    slam._fused_mapping = FusedMapping(slam)
    serialize.load_map(slam, path)
    assert slam.fused_mapping is None


def test_shutdown_is_a_noop(runs):
    """``CubemapSLAM.shutdown`` (System::Shutdown, a no-op in the JAX
    package) returns None and changes nothing."""
    slam = runs["eager"]["slam"]
    tables = {k: getattr(slam.arena, k).clone() for k in slam.arena._fields}
    n_rows, state, n_kf = len(slam.metrics), slam.state, slam.n_kf
    assert slam.shutdown() is None
    assert (len(slam.metrics), slam.state, slam.n_kf) == (n_rows, state,
                                                          n_kf)
    assert all(torch.equal(getattr(slam.arena, k), v)
               for k, v in tables.items())
