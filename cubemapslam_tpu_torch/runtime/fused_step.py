"""The tracked frame as captured CUDA graphs.

``FusedStep`` is the port's counterpart of the JAX package's one-program
tracked frame (``CubemapSLAM._build_fused_step``,
``cubemapslam_tpu/runtime/system.py:278-303``: warp, cross assembly,
``extract`` and ``track_frame_full`` under one ``jax.jit``, whose
fallbacks are ``lax.cond`` branches on the device). The port's frame
branches on the host (``runtime/kernels.py``), so it is a graph for each
part between two reads, each captured on the first frame that runs it and
replayed on every later one:

* graph A: the front end (``CapturedFrame.front_end``, which
  ``runtime/fused_localization.py`` records too: the static fisheye buffer
  through kernel W (``warp_to_cross``), ``extract`` (the pyramid products,
  kernel D's two launches, the top-k and the describe kernel)), then
  ``TrackingKernels.frame_motion`` (the re-anchoring, the velocity gate and
  the prediction, the 15 px projection search and the pose-only LM) and
  the counts [matches, inliers];
* host read 1 of those counts; then the fallbacks that the counts call
  for, in the JAX order (``TrackingKernels.motion_fallbacks``), each a
  graph on graph A's outputs followed by one read of its counts: graph W
  (30 px from the prediction), graph Z (30 px from the last pose) and
  graph R (the reference keyframe and a pose solve); the stage tuple the
  host keeps is copied into graph A's outputs, which graph B or S reads;
* graph B, when the frame tracks: ``TrackingKernels.frame_local``
  (TrackLocalMap, with the arena's visible/found counters updated in place,
  then the epilogue); graph S, when it does not: ``frame_skip`` (the
  epilogue alone);
* the last host read, of the packed result, by the caller.

Static inputs. Before a replay the frame's inputs are copied into buffers
that do not move: the fisheye frame, the mask (only when it is not the
tensor, at the same version, that was copied last), the last frame's
associations, outliers, keypoint levels and angles, its pose relative to
its keyframe, that keyframe's slot, the velocity and its gain, the
reference keyframe's slot, and the covisibility and observation-count
views (only when they are not the tensors copied last). Slots and the gain
are written by fills, so no input makes the host wait, except the upload of
a frame that arrives as a host array, as on the eager path.

The arena is read and updated in place by the graphs, so its tensors must
stay where they were at capture: every tensor the graphs read that the
tracker owns (the arena's tables and the tracker's buffers) is checked by
``data_ptr`` before each replay, and a moved one raises. Whoever replaces
the arena drops the graphs (``MapTracker.drop_graphs``: ``seed``,
``CubemapSLAM.reset``, ``serialize.load_map``).

Outputs. A graph's outputs live in its memory pool and the next replay
writes over them, so everything that outlives the frame (the keypoints,
the associations, outliers, pose, the pose relative to the new reference,
the velocity and the packed result) is cloned after the frame; the clones
are what the caller keeps. The graphs share one private pool. Within a
frame they replay as A, then any of W, Z and R, then B or S; a graph
captured later than another may have put its outputs where the earlier
one keeps its temporaries, so every output is consumed (read, copied into
graph A's outputs or cloned) before a graph captured earlier replays: W's,
Z's and R's before B or S, which each frame replays last.

Capture (``CapturedFrame``, which ``runtime/fused_mapping.py`` shares). The
first frame that needs a graph runs its part eagerly on a side stream
(which warms every library handle and workspace on that stream, and is that
frame's own work, so the arena's counters are updated once), then captures
the same part on that stream into the pool (``CUDAGraph.capture_begin``
/ ``capture_end``: no synchronization and the allocator's cache kept,
where ``torch.cuda.graph`` would empty it first), and
copies the eager outputs into the graph's outputs. A hand-written kernel's
wrapper counts a Python call, and a replay makes none, so each capture
records every ``CudaKernel``'s launches during it, takes them back, and
adds them again on each replay.

No fallback: on the card a failed capture, a failed replay or a moved
tensor raises. On the CPU (the tests) there is no graph: each part runs
eagerly on the same static buffers, so the copies, the fallback copy, the
clones and the ``data_ptr`` check are the same code.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from cubemapslam_tpu_torch._build import CudaKernel, capture_ops
from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.runtime.kernels import FrameTrack
from cubemapslam_tpu_torch.spans import (Census, Table, host_read, replayed,
                                         span)

N_KP = len(Keypoints._fields)
# host waits of one capture: capture_begin / capture_end synchronize
# nothing (a capturing loop closure waits only for its reads)
CAPTURE_WAITS = 0


class CapturedFrame:
    """Static input buffers, and parts of a frame captured as CUDA graphs
    into one private memory pool, each replayed on every later call.

    ``run(name, part)`` runs ``part()`` (which returns a list of tensors)
    and keeps its outputs in ``outputs[name]``: the first time on the card
    eagerly on a side stream and then captured (see the module docstring),
    every later time by replaying the graph; on the CPU, or made with
    ``graphs=False``, eagerly every time.
    ``check(named)`` records the data pointers of the (name, tensor) pairs
    the parts read the first time it is called and raises on a later call
    if one moved. ``captures`` and ``replays`` count the graphs captured
    and replayed so far, ``frame_captures`` / ``frame_replays`` those since
    ``new_frame()`` and ``frame_replayed`` their names (upper case, in
    replay order), ``capture_ms`` the host's wall time in
    the capture and ``capture_mib`` the device memory the
    captures' pool reserved.

    Spans (``spans.py``): a replay is ``graph.<owner>.<NAME>`` (``owner``
    names the subclass: ``graph.loc.L1``, ``graph.step.A``), a capture
    ``graph.<owner>.<NAME>.capture``; ``census[name]`` is the census table
    of the part's capture (``spans.Census``, the first entry the graph's
    own span with its total of device operations), built once a capture;
    a replay while a profiler records hands it to the open frame's row.

    One pool serves every part of an instance. A graph writes its
    temporaries into the pool on each replay, so a part that another part
    captured later reads (graph B reads graph A's outputs) must be replayed
    before it, and outputs that the caller keeps are cloned after the
    replay that wrote them."""

    label = "captured frame"
    owner = "frame"

    def __init__(self, device: torch.device, graphs: bool = True):
        self.device = device
        self.graphs = graphs and device.type == "cuda"
        self.inputs: Dict[str, torch.Tensor] = {}
        self.outputs: Dict[str, List[torch.Tensor]] = {}
        self._graph: Dict[str, torch.cuda.CUDAGraph] = {}
        self.census: Dict[str, Table] = {}
        self._launch_delta: Dict[str, List[Tuple[CudaKernel, int]]] = {}
        self._sources: Dict[str, Tuple[int, int]] = {}
        self._held: Dict[str, torch.Tensor] = {}
        self._pointers: Optional[List[Tuple[str, int]]] = None
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._stream = torch.cuda.Stream(device) if self.graphs else None
        self.captures = self.replays = 0
        self.frame_captures = self.frame_replays = 0
        self.frame_replayed: List[str] = []
        self.capture_ms = 0.0
        self.capture_mib = 0.0

    # ------------------------------------------------------------------
    # Static inputs
    # ------------------------------------------------------------------

    def _static(self, name: str, like: torch.Tensor) -> torch.Tensor:
        buf = self.inputs.get(name)
        if buf is None:
            buf = torch.empty_like(like, device=self.device,
                                   memory_format=torch.contiguous_format)
            self.inputs[name] = buf
        elif buf.shape != like.shape or buf.dtype != like.dtype:
            raise ValueError(f"{self.label}: input {name} is "
                             f"{tuple(like.shape)} {like.dtype}, the "
                             f"captured graphs take {tuple(buf.shape)} "
                             f"{buf.dtype}")
        return buf

    def _copy(self, name: str, src: torch.Tensor) -> None:
        self._static(name, src).copy_(src)

    def _copy_if_new(self, name: str, src: torch.Tensor) -> None:
        """Copy ``src`` unless it is the tensor, at the same version, that
        was copied into ``name`` last."""
        key = (id(src), src._version)
        if self._sources.get(name) == key and name in self.inputs:
            return
        self._copy(name, src)
        self._sources[name] = key
        # the source is kept alive, so that no other tensor takes its id
        self._held[name] = src

    def _fill(self, name: str, value, dtype: torch.dtype) -> None:
        buf = self.inputs.get(name)
        if buf is None:
            buf = torch.empty((), dtype=dtype, device=self.device)
            self.inputs[name] = buf
        buf.fill_(value)

    # ------------------------------------------------------------------
    # The front end: warp and extract
    # ------------------------------------------------------------------

    def load_front_end(self, tracker, fisheye, mask) -> None:
        """Copy a frame's (H, W) uint8 fisheye image (an array or a tensor)
        into the static ``fisheye`` buffer, and ``tracker.as_mask(mask)``
        into ``mask`` when it is not the tensor, at the same version, that
        was copied last."""
        W, H = tracker.src_wh
        img = torch.as_tensor(fisheye)
        if img.shape != (H, W) or img.dtype != torch.uint8:
            raise ValueError(f"fisheye must be ({H}, {W}) uint8, got "
                             f"{tuple(img.shape)} {img.dtype}")
        self._copy("fisheye", img)
        self._copy_if_new("mask", tracker.as_mask(mask))

    def front_end(self, tracker) -> Keypoints:
        """Kernel W on the static fisheye buffer, then ``extract`` with the
        static mask: the keypoints of the frame that ``load_front_end``
        loaded, as a part records them."""
        s = self.inputs
        with span("warp"):
            cube = tracker.warp(s["fisheye"])
        with span("extract"):
            return tracker.extract(cube, s["mask"])

    # ------------------------------------------------------------------
    # Capture and replay
    # ------------------------------------------------------------------

    def new_frame(self) -> None:
        self.frame_captures = self.frame_replays = 0
        self.frame_replayed = []

    def check(self, named: Sequence[Tuple[str, torch.Tensor]]) -> None:
        """Record where the tensors of ``named`` lie the first time; later,
        raise if one has moved (the arena replaced, a buffer reassigned)."""
        now = [(k, t.data_ptr()) for k, t in named]
        if self._pointers is None:
            self._pointers = now
            return
        where = dict(now)
        moved = [k for k, p in self._pointers if where.get(k) != p]
        if moved:
            raise RuntimeError(
                f"{self.label}: {', '.join(moved[:4])}"
                f"{' ...' if len(moved) > 4 else ''} moved since the graphs "
                f"were captured; drop the graphs (MapTracker.drop_graphs) "
                f"where the arena is replaced")

    def check_tracker(self, tracker) -> None:
        """``check`` on every tensor the parts read that the tracker owns:
        the arena's tables and the tracker's buffers."""
        named = [(f"arena.{k}", getattr(tracker.arena, k))
                 for k in tracker.arena._fields]
        self.check(named + list(tracker.named_buffers()))

    def run(self, name: str, part: Callable[[], List[torch.Tensor]]
            ) -> List[torch.Tensor]:
        """Part ``name`` of the frame: replayed from its graph, or, the first
        time, run eagerly on the side stream and captured (on the CPU, run
        eagerly every time). Its outputs are ``self.outputs[name]``."""
        if not self.graphs:
            self.outputs[name] = part()
            return self.outputs[name]
        graph = self._graph.get(name)
        if graph is not None:
            table = self.census[name]
            with span(table[0][0]):
                graph.replay()
            replayed(table)
            for k, d in self._launch_delta[name]:
                k.launches += d
            self.replays += 1
            self.frame_replays += 1
            self.frame_replayed.append(name.upper())
            return self.outputs[name]
        label = f"graph.{self.owner}.{name.upper()}"
        with span(label + ".capture"):
            graph, delta, static, census = self._capture(name, label, part)
        self._graph[name] = graph
        self.census[name] = census.table()
        self._launch_delta[name] = delta
        self.outputs[name] = static
        self.captures += 1
        self.frame_captures += 1
        return static

    def _capture(self, name: str, label: str,
                 part: Callable[[], List[torch.Tensor]]):
        """Run part ``name`` eagerly on the side stream, then capture it
        there under its census, named ``label``. Returns (graph, launch
        deltas, the graph's outputs holding the eager outputs, census)."""
        main, side = torch.cuda.current_stream(self.device), self._stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            eager = part()
            before = [(k, k.launches) for k in CudaKernel.instances]
            graph = torch.cuda.CUDAGraph()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            # capture_begin / capture_end, not torch.cuda.graph, which
            # synchronizes and empties the allocator's cache first: the
            # cache stays, so the eager work after a capture allocates no
            # memory anew (cudaMalloc / cudaFree that can stall for tens of
            # ms), and the pool takes new blocks only for what it holds
            try:
                graph.capture_begin(pool=self._pool)
                try:
                    with Census(label, lambda: capture_ops(side)) as census:
                        static = part()
                finally:
                    graph.capture_end()
            except Exception as e:
                raise RuntimeError(f"{self.label}: the capture of graph "
                                   f"{name.upper()} failed: {e}") from e
            self.capture_ms += (time.perf_counter() - t0) * 1e3
            self.capture_mib += (torch.cuda.memory_reserved(self.device)
                                 - reserved) / 2 ** 20
            delta = []
            for k, n in before:
                if k.launches != n:
                    delta.append((k, k.launches - n))
                    k.launches = n
            for s, e in zip(static, eager):
                s.copy_(e)
        main.wait_stream(side)
        return graph, delta, static, census

    def drop(self, names: Sequence[str]) -> None:
        """Forget the parts ``names``: their graphs and outputs. What they
        held goes back to the pool, where later captures take it."""
        for name in names:
            self._graph.pop(name, None)
            self.census.pop(name, None)
            self._launch_delta.pop(name, None)
            self.outputs.pop(name, None)


class CapturedLoop(CapturedFrame):
    """The body of an iteration loop as one CUDA graph, captured once and
    replayed for the iterations after the first: ``repeat(name, body, n)``
    runs ``body()`` n times. The body updates a fixed set of state tensors
    in place and returns nothing; whatever it reads (the state, the
    problem, its segment plans) the caller keeps alive until the last
    replay.

    On the card the first ``run`` runs the body eagerly on the side stream,
    which is one iteration (the state advances), and then captures it,
    which records its launches without running them (the state does not
    advance again); every later ``run`` replays the graph, one iteration
    each. So n calls are n iterations, wherever the capture falls. On the
    CPU every call runs the body eagerly. An instance serves one solve and
    is dropped after it with its graph and pool: the next solve's shapes
    may differ."""

    label = "captured loop"
    owner = "iter"

    def repeat(self, name: str, body: Callable[[], None], n: int) -> None:
        def part() -> List[torch.Tensor]:
            body()
            return []

        for _ in range(n):
            self.run(name, part)


class FusedStep(CapturedFrame):
    """Static buffers, the graphs and their pool for one tracker's frame.
    Call it as ``step(tracker, fisheye, mask, last, velocity, gain,
    ref_kf)``; it returns (keypoints, ``FrameTrack``). Graph A and B or S
    run every frame, W, Z and R when the counts call for them, in that
    order."""

    label = "fused step"
    owner = "step"

    def __init__(self, tracker):
        super().__init__(tracker.device)

    def load_inputs(self, tracker, fisheye, mask, last, velocity, gain: float,
                    ref_kf: int) -> None:
        """Copy one frame's inputs into the static buffers (see the module
        docstring). ``fisheye`` is an (H, W) uint8 array or tensor,
        ``mask`` what ``FrameFrontend.as_mask`` takes, ``last`` the
        tracker's ``LastFrame`` and ``velocity`` (R, t)."""
        self.load_front_end(tracker, fisheye, mask)
        self._copy("last_assoc", last.assoc)
        self._copy("last_outlier", last.outlier)
        self._copy("last_level", last.kp.level)
        self._copy("last_angle", last.kp.angle)
        self._copy("rel_R", last.rel_R)
        self._copy("rel_t", last.rel_t)
        self._fill("last_ref", last.ref_kf, torch.int64)
        self._copy("vel_R", velocity[0])
        self._copy("vel_t", velocity[1])
        self._fill("gain", gain, torch.float32)
        self._fill("ref_kf", ref_kf, torch.int64)
        self._copy_if_new("covis", tracker.covis)
        self._copy_if_new("cnt", tracker.cnt)

    # ------------------------------------------------------------------
    # The parts
    # ------------------------------------------------------------------

    def _last(self) -> Tuple[torch.Tensor, ...]:
        s = self.inputs
        return (s["last_assoc"], s["last_outlier"], s["last_level"],
                s["last_angle"])

    def _part_a(self, tracker) -> List[torch.Tensor]:
        """Warp, extract and ``frame_motion``, flat: the keypoints' fields,
        the stage tuple (assoc, n, R, t, outlier, n_inl), (R_last, t_last,
        R_pred, t_pred) and the counts."""
        s = self.inputs
        kp = self.front_end(tracker)
        st, pose, counts = tracker.kernels.frame_motion(
            tracker.arena, kp, *self._last(), s["rel_R"], s["rel_t"],
            s["last_ref"], s["vel_R"], s["vel_t"], s["gain"])
        return [*kp, *st, *pose, counts]

    def _a(self):
        """Graph A's outputs: (keypoints, stage tuple, (R_last, t_last,
        R_pred, t_pred)); the stage tuple is the one graph B or S reads."""
        a = self.outputs["a"]
        return (Keypoints(*a[:N_KP]), a[N_KP:N_KP + 6],
                tuple(a[N_KP + 6:N_KP + 10]))

    def _part_b(self, tracker) -> List[torch.Tensor]:
        """``frame_local`` on graph A's outputs (the stage tuple possibly
        overwritten by a fallback's)."""
        kp, st, pose = self._a()
        return list(tracker.kernels.frame_local(
            tracker.arena, kp, st, *pose[:2], self.inputs["ref_kf"],
            self.inputs["covis"], self.inputs["cnt"]))

    def _part_s(self, tracker) -> List[torch.Tensor]:
        """``frame_skip`` on graph A's outputs (the stage tuple possibly
        overwritten by a fallback's)."""
        _, st, pose = self._a()
        return list(tracker.kernels.frame_skip(
            tracker.arena, st, *pose[:2], self.inputs["ref_kf"],
            self.inputs["cnt"]))

    # ------------------------------------------------------------------
    # One frame
    # ------------------------------------------------------------------

    def __call__(self, tracker, fisheye, mask, last, velocity, gain: float,
                 ref_kf: int) -> Tuple[Keypoints, FrameTrack]:
        with span("host.inputs"):
            self.new_frame()
            self.check_tracker(tracker)
            self.load_inputs(tracker, fisheye, mask, last, velocity, gain,
                             ref_kf)
        k = tracker.kernels
        counts = self.run("a", lambda: self._part_a(tracker))[-1]
        kp, st, pose = self._a()
        n, n_inl = host_read(counts)
        path = ["motion"]
        parts = k.fallback_parts(tracker.arena, kp, self._last(), pose,
                                 self.inputs["ref_kf"])
        st_f, n, n_inl, reads = k.motion_fallbacks(
            lambda name: self.run(name, parts[name]), tuple(st), n, n_inl,
            path)
        for dst, src in zip(st, st_f):
            if dst is not src:
                dst.copy_(src)
        if n >= 15 and n_inl >= 10:
            out = self.run("b", lambda: self._part_b(tracker))
            path.append("local")
        else:
            out = self.run("s", lambda: self._part_s(tracker))
            path.append("skip_local")
        with span("host.keep"):
            kp = Keypoints(*(x.clone() for x in kp))
            out = [x.clone() for x in out]
        return kp, FrameTrack(tracker.arena, *out, tuple(path), reads + 1)
