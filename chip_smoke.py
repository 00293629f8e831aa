#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cubemapslam_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card at the shapes
of the Lafida cam0 working configuration (754x480 fisheye, 650^2 faces, a
1950x1950 cross, 2000 features over 8 levels, 8192 landmarks), times them
(``ms``: a wrapper call as the frame step pays it, host launch cost
included; ``device_ms``: the same calls replayed from a CUDA graph, the
device's time alone), then drives the per-frame tracking step
(``FrameTracker``) on a seeded synthetic fisheye frame and checks the
recovered pose, and that each kernel was launched once a frame (kernel D's
two passes once each). It then runs the same step under ``torch.profiler``
with one range per stage, for the device's busy time and idle share, the
five device operations with the most time in each stage, each kernel's
device time, and a check that the card's extract makes no product with the
dense descriptor operator; and it holds the card's frame step against the
same step on the CPU at a small size.

Then the tracking path against the map arena, at ``SlamConfig()`` defaults
(an arena of 512 keyframes x 2000 features and 65536 landmarks): it builds
a map (``build_map``: 6 keyframes rendered along a forward trajectory
through a seeded world of 1500 billboards), drives ``MapTracker`` over the
8 frames that follow a warm-up frame twice from the map as built: eagerly
(``stage_times`` set) and through the captured CUDA graphs
(``runtime/fused_step.py``; the warm-up frame captures them), requiring
the same bits at every frame and in the arena after them, and checking
that every frame tracks within the stated pose bound of the ground truth,
that TrackLocalMap adds matches on most frames and that each kernel
launches once a frame (kernel D's passes once each, the capture frame
included) on both; prints both medians, the capture's host time and the
memory it took; profiles 2 more eager frames with one range per stage and
2 graph frames (device busy, idle share, host waits: at most the upload
and the 2 reads); forces the fallback, velocity-gate and blank-frame
branches eagerly and through the graphs, bitwise equal; and holds
``MapTracker`` on the card against the CPU on a small map. A graph frame
must run fewer than ``GRAPH_MAX_OPS`` device operations. The pose-LM kernel
(``csrc/pose_lm.cu``, the whole pose-only LM in one launch of one cluster
of 1, 2, 4 or 8 blocks) is then held bitwise against its kernel-order plain
version (``pose_optimization_ordered``) at every cluster size on the first
pose solve of the eager run's first frame (recorded as the frame ran; the
graph run's is the same bits) and on seeded problems of 37, 2000 and 6000
edges, timed at every cluster size on each (device, wrapper, a pass) with
its serial floor (no edge, every iteration) and the ptxas line of each
size, and, at the size the wrapper picks, beside the masked eager LM it
replaced (from a CUDA graph and eagerly).
Its launches are counted from 0 around the drive of every path (frame step,
tracking eagerly and through the graphs, slam, repeat, reloc, localization,
app), each required > 0, the graph run's equal to the eager run's and the
repeat run's to the slam drive's.

Then the whole system from its first frame, the ``slam`` phase:
``CubemapSLAM`` at ``SlamConfig()`` defaults (2000 features, 6000 at init)
over a rendered 30-frame sequence through a seeded world of 1500
billboards, one line a frame (state, counts, keyframe, deferred BA, host
reads, the wall ms of each stage), checked for initialization within 10
frames, every later frame tracked, 3 keyframes beyond the first 2, new
landmarks triangulated, a deferred BA, the launches of each kernel (one a
frame, kernel D's passes once each) and the ATE of the Sim3-aligned
trajectory; then one keyframe frame and one deferred-BA frame under the
profiler, whose host waits may not exceed their stated reads and the
upload (and one wait for each graph the frame captures: the profiled
frames run with ``stage_times`` unset, so their tracking replays the
graphs, and their mapping ``FusedMapping``'s graph K or graph BA,
``runtime/fused_mapping.py``, which these frames capture: their capture's
host ms and memory are printed); the same kinds of frame once more on the
``repeat`` run's system, whose mapping graphs are captured, so that the
frames reported replay them; the ``repeat`` check (the same 30 frames
again in a fresh ``CubemapSLAM`` with ``stage_times`` unset, so every
tracked frame replays the captured graphs, and every keyframe and
deferred-BA frame graph K or BA after the one that captured it: every
arena table and the trajectory bitwise equal to the eager first run's,
whose sha256 digest is printed on a line of its own so that runs can be
compared across calls, every kernel launched once a frame and the
segmented sum as often as in the eager drive; the wall ms by kind of
frame beside the eager drive's); and ``mapping_step`` / ``local_ba`` on
the card against the CPU on a small arena. Each profiled keyframe frame
launches the triangulation kernel once (graph K's replays included), and
one that replays graph K runs at most ``KEYFRAME_MAX_OPS`` device
operations. Initialization through ``FusedInit``
(``runtime/fused_init.py``: graph I0, the front end; I1, the front end and
the bootstrap match; I2, the RANSAC with the essential's three eigen-solves
on the ``sym_eig`` kernel and the reconstruction; ``[init-graph]`` /
``[init-profile]`` lines): two systems of the drive's seed over its frames
up to the initializing one, ``INIT_CYCLES`` times with a reset between,
one through the graphs and one eagerly, every frame and attempt bitwise
equal; the first cycle captures, the middle ones give the replaying walls,
the first and the last are profiled (no wait in ``torch.linalg.svd``; a
graph frame's waits at most its reads and the upload; at least
``INIT_MIN_REPLAYS`` attempts replay). A fresh eager ``CubemapSLAM`` over
the same frames counts the init path's triangulation launches and profiles the drive's first mapping
step with a range around each call graph K makes (the insertion and BoW
row, culling, the pairs' geometry, the 6 epipolar searches, the one
launch that triangulates and gates all 6 pairs, the commit, the 8 fuses,
the landmark statistics, keyframe culling), each device operation given
to its innermost range: ``[graph-k]`` lines of busy ms and operations by
part (the pairs' geometry at most ``GRAPH_K_GEOMETRY_MAX_OPS``). Then the
``triangulate`` phase: the triangulation kernel (``csrc/triangulate.cu``,
one thread a row of B pairs x N correspondences) in its gated form
bitwise against ``triangulate_gated_ordered`` on that mapping step's call
(recorded as the drive ran) and on seeded problems, and in its ungated
form against ``triangulate_rays_ordered`` and its one-pair launches, at
1, 4 and 6 pairs of 0, 1, 37, 2000 and 6000 rows with degenerate rows
(parallel, axis-aligned, NaN rays, out-of-range levels; a zero baseline;
zero pivots), eagerly and from a CUDA graph; the ungated form within
``TRI_REF_RTOL`` of the matmul path it replaced on the rows of
``tri_ref_rows``, the gated form's decisions against the eager gates it
replaced (a row decided otherwise lies within ``TRI_FLIP_ULPS`` of the
gate that turned); timed by block size, beside ``torch.linalg.eigh`` on
the same normal matrices and the replaced path. Its launches are counted
on the slam, repeat, init, reloc, localization and app paths. The
``slam`` phase loads the
repo's pretrained vocabulary (``artifacts/vocab_synth_10k.npz``), and each
keyframe gets its BoW row. The segmented-sum kernel (``csrc/seg_sum.cu``,
which gives the BA, the pose graph and the landmark normals a fixed order
of additions) runs a data-dependent number of times: its launches are
counted from 0 around the drive of each path (the mapping step and the
local BA here, the correction and the global BA of the loop closure, the
runner, the sharded BA), and each of those must launch it.

Then, on the ``slam`` phase's map: the ``reloc`` phase (2 blank frames make
the system LOST without a reset; from that state the frame at the
ground-truth pose of a mid-sequence frame relocalizes three times: eagerly
(``reloc_graphs`` off), through ``FusedLocalization``'s graph X (the
front end, ``runtime/fused_localization.py``) and ``FusedReloc``'s graphs
R (a candidate: match, PnP, LM) and W (the widening pass), capturing them
and replaying them (``runtime/fused_reloc.py``), the graph frames bitwise
equal to the eager
one, each within the stated bound of the ground truth through the ATE's
Sim3 alignment, the wall ms of each kind and the capture's ms and pool MiB
printed; twice more under the profiler, eagerly and replaying, whose host
waits may not exceed the frame's stated reads and the upload); the
``sym_eig`` check (the
eigen-solve kernel ``csrc/sym_eig.cu``, a round-robin Jacobi, one warp a
matrix, bitwise against its kernel-order plain version ``sym_eig_ordered``
on the six solves of the reloc frame's first PnP, recorded as it ran, on
those of a seeded 2000-point scene and on special matrices at n = 3, 4, 9
and 12, eagerly and from a CUDA graph; timed on the recorded solves beside
``torch.linalg.eigh``, the bound and the serial floor: a solve's most steps
a matrix times one step's measured latency; and on the essential solver's
three solves of the slam drive's first two-view attempt, the (200,9,9)
float64 normal matrices, the (200,3,3) and (1,3,3) EᵀE, and float64
specials at n = 9, timed beside the ``torch.linalg.svd`` each replaced,
with its host waits); the ``localization`` phase (6
frames tracked in localization mode with the map unchanged through
``FusedLocalization``'s graphs L1 (front end and 15 px search) and L3
(TrackLocalMap), each within the bound, the worst frame and its margin to
the bound printed; the arena and tracker restored and the 6 frames run
eagerly, bitwise equal; a frame with its last association emptied through
graph L2 (30 px), the eager reference-keyframe fallback and L3, bitwise
its eager twin; 2 graph and 2 eager frames under the profiler (busy ms,
operations, host waits against the stated reads and the upload); perturbed
landmarks engage mbVO, restored ones relocalize and clear it); a save/load
check
(``save_map``, ``load_map`` into a fresh ``CubemapSLAM``, whose next frame
relocalizes); and ``word_ids`` / ``bow_vector``, ``detect_candidates`` and
``pnp_ransac`` on the card against the CPU on seeded inputs. The ``slam`` phase runs with loop closing on: its
forward trajectory revisits nothing, so it must close no loop, and each
keyframe from the tenth runs loop detection (its wall ms is printed).

Last, the ``loop`` phase: the constructed-drift arena (14 keyframes,
segment B revisiting segment A under a Sim3 drift) at ``SlamConfig()``
capacities (512 keyframes x 2000 features, 65536 landmarks), with the
repo's vocabulary. On its arena the segmented-sum kernel is held bitwise
against its kernel-order plain version at the global BA's shapes (its live
edges by camera and by point) and at those of the local BA, the pose graph
and the landmark normals, and timed beside ``index_add_``;
``LoopCloser.process`` on slots 12 and 13 closes a fresh copy of the
arena once eagerly (``LoopCloser.graphs`` off) and once through the CUDA
graphs (DetectLoop and ComputeSim3 through ``FusedLoop``'s graphs D, M and
S, ``runtime/fused_loop.py``; CorrectLoop through its ``FusedCorrect``'s
graph C, the Gauss-Newton step at the closure's edge capacity and graph F,
captured once a system; the global BA through its ``FusedGlobalBA``'s
graphs B, P, L, X and W at the live count's edge capacity, captured once a
system too): each must close the loop, cut the segment-B
error to the stated share (a miss is raised after the last phase), launch
the segmented sum the stated number of times by stage and the eigen-solve
kernel twice (one Sim3 RANSAC), and every table of the two closed arenas
must be bitwise equal (the digest is printed); the graph copy's arena,
restored in place and closed again, must replay graphs D, M and S, the
correction's and the global BA's graphs, capture none of them and give the
same tables. A
warm closure eagerly, capturing (a fresh copy) and replaying
(that copy restored) prints the wall time of each stage (detect, sim3,
correct, gba), the host reads, the eigen-solve waits, the captures,
replays, capture ms, pool MiB and capture waits, and the peak memory; the
same three are closed under the profiler (``process(12)`` alone for
``loop.detect``, then the closure) by stage and by ComputeSim3's eager,
the correction's and the global BA's sub-ranges (whose host waits may not
exceed the stated reads, eigen-solve waits and capture waits; the
replaying closure's ``loop.correct`` at most LOOP_CORRECT_WAITS and
``loop.gba`` at most LOOP_GBA_WAITS), printed side by side, with each
stage's and the global BA's parts' device busy ms and pool MiB; the eigen-solve kernel is held bitwise on the eager
closure's two Sim3 RANSAC solves and timed beside ``torch.linalg.eigh``;
and it holds the closure on the card against the CPU at the tier-1 test's
size, the correction and the global BA each within its stated bounds.

Then the ``app`` phase: the ``slam`` phase's rendered frames written as PGM
files with a Lafida "id ts path" list under ``build/``, run through the
dataset runner ``apps.run_sequence.main`` with the reference argv (the
repo's vocabulary, ``SETTINGS_YAML none``: ``SlamConfig()``, ``MASK none``)
on the card, with the kernels' launch counts read around it; checked: the
native loader read the frames, every frame from initialization on is
tracked, no loop is closed, and the tracked frames' Sim3-aligned ATE is
under the ``slam`` bound (the TUM file's keyframes and their ATE are
printed); the median frame time (its tracked frames replay the graphs) is
printed.
Last, the ``dist`` phase: the ``loop`` phase's arena, its global BA problem
on its live edges sharded with landmark ownership and solved by
``dist.distributed_bundle_adjust`` at world size 1 over NCCL (this process)
and 2 over gloo (two spawned ranks sharing the card; gloo stages CUDA
tensors through the host), each held against the single-process
``bundle_adjust`` of the same layout on the card within the stated bounds,
with the wall times and the boundary rows reduced each CG iteration. The
viewer (``viz``) needs matplotlib, which the card's machine lacks, so no
phase draws.

Output: progress lines, then one ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and the last line is missing. Without a CUDA card, or
without the package beside it, it exits non-zero before printing a result.
This script imports nothing of JAX.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import datetime
import gc
import hashlib
import io
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from cubemapslam_tpu_torch import (CubemapCamera, SlamConfig, _build,
                                   load_config)
from cubemapslam_tpu_torch import camera as TC
from cubemapslam_tpu_torch import dist as D
from cubemapslam_tpu_torch import interop, native, serialize
from cubemapslam_tpu_torch import place as PL
from cubemapslam_tpu_torch import segment as SG
from cubemapslam_tpu_torch import slam_map as SMAP
from cubemapslam_tpu_torch import warp as TW
from cubemapslam_tpu_torch import warp_cuda
from cubemapslam_tpu_torch.apps import run_sequence
from cubemapslam_tpu_torch.features import extractor as TE
from cubemapslam_tpu_torch.geometry import so3_exp, so3_log
from cubemapslam_tpu_torch.optim import ba as TBA
from cubemapslam_tpu_torch.optim import pose_opt as PO
from cubemapslam_tpu_torch.optim import residuals as TR
from cubemapslam_tpu_torch.optim.ba import BAProblem, bundle_adjust
from cubemapslam_tpu_torch.runtime import FrameTracker
from cubemapslam_tpu_torch.runtime import kernels as TK
from cubemapslam_tpu_torch.runtime import mapping as TMAP
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.synthetic import (
    landmarks_from_keypoints, perturbed_pose, synthetic_fisheye)
from cubemapslam_tpu_torch.runtime import loop_closing as LC
from cubemapslam_tpu_torch.runtime.fused_loop import LoopGraphOwner
from cubemapslam_tpu_torch.runtime.fused_step import CAPTURE_WAITS
from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser
from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM, TrackState
from cubemapslam_tpu_torch.runtime.tracking import MapTracker
from cubemapslam_tpu_torch.solvers import horn_alignment
from cubemapslam_tpu_torch.solvers import essential as ES
from cubemapslam_tpu_torch.solvers import pnp as PNP
from cubemapslam_tpu_torch.solvers import sim3 as S3
from cubemapslam_tpu_torch.solvers import sym_eig as SE
from cubemapslam_tpu_torch.solvers import triangulate as TT
from cubemapslam_tpu_torch.solvers.sampling import sample_minimal_sets

SEED = 0
N_LANDMARKS = 8192
N_FRAMES = 6                  # the first is a warm-up frame
PROFILE_FRAMES = 3            # frame steps under the profiler
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12    # float32 outside the tensor cores
H100_F64_OPS_PER_S = 34e12    # float64 outside the tensor cores, H100 SXM
                              # data sheet
TIMING_REPS, TIMING_BATCH = 7, 20
SOURCES = ("warp_remap.cu", "orb_detect.cu", "orb_describe.cu",
           "seg_sum.cu", "pose_lm.cu", "triangulate.cu", "sym_eig.cu")
# launches of each kernel entry in one frame step
LAUNCHES_PER_FRAME = 1

# float operations per valid pixel of kernel W, counted from its source: 2
# floors, 4 subtractions, 8 products and 3 sums (the u8 loads and their
# conversions are not counted)
WARP_OPS_PER_PIXEL = 2 + 4 + 8 + 3
# float operations of kernel D, counted from its source. Every pixel: the
# compass test (4 differences, 6 min/max, 2 compares), the fallback merge (a
# compare and a select), the merged-zero test and one key compare. A pixel that
# passes the compass test: two FAST runs of 42 + 15 min/max, 2 differences,
# 1 max and the any-strong compare. A pixel whose merged response is > 0:
# NMS (9 max, 1 compare), 4 border compares.
DETECT_OPS_PIXEL = 4 + 8 + 2 + 1 + 1
DETECT_OPS_PASSING = 2 * (42 + 15) + 2 + 1 + 1
DETECT_OPS_POSITIVE = 10 + 4
# columns of the dense descriptor+moment operator: 32 bins x 256 bits + 2
DESC_OP_COLS = TE.N_ROT * 256 + 2
# the tracking path against the map arena (MapTracker), at SlamConfig()
# defaults: an arena of K=512 keyframes x N=2000 features, L=65536 landmarks
MAP_BILLBOARDS = 1500
MAP_KEYFRAMES = 6
KF_STRIDE = 3                 # keyframes at frames 0, 3, ..., 15
TRAJ_STEP, TRAJ_YAW = 0.04, 0.003   # per frame: map units, radians
TRACK_FRAMES = 8              # after one warm-up frame
TRACK_PROFILE_FRAMES = 2      # eager frames profiled by stage
GRAPH_PROFILE_FRAMES = 2      # graph frames profiled
# the map build_map must reach: live landmarks per feature of a keyframe,
# and landmarks the newest keyframe shares with each other keyframe
MAP_MIN_LANDMARKS_PER_FEATURE = 2
MAP_MIN_COVIS = 50
# bounds on every tracked frame: the pose against the ground truth, and
# TrackLocalMap adding matches on most frames
POSE_BOUND_DEG, POSE_BOUND_M = 0.1, 0.015
LOCAL_MIN_FRAMES = 6          # of TRACK_FRAMES with local_matched > 0
GATE_ROT_RAD = 0.3            # a velocity above the 0.2 rad gate
FORCED_REPEATS = 3            # frames of a forced path after its first
# the forced paths of the tracked frame: the branches taken and the graphs
# a repeat replays
FORCED = {
    "emptied": (("motion", "widen", "zero_velocity", "reference_kf",
                 "local"), ("A", "W", "Z", "R", "B")),
    "gate": (("motion", "local"), ("A", "B")),
    "blank": (("motion", "widen", "zero_velocity", "reference_kf",
               "skip_local"), ("A", "W", "Z", "R", "S")),
}
GRAPH_MAX_OPS = 1500          # device operations of a graph frame: its two
                              # pose solves are one launch each (the masked
                              # eager LM was about 11k a solve); the other
                              # stages make about 1,200
TRACK_STAGES = ("warp", "extract", "motion", "local.select", "local.search",
                "local.optimize", "local.counters", "epilogue")
# the whole system from its first frame (CubemapSLAM) at SlamConfig()
# defaults, over a rendered sequence of SLAM_FRAMES frames: the cut against
# the 220 frames of the working-scale run
SLAM_FRAMES = 30
SLAM_BILLBOARDS = 1500
SLAM_INIT_BY = 10             # initialized within the first 10 frames
SLAM_MIN_NEW_KF = 3           # keyframes by the cadence beyond the first 2
SLAM_ATE_FRAC = 0.01          # ATE bound, as a fraction of the path length
DIGEST_MASKED_LM = "d6f6104a"  # the slam map's digest before the pose-LM
                               # kernel's order of sums
SLAM_PROFILE_MAX = 8          # frames profiled to find a keyframe frame and
                              # a deferred-BA frame
KEYFRAME_MAX_OPS = 5600       # device operations of a keyframe frame that
                              # replays graph K: the triangulation and gates
                              # of the 6 neighbours are one launch (they
                              # were about 1,560 operations)
GRAPH_K_GEOMETRY_MAX_OPS = 400    # the pairs' geometry in graph K
SLAM_STAGES = TRACK_STAGES + ("insert+mapping", "loop", "local_ba")
# the pretrained vocabulary the slam phase loads (k=10, depth 4)
VOCAB_PATH = pathlib.Path(__file__).resolve().parent / "artifacts" / \
    "vocab_synth_10k.npz"
# relocalization and localization mode on the slam phase's map: blank frames
# (a constant-20 image) make it LOST, then the frame at the ground-truth pose
# of RELOC_FRAME relocalizes; LOC_FRAMES frames after it in localization
# mode; landmark noise of LOC_SIGMA map units (a quarter of the median depth,
# which the initialization sets to 1: about 80 px at 650^2 faces, far
# outside the chi2 gate of every level) leaves fewer than 10 inliers
RELOC_BLANK = 2
RELOC_FRAME = 15
LOC_FRAMES = 6
LOC_SIGMA = 0.25
SAVELOAD_FRAME = 10
# bound on a relocalized or localization-mode pose against the ground
# truth, through the ATE's Sim3 alignment: degrees, and the camera centre as
# a fraction of the path length
RELOC_BOUND_DEG, RELOC_BOUND_FRAC = 0.5, SLAM_ATE_FRAC
RELOC_STAGES = ("warp", "extract", "reloc", "reloc.detect",
                "reloc.candidates", "reloc.widen")
# loop closing at full width (SlamConfig() capacities) on the
# constructed-drift arena: 14 keyframes, segment B (10-13) revisiting segment
# A (0-5) under a Sim3 drift; LOOP_POINTS world points give each segment
# keyframe row at least LOOP_MIN_ROW observations. The closure must cut the
# summed segment-B centre error to LOOP_ERR_FRAC of its value before.
LOOP_POINTS = 3000
LOOP_MIN_ROW = 1000
LOOP_ERR_FRAC = 0.6
LOOP_STAGES = ("loop.detect", "loop.sim3", "loop.correct", "loop.gba")
# ComputeSim3's eager sub-ranges (runtime/loop_closing.py)
LOOP_SIM3_SUBRANGES = ("loop.sim3.match", "loop.sim3.ransac",
                       "loop.sim3.widen", "loop.sim3.refine",
                       "loop.sim3.scw")
# the loop closer's graphs on a fresh system (runtime/fused_loop.py): D on
# the first keyframe it sees, M and S on its first ComputeSim3; C, the
# Gauss-Newton step at the closure's edge capacity and F on its first
# CorrectLoop; B, P, L, X and W (at the live count's edge capacity) on its
# first global BA; and a closure's captures: M, S, C, the step, F, B, P, L,
# X and W. A global BA on a system whose graphs are captured replays B, P,
# L 15 times, X twice and W. On such a system loop.correct waits for the
# edge count's read and the timing sync only, and so does loop.gba for the
# live count's read.
LOOP_FUSED_GRAPHS = 3
LOOP_CORRECT_GRAPHS = 3
LOOP_GBA_GRAPHS = 5
LOOP_GBA_REPLAYS = 1 + 1 + 15 + 2 + 1
LOOP_CLOSURE_CAPTURES = 10
LOOP_CORRECT_WAITS = 2
LOOP_GBA_WAITS = 2
# the Sim3 RANSAC's eigen-solves (its Horn 4x4s), in call order: the
# hypotheses' batch and the refit's single matrix
SIM3_EIG_SITES = ("sim3.horn", "sim3.refit.horn")
# the correction's and the global BA's sub-ranges (runtime/loop_closing.py,
# optim/ba.py); through the correction's graphs .fuse holds the static
# inputs' fills and copies, .propagate graph C (the fusion with it) and the
# edge count's read, .pose_graph the problem's build and the 12 steps,
# .remap graph F (SearchAndFuse and the statistics with it)
LOOP_SUBRANGES = ("loop.correct.fuse", "loop.correct.propagate",
                  "loop.correct.pose_graph", "loop.correct.remap",
                  "loop.correct.search_and_fuse", "loop.correct.stats",
                  "loop.gba.build", "loop.gba.lm", "loop.gba.cut",
                  "loop.gba.write")
# the closure's segmented sums by LoopCloser stage: the correction's 12
# Gauss-Newton iterations x 2 and the landmark normals; the global BA's 15
# LM steps x (4 + 2 x 50 CG iterations + 2 + 2): the normal blocks, the CG,
# the rhs and the back-substitution, and the step's two costs, summed
# through a one-segment plan so that padding to an edge capacity moves no
# bit of them (1590 before)
LOOP_SEG_LAUNCHES = {"_correct": 25, "_global_ba": 1620}
# the card-against-CPU closure at the tier-1 test's size, and its bounds:
# the RANSAC Sim3 and the refined rotation and translation (largest entry);
# (pose difference, 99% and largest landmark difference, share of the
# observation table equal) after the correction, and after the global BA
LOOP_SMALL = dict(cube_face_w=160, cube_face_h=160, n_features=600,
                  n_levels=3, max_keyframes=64, max_landmarks=8192)
LOOP_REF_SIM3 = 1e-4
LOOP_REF_CORRECT = (1e-4, 1e-3, 1e-2, 0.995)
LOOP_REF_GBA = (1e-5, 1e-3, 5e-3, 0.995)
# the dataset runner over the slam phase's frames, from files under build/
ROOT = pathlib.Path(__file__).resolve().parent
APP_DIR = ROOT / "build" / "chip_smoke_app"
# the sharded global BA on the loop phase's arena: the loop closer's
# schedule; bounds against the single-process solve of the same layout:
# (pose difference, 99% and largest point difference, share of the live
# edges with the same inlier verdict)
DIST_PHASES, DIST_CG_ITERS = (5, 10), 50
DIST_REF = (1e-4, 1e-3, 5e-3, 0.999)
DIST_TIMEOUT = 600.0
# the port's __global__ kernels, as the profiler names them
PORT_KERNELS = ("warp_remap_kernel", "fast_levels_kernel",
                "select_levels_kernel", "orb_describe_kernel",
                "seg_sum_kernel", "pose_lm_kernel", "triangulate_kernel",
                "sym_eig_kernel")
# the segmented-sum kernel at the shapes the main path gives it (full width):
# (rows, segments, lanes, live segments or None for all, share of rows on
# the dump id). The CG global BA of the loop arena (20,160 live edges over 14
# of 512 cameras, about 1,440 rows a camera, and 4,167 of 65,536 points,
# padded to the edge capacity of 20,480 rows, the padding on the dump id;
# and its cost, one segment of those rows; the smoke takes these three from
# the arena itself, the tests seed them), the
# direct local BA at SlamConfig() capacities (48 free of 96 cameras, 1280 row
# slots a camera, 8192 points), the pose graph's normal matrix over 512
# keyframe slots, and the landmark normals of update_landmark_stats_touched
# (16384 landmarks, 131072 observation slots).
SEG_SHAPES = {
    "gba_cameras": (20480, 512, (6, 6), 14, 320 / 20480),
    "gba_points": (20480, 65536, (3, 3), 4167, 320 / 20480),
    "gba_cost": (20480, 1, (), None, 320 / 20480),
    "local_ba_coupling": (48 * 1280, 48 * 8192, (18,), None, 0.0),
    "local_ba_points": (96 * 1280, 8192, (9,), None, 0.0),
    "pose_graph_H": (4 * 300, 512 * 512, (7, 7), 700, 0.0),
    "landmark_normals": (131072, 16384, (3,), None, 0.5),
}


# edge shapes of the segmented sum (bitwise checks, not timed): segment
# lengths (repeated to the given count), lanes, rows on the dump id, and
# whether the values are a transposed (strided) view. Segments of exactly 32
# (the last short), 33 (the first long) and 2,049 rows (chunks of 65, the
# last of 34); one case per lane count the BA, the pose graph and the normals
# use (1, 3, 6, 9, 18, 36, 49) over short, long and empty segments; every row
# dropped; rows and lanes read through strides; 49 lanes over segments of 32
# rows each, whose tiles (4 segments, 128 rows) overflow the 83 rows the
# kernel stages, so the rest are summed from device memory.
SEG_MIX = [0, 1, 5, 31, 32, 33, 40, 97, 300]
SEG_EDGES = {
    "rows_32_33_2049": ([32, 33, 2049, 0, 1, 64], 1, (9,), 0, False),
    **{f"lanes_{c}": (SEG_MIX, 3, (c,), 20, False)
       for c in (1, 3, 6, 9, 18, 36, 49)},
    "all_dropped": ([0], 300, (7,), 4000, False),
    "strided": (SEG_MIX, 5, (9,), 100, True),
    "staging_overflow": ([32], 40, (49,), 0, False),
}


def seg_case(name, device, seed=SEED + 11):
    """A seeded (plan, values) at SEG_SHAPES[name] (rows spread uniformly
    over the live segments, the given share on the dump id) or
    SEG_EDGES[name] (the segment lengths as given, in a shuffled row
    order); normal values."""
    rng = np.random.default_rng([seed, len(name)])
    if name in SEG_SHAPES:
        E, n, tail, live, dump = SEG_SHAPES[name]
        ids = rng.choice(n, live, replace=False) if live else np.arange(n)
        idx = ids[rng.integers(0, len(ids), E)]
        idx[rng.uniform(size=E) < dump] = n
        v = rng.normal(size=(E,) + tail).astype(np.float32)
        return (SG.SegmentPlan(torch.as_tensor(idx).to(device), n),
                torch.as_tensor(v).to(device))
    lens, reps, tail, dropped, strided = SEG_EDGES[name]
    lens = list(lens) * reps
    n = len(lens)
    idx = rng.permutation(np.repeat(np.arange(n + 1), lens + [dropped]))
    E = len(idx)
    v = torch.as_tensor(rng.normal(size=(E,) + tail).astype(np.float32))
    if strided:   # (E, C) read through the strides of a (C, E) tensor
        v = v.reshape(E, -1).T.contiguous().T.reshape((E,) + tail)
    return (SG.SegmentPlan(torch.as_tensor(idx).to(device), n),
            v.to(device))


# the pose-only LM kernel (csrc/pose_lm.cu): seeded problems at the edge
# counts of a frame (2000 features), of an init frame (6000) and one not a
# multiple of a warp; the seeded problems of the CPU tests at 128^2 faces
LM_SIZES = (37, 2000, 6000)
LM_SEEDS = (1, 2, 3)


def lm_problem(cfg, n, seed, device, noise=0.5, outliers=0.15):
    """A seeded pose-only problem on ``device``: n landmarks in front
    of a known pose, each seen on the face its direction falls on, with
    pixel noise, gross outliers (a share ``outliers`` moved by up to 30
    px), three pyramid levels' inverse sigma^2 and 5% invalid edges; the
    start 2 degrees and 5 cm off, on the faces of ``cfg``'s camera.
    Returns the arguments of ``pose_optimization`` after the camera: (R0,
    t0, Xw, face, uv_face, inv_sigma2, valid)."""
    rng = np.random.default_rng(seed)
    R = so3_exp(torch.tensor([0.05, -0.1, 0.03])).numpy()
    t = np.array([0.1, -0.05, 0.2], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Xc = d * rng.uniform(2, 8, (n, 1)).astype(np.float32)
    Xw = ((Xc - t) @ R).astype(np.float32)               # R^T (Xc - t)
    a = np.abs(Xc)
    face = np.select([(Xc[:, 2] >= a[:, 0]) & (Xc[:, 2] >= a[:, 1]),
                      Xc[:, 0] >= a[:, 1], Xc[:, 0] <= -a[:, 1],
                      Xc[:, 1] >= 0], [0, 2, 1, 4], 3).astype(np.int64)
    uv = TR.project_to_face(CubemapCamera.from_config(cfg, "cpu"),
                            torch.as_tensor(Xc),
                            torch.as_tensor(face)).numpy()
    uv = uv + rng.normal(0, noise, uv.shape).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    uv[bad] += rng.uniform(-30, 30, (int(bad.sum()), 2)).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 3, n)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    dR = so3_exp(torch.tensor([0.02, 0.02, -0.02])).numpy()
    R0 = (dR @ R).astype(np.float32)
    t0 = t + np.array([0.05, -0.03, 0.02], np.float32)
    return tuple(torch.as_tensor(x).to(device) for x in
                 (R0, t0, Xw, face, uv.astype(np.float32), inv_s2, valid))


# the triangulation kernel (csrc/triangulate.cu): seeded problems at the
# correspondence counts of a mapping step's neighbour (2000 features) and of
# init (6000), one not a multiple of a warp, one and none, each with
# degenerate rows (parallel, axis-aligned and NaN rays), under 1, 4 (the
# two-view reconstruction's hypotheses) and 6 pairs (a mapping step's
# neighbours), ungated and gated; at 2000 also a zero baseline, and an
# identity rotation with the baseline on the x axis, where the axis-aligned
# rows give normal matrices with exact zeros off the diagonal (rotations
# with M[p][q] == 0). Block sizes timed beside the port's (TRI_THREADS); the
# bound on the replaced matmul path's points.
TRI_SIZES = (0, 1, 37, 2000, 6000)
TRI_PAIRS = (1, 4, 6)
TRI_BLOCKS = (32, 64, 128)
TRI_REF_RTOL = 1e-5           # relative, on the rows of tri_ref_rows
TRI_REF_DEG = 1.0             # parallax and ray-consistency angle of those
TRI_FLIP_ULPS = 16            # a gate decision the eager gates make the
                              # other way lies this close to its threshold
# float64 operations of the kernel a correspondence, counted from its
# source: A's camera-2 rows (3 negations, 12 entries of 2 products and a
# sum) and camera-1 negations 42; the 10 entries of M (6 products, 5 sums)
# 110; each of the 36 rotations 19 for c and s (14 arithmetic, 5 compares
# and selects) and 72 for the rows and columns of M and the columns of V
# (24 entries of 2 products and a sum); the argmin 9 and the division 6
TRI_OPS = 42 + 110 + 36 * (19 + 72) + 9 + 6
TRI_BYTES = 12 + 12 + 12      # two rays read, a point written
# float32 operations of the gated form's gates a row, counted from its
# source: 3 finite tests; the parallax 15 + 1; the two norms 10 and 50 base
# 2; the two FOV cones 2 x 3 and X2 15; each of the two projections 10
# octant tests and negations, 1 select, 6 for the pinhole, 4 in-face, 2 the
# offset, 5 the chi2 and 1 its product; the scale test 6; the world point
# 3 + 15; the mask's 12 ands
TRI_GATE_OPS = 3 + 16 + 12 + 21 + 2 * 29 + 6 + 18 + 12
# bytes of the gated form a row: r1, r2 (24), uv1, uv2 (16), two levels
# (16), idx (8), the match flag (1) read; Xw (12), ok (1), cos_par (4)
# written (the pair's geometry and the tables of levels once a launch)
TRI_GATE_BYTES = 24 + 16 + 16 + 8 + 1 + 12 + 1 + 4


def tri_problem(n, seed, device, kind="mixed", pairs=1):
    """A seeded triangulation problem on ``device``: (rays1, rays2, R21s,
    t21s) float32 of n points 2-10 map units in front of camera 1, seen from
    a pose 0.8 units away with 1e-3 of ray noise, under ``pairs`` poses
    (R21s (B,3,3), t21s (B,3)): pair 0 that pose, pair b turned by a further
    b (0.01, -0.02, 0.015) rad and moved by b (0.1, 0.05, -0.05). ``kind``
    "mixed": every 16th row from 1 has parallel rays (r2 = R21 r1 under
    pair 0), from 2 both rays on the z axis, from 3 both on x, from 4 a NaN
    in r1, from 5 a NaN in r2; "zero_baseline": t21 = 0; "axis": R21 = I and
    t21 on the x axis, with the mixed rows."""
    rng = np.random.default_rng([seed, n])
    pts = rng.uniform(-4.0, 4.0, (n, 3))
    pts[:, 2] += 6.0
    R21 = so3_exp(torch.tensor([0.03, -0.08, 0.01],
                               dtype=torch.float64)).numpy()
    t21 = np.array([0.8, 0.15, -0.1])
    if kind == "zero_baseline":
        t21 = np.zeros(3)
    if kind == "axis":
        R21, t21 = np.eye(3), np.array([0.8, 0.0, 0.0])
    rays = []
    for P in (pts, pts @ R21.T + t21):
        r = P / np.linalg.norm(P, axis=1, keepdims=True)
        r = r + rng.normal(0, 1e-3, r.shape)
        rays.append(r / np.linalg.norm(r, axis=1, keepdims=True))
    r1, r2 = rays
    if kind != "zero_baseline":
        i = np.arange(n) % 16
        r2[i == 1] = r1[i == 1] @ R21.T
        r1[i == 2] = r2[i == 2] = (0.0, 0.0, 1.0)
        r1[i == 3] = r2[i == 3] = (1.0, 0.0, 0.0)
        r1[i == 4, 1] = np.nan
        r2[i == 5, 2] = np.nan
    Rs = [so3_exp(torch.tensor([0.01, -0.02, 0.015], dtype=torch.float64)
                  * b).numpy() @ R21 for b in range(pairs)]
    ts = [t21 + b * np.array([0.1, 0.05, -0.05]) for b in range(pairs)]
    return tuple(torch.as_tensor(np.ascontiguousarray(x, np.float32))
                 .to(device) for x in (r1, r2, np.stack(Rs), np.stack(ts)))


def tri_gated_problem(pairs, n, seed, device):
    """A seeded problem of the gated form on ``device``: the arguments of
    ``TT.triangulate_gated`` for a new keyframe (slot ``pairs``) against
    ``pairs`` neighbours (slots 0 .. pairs - 1, shuffled), K = pairs + 2
    keyframes (the last an empty slot) of n features, at ``SlamConfig()``'s
    camera and level tables. Seeded world points 1.5-12 units in front of
    the new keyframe (within about 75 degrees of its axis); each neighbour,
    0.3-1 unit away (0.05 for pair 1: its depth gate bites) and turned by up
    to 0.1 rad, sees them through a shuffle of its features (``idx``); rays
    with 1e-3 of noise, cross uv from ``camera.ray_to_cubemap`` with 0.7 px;
    90% of rows matched; levels 0-7. Every 16th row from 1 has the
    neighbour's ray parallel to the new one (r2 = R21 r1), from 2 a NaN in
    the new ray, from 3 level 9 in the new keyframe, from 4 level -1 in the
    neighbour (the kernel clamps both), from 5 both rays on the z axis."""
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, "cpu")
    rng = np.random.default_rng([seed, pairs, n])
    K = pairs + 2
    f64 = torch.float64
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.6
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    R = [so3_exp(torch.as_tensor(rng.uniform(-0.1, 0.1, 3), dtype=f64))
         .numpy() for _ in range(K)]
    c = [rng.uniform(-1.0, 1.0, 3) for _ in range(K)]
    k_new = pairs
    for b in range(pairs):
        off = rng.normal(size=3)
        c[b] = c[k_new] + off / np.linalg.norm(off) * (
            0.05 if b == 1 else rng.uniform(0.3, 1.0))
    Xw = c[k_new] + (d * rng.uniform(1.5, 12.0, (n, 1))) @ R[k_new]
    rays = np.zeros((K, n, 3))
    perm = np.stack([rng.permutation(n) for _ in range(pairs)])
    for k in range(K - 1):
        P = (Xw - c[k]) @ R[k].T                     # world -> camera k
        r = P / np.linalg.norm(P, axis=1, keepdims=True)
        r = r + rng.normal(0, 1e-3, r.shape)
        r /= np.linalg.norm(r, axis=1, keepdims=True)
        rays[k, perm[k] if k < pairs else np.arange(n)] = r
    t = [-(R[k] @ c[k]) for k in range(K)]
    R21 = [R[b] @ R[k_new].T for b in range(pairs)]     # float64, as a guide
    i16 = np.arange(n) % 16
    for b in range(pairs):
        rows = np.nonzero(i16 == 1)[0]
        rays[b, perm[b, rows]] = rays[k_new, rows] @ R21[b].T
        rows = np.nonzero(i16 == 5)[0]
        rays[b, perm[b, rows]] = (0.0, 0.0, 1.0)
    rays[k_new, i16 == 5] = (0.0, 0.0, 1.0)
    rays[k_new, i16 == 2, 1] = np.nan
    rays32 = torch.as_tensor(rays, dtype=torch.float32)
    uv = TC.ray_to_cubemap(cam, rays32)[0]
    uv = uv + torch.as_tensor(rng.normal(0, 0.7, uv.shape), dtype=torch.float32)
    level = rng.integers(0, 8, (K, n))
    level[k_new, i16 == 3] = 9
    for b in range(pairs):
        level[b, perm[b, i16 == 4]] = -1
    level[K - 1] = 0
    uv[K - 1] = 0.0
    kf_R = np.stack(R).astype(np.float32)
    kf_t = np.stack(t).astype(np.float32)
    Rt = torch.as_tensor(kf_R)
    tt = torch.as_tensor(kf_t)
    R21s = torch.stack([Rt[b] @ Rt[k_new].T for b in range(pairs)])
    t21s = torch.stack([tt[b] - R21s[b] @ tt[k_new] for b in range(pairs)])
    order = rng.permutation(pairs)
    kf = TT.Keyframes(rays32, uv, torch.as_tensor(level), Rt, tt)
    consts = TT.GateConstants(
        cam.fxycxy, cam.face_wh, cam.cos_fov_th,
        torch.tensor(cfg.level_sigma2, dtype=torch.float32),
        torch.tensor(cfg.scale_factors, dtype=torch.float32),
        1.5 * cfg.scale_factor)
    match = torch.as_tensor(rng.uniform(size=(pairs, n)) < 0.9)
    idx = torch.as_tensor(perm[order].astype(np.int64))
    args = (kf, torch.tensor([k_new]), torch.as_tensor(order.astype(np.int64)),
            idx, match, R21s[order].contiguous(), t21s[order].contiguous(),
            consts)
    return to_device(args, device)


def tensors_map(fn, x):
    """``fn`` applied to every tensor in ``x``, a tensor or a tuple (named
    or not) of them and of other values."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, tuple):
        items = [tensors_map(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def to_device(x, device):
    """The tensors of ``x`` moved to ``device``, contiguous."""
    return tensors_map(lambda t: t.to(device).contiguous(), x)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def lm_ptxas_lines(text: str):
    """The ptxas lines (spills, registers) of each cluster size's pose-LM
    kernel in an nvcc -Xptxas -v log, as "C=<size>: ..."."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"pose_lm_kernelILi(\d+)E", line)
        if "Compiling entry function" in line:
            cur = m.group(1) if m else None
        elif cur and ("spill" in line or "Used" in line):
            out.append(f"C={cur}: "
                       + re.sub(r"^ptxas info\s*:\s*", "", line.strip()))
    return out


def time_ms(fn) -> float:
    """Median over TIMING_REPS batches of the per-launch time of a batch of
    TIMING_BATCH launches, between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(TIMING_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TIMING_BATCH):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / TIMING_BATCH)
    return float(np.median(per))


def graph_ms(fn) -> float:
    """Device time of one call of ``fn``, without the host's launch cost:
    TIMING_BATCH calls captured in one CUDA graph, the replay timed as in
    ``time_ms``, divided by TIMING_BATCH."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMING_BATCH):
            fn()
    return time_ms(graph.replay) / TIMING_BATCH


def bound(nbytes: float, nops: float, ops_per_s: float = H100_F32_OPS_PER_S):
    """Least time on an H100 (ms) and what bounds it; ``nops`` at the
    float32 rate unless another is given."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pose_error(R, t):
    """(degrees, millimetres) away from the identity pose."""
    ang = math.degrees(float(torch.linalg.norm(so3_log(R))))
    return ang, float(torch.linalg.norm(t)) * 1e3


def check_warp(tracker, frame_u8):
    """Kernel W against warp_bilinear, and grid_sample as the yardstick."""
    wm = tracker.warp_map
    out = warp_cuda.warp_to_cross(frame_u8, wm)
    ref = TW.warp_bilinear(frame_u8, wm)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    log(f"[W] warp {tuple(frame_u8.shape)} u8 -> {tuple(out.shape)}: "
        f"max |kernel - plain| = {err:.3g}")
    if not err <= 1e-3:
        raise AssertionError(f"kernel W disagrees: {err}")
    W, H = wm.src_wh
    valid = wm.valid
    # the same source coordinates as grid_sample's grid; invalid pixels
    # sample far outside the image and come out 0
    grid = torch.stack([wm.xy[..., 0] / (W - 1) * 2 - 1,
                        wm.xy[..., 1] / (H - 1) * 2 - 1], -1)
    grid = torch.where(valid[..., None], grid, torch.full_like(grid, -3.0))
    grid = grid[None].contiguous()
    src = frame_u8.float()[None, None].contiguous()
    n_pix, n_valid = valid.numel(), int(valid.sum())
    b_ms, b_by = bound(frame_u8.numel() + n_pix * (8 + 4),
                       WARP_OPS_PER_PIXEL * n_valid)
    row = dict(
        name="warp_remap", route="cuda",
        source="cubemapslam_tpu_torch/csrc/warp_remap.cu",
        replaces="cubemapslam_tpu/warp_tpu.py:242",
        max_abs_err=err,
        ms=time_ms(lambda: warp_cuda.warp_to_cross(frame_u8, wm)),
        device_ms=graph_ms(lambda: warp_cuda.warp_to_cross(frame_u8, wm)),
        plain_ms=time_ms(lambda: TW.warp_bilinear(frame_u8, wm)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)),
        library_device_ms=graph_ms(lambda: F.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)),
        calls_per_frame=1)
    return row, out


def detect_work(levels, lo, cell, ini, mn):
    """What kernel D's work depends on in these levels: the pixels, those
    that pass its compass test at ``lo`` (two neighbouring compass points of
    the FAST circle both brighter than c + lo or both darker than c - lo),
    and those whose merged response is > 0 (plain versions, on the card)."""
    n_pix = n_pass = n_pos = 0
    for img in levels:
        d = [torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) - img
             for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
        hit = torch.zeros_like(img, dtype=torch.bool)
        for i in range(4):
            a, b = d[i], d[(i + 1) % 4]
            hit |= ((a > lo) & (b > lo)) | ((a < -lo) & (b < -lo))
        n_pix += img.numel()
        n_pass += int(hit.sum())
        n_pos += int((TE._fast_adaptive(img, ini, mn, cell) > 0).sum())
    return n_pix, n_pass, n_pos


def check_detect(tracker, levels):
    """Kernel D, one launch pair for all levels, against its plain version
    level by level: candidates bitwise, subpixel offsets within 1e-6."""
    p, cfg = tracker.params, tracker.cfg
    ini, mn = cfg.ini_th_fast, cfg.min_th_fast
    kern = TE.detect_cells_levels(levels, p.cell, ini, mn)
    start, err = 0, 0.0
    for lv, img in enumerate(levels):
        plain = TE._detect_cells_plain(img, p.cell, ini, mn)
        n = plain[0].shape[0]
        part = [t[start:start + n] for t in kern]
        for name, a, b in zip(("resp", "y", "x"), part[:3], plain[:3]):
            if not torch.equal(a, b):
                raise AssertionError(f"kernel D level {lv}: {name} differs "
                                     f"at {int((a != b).sum())} entries")
        e = max(float((part[3] - plain[3]).abs().max()),
                float((part[4] - plain[4]).abs().max()))
        if not e <= 1e-6:
            raise AssertionError(f"kernel D level {lv}: subpixel err {e}")
        err = max(err, e)
        start += n
        log(f"[D] level {lv} {tuple(img.shape)}: {n} cells, candidates "
            f"bitwise equal, subpixel err {e:.3g}")
    if start != kern[0].shape[0]:
        raise AssertionError(f"kernel D gave {kern[0].shape[0]} cells, the "
                             f"levels have {start}")
    n_pix, n_pass, n_pos = detect_work(levels, min(ini, mn), p.cell, ini,
                                       mn)
    b_ms, b_by = bound(4 * n_pix + start * TE.PER_CELL * 20,
                       DETECT_OPS_PIXEL * n_pix + DETECT_OPS_PASSING * n_pass
                       + DETECT_OPS_POSITIVE * n_pos)
    log(f"[D] {n_pix} pixels, {n_pass} pass the compass test, {n_pos} "
        f"merge to a response > 0")
    row = dict(
        name="orb_detect", route="cuda",
        source="cubemapslam_tpu_torch/csrc/orb_detect.cu",
        replaces="cubemapslam_tpu/features/extractor.py:369",
        max_abs_err=err,
        ms=time_ms(lambda: TE.detect_cells_levels(levels, p.cell, ini, mn)),
        device_ms=graph_ms(
            lambda: TE.detect_cells_levels(levels, p.cell, ini, mn)),
        plain_ms=time_ms(lambda: [TE._detect_cells_plain(img, p.cell, ini, mn)
                                  for img in levels]),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, calls_per_frame=2)
    log(f"[D] {len(levels)} levels, {start} cells in one launch pair: kernel "
        f"{row['ms']:.5f} ms (device {row['device_ms']:.5f} ms), plain "
        f"{row['plain_ms']:.5f} ms, bound {b_ms:.5f} ms ({b_by})")
    return row, kern


def unpack_bits(desc):
    """(K, 8) int64 words -> (K, 256) bits (bit j of word w = bit 32w+j)."""
    shifts = torch.arange(32, device=desc.device)
    return ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256)


def rot_bin(ang):
    return torch.remainder(torch.round(
        ang * (TE.N_ROT / (2.0 * math.pi))).to(torch.int64), TE.N_ROT)


def check_describe(p, ops, levels, cands, tag="describe"):
    """The describe kernel, one launch for all keypoints, against its plain
    version (raw patches, then the dense product with the descriptor+moment
    operator) on the frame's keypoints, for an extractor plan ``p`` and its
    operators. Both sum in float32 in different orders, so: angles within
    1e-4 rad (mod 2 pi), bins equal on >= 99.5% of keypoints, and on those,
    bits equal wherever the plain score is farther than 1e-2 from 0."""
    ys, xs, _, _, _ = TE._select_levels(cands, ops.sel_index, ops.sel_take)
    args = (levels, ys, xs, p.level_k, ops.desc_table)
    ang_k, desc_k = TE.describe_keypoints(*args)
    ang_p, desc_p = TE._describe_plain(*args)
    K = ys.shape[0]
    # the dense product the kernel removes, on the plain version's operands
    bnd = np.concatenate([[0], np.cumsum(p.level_k)])
    flat = TE._bf16_round(torch.cat([
        TE._gather_patches_plain(img, ys[bnd[i]:bnd[i + 1]],
                                 xs[bnd[i]:bnd[i + 1]])
        for i, img in enumerate(levels)]).reshape(K, -1))
    desc_op = TE.desc_operator(flat.device)
    fused = flat @ desc_op
    d_ang = torch.remainder(ang_k - ang_p + math.pi, 2 * math.pi) - math.pi
    err = float(d_ang.abs().max())
    bin_k, bin_p = rot_bin(ang_k), rot_bin(ang_p)
    same_bin = bin_k == bin_p
    scores = fused[:, :TE.N_ROT * 256].reshape(K, TE.N_ROT, 256)[
        torch.arange(K, device=flat.device), bin_p]
    bits_k, bits_p = unpack_bits(desc_k), unpack_bits(desc_p)
    firm = (scores.abs() > 1e-2) & same_bin[:, None]
    bad_firm = int(((bits_k != bits_p) & firm).sum())
    bins_equal = float(same_bin.float().mean())
    bits_equal = float((bits_k == bits_p).float().mean())
    log(f"[{tag}] {K} keypoints: angle err {err:.3g} rad, bins equal on "
        f"{bins_equal:.5f}, bits equal {bits_equal:.6f} ({bad_firm} firm "
        f"bits differ)")
    if not (err <= 1e-4 and bins_equal >= 0.995 and bad_firm == 0):
        raise AssertionError("the describe kernel disagrees with its plain "
                             "version")
    # bound: each keypoint's window read once (at most the level), the
    # chosen bins' table rows, the coordinates and the outputs; operations:
    # the two moments over the disc and the chosen bins' non-zero taps
    nnz = (ops.desc_table != 0).sum(dim=1)            # (N_ROT, 256)
    win = TE._WIN * TE._WIN
    n_bytes = sum(min(k * win, img.numel()) * 4
                  for k, img in zip(p.level_k, levels))
    n_bytes += int(torch.unique(bin_k).numel()) * ops.desc_table.shape[1] \
        * 256 * 4 + K * (8 + 4 + 64)
    n_mom = int((TE._moment_operator() != 0).sum())
    n_ops = 2 * (K * n_mom + int(nnz[bin_k].sum()))
    b_ms, b_by = bound(n_bytes, n_ops)
    row = dict(
        name="orb_describe", route="cuda",
        source="cubemapslam_tpu_torch/csrc/orb_describe.cu",
        replaces="cubemapslam_tpu/features/extractor.py:257",
        max_abs_err=err, bins_equal=bins_equal, bits_equal=bits_equal,
        ms=time_ms(lambda: TE.describe_keypoints(*args)),
        device_ms=graph_ms(lambda: TE.describe_keypoints(*args)),
        plain_ms=time_ms(lambda: TE._describe_plain(*args)),
        bound_ms=b_ms, bound_by=b_by,
        # the dense product of all 32 bins (a superset of the work)
        library_ms=time_ms(lambda: flat @ desc_op),
        library_device_ms=graph_ms(lambda: flat @ desc_op),
        calls_per_frame=1)
    log(f"[{tag}] kernel {row['ms']:.5f} ms (device "
        f"{row['device_ms']:.5f} ms), plain {row['plain_ms']:.5f} ms, dense "
        f"product {row['library_ms']:.5f} ms (device "
        f"{row['library_device_ms']:.5f} ms), bound {b_ms:.5f} ms ({b_by})")
    return row


def check_kernels(tracker, frame):
    """Every kernel against its plain version at the frame's shapes: the
    kernels' JSON rows, without their main-path launches. The describe
    kernel is also held at the init extractor's shape (3x the features):
    its row's ``init`` entry. Kernel D's work does not depend on the
    feature budget (it scores every cell of every level; the budget
    applies in the selection after it), so its one check covers both
    extractors. What the checks allocate is freed on return, before the
    main path is measured."""
    w_row, cube = check_warp(tracker, frame)
    levels = [cube] + [TE.pyramid_level(cube, A, Bt)
                       for A, Bt in tracker.extractor.ops.pyr]
    d_row, cands = check_detect(tracker, levels)
    g_row = check_describe(tracker.params, tracker.extractor.ops, levels,
                           cands)
    cfg = tracker.cfg
    ext, plan = TE.build_extractor(cfg, tracker.cam,
                                   cfg.n_features * cfg.init_features_factor,
                                   (cfg.cube_h, cfg.cube_w))
    init = check_describe(plan, ext.ops, levels, cands, tag="describe-init")
    g_row["init"] = {k: init[k] for k in (
        "max_abs_err", "bins_equal", "bits_equal", "ms", "device_ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")}
    g_row["init"]["keypoints"] = sum(plan.level_k)
    return [w_row, d_row, g_row]


# the segmented-sum kernel's launches by path: {phase: {"total": n, and by
# the method that launched them}}, each counted from 0 around its drive
SEG_LAUNCHES = {}
# the pose-LM kernel's launches by path, each counted from 0 around its
# drive: one a solve (two on a steady tracked frame, one more a motion
# fallback, one a relocalization candidate and one its widening pass)
POSE_LAUNCHES = {}
# (camera, arguments) of the pose solves of the eager map-tracking run's
# first frame, recorded for check_pose_lm
LM_INPUTS = []
# the triangulation kernel's launches by path, each counted from 0 around
# its drive: one a two-view reconstruction at init, one a mapping step
TRI_LAUNCHES = {}
# the arguments of the triangulate_gated call of the slam drive's first
# mapping step, recorded for check_triangulate
TRI_INPUTS = []


def tri_launches(tag, n_frames, required=True):
    """The triangulation launches since the counters were set to 0,
    recorded as the ``tag`` path's; with ``required`` the path must have
    launched the kernel."""
    n = TT.TRIANGULATE.launches
    TRI_LAUNCHES[tag] = n
    log(f"[{tag}] triangulate: launches in {n_frames} frames {n}")
    if required and n <= 0:
        raise AssertionError(f"the {tag} path launched no triangulation "
                             f"kernel")
    return n


@contextlib.contextmanager
def recording_triangulation(store):
    """Record the cloned arguments of the first ``triangulate_gated`` call
    of the mapping stages into ``store`` while the context is open."""
    inner = TMAP.triangulate_gated

    def recorded(*args):
        if not store:
            store.append(tensors_map(torch.clone, args))
        return inner(*args)

    TMAP.triangulate_gated = recorded
    try:
        yield store
    finally:
        TMAP.triangulate_gated = inner


def pose_launches(tag, n_frames):
    """The pose-LM launches since the counters were set to 0, recorded as
    the ``tag`` path's; the path must have launched the kernel."""
    n = PO.POSE_LM.launches
    POSE_LAUNCHES[tag] = n
    log(f"[{tag}] pose_lm: launches in {n_frames} frames {n}")
    if n <= 0:
        raise AssertionError(f"the {tag} path launched no pose-LM kernel")
    return n


@contextlib.contextmanager
def recording_lm(store):
    """Record (camera, cloned arguments) of every ``pose_optimization``
    call of the tracking kernels into ``store`` while the context is
    open."""
    inner = TK.pose_optimization

    def recorded(cam, *args, **kwargs):
        store.append((cam, tuple(a.clone() for a in args)))
        return inner(cam, *args, **kwargs)

    TK.pose_optimization = recorded
    try:
        yield store
    finally:
        TK.pose_optimization = inner


# float operations of the pose-LM kernel, counted from its source: every
# edge of a pass is evaluated (the pose on the landmark 18, the face
# rotation 15, the safe depth 2, the projection and residual 8, chi2 4, the
# gate 1); an edge in the round's mask adds the robust weight and rho (10,
# the robust rounds), the Jacobian (57), the weighted rows (12), the 21 H
# entries (4 each), the 6 gradient entries (4 each) and the cost (1)
LM_EVAL_OPS = 18 + 15 + 2 + 8 + 4 + 1
LM_TERM_OPS = 10 + 57 + 12 + 21 * 4 + 6 * 4 + 1
LM_EDGE_BYTES = 12 + 8 + 4 + 8 + 1 + 1     # Xw, uv, 1/sigma^2, face, valid,
                                           # the inlier flag written


def lm_bound(n, iters, counted):
    """The pose-LM kernel's bound (ms, what bounds it) on one input of n
    edges whose rounds ran ``iters`` LM iterations with ``counted`` edges
    in their sums: each pass (a round's start, each iteration) evaluates
    every edge and sums the counted ones, the last pass evaluates every
    edge once more; every input read once, the outputs written once."""
    passes = [1 + int(i) for i in iters]
    ops = sum(p * (n * LM_EVAL_OPS + int(c) * LM_TERM_OPS)
              for p, c in zip(passes, counted)) + n * LM_EVAL_OPS
    return bound(n * LM_EDGE_BYTES + 4 * (9 + 3 + 45 + 4) + 4 * (9 + 3) + 8,
                 ops)


def wall_ms(fn, reps=3):
    """Median synchronised wall time (ms) of ``reps`` calls after one."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def graph1_ms(fn, reps=5):
    """Device time (ms) of one call of ``fn`` captured alone in a CUDA graph
    (for calls of thousands of operations, where ``graph_ms``'s batch of
    TIMING_BATCH would make a graph of 10^5 nodes): the median of ``reps``
    replays between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def lm_case(name, cam, args):
    """The kernel against ``pose_optimization_ordered`` on one input, at
    every cluster size of ``pose_opt.LM_CLUSTERS``: one launch a call; the
    iterations of each round, R, t, the inlier mask and its count, bitwise
    (the order of sums does not depend on the cluster size). The case's
    dict (the largest pose difference, bitwise by cluster size)."""
    ref = PO.pose_optimization_ordered(cam, *args)
    c = dict(name=name, n=args[2].shape[0], iters=ref[4].tolist(),
             counted=ref[5].tolist(), inliers=int(ref[3]), max_abs_err=0.0,
             bitwise_by_cluster={})
    for cluster in PO.LM_CLUSTERS:
        n0 = PO.POSE_LM.launches
        R, t, inl, n_inl, iters = PO.pose_lm(cam, *args, cluster=cluster)
        torch.cuda.synchronize()
        one = PO.POSE_LM.launches == n0 + 1
        err = max(float((R - ref[0]).abs().max()),
                  float((t - ref[1]).abs().max()))
        same = bool(torch.equal(R, ref[0]) and torch.equal(t, ref[1])
                    and torch.equal(inl, ref[2])
                    and int(n_inl) == int(ref[3])
                    and torch.equal(iters.long(), ref[4].long()))
        c["max_abs_err"] = max(c["max_abs_err"], err)
        c["bitwise_by_cluster"][cluster] = same
        if not (one and same):
            raise AssertionError(
                f"the pose-LM kernel on a cluster of {cluster} differs from "
                f"its plain version on {name} (one launch {one}, iterations "
                f"{iters.tolist()} against {ref[4].tolist()}, max |err| "
                f"{err:.3g})")
    c["bitwise"] = all(c["bitwise_by_cluster"].values())
    log(f"[pose_lm] {name}: {c['n']} edges, iterations a round "
        f"{c['iters']}, edges summed a round {c['counted']}, "
        f"{c['inliers']} inliers; bitwise at cluster sizes "
        f"{c['bitwise_by_cluster']}")
    return c


# the ptxas lines of the pose-LM kernel at each cluster size, from the build
LM_PTXAS = {}


def check_pose_lm(cfg, real):
    """The pose-LM kernel (``csrc/pose_lm.cu``) against its kernel-order
    plain version on the card, at every cluster size: on ``real`` (camera,
    arguments), the first pose solve of a tracked frame of the map-tracking
    phase (the eager twin of the graph frame, same bits), and on the seeded
    problems of LM_SIZES; bitwise (``lm_case``). Timed at every cluster
    size on each of these inputs: a wrapper call, the device's time from a
    CUDA graph and its time a pass; and the serial floor a pass, the device
    time with no edge (4 rounds of 10 iterations, nothing summed) over 44.
    The row carries the times of the wrapper's cluster size
    (``pose_opt.LM_CLUSTER``); beside them the plain version's
    wall time and what the kernel replaced, the masked eager LM
    (``pose_optimization_masked``), captured in one CUDA graph (device ms;
    its device operations from the profiler) and eager (wall ms). Returns
    the kernel's JSON row, without its launches."""
    cam, args = real
    full = CubemapCamera.from_config(cfg, "cuda")
    inputs = [("tracked frame, first solve", cam, args)] + [
        (f"seeded, {n} edges", full, lm_problem(cfg, n, SEED + 5, "cuda"))
        for n in LM_SIZES]
    cases = [lm_case(name, c, a) for name, c, a in inputs]
    head = cases[0]
    chosen = PO.LM_CLUSTER
    b_ms, b_by = lm_bound(head["n"], head["iters"], head["counted"])
    empty = [a[:0] if k >= 2 else a for k, a in enumerate(args)]
    by_cluster = {}
    for cluster in PO.LM_CLUSTERS:
        floor_pass = graph_ms(lambda: PO.pose_lm(
            cam, *empty, cluster=cluster)) / 44
        sizes = {}
        for (name, c, a), case in zip(inputs, cases):
            def run(c=c, a=a):
                return PO.pose_lm(c, *a, cluster=cluster)
            passes = sum(1 + i for i in case["iters"])
            dev = graph_ms(run)
            sizes[name] = dict(n=case["n"], passes=passes, ms=time_ms(run),
                               device_ms=dev, device_pass_ms=dev / passes)
            log(f"[pose_lm] C={cluster} {name} ({case['n']} edges, "
                f"{passes} passes): device {dev:.5f} ms "
                f"({dev / passes * 1e3:.3f} us a pass), wrapper "
                f"{sizes[name]['ms']:.5f} ms")
        by_cluster[cluster] = dict(serial_floor_pass_ms=floor_pass,
                                   ptxas=LM_PTXAS.get(cluster, []),
                                   sizes=sizes)
        log(f"[pose_lm] C={cluster}: serial floor {floor_pass * 1e3:.3f} us "
            f"a pass (no edge, 44 passes); ptxas "
            f"{'; '.join(LM_PTXAS.get(cluster, [])) or 'not built here'}")
    log(f"[pose_lm] the wrapper's cluster size: {chosen}")

    def masked():
        return PO.pose_optimization_masked(cam, *args)

    passes = sum(1 + i for i in head["iters"])
    at = by_cluster[chosen]
    floor_pass = at["serial_floor_pass_ms"]
    prof = profile_stages(masked, (), 1)
    row = dict(name="pose_lm", route="cuda",
               source="cubemapslam_tpu_torch/csrc/pose_lm.cu",
               replaces="cubemapslam_tpu/optim/pose_opt.py:36 "
                        "(pose_optimization: lax.fori_loop of "
                        "lax.while_loop LM iterations, one XLA program; no "
                        "pallas_call)",
               shape=f"{head['n']} edges, iterations a round "
                     f"{head['iters']}, a cluster of {chosen} blocks",
               cluster=chosen,
               max_abs_err=max(c["max_abs_err"] for c in cases),
               bitwise=all(c["bitwise"] for c in cases),
               ms=at["sizes"][head["name"]]["ms"],
               device_ms=at["sizes"][head["name"]]["device_ms"],
               plain_ms=wall_ms(lambda: PO.pose_optimization_ordered(
                   cam, *args)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               serial_floor_ms=floor_pass * passes,
               serial_floor_pass_ms=floor_pass,
               replaced_graph_ms=graph1_ms(masked),
               replaced_eager_ms=wall_ms(masked),
               replaced_device_ops=prof["device_ops"], cases=cases,
               by_cluster=by_cluster)
    log(f"[pose_lm] row (C={chosen}): kernel {row['ms']:.5f} ms (device "
        f"{row['device_ms']:.5f}), plain (kernel order) {row['plain_ms']:.3f}"
        f" ms, the replaced masked LM {row['replaced_graph_ms']:.3f} ms from "
        f"a CUDA graph ({row['replaced_device_ops']:.0f} device operations)"
        f" and {row['replaced_eager_ms']:.3f} ms eager; bound "
        f"{b_ms:.5f} ms ({b_by}); serial floor {row['serial_floor_ms']:.5f}"
        f" ms ({passes} passes of {floor_pass:.5f}); library none")
    return row


def same_float_bits(a, b):
    """Equal bits wherever neither is NaN, and NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32)))


def wide_rows(args):
    """Rows of a triangulation problem whose rays part by >= TRI_REF_DEG."""
    r1, r2, R21, _ = args
    return (r1 * (r2 @ R21)).sum(-1) < math.cos(math.radians(TRI_REF_DEG))


def tri_ref_rows(args, X):
    """The rows on which the kernel is held to the path it replaced, whose
    points are ``X``: rays parting by >= TRI_REF_DEG, and a point that is
    finite, within 50 baselines of camera 1 (the mapping's depth gate) and
    within TRI_REF_DEG of both rays, as a match the mapping's gates keep.
    Elsewhere (rays that do not meet: the unmatched rows of a mapping
    step's candidates) the two smallest eigenvalues may lie close, and the
    two paths' roundings pick different vectors."""
    r1, r2, R21, t21 = args
    cos = math.cos(math.radians(TRI_REF_DEG))
    d1 = torch.linalg.norm(X, dim=-1)
    X2 = X @ R21.T + t21
    d2 = torch.linalg.norm(X2, dim=-1)
    return (wide_rows(args) & torch.isfinite(X).all(-1) & (d1 > 0)
            & (d1 <= 50.0 * torch.linalg.norm(t21))
            & ((X * r1).sum(-1) >= cos * d1)
            & ((X2 * r2).sum(-1) >= cos * d2))


def pair_args(args, b):
    """Pair b of an ungated problem (rays1, rays2, R21s, t21s)."""
    r1, r2, R21s, t21s = args
    return r1, r2, R21s[b], t21s[b]


def replayed(fn):
    """``fn()`` captured in a CUDA graph, its outputs then filled with
    NaN (floats) or ones (masks, counts), the graph replayed: the outputs
    of the replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            out = fn()
    torch.cuda.current_stream().wait_stream(side)
    for x in (out if isinstance(out, tuple) else (out,)):
        x.fill_(float("nan") if x.is_floating_point() else 1)
    graph.replay()
    torch.cuda.synchronize()
    return out


def tri_case(name, args):
    """The ungated kernel on B pairs against ``triangulate_rays_ordered``,
    from one launch and from a CUDA graph replay of it, against the B
    one-pair launches (PR 13's kernel, a launch a pair), and against the
    matmul path it replaced (run on the card) within TRI_REF_RTOL on the
    rows of wide parallax. The case's dict."""
    n, B = args[0].shape[0], args[2].shape[0]
    n0 = TT.TRIANGULATE.launches
    X = TT.triangulate_pairs_cuda(*args)
    torch.cuda.synchronize()
    launched = TT.TRIANGULATE.launches - n0
    ref = TT.triangulate_rays_ordered(*args)
    one = torch.stack([TT.triangulate_rays(*pair_args(args, b))
                       for b in range(B)])
    Xg = replayed(lambda: TT.triangulate_pairs_cuda(*args)) if n else X
    fin = torch.isfinite(X).all(-1)
    both = fin & torch.isfinite(ref).all(-1)
    err = float((X - ref)[both].abs().max()) if bool(both.any()) else 0.0
    held = rest = 0
    gap = gap_rest = 0.0
    as_replaced = True
    for b in range(B):
        pa = pair_args(args, b)
        old = TT.triangulate_rays_matmul(*pa)
        rel = (torch.linalg.norm(X[b] - old, dim=-1)
               / torch.linalg.norm(old, dim=-1))
        h = tri_ref_rows(pa, old)
        r = wide_rows(pa) & fin[b] & torch.isfinite(old).all(-1) & ~h
        held, rest = held + int(h.sum()), rest + int(r.sum())
        gap = max(gap, float(rel[h].max()) if bool(h.any()) else 0.0)
        gap_rest = max(gap_rest, float(rel[r].max()) if bool(r.any())
                       else 0.0)
        as_replaced &= bool(torch.equal(fin[b], torch.isfinite(old).all(-1)))
    c = dict(name=name, n=n, pairs=B, bitwise=same_float_bits(X, ref),
             graph_bitwise=same_float_bits(Xg, ref),
             per_pair_bitwise=same_float_bits(X, one), max_abs_err=err,
             finite=int(fin.sum()), finite_as_replaced=as_replaced,
             held=held, replaced_rel_gap=gap, other_wide=rest,
             other_wide_rel_gap=gap_rest, launches=launched)
    log(f"[triangulate] {name}: {B} x {n} rows, {c['finite']} finite (the "
        f"replaced path's mask the same: {as_replaced}), bitwise "
        f"{c['bitwise']}, from a graph {c['graph_bitwise']}, as {B} one-pair "
        f"launches {c['per_pair_bitwise']}, max |err| {err:.3g}; {launched} "
        f"launch(es); against the replaced matmul path on {held} rows of "
        f"tri_ref_rows: largest relative gap {gap:.3g} (bound "
        f"{TRI_REF_RTOL}); on the {rest} other finite wide rows (not held) "
        f"{gap_rest:.3g}")
    if not (c["bitwise"] and c["graph_bitwise"] and c["per_pair_bitwise"]
            and launched == (1 if n else 0) and gap <= TRI_REF_RTOL):
        raise AssertionError(f"the triangulation kernel differs from its "
                             f"plain version, or from the replaced path, "
                             f"on {name}")
    return c


def same_candidates(a, b):
    """Two gated results with the same bits (NaN where NaN)."""
    return (same_float_bits(a.Xw, b.Xw) and torch.equal(a.ok, b.ok)
            and same_float_bits(a.cos_par, b.cos_par)
            and torch.equal(a.gates, b.gates))


def gated_rows(args):
    """The gated form's gathers: k_new's rays, uv, levels and pose, and
    each pair's matched rays, uv and levels (B,N,..)."""
    kf, k_new, nb_idx, idx = args[:4]
    rays1, uv1, lev1, R1, t1 = (x.index_select(0, k_new)[0] for x in kf)
    at = (nb_idx[:, None], idx)
    return rays1, uv1, lev1, R1, t1, kf.rays[at], kf.uv[at], kf.level[at]


def replaced_gated(mk, args):
    """What the gated kernel replaced, on its arguments: a pair at a time,
    the gathers, a one-pair launch and the eager gates
    (``MappingKernels.gate_pair``)."""
    R21s, t21s = args[5], args[6]
    rays1, uv1, lev1, R1, t1, rays2, uv2, lev2 = gated_rows(args)
    outs = [mk.gate_pair(rays1, rays2[b], uv1, uv2[b], lev1, lev2[b],
                         args[4][b], R21s[b], t21s[b], R1, t1)
            for b in range(R21s.shape[0])]
    return TT.Candidates(*(torch.stack(x) for x in zip(*outs)))


def _ulp(x):
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def gate_flips(mk, args, new, old):
    """Rows whose mask the gated kernel (``new``) and the eager gates it
    replaced (``old``, ``replaced_gated``) decide differently. Each such
    row is given to the first gate that the two formulations decide
    differently (the eager one: ``@``, ``linalg.norm`` and
    ``camera.ray_to_cubemap``; the kernel's: products and norms written
    out), with the kernel's distance to that gate's threshold in float32
    ulps (of the threshold; for a chi2 gate, of the reprojected pixel: how
    far u and v would have to move for the decision to turn). Returns
    ({gate: flipped rows}, the largest distance)."""
    kf, k_new, nb_idx, idx, match, R21s, t21s, consts = args
    rays1, uv1, lev1, R1, t1, rays2, uv2, lev2 = gated_rows(args)
    X1 = TT.triangulate_rays_ordered(rays1, rays2, R21s, t21s)
    cam, top = mk.cam, consts.level_sigma2.shape[0] - 1
    s1 = consts.level_sigma2[lev1.clamp(0, top)]
    s2 = consts.level_sigma2[lev2.clamp(0, top)]
    ro = (consts.scale_factors[lev1.clamp(0, top)]
          / consts.scale_factors[lev2.clamp(0, top)])
    rf = consts.ratio
    cos_t = consts.cos_fov_th
    flips, worst = {}, 0.0
    differ = new.ok != old.ok
    for b in torch.nonzero(differ.any(-1)).flatten().tolist():
        x1, R, t = X1[b], R21s[b], t21s[b]
        # the eager formulation, as gate_pair writes it
        cos_e = (rays1 * (rays2[b] @ R)).sum(-1)
        d1_e = torch.linalg.norm(x1, dim=-1)
        x2_e = x1 @ R.T + t
        d2_e = torch.linalg.norm(x2_e, dim=-1)
        p1_e, p2_e = TC.ray_to_cubemap(cam, x1), TC.ray_to_cubemap(cam, x2_e)
        # the kernel's, written out
        q = [rays2[b, :, 0] * R[0, j] + rays2[b, :, 1] * R[1, j]
             + rays2[b, :, 2] * R[2, j] for j in range(3)]
        cos_w = rays1[:, 0] * q[0] + rays1[:, 1] * q[1] + rays1[:, 2] * q[2]
        d1_w = TT._norm3(*x1.unbind(-1))
        x2_w = torch.stack([(R[a, 0] * x1[:, 0] + R[a, 1] * x1[:, 1]
                             + R[a, 2] * x1[:, 2]) + t[a] for a in range(3)],
                           -1)
        d2_w = TT._norm3(*x2_w.unbind(-1))
        p1_w = TT._to_cubemap(consts, *x1.unbind(-1))
        p2_w = TT._to_cubemap(consts, *x2_w.unbind(-1))
        base_e, base_w = torch.linalg.norm(t), TT._norm3(*t.unbind())

        def chi2(p, uv, s, eager):
            u, v = (p[0][:, 0], p[0][:, 1]) if eager else (p[0], p[1])
            valid = p[1] >= 0 if eager else p[2]
            du, dv = u - uv[:, 0], v - uv[:, 1]
            e = du * du + dv * dv
            thr = 5.991 * s
            move = 2 * (du.abs() * _ulp(u) + dv.abs() * _ulp(v))
            return valid & (e <= thr), (e - thr).abs() / move

        def fov(x, d):
            r = x[:, 2] / torch.clamp(d, min=1e-12)
            return r > cos_t, (r - cos_t).abs() / _ulp(cos_t)

        c1e, _ = chi2(p1_e, uv1, s1, True)
        c1w, m1 = chi2(p1_w, uv1, s1, False)
        c2e, _ = chi2(p2_e, uv2[b], s2[b], True)
        c2w, m2 = chi2(p2_w, uv2[b], s2[b], False)
        rd_e, rd_w = d2_e / torch.clamp(d1_e, min=1e-12), \
            d2_w / torch.clamp(d1_w, min=1e-12)
        stages = [
            ("parallax", cos_e < 0.9998, cos_w < 0.9998,
             (cos_w - 0.9998).abs()
             / _ulp(torch.tensor(0.9998, device=cos_w.device))),
            ("depth", d1_e <= 50.0 * base_e, d1_w <= 50.0 * base_w,
             (d1_w - 50.0 * base_w).abs() / _ulp(50.0 * base_w)),
            ("fov1", *fov(x1, d1_e)[:1], *fov(x1, d1_w)),
            ("fov2", *fov(x2_e, d2_e)[:1], *fov(x2_w, d2_w)),
            ("chi2 (new keyframe)", c1e, c1w, m1),
            ("chi2 (neighbour)", c2e, c2w, m2),
            ("scale", (rd_e * rf > ro[b]) & (rd_e < ro[b] * rf),
             (rd_w * rf > ro[b]) & (rd_w < ro[b] * rf),
             torch.minimum((rd_w * rf - ro[b]).abs() / _ulp(ro[b]),
                           (rd_w - ro[b] * rf).abs() / _ulp(rd_w)))]
        for i in torch.nonzero(differ[b]).flatten().tolist():
            for gate, pe, pw, margin in stages:
                if bool(pe[i]) != bool(pw[i]):
                    flips[gate] = flips.get(gate, 0) + 1
                    worst = max(worst, float(margin[i]))
                    break
            else:
                flips["none found"] = flips.get("none found", 0) + 1
                worst = math.inf
    return flips, worst


def tri_gated_case(name, args, mk):
    """The gated kernel against ``triangulate_gated_ordered``, from one
    launch and from a CUDA graph replay of it, and its decisions against
    the eager gates it replaced (``gate_flips``). The case's dict."""
    n, B = args[3].shape[1], args[3].shape[0]
    n0 = TT.TRIANGULATE.launches
    new = TT.triangulate_gated_cuda(*args)
    torch.cuda.synchronize()
    launched = TT.TRIANGULATE.launches - n0
    ref = TT.triangulate_gated_ordered(*args)
    g = replayed(lambda: TT.triangulate_gated_cuda(*args)) if n else new
    old = replaced_gated(mk, args)
    flips, worst = gate_flips(mk, args, new, old)
    both = torch.isfinite(new.Xw) & torch.isfinite(ref.Xw)
    err = float((new.Xw - ref.Xw)[both].abs().max()) if bool(both.any()) \
        else 0.0
    kept = new.ok & old.ok

    def bits(a, b):
        """(B,N): the rows whose values differ in any bit."""
        d = a.view(torch.int32) != b.view(torch.int32)
        return d.any(-1) if d.dim() == 3 else d

    c = dict(name=name, n=n, pairs=B, bitwise=same_candidates(new, ref),
             graph_bitwise=same_candidates(g, ref), max_abs_err=err,
             kept=int(new.ok.sum()), gates=new.gates.sum(0).tolist(),
             kept_eager=int(old.ok.sum()),
             gates_eager=old.gates.sum(0).tolist(), flips=flips,
             flip_ulps=worst, launches=launched,
             xw_bits_differ=int((kept & bits(new.Xw, old.Xw)).sum()),
             cos_bits_differ=int((kept & bits(new.cos_par, old.cos_par))
                                 .sum()))
    log(f"[triangulate] {name}, gated: {B} x {n} rows, kept {c['kept']} "
        f"(gates [raw, parallax, depth, chi2] {c['gates']}), bitwise "
        f"{c['bitwise']}, from a graph {c['graph_bitwise']}; {launched} "
        f"launch(es); the eager gates it replaced kept {c['kept_eager']} "
        f"({c['gates_eager']}): rows decided otherwise "
        f"{sum(flips.values())} {flips}, each within {worst:.3g} ulps of its "
        f"gate (bound {TRI_FLIP_ULPS}); of the rows both keep, "
        f"{c['xw_bits_differ']} with other bits in the world point and "
        f"{c['cos_bits_differ']} in the parallax cosine (written out here, "
        f"through cuBLAS there)")
    if not (c["bitwise"] and c["graph_bitwise"] and worst <= TRI_FLIP_ULPS
            and launched == (1 if n else 0)):
        raise AssertionError(f"the gated triangulation kernel differs from "
                             f"its plain version, or from the eager gates "
                             f"beyond a rounding, on {name}")
    return c


def check_triangulate(real, mk):
    """The triangulation kernel (``csrc/triangulate.cu``) on the card: the
    gated form on ``real``, the slam drive's first mapping step's
    ``triangulate_gated`` call (recorded as it ran; ``mk`` its
    ``MappingKernels``), and on ``tri_gated_problem`` inputs of TRI_PAIRS x
    TRI_SIZES (``tri_gated_case`` each); the ungated form on
    ``tri_problem`` inputs of TRI_PAIRS x TRI_SIZES and the two 2000-row
    specials (``tri_case``). Timed on the real input: a wrapper call, the
    device's time from a CUDA graph (and at each of TRI_BLOCKS), the plain
    version's wall time, the library call (``torch.linalg.eigh`` of the
    B N float64 normal matrices, a non-finite one replaced by the identity;
    it waits for the host) and what the kernel replaced, a one-pair launch
    and the eager gates a pair (device ms from a CUDA graph, its device
    operations from the profiler, eager wall ms); and the ungated form at
    the two-view reconstruction's shape (4 x 6000). Returns the kernel's
    JSON row, without its launches."""
    cases = [tri_gated_case("slam, first mapping step", real, mk)]
    cfg_mk = MappingKernels(SlamConfig(), device="cuda")
    for B in TRI_PAIRS:
        for n in TRI_SIZES:
            cases.append(tri_gated_case(
                f"seeded, {B} pairs x {n} rows",
                tri_gated_problem(B, n, SEED + 8, "cuda"), cfg_mk))
            cases.append(tri_case(f"seeded, {B} pairs x {n} rows",
                                  tri_problem(n, SEED + 6, "cuda",
                                              pairs=B)))
    for kind in ("zero_baseline", "axis"):
        cases.append(tri_case(f"seeded {kind}, 2000 rows", tri_problem(
            2000, SEED + 7, "cuda", kind)))
    B, n = real[3].shape
    n64 = B * n * TRI_OPS
    n32 = B * n * TRI_GATE_OPS
    b_ms, b_by = bound(B * n * TRI_GATE_BYTES + 4 * 12 * B,
                       n64 + n32 * H100_F64_OPS_PER_S / H100_F32_OPS_PER_S,
                       H100_F64_OPS_PER_S)
    rays1, _, _, _, _, rays2 = gated_rows(real)[:6]
    M = TT.normal_matrices(rays1, rays2, real[5], real[6]).reshape(-1, 4, 4)
    fin = torch.isfinite(M).all(-1).all(-1)
    M = torch.where(fin[:, None, None], M,
                    torch.eye(4, dtype=M.dtype, device=M.device))

    def kernel():
        return TT.triangulate_gated_cuda(*real)

    def replaced():
        return replaced_gated(mk, real)

    init = tri_problem(6000, SEED + 6, "cuda", pairs=4)
    blocks = {b: graph_ms(lambda b=b: TT.triangulate_gated_cuda(
        *real, threads=b)) for b in TRI_BLOCKS}
    # the same rows' chains without the gathers and the gates: pair 0's
    # rays under all B pairs' geometry, and under pair 0's alone
    plain_rows = (rays1, rays2[0].contiguous(), real[5], real[6])
    ungated = {f"{B} x {n}": graph_ms(
                   lambda: TT.triangulate_pairs_cuda(*plain_rows)),
               f"1 x {n}": graph_ms(lambda: TT.triangulate_pairs_cuda(
                   rays1, plain_rows[1], real[5][:1], real[6][:1]))}
    prof = profile_stages(replaced, (), 1)
    row = dict(name="triangulate", route="cuda",
               source="cubemapslam_tpu_torch/csrc/triangulate.cu",
               replaces="cubemapslam_tpu/solvers/triangulate.py:18 "
                        "(triangulate_rays: a batched XLA SVD at :33) and "
                        "the gates of cubemapslam_tpu/runtime/mapping.py:"
                        "116-168, vmapped over 6 neighbours in one XLA "
                        "program; no pallas_call",
               shape=f"{B} pairs x {n} rows, gated, blocks of "
                     f"{TT.TRI_THREADS}",
               max_abs_err=max(c["max_abs_err"] for c in cases),
               bitwise=all(c["bitwise"] and c["graph_bitwise"]
                           for c in cases),
               ms=time_ms(kernel), device_ms=graph_ms(kernel),
               device_ms_by_block={str(b): v for b, v in blocks.items()},
               device_ms_reconstruction=graph_ms(
                   lambda: TT.triangulate_pairs_cuda(*init)),
               device_ms_ungated=ungated,
               plain_ms=wall_ms(lambda: TT.triangulate_gated_ordered(*real)),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: torch.linalg.eigh(M)),
               library_call=f"torch.linalg.eigh on the {B * n} float64 "
                            f"normal matrices",
               replaced_graph_ms=graph1_ms(replaced),
               replaced_eager_ms=wall_ms(replaced),
               replaced_device_ops=prof["device_ops"],
               flips=cases[0]["flips"], cases=cases)
    log(f"[triangulate] row: kernel {row['ms']:.5f} ms (device "
        f"{row['device_ms']:.5f}; by block size "
        + ", ".join(f"{b} {v:.5f}" for b, v in blocks.items())
        + f"; ungated 4 x 6000 {row['device_ms_reconstruction']:.5f}, "
        + ", ".join(f"{k} {v:.5f}" for k, v in ungated.items())
        + f" of these rows), plain "
        f"(kernel order) {row['plain_ms']:.3f} ms, the replaced path (a "
        f"one-pair launch and the eager gates a pair) "
        f"{row['replaced_graph_ms']:.3f} ms from a CUDA graph "
        f"({row['replaced_device_ops']:.0f} device operations) and "
        f"{row['replaced_eager_ms']:.3f} ms eager; library (eigh) "
        f"{row['library_ms']:.5f} ms; bound {b_ms:.6f} ms ({b_by}: "
        f"{TRI_OPS} float64 and {TRI_GATE_OPS} float32 operations a row)")
    return row


# ---------------------------------------------------------------------------
# The symmetric eigen-solve kernel (csrc/sym_eig.cu)
# ---------------------------------------------------------------------------

# the kernel's launches by path, each counted from 0 around its drive: one
# an eigen-solve, 6 a relocalization candidate's PnP
EIG_LAUNCHES = {}
# the inputs of the six eigen-solves of the reloc phase's first PnP (its
# eager frame's first candidate), recorded for check_sym_eig
EIG_INPUTS = []
# the names of one pnp_ransac's six eigen-solves, in call order
EIG_SITES = ("pca", "null", "horn", "refit.pca", "refit.null", "refit.horn")


def eig_launches(tag, required=True):
    """The eigen-solve kernel's launches since the counters were set to 0,
    recorded as the ``tag`` path's; with ``required`` the path must have
    launched it."""
    n = SE.SYM_EIG.launches
    EIG_LAUNCHES[tag] = n
    log(f"[{tag}] sym_eig: launches {n}")
    if required and n <= 0:
        raise AssertionError(f"the {tag} path launched no sym_eig kernel")
    return n


@contextlib.contextmanager
def recording_eigh(store):
    """Record clones of the inputs of the first six ``pnp._eigh`` calls (one
    ``pnp_ransac``) into ``store`` while the context is open."""
    inner = PNP._eigh

    def recorded(A):
        if len(store) < len(EIG_SITES):
            store.append(A.clone())
        return inner(A)

    PNP._eigh = recorded
    try:
        yield store
    finally:
        PNP._eigh = inner


def pnp_eig_inputs(device, seed=SEED + 12, n=2000, n_out=600):
    """The six eigen-solve inputs of one ``pnp_ransac`` on a seeded
    ``pnp_scene`` of ``n`` points, ``n_out`` of the matches scrambled, on
    ``device``: (300,3,3), (300,12,12), (300,3,4,4), (3,3), (12,12),
    (3,4,4)."""
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, device)
    _, _, pw, rays, uv, valid = pnp_scene(
        CubemapCamera.from_config(cfg, "cpu"), np.random.default_rng(seed),
        n=n, n_out=n_out)
    sets = sample_minimal_sets(torch.Generator().manual_seed(seed), valid,
                               cfg.pnp_ransac_iters, PNP.MIN_SET)
    store = []
    with recording_eigh(store):
        PNP.pnp_ransac(cam, None, *(x.to(device) for x in (
            pw, rays, uv, torch.ones(n), valid)), sets=sets)
    return store


def eig_specials(n, device, seed=SEED + 13):
    """(8, n, n) float32 matrices that exercise the kernel's branches: equal
    eigenvalues (a diagonal with ties, the identity), zero, a rank-one
    matrix, an indefinite and a badly scaled one, and a NaN and an inf
    entry (their results NaN)."""
    rng = np.random.default_rng(seed + n)
    X = rng.standard_normal((4, n, n)).astype(np.float32)
    A = np.zeros((8, n, n), np.float32)
    A[0] = np.diag(np.array([1.0, 2.0, 1.0] + [3.0] * (n - 3), np.float32))
    A[1] = np.eye(n, dtype=np.float32)
    A[3] = np.outer(X[0, 0], X[0, 0])
    A[4] = X[1] + X[1].T
    A[5] = (X[2] @ X[2].T) * np.float32(1e-20)
    A[6] = X[3] @ X[3].T
    A[6, n - 1, 0] = np.nan
    A[7] = X[3] @ X[3].T
    A[7, 0, 0] = np.inf
    return torch.as_tensor(A).to(device)


def eig_case(name, A):
    """The kernel against ``sym_eig_ordered`` on (..., n, n) ``A``: one
    launch, eigenvalues and eigenvectors bitwise (NaN where NaN), eagerly
    and replayed from a CUDA graph. The case's dict with the rotations,
    sweeps and steps of its matrices (the ordered version's count)."""
    ref_w, ref_V, rot, sw, st = SE.sym_eig_ordered(A, counts=True)
    n0 = SE.SYM_EIG.launches
    w, V = SE.sym_eig_cuda(A)
    torch.cuda.synchronize()
    one = SE.SYM_EIG.launches == n0 + 1
    out = {}

    def run():
        out["w"], out["V"] = SE.sym_eig_cuda(A)

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    fin = torch.isfinite(ref_w)
    err = max(float((w - ref_w)[fin].abs().max()) if fin.any() else 0.0,
              float((V - ref_V)[torch.isfinite(ref_V)].abs().max())
              if torch.isfinite(ref_V).any() else 0.0)
    c = dict(name=name, shape=list(A.shape), max_abs_err=err,
             bitwise=same_float_bits(w, ref_w) and same_float_bits(V, ref_V),
             graph_bitwise=same_float_bits(out["w"], ref_w)
             and same_float_bits(out["V"], ref_V),
             rotations=int(rot.sum()), max_sweeps=int(sw.max()),
             max_steps=int(st.max()))
    log(f"[sym_eig] {name} {tuple(A.shape)}: bitwise {c['bitwise']}, from a "
        f"graph {c['graph_bitwise']}; {c['rotations']} rotations, at most "
        f"{c['max_sweeps']} sweeps ({c['max_steps']} steps) a matrix")
    if not (one and c["bitwise"] and c["graph_bitwise"]):
        raise AssertionError(f"the sym_eig kernel differs from its plain "
                             f"version on {name} (one launch {one}, max "
                             f"|err| {err:.3g})")
    return c


def eig_bound(A, rotations, sweeps):
    """The kernel's bound (ms, what bounds it) on ``A`` (B, n, n), from the
    ordered version's count of each matrix's rotations applied and sweeps
    begun: the input read (in its dtype) and the float32 outputs written
    once; the float64 operations the solve needs whatever its schedule or its lanes: the sum
    of squares (2 n^2), each convergence test (2 a pair above the diagonal,
    one a sweep begun and one more where the matrix converged), each skip
    test (2 a pair a sweep begun), each rotation applied (14 for the angle,
    6 for each of the n - 2 pairs of entries, 4 for the diagonal, 6 for
    each row of V: 12 n + 6), the order and the sign (4 n^2). The kernel's
    program does more (both lanes of a pair compute its angle, each entry
    of A is computed in both triangles, a skipped pair rotates by the
    identity, n = 3 runs at 4): none of that is counted."""
    B, n = A.shape[0], A.shape[-1]
    pairs = n * (n - 1) // 2
    sweeps = sweeps.double()
    tests = sweeps + (sweeps < SE.MAX_SWEEPS).double()
    ops = float((2 * n * n + 2 * pairs * tests + 2 * pairs * sweeps
                 + (12 * n + 6) * rotations.double() + 4 * n * n).sum())
    return bound(B * ((A.element_size() + 4) * n * n + 4 * n), ops,
                 H100_F64_OPS_PER_S)


def eig_step_ms(n):
    """One step's latency (ms) at size n and the steps it was measured on:
    the device time (``graph_ms``) of one seeded symmetric (1, n, n) matrix
    less that of the identity (done before its first sweep), over the
    seeded matrix's steps."""
    X = np.random.default_rng(SEED + 14 + n).standard_normal(
        (1, n, n)).astype(np.float32)
    A = torch.as_tensor(X + X.transpose(0, 2, 1)).cuda()
    eye = torch.eye(n, device="cuda")[None]
    steps = int(SE.sym_eig_ordered(A, counts=True)[4].max())
    busy = graph_ms(lambda: SE.sym_eig_cuda(A))
    idle = graph_ms(lambda: SE.sym_eig_cuda(eye))
    return (busy - idle) / steps, steps


def check_sym_eig(real):
    """The eigen-solve kernel (``csrc/sym_eig.cu``) on the card, bitwise
    against ``sym_eig_ordered`` (``eig_case``) on ``real``, the six inputs
    of the reloc phase's first PnP (recorded as it ran), on the six of a
    seeded 2000-point ``pnp_scene``, and on ``eig_specials`` at n = 3, 4 and
    12. Timed on each real input: a wrapper call, the device's time from a
    CUDA graph, the plain version's wall time and the library call
    (``torch.linalg.eigh`` of the same float32 matrices, which waits for
    the host each call), beside the bound and the serial floor (the most
    steps a matrix times ``eig_step_ms``). Returns the kernel's JSON row
    (one PnP's six solves summed), without its launches."""
    cases = [eig_case(f"reloc, {site}", A.reshape(-1, *A.shape[-2:]))
             for site, A in zip(EIG_SITES, real)]
    seeded = pnp_eig_inputs("cuda")
    cases += [eig_case(f"seeded pnp_scene, {site}",
                       A.reshape(-1, *A.shape[-2:]))
              for site, A in zip(EIG_SITES, seeded)]
    cases += [eig_case(f"specials n={n}", eig_specials(n, "cuda"))
              for n in SE.SYM_EIG_SIZES]
    step = {}
    for n in SE.SYM_EIG_SIZES:
        step[n] = eig_step_ms(n)
        log(f"[sym_eig] one step at n={n}: {step[n][0] * 1e3:.4f} us "
            f"(a seeded (1,{n},{n}) matrix of {step[n][1]} steps less the "
            f"identity, device time)")
    by_site = {}
    for site, A in zip(EIG_SITES, real):
        A = A.reshape(-1, *A.shape[-2:]).contiguous()
        n = A.shape[-1]
        _, _, rot, sw, st = SE.sym_eig_ordered(A, counts=True)
        b_ms, b_by = eig_bound(A, rot, sw)
        by_site[site] = dict(
            shape=list(A.shape), ms=time_ms(lambda: SE.sym_eig_cuda(A)),
            device_ms=graph_ms(lambda: SE.sym_eig_cuda(A)),
            plain_ms=wall_ms(lambda: SE.sym_eig_ordered(A)),
            library_ms=time_ms(lambda: torch.linalg.eigh(A)),
            library_wall_ms=wall_ms(lambda: torch.linalg.eigh(A)),
            bound_ms=b_ms, bound_by=b_by,
            mean_rotations=float(rot.double().mean()),
            max_sweeps=int(sw.max()), mean_steps=float(st.double().mean()),
            max_steps=int(st.max()), step_ms=step[n][0],
            serial_floor_ms=int(st.max()) * step[n][0])
        v = by_site[site]
        log(f"[sym_eig] {site} {tuple(A.shape)}: kernel {v['ms']:.5f} ms "
            f"(device {v['device_ms']:.5f}), plain {v['plain_ms']:.3f} ms, "
            f"library (eigh, waits) {v['library_ms']:.5f} ms (wall "
            f"{v['library_wall_ms']:.5f}); bound {b_ms:.6f} ms ({b_by}); "
            f"serial floor {v['serial_floor_ms']:.5f} ms ({v['max_steps']} "
            f"steps x {v['step_ms'] * 1e3:.4f} us); "
            f"{v['mean_rotations']:.1f} rotations and {v['mean_steps']:.1f} "
            f"steps a matrix, at most {v['max_sweeps']} sweeps")

    def total(key):
        return sum(v[key] for v in by_site.values())

    row = dict(name="sym_eig", route="cuda",
               source="cubemapslam_tpu_torch/csrc/sym_eig.cu",
               replaces="jnp.linalg.eigh inside the compiled relocalization "
                        "program: cubemapslam_tpu/solvers/pnp.py:51 and "
                        ":133, cubemapslam_tpu/solvers/horn.py:46; no "
                        "pallas_call",
               shape="one pnp_ransac's six solves: " + ", ".join(
                   f"{k} {tuple(v['shape'])}" for k, v in by_site.items()),
               max_abs_err=max(c["max_abs_err"] for c in cases),
               bitwise=all(c["bitwise"] and c["graph_bitwise"]
                           for c in cases),
               ms=total("ms"), device_ms=total("device_ms"),
               plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
               bound_by=max(by_site.values(),
                            key=lambda v: v["bound_ms"])["bound_by"],
               library_ms=total("library_ms"),
               library_call="torch.linalg.eigh on the same float32 "
                            "matrices (a host wait each call)",
               serial_floor_ms=total("serial_floor_ms"),
               step_ms={n: v[0] for n, v in step.items()},
               by_site=by_site, cases=cases)
    log(f"[sym_eig] row (one PnP's six solves): kernel {row['ms']:.5f} ms "
        f"(device {row['device_ms']:.5f}), plain {row['plain_ms']:.3f} ms, "
        f"library {row['library_ms']:.5f} ms, bound {row['bound_ms']:.6f} "
        f"ms, serial floor {row['serial_floor_ms']:.5f} ms; bitwise on "
        f"{len(cases)} cases {row['bitwise']}")
    return row


# the inputs of the slam drive's first two-view attempt, recorded for
# check_sym_eig_init: its 8-point sets' rays ("rays") and the best E that
# decompose_e took ("E")
INIT_EIG_INPUTS = {}
# the essential solver's three eigen-solves, in call order, and the
# torch.linalg.svd each replaced
INIT_EIG_SITES = ("normal", "rank2", "decompose")


@contextlib.contextmanager
def recording_essential(store):
    """Record clones of the first ``essential.compute_e21`` call's rays and
    of the first ``essential.decompose_e`` call's E into ``store`` while
    the context is open."""
    e21, dec = ES.compute_e21, ES.decompose_e

    def rec_e21(rays1, rays2):
        store.setdefault("rays", (rays1.clone(), rays2.clone()))
        return e21(rays1, rays2)

    def rec_dec(E):
        store.setdefault("E", E.clone())
        return dec(E)

    ES.compute_e21, ES.decompose_e = rec_e21, rec_dec
    try:
        yield store
    finally:
        ES.compute_e21, ES.decompose_e = e21, dec


def init_eig_cases(rec):
    """The essential solver's three eigen-solve inputs from a
    ``recording_essential`` record, by site, each with the input of the
    ``torch.linalg.svd`` it replaced: the 8-point sets' float64 normal
    matrices (the (B,8,9) float32 systems), the EᵀE of their null vectors
    (those (B,3,3) E) and the best E's (1,3,3) EᵀE (that E)."""
    r1, r2 = rec["rays"]
    A8 = (r2[..., :, None] * r1[..., None, :]).reshape(-1, 8, 9)
    N = ES.normal_matrix(r1, r2)
    E0 = SE.sym_eig(N)[1][..., :, 0].reshape(-1, 3, 3)
    Ed = rec["E"].reshape(1, 3, 3)
    return {"normal": (N, A8), "rank2": (ES._gram(E0), E0),
            "decompose": (ES._gram(Ed), Ed)}


def host_waits_of(fn):
    """Host waits (synchronisations and blocking copies) that start inside
    one call of ``fn`` (a range around it; the profiler's own stop
    synchronises outside it), after a warm-up, under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("call"):
            fn()
    cpu = [e for e in raw_events(prof) if not e[1]]
    spans = [(e[2], e[3]) for e in cpu if e[0] == "call"]
    return sum(1 for e in cpu
               if ("Synchronize" in e[0] or e[0] == "cudaMemcpy")
               and any(a <= e[2] < b for a, b in spans))


def check_sym_eig_init(rec):
    """The eigen-solve kernel on the essential solver's three solves of the
    slam drive's first two-view attempt (``rec``, from
    ``recording_essential``): the (200,9,9) float64 normal matrices of its
    8-point sets, the (200,3,3) EᵀE of their null vectors and the best E's
    (1,3,3) EᵀE, each bitwise against ``sym_eig_ordered`` eagerly and from
    a CUDA graph (``eig_case``), and ``eig_specials`` at n = 9 in float64.
    Timed as ``check_sym_eig`` times the PnP's, beside the
    ``torch.linalg.svd`` each replaced (of the (200,8,9) systems, of the
    (200,3,3) null vectors and of the (3,3) E, with the host waits of one
    call). Returns the per-site dicts for the kernel's JSON row."""
    inputs = init_eig_cases(rec)
    cases = [eig_case(f"init, {site}", A)
             for site, (A, _) in inputs.items()]
    cases.append(eig_case("specials n=9 float64",
                          eig_specials(9, "cuda").double()))
    step = {n: eig_step_ms(n) for n in (3, 9)}
    out = {}
    for site, (A, L) in inputs.items():
        n = A.shape[-1]
        _, _, rot, sw, st = SE.sym_eig_ordered(A, counts=True)
        b_ms, b_by = eig_bound(A, rot, sw)
        out[site] = v = dict(
            shape=list(A.shape), dtype=str(A.dtype).replace("torch.", ""),
            ms=time_ms(lambda: SE.sym_eig_cuda(A)),
            device_ms=graph_ms(lambda: SE.sym_eig_cuda(A)),
            plain_ms=wall_ms(lambda: SE.sym_eig_ordered(A)),
            library_call=f"torch.linalg.svd of {tuple(L.shape)} float32",
            library_ms=time_ms(lambda: torch.linalg.svd(L)),
            library_wall_ms=wall_ms(lambda: torch.linalg.svd(L)),
            library_waits=host_waits_of(lambda: torch.linalg.svd(L)),
            kernel_waits=host_waits_of(lambda: SE.sym_eig_cuda(A)),
            bound_ms=b_ms, bound_by=b_by,
            max_sweeps=int(sw.max()), mean_steps=float(st.double().mean()),
            max_steps=int(st.max()), step_ms=step[n][0],
            serial_floor_ms=int(st.max()) * step[n][0],
            max_abs_err=next(c["max_abs_err"] for c in cases
                             if c["name"] == f"init, {site}"))
        log(f"[sym_eig] init {site} {tuple(A.shape)} {v['dtype']}: kernel "
            f"{v['ms']:.5f} ms (device {v['device_ms']:.5f}, host waits "
            f"{v['kernel_waits']}), plain {v['plain_ms']:.3f} ms, library "
            f"({v['library_call']}) {v['library_ms']:.5f} ms (wall "
            f"{v['library_wall_ms']:.5f}, host waits {v['library_waits']}); "
            f"bound {b_ms:.6f} ms ({b_by}); serial floor "
            f"{v['serial_floor_ms']:.5f} ms ({v['max_steps']} steps x "
            f"{v['step_ms'] * 1e3:.4f} us); {v['mean_steps']:.1f} steps a "
            f"matrix, at most {v['max_sweeps']} sweeps")
        if v["kernel_waits"]:
            raise AssertionError(f"the sym_eig kernel waited on the host on "
                                 f"the init's {site} solve")
    return out


def seg_sum_cases(cam, arena, inv_s2):
    """The segmented-sum kernel's inputs at the main path's shapes: the
    loop arena's global BA on its live edges padded to their edge capacity
    (``LoopKernels.padded_ba_problem``; by camera, the 36 lanes of Hcc,
    1,440 rows a live camera on average and 2,000 at most; by point, the 9
    of Hpp; the cost, one segment of the robust chi2; the values of a first
    LM step) and ``seg_case`` at the other SEG_SHAPES. {name: (plan,
    values)}."""
    prob = D.global_ba_problem_from_arena(cam, arena, inv_s2)
    cap = LC.LoopKernels.ba_edge_capacity(int(prob.obs_valid.sum()),
                                          prob.obs_valid.shape[0])
    padded, _ = LC.LoopKernels.padded_ba_problem(prob, cap)
    cam_plan, pt_plan = TBA._cg_plans(padded)
    w = torch.where(padded.obs_valid, padded.obs_inv_sigma2, 0.0)
    _, Hcc_e, Hpp_e, _, _, _ = TBA._edge_terms(cam, padded, w)
    rho = torch.where(padded.obs_valid, TBA._chi2(cam, padded), 0.0)
    cases = {"gba_cameras": (cam_plan, Hcc_e), "gba_points": (pt_plan, Hpp_e),
             "gba_cost": (TBA._cost_plan(padded), rho)}
    for name in SEG_SHAPES:
        if name not in cases:
            cases[name] = seg_case(name, "cuda")
    return cases


def check_seg_sum(cam, arena, inv_s2):
    """The segmented-sum kernel against its kernel-order plain version on
    the card at each shape of ``seg_sum_cases``, bitwise, and two launches
    on one plan bitwise equal; times at each shape (a wrapper call, the
    device's time from a CUDA graph, and ``index_add_`` into zeros, the
    library call with float atomics), the plain version's at the global
    BA's camera shape, which is the row's. Bound: ``seg_bound``. Then the
    same bitwise checks, untimed, at every SEG_EDGES shape.
    Returns the kernel's JSON row, without its launches."""
    cases = []
    for name, (plan, v) in seg_sum_cases(cam, arena, inv_s2).items():
        c = seg_bitwise(name, plan, v)
        E, n, tail = v.shape[0], plan.n, tuple(v.shape[1:])
        lanes = c["lanes"]

        def lib(plan=plan, v=v, tail=tail):
            # the dump row n takes the dropped rows, as in the plain version
            return torch.zeros((plan.n + 1,) + tail,
                               device="cuda").index_add_(0, plan.idx, v)[:-1]

        b_ms, b_by = seg_bound(plan, v)
        c.update(index_add_max_abs_diff=float(
                     (lib() - SG.segment_sum(plan, v)).abs().max()),
                 ms=time_ms(lambda: SG.segment_sum(plan, v)),
                 device_ms=graph_ms(lambda: SG.segment_sum(plan, v)),
                 library_ms=time_ms(lib), library_device_ms=graph_ms(lib),
                 bound_ms=b_ms, bound_by=b_by)
        c["bound_share"] = b_ms / c["device_ms"]
        if name == "gba_cameras":
            c["plain_ms"] = time_ms(lambda: SG.segment_sum_ordered(plan, v))
        log(f"[seg_sum] {name}: {E} rows, {n} segments (longest "
            f"{c['longest']}, {c['long']} long), {lanes} lanes: bitwise "
            f"{c['bitwise']} (max |err| {c['max_abs_err']:.3g}; index_add_ "
            f"differs by {c['index_add_max_abs_diff']:.3g}); kernel "
            f"{c['ms']:.5f} ms (device {c['device_ms']:.5f}), index_add_ "
            f"{c['library_ms']:.5f} ms (device "
            f"{c['library_device_ms']:.5f}), bound {b_ms:.5f} ms ({b_by}, "
            f"{c['bound_share']:.3f} of the device time)"
            + (f", plain {c['plain_ms']:.5f} ms" if "plain_ms" in c else ""))
        cases.append(c)
    for name in SEG_EDGES:
        c = seg_bitwise(name, *seg_case(name, "cuda"))
        log(f"[seg_sum] edge {name}: {c['rows']} rows, {c['segments']} "
            f"segments (longest {c['longest']}, {c['long']} long), "
            f"{c['lanes']} lanes, strides {c['strides']}: bitwise "
            f"{c['bitwise']}")
        cases.append(c)
    bad = [c["name"] for c in cases if not c["bitwise"]]
    if bad:
        raise AssertionError(f"seg_sum differs from its kernel-order plain "
                             f"version, or from itself, at {bad}")
    head = cases[0]
    row = dict(name="seg_sum", route="cuda",
               source="cubemapslam_tpu_torch/csrc/seg_sum.cu",
               replaces="cubemapslam_tpu/optim/ba.py:447 (the CG BA's "
                        ".at[].add, an XLA scatter; also ba.py:311, 329, "
                        "475-486, 514, optim/pose_graph.py:74-80, "
                        "slam_map.py:203; no pallas_call)",
               shape=f"gba_cameras: {head['rows']} rows x {head['lanes']} "
                     f"lanes into {head['segments']} segments",
               max_abs_err=max(c["max_abs_err"] for c in cases),
               **{k: head[k] for k in ("ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_device_ms")},
               cases=cases)
    return row


def seg_bound(plan, v):
    """The segmented sum's bound (ms, what bounds it) on this input: the
    values and permutation entries of the rows it keeps read once (a
    dropped row sorts after the last offset and is never read), every
    offset read once, each output lane written once; one add a kept
    value."""
    kept, lanes = int(plan.order()[1][-1]), math.prod(v.shape[1:])
    return bound(kept * lanes * 4 + kept * 8 + (plan.n + 1) * 8
                 + plan.n * lanes * 4, kept * lanes)


def seg_bitwise(name, plan, v):
    """Two kernel launches on one plan and the kernel-order plain version:
    the case's dict (shape, longest segment, long segments, whether all
    three are bitwise equal, the largest difference)."""
    a, b = SG.segment_sum(plan, v), SG.segment_sum(plan, v)
    ref = SG.segment_sum_ordered(plan, v)
    torch.cuda.synchronize()
    lens = plan.order()[1].diff()
    return dict(name=name, rows=v.shape[0], segments=plan.n,
                lanes=math.prod(v.shape[1:]), strides=tuple(v.stride()),
                longest=int(lens.max()) if plan.n else 0,
                long=int(plan.schedule()[1]),
                bitwise=bool(torch.equal(a, ref) and torch.equal(a, b)),
                max_abs_err=float((a - ref).abs().max()) if a.numel()
                else 0.0)


@contextlib.contextmanager
def seg_tally(obj, names, tally):
    """Count the segmented-sum launches inside each named method of
    ``obj`` into ``tally`` (by name) while the context is open."""
    orig = {n: getattr(obj, n) for n in names}

    def counted(name, fn):
        def call(*args, **kwargs):
            n0 = SG.SEG_SUM.launches
            try:
                return fn(*args, **kwargs)
            finally:
                tally[name] = tally.get(name, 0) + SG.SEG_SUM.launches - n0
        return call

    for name, fn in orig.items():
        setattr(obj, name, counted(name, fn))
    try:
        yield tally
    finally:
        for name, fn in orig.items():
            setattr(obj, name, fn)


def drive_main_path(tracker, frame_u8, lms, starts):
    """The frame step at full width from the perturbed start poses
    ``starts``, through graph F (``tracker.graphs`` on: the first frame
    captures it) or eagerly. Per frame: the synchronised wall time and the
    host thread's CPU time (ms), and the outputs."""
    walls, cpus, results = [], [], []
    for k, (R0, t0) in enumerate(starts):
        torch.cuda.synchronize()
        t_start, c_start = time.perf_counter(), time.thread_time()
        out = tracker(frame_u8, *lms, R0, t0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t_start) * 1e3)
        cpus.append((time.thread_time() - c_start) * 1e3)
        results.append(out)
        cf = tracker.step_graph
        if tracker.graphs and (cf.frame_captures, cf.frame_replayed) != (
                (1, []) if k == 0 else (0, ["F"])):
            raise AssertionError(f"frame step {k} captured "
                                 f"{cf.frame_captures} graphs and replayed "
                                 f"{cf.frame_replayed}")
    return walls, cpus, results


def frame_step_twins(tracker, frame_u8, lms, starts, results, walls):
    """The frame step's eager twin (``tracker.graphs`` off) over the same
    frames and start poses as the graph F run: every output bitwise equal;
    the walls side by side; then 2 replaying graph F frames fed from a host
    copy of the frame and 2 eager frames under the profiler: device busy,
    operations and host waits (graph F's at most 1: the upload)."""
    PO.POSE_LM.launches = 0
    tracker.graphs = False
    try:
        e_walls, _, e_results = drive_main_path(tracker, frame_u8, lms,
                                                starts)
    finally:
        tracker.graphs = True
    pose_launches("frame_step_eager", N_FRAMES)
    for k, (g, e) in enumerate(zip(results, e_results)):
        same = (all(torch.equal(x, y) for x, y in zip(g[0], e[0]))
                and all(torch.equal(x, y) for x, y in zip(g[1:], e[1:])))
        if not same:
            raise AssertionError(f"frame step {k}: graph F differs from its "
                                 f"eager twin")
    cf = tracker.step_graph
    log(f"[frame-step-graph] {N_FRAMES} frames through graph F bitwise the "
        f"eager twin's; wall ms graph {', '.join(f'{w:.3f}' for w in walls)}"
        f" (capturing {walls[0]:.3f}, replaying median "
        f"{float(np.median(walls[1:])):.3f}), eager "
        f"{', '.join(f'{w:.3f}' for w in e_walls)} (median of the last "
        f"{N_FRAMES - 1} {float(np.median(e_walls[1:])):.3f}); capture "
        f"{cf.capture_ms:.3f} ms of host time, pool {cf.capture_mib:.1f} MiB")
    R0, t0 = starts[-1]
    host = frame_u8.cpu()
    profs = {}
    for graphs, img in ((True, host), (False, frame_u8)):
        tracker.graphs = graphs
        try:
            profs[graphs] = profile_stages(
                lambda: tracker(img, *lms, R0, t0), (), GRAPH_PROFILE_FRAMES)
        finally:
            tracker.graphs = True
    for graphs, prof in profs.items():
        tag = "frame-step-graph" if graphs else "frame-step-eager"
        log_profile(tag, prof, walls[1:] if graphs else e_walls[1:])
        log(f"[{tag}] device busy {prof['device_busy_ms']:.3f} ms a frame "
            f"in {prof['device_ops']:.0f} operations; host waits "
            f"{prof['host_waits']:.2f} a frame ("
            + ("fed from the host: the upload alone may wait)" if graphs
               else "the frame on the card)"))
    if profs[True]["host_waits"] > 1:
        raise AssertionError(f"a graph F frame waited "
                             f"{profs[True]['host_waits']:.2f} times; only "
                             f"the upload may")
    if cf.frame_replayed != ["F"]:
        raise AssertionError("the profiled frame step did not replay graph F")


def check_results(results, cfg):
    for i, (kp, assoc, R, t, inl, n) in enumerate(results):
        n_valid = int(kp.valid.sum())
        n_match = int((assoc >= 0).sum())
        n_inl = int(n)
        ang, mm = pose_error(R, t)
        finite = bool(torch.isfinite(R).all() and torch.isfinite(t).all())
        log(f"[path] frame {i}: {n_valid} valid keypoints, {n_match} "
            f"matches, {n_inl} inliers, pose error {ang:.4f} deg / "
            f"{mm:.3f} mm")
        if kp.uv.shape != (cfg.n_features, 2) or not finite:
            raise AssertionError("malformed frame-step output")
        if not (n_valid > 1000 and n_match > 500 and n_inl > 300):
            raise AssertionError("too few keypoints, matches or inliers")
        if not (ang < 0.2 and mm < 5.0):
            raise AssertionError("pose not recovered")


def raw_events(prof):
    """The profiler's events as (name, on the card, start ns, end ns, input
    shapes, correlation id), read from its raw result: ``prof.events()``
    builds a tree of Python objects, which takes minutes for a loop
    closure's 10^5 operations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                    s + e.duration_ns(), e.shapes(), e.correlation_id()))
    return out


def launch_times(cpu):
    """The start of each CUDA runtime or driver call (a kernel launch, a
    copy, a graph launch) by its correlation id."""
    return {e[5]: e[2] for e in cpu if e[5] and e[0].startswith("cu")}


def launched_in(kernels, launch, host):
    """The device operations whose launch (``launch_times``) starts inside
    one of the ``host`` spans. Unlike the range's span on the device, this
    holds for nested ranges."""
    spans = sorted(host)
    starts = [a for a, _ in spans]

    def inside(k):
        t = launch.get(k[5])
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return i >= 0 and t < spans[i][1]

    return [k for k in kernels if inside(k)]


def wait_sources(cpu):
    """A function that names the outermost aten operation around a host
    wait (a span of ``cpu``), else the wait's own name."""
    tops = []
    for name, _, a, b, *_ in sorted((e for e in cpu
                                    if e[0].startswith("aten::")),
                                   key=lambda e: (e[2], -e[3])):
        if not tops or a >= tops[-1][2]:
            tops.append((name, a, b))
    starts = [t[1] for t in tops]

    def source(w):
        i = bisect.bisect_right(starts, w[2]) - 1
        return tops[i][0] if i >= 0 and tops[i][2] >= w[3] else w[0]

    return source


def waits_in(waits, spans, n, source):
    """Host waits that start inside ``spans``, per frame: their count and
    their count by ``source``, most first."""
    inside = [w for w in waits if any(a <= w[2] < b for a, b in spans)]
    by_src = {}
    for w in inside:
        src = source(w)
        by_src[src] = by_src.get(src, 0) + 1 / n
    return len(inside) / n, sorted(by_src.items(), key=lambda kv: -kv[1])


# a gap between two device operations of a frame shorter than this is
# counted as the cost of back-to-back launches (inside a graph replay or
# between eager launches); a longer one waits for the host
SHORT_GAP_NS = 20_000


def device_gaps(kernels, spans):
    """Per span (a frame's host range) of the device operations that start
    in it, sorted by start: the device span from the first start to the
    last end, and the idle time between operations split into gaps
    shorter than SHORT_GAP_NS and the rest (ms, summed over the spans)."""
    span = short = long_ = 0
    for a, b in spans:
        ks = sorted((k for k in kernels if a <= k[2] < b),
                    key=lambda k: k[2])
        if not ks:
            continue
        end = ks[0][3]
        for k in ks[1:]:
            gap = k[2] - end
            if gap > 0:
                if gap < SHORT_GAP_NS:
                    short += gap
                else:
                    long_ += gap
            end = max(end, k[3])
        span += end - ks[0][2]
    return span / 1e6, short / 1e6, long_ / 1e6


def profile_stages(step, stages, n, before=None):
    """``n`` calls of ``step`` under torch.profiler, each in a ``frame``
    range (after ``before()``, if given, outside it; what it launches is
    not counted) and synchronised after it, with one range per stage
    (``record_function``) inside. Returns the per-frame medians of the wall
    time (profiler on), the device's busy time (summed kernel and copy time)
    and the device operations (also those that start in each frame's host
    range); the host waits of a frame (a call that waits
    for the device: a synchronisation, which every blocking copy between
    host and card makes, or a blocking ``cudaMemcpy``) with their sources;
    per stage the host time, device busy time and device operations of what
    it launched (``launched_in``), host waits and the five device operations
    with the most time, all per frame; each
    port kernel's device time; the count of matrix products with the
    dense descriptor operator (its 8194 columns), which must be 0; and per
    frame ``device_gaps``: the device span and its short and long gaps."""
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            if before is not None:
                before()
            torch.cuda.synchronize()
            a = time.perf_counter()
            with record_function("frame"):
                step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - a) * 1e3)
    events = raw_events(prof)
    cpu = [e for e in events if not e[1]]
    dev = [e for e in events if e[1]]
    kernels = [e for e in dev if e[0] not in stages and e[0] != "frame"]
    if before is not None:
        # what before() launched is not the frames'
        kernels = launched_in(kernels, launch_times(cpu),
                              [(e[2], e[3]) for e in cpu if e[0] == "frame"])
    if not kernels:
        raise AssertionError("the profiler recorded no device operation")
    busy = sum(e[3] - e[2] for e in kernels) / 1e6 / n
    waits = [e for e in cpu
             if "Synchronize" in e[0] or e[0] == "cudaMemcpy"]
    source = wait_sources(cpu)

    def host_spans(name):
        return [(e[2], e[3]) for e in cpu if e[0] == name]

    frame_waits, frame_sources = waits_in(waits, host_spans("frame"), n,
                                          source)
    per_stage = {}
    launch = launch_times(cpu)
    for st in stages:
        host = host_spans(st)
        inside = launched_in(kernels, launch, host)
        by_name = {}
        for k in inside:
            t, c = by_name.get(k[0], (0.0, 0))
            by_name[k[0]] = (t + (k[3] - k[2]) / 1e6 / n, c + 1 / n)
        per_stage[st] = dict(
            host_ms=sum(b - a for a, b in host) / 1e6 / n,
            device_busy_ms=sum(k[3] - k[2] for k in inside) / 1e6 / n,
            device_ops=len(inside) / n,
            host_waits=waits_in(waits, host, n, source)[0],
            top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5])
    port = {}
    for k in kernels:
        name = next((n for n in PORT_KERNELS if n in k[0]), None)
        if name:
            port[name] = port.get(name, 0.0) + (k[3] - k[2]) / 1e6 / n
    dense_products = sum(
        1 for e in cpu
        if e[0] in ("aten::mm", "aten::matmul", "aten::addmm")
        and any(DESC_OP_COLS in s for s in (e[4] or []) if s))
    wall = float(np.median(walls))
    frames = host_spans("frame")
    span, short, long_ = device_gaps(kernels, frames)
    ops_by_frame = [sum(1 for k in kernels if a <= k[2] < b)
                    for a, b in frames]
    return dict(wall_ms=wall, walls_ms=walls, device_busy_ms=busy,
                device_ops_by_frame=ops_by_frame,
                device_span_ms=span / n, short_gaps_ms=short / n,
                long_gaps_ms=long_ / n,
                idle_share=1.0 - busy / float(np.mean(walls)),
                device_ops=len(kernels) / n, host_waits=frame_waits,
                wait_sources=frame_sources, stages=per_stage,
                port_kernels=port, dense_products=dense_products)


def log_profile(tag, prof, unprofiled_walls):
    """Print a profile_stages result; fail on a dense descriptor product.
    The profiler slows the host, so the idle share is also given against
    the mean wall time of unprofiled frames."""
    n = len(prof["walls_ms"])
    idle_off = 1.0 - prof["device_busy_ms"] / float(np.mean(unprofiled_walls))
    log(f"[{tag}] {n} frames under torch.profiler: wall ms "
        f"{', '.join(f'{w:.3f}' for w in prof['walls_ms'])} (median "
        f"{prof['wall_ms']:.3f}); device busy {prof['device_busy_ms']:.3f} "
        f"ms per frame; idle share {prof['idle_share']:.4f} of the profiled "
        f"wall, {idle_off:.4f} of the unprofiled wall; "
        f"{prof['device_ops']:.0f} device operations per frame (starting in "
        f"each frame's host range: {prof['device_ops_by_frame']})")
    log(f"[{tag}] host waits a frame {prof['host_waits']:.2f}, by source: "
        + ", ".join(f"{src} {c:.2f}" for src, c in prof["wait_sources"]))
    log(f"[{tag}] device span a frame {prof['device_span_ms']:.3f} ms (first "
        f"start to last end): idle between operations "
        f"{prof['short_gaps_ms']:.3f} ms in gaps under "
        f"{SHORT_GAP_NS / 1e3:.0f} us, {prof['long_gaps_ms']:.3f} ms in "
        f"longer ones")
    for st, v in prof["stages"].items():
        log(f"[{tag}] stage {st:14s}: host {v['host_ms']:.3f} ms, device "
            f"busy {v['device_busy_ms']:.3f} ms, {v['device_ops']:.0f} "
            f"device operations, {v['host_waits']:.0f} host waits per frame")
        for name, (ms, cnt) in v["top"]:
            log(f"[{tag}]   {ms:.5f} ms in {cnt:.0f} x {name[:110]}")
    log(f"[{tag}] the port's kernels, device ms per frame: "
        f"{', '.join(f'{k} {v:.5f}' for k, v in prof['port_kernels'].items())}")
    log(f"[{tag}] matrix products with the dense descriptor operator: "
        f"{prof['dense_products']}")
    if prof["dense_products"]:
        raise AssertionError("the card's extract made a dense descriptor "
                             "product")


def profiled_frames(tracker, frame_u8, lms, rng):
    """PROFILE_FRAMES frame steps of FrameTracker under profile_stages."""
    R0, t0 = perturbed_pose(rng, tracker.device)

    def step():
        with record_function("warp"):
            cube = tracker.warp(frame_u8)
        with record_function("extract"):
            kp = tracker.extract(cube)
        with record_function("match"):
            assoc = tracker.match(kp, *lms, R0, t0)
        with record_function("optimize"):
            tracker.optimize(kp, assoc, lms[0], R0, t0)

    return profile_stages(step, ("warp", "extract", "match", "optimize"),
                          PROFILE_FRAMES)


def small_reference_check():
    """The card's frame step against the CPU's (plain versions) on a small
    configuration, on the same warp map, mask and landmarks: same pose
    within 1e-3, same associations on >= 98% of matched rows."""
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4)
    rng = np.random.default_rng(SEED + 2)
    ref = FrameTracker(cfg, device="cpu")
    card = FrameTracker(cfg, device="cuda")
    card.set_warp_map(ref.warp_map)
    card.mask = ref.mask.to("cuda")
    f = torch.as_tensor(synthetic_fisheye(cfg, SEED + 1))
    lms = landmarks_from_keypoints(ref.extract(ref.warp(f)), 1024, rng,
                                   cfg.n_levels)
    R0, t0 = perturbed_pose(rng, "cpu")
    outs = []
    for tr, dev in ((ref, "cpu"), (card, "cuda")):
        args = [x.to(dev) for x in (f, *lms, R0, t0)]
        outs.append([o.cpu() for o in tr(*args)[1:]])
    (a_c, R_c, t_c, _, n_c), (a_g, R_g, t_g, _, n_g) = outs
    dR = float((R_c - R_g).abs().max())
    dt = float((t_c - t_g).abs().max())
    matched = (a_c >= 0) | (a_g >= 0)
    agree = float((a_c == a_g)[matched].float().mean())
    log(f"[ref] small config, card vs CPU: |dR| {dR:.3g}, |dt| {dt:.3g}, "
        f"associations agree on {agree:.4f} of {int(matched.sum())} "
        f"matched rows, inliers {int(n_g)} vs {int(n_c)}")
    if not (dR < 1e-3 and dt < 1e-3 and agree >= 0.98
            and int(matched.sum()) > 50):
        raise AssertionError("card and CPU frame steps disagree")


# ---------------------------------------------------------------------------
# The tracking path against the map arena
# ---------------------------------------------------------------------------

def gt_error(T, pose):
    """(degrees, map units) between a 4x4 world->camera pose and the
    ground-truth (R, t)."""
    R, t = pose
    dR = torch.as_tensor(T[:3, :3] @ R.T, dtype=torch.float32)
    return (math.degrees(float(torch.linalg.norm(so3_log(dR)))),
            float(np.linalg.norm(T[:3, 3] - t)))


def build_map_phase(cfg):
    """A seeded world and trajectory, and the map that build_map makes from
    MAP_KEYFRAMES rendered keyframes, on the card at full width. Returns
    the tracker, the poses and the rendered frames that follow the last
    keyframe (by trajectory index)."""
    first = (MAP_KEYFRAMES - 1) * KF_STRIDE + 1
    n_after = 1 + TRACK_FRAMES + TRACK_PROFILE_FRAMES + GRAPH_PROFILE_FRAMES
    poses = S.forward_trajectory(first + n_after, step=TRAJ_STEP,
                                 yaw_rate=TRAJ_YAW)
    world = S.make_world(np.random.default_rng(SEED), n=MAP_BILLBOARDS,
                         centers=S.camera_centres(poses),
                         fx=cfg.cube_face_w / 2.0)
    mt = MapTracker(cfg)                    # the card, by default
    a = mt.arena
    arena_mib = sum(t.numel() * t.element_size() for t in a) / 2 ** 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = S.build_map(mt, world, poses, MAP_KEYFRAMES, kf_stride=KF_STRIDE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_kf, n_lm = int(a.kf_valid.sum()), int(a.lm_valid.sum())
    newest = MAP_KEYFRAMES - 1
    weights = mt.covis[newest, :MAP_KEYFRAMES].tolist()
    log(f"[map] arena K={a.n_kf_cap} N={a.n_feat} L={a.n_lm_cap} "
        f"({arena_mib:.1f} MiB); {MAP_BILLBOARDS} billboards; keyframes at "
        f"frames {built.frames}: {n_kf} live keyframes, {n_lm} live "
        f"landmarks; keypoints linked to landmarks {built.linked}, new "
        f"landmarks {built.created}; covisibility of the newest keyframe "
        f"{weights}; built in {secs:.2f} s (rendering included)")
    if not (n_kf == MAP_KEYFRAMES
            and n_lm >= MAP_MIN_LANDMARKS_PER_FEATURE * a.n_feat
            and min(weights[:newest]) >= MAP_MIN_COVIS):
        raise AssertionError("the map was not built")
    render = S.Renderer(mt.cam, cfg)
    frames = {i: S.to_u8(render.render(*world, *poses[i])[0])
              for i in range(first, first + n_after)}
    return mt, poses, frames, first


def track_row_line(i, row, err, extra=""):
    counts = {k: row[k] for k in ("matches", "inliers_mm", "inliers",
                                  "n_ref", "live_kf", "first_free",
                                  "track_ok", "new_ref", "local_frustum",
                                  "local_queried", "local_matched")}
    e = "lost" if err is None else f"{err[0]:.4f} deg / {err[1] * 1e3:.2f} mm"
    return (f"frame {i}: {extra}counts {counts}; path {'>'.join(row['path'])}"
            f"; host reads {row['host_reads']}; pose error {e}")


def check_tracked(mt, T, i, poses):
    row = mt.metrics[-1]
    err = None if T is None else gt_error(T, poses[i])
    if T is None or not row["track_ok"] \
            or row["inliers"] < mt.cfg.min_track_inliers:
        raise AssertionError(f"frame {i} did not track: {row}")
    if not (err[0] < POSE_BOUND_DEG and err[1] < POSE_BOUND_M):
        raise AssertionError(f"frame {i}: pose error {err} beyond the bound")
    return row, err


def frame_record(mt, T):
    """What a tracked frame leaves behind, on the host: the returned pose,
    the row's counts and branches, the last frame's tensors and the
    velocity."""
    row = {k: v for k, v in mt.metrics[-1].items()
           if k not in ("graph_captures", "graph_replays", "graph_replayed")}
    last = mt.last
    tensors = dict(zip(("kp." + f for f in last.kp._fields), last.kp))
    tensors.update(assoc=last.assoc, outlier=last.outlier, R=last.R,
                   t=last.t, rel_R=last.rel_R, rel_t=last.rel_t)
    if mt.velocity is not None:
        tensors.update(vel_R=mt.velocity[0], vel_t=mt.velocity[1])
    return dict(T=None if T is None else T.copy(), row=row,
                tensors={k: v.cpu().clone() for k, v in tensors.items()})


def same_bits(tag, eager, graph):
    """Fail unless two frame records (``frame_record``), or two arena
    snapshots, are bitwise equal; returns the number of tensors held."""
    if isinstance(eager, dict) and "tensors" in eager:
        te, tg = eager["T"], graph["T"]
        if (te is None) != (tg is None) or (
                te is not None and not np.array_equal(te, tg)):
            raise AssertionError(f"{tag}: the graph frame's pose differs")
        if eager["row"] != graph["row"]:
            raise AssertionError(f"{tag}: rows differ: {eager['row']} vs "
                                 f"{graph['row']}")
        eager, graph = eager["tensors"], graph["tensors"]
    bad = [k for k in eager if k not in graph
           or not torch.equal(eager[k], graph[k])]
    if bad or set(eager) != set(graph):
        raise AssertionError(f"{tag}: not bitwise equal: {bad}")
    return len(eager)


def arena_host(mt):
    return {k: getattr(mt.arena, k).cpu().clone() for k in mt.arena._fields}


def reseed(mt, arena, seed, assoc=None):
    """Seed ``mt`` again from the map as built (a copy of ``arena``, the
    last frame ``seed``), which drops its graphs."""
    mt.seed(type(mt.arena)(*(t.clone() for t in arena)), seed.kp,
            seed.assoc if assoc is None else assoc, seed.outlier, seed.R,
            seed.t, seed.ref_kf, frame_id=seed.frame_id)


def drive_tracking_path(mt, poses, frames, first, counters, graphs):
    """One warm-up frame, then TRACK_FRAMES frames of MapTracker: eagerly
    (``stage_times`` set, so each stage also synchronises) or through the
    captured graphs (the warm-up frame captures them). The launch counters
    are set to 0 before the warm-up frame (each kernel must launch once in
    it, captures included) and again just before the TRACK_FRAMES frames.
    Per frame: the synchronised wall time and the host thread's CPU time
    (ms). The eager run's warm-up frame records its pose solves' inputs
    into LM_INPUTS. Returns (walls, launches, frame records)."""
    tag = "graph" if graphs else "eager"
    mt.stage_times = None if graphs else {}
    zero_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    t0 = time.perf_counter()
    with contextlib.nullcontext() if graphs else recording_lm(LM_INPUTS):
        T = mt.track_fisheye(frames[first], first / mt.cfg.fps)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    row, err = check_tracked(mt, T, first, poses)
    records = [frame_record(mt, T)]
    log(f"[track-{tag}] warm-up " + track_row_line(first, row, err)
        + f"; wall {warm_ms:.3f} ms")
    warm = {c.symbol: c.launches for g in counters.values() for c in g}
    log(f"[track-{tag}] launches in the warm-up frame: {warm}")
    if any(n != LAUNCHES_PER_FRAME for n in warm.values()):
        raise AssertionError(f"the warm-up frame launched {warm}")
    if graphs:
        fs = mt.fused_step
        mem = (torch.cuda.memory_allocated() - mem0[0],
               torch.cuda.memory_reserved() - mem0[1])
        log(f"[track-graph] capture frame: {fs.captures} graphs captured, "
            f"{fs.capture_ms:.3f} ms of host time in torch.cuda.graph; "
            f"memory allocated {mem[0] / 2 ** 20:+.1f} MiB (static buffers, "
            f"outputs and the graphs' pool), reserved {mem[1] / 2 ** 20:+.1f}"
            f" MiB (torch.cuda.graph empties the cache first)")
        if row["graph_captures"] != 2:
            raise AssertionError(f"the capture frame captured "
                                 f"{row['graph_captures']} graphs")
    zero_launches(counters)
    walls, cpus, rows = [], [], []
    for i in range(first + 1, first + 1 + TRACK_FRAMES):
        torch.cuda.synchronize()
        t_start, c_start = time.perf_counter(), time.thread_time()
        T = mt.track_fisheye(frames[i], i / mt.cfg.fps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t_start) * 1e3)
        cpus.append((time.thread_time() - c_start) * 1e3)
        row, err = check_tracked(mt, T, i, poses)
        rows.append(row)
        records.append(frame_record(mt, T))
        log(f"[track-{tag}] " + track_row_line(i, row, err) + f"; graphs "
            f"replayed {row['graph_replays']}; wall {walls[-1]:.3f} ms, "
            f"host CPU {cpus[-1]:.3f} ms")
        if row["graph_replays"] != (2 if graphs else 0):
            raise AssertionError(f"frame {i} replayed "
                                 f"{row['graph_replays']} graphs")
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    pose_launches(f"tracking_{tag}", TRACK_FRAMES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"[track-{tag}] {TRACK_FRAMES} frames: wall ms median "
        f"{float(np.median(walls)):.3f}, host CPU ms median "
        f"{float(np.median(cpus)):.3f}; host reads a frame "
        f"{sorted(set(r['host_reads'] for r in rows))}; peak memory "
        f"{peak:.1f} MiB")
    for name, by_kernel in launches.items():
        log(f"[track-{tag}] {name}: launches in {TRACK_FRAMES} frames "
            f"{by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * TRACK_FRAMES:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in {TRACK_FRAMES} tracked frames")
    n_local = sum(r["local_matched"] > 0 for r in rows)
    if n_local < LOCAL_MIN_FRAMES:
        raise AssertionError(f"TrackLocalMap added matches on only {n_local} "
                             f"of {TRACK_FRAMES} frames")
    return walls, launches, records


def eager_and_graph_tracking(mt, poses, frames, first, counters):
    """The tracking path twice from the map as built: eagerly, then through
    the graphs; every frame (pose, counts, branches, the last frame's
    tensors, the velocity) and the arena after them bitwise equal. Returns
    the graph run's walls and launches, and the eager run's walls."""
    seed = mt.last
    built = tuple(t.clone() for t in mt.arena)
    e_walls, _, e_rec = drive_tracking_path(mt, poses, frames, first,
                                            counters, graphs=False)
    e_arena = arena_host(mt)
    reseed(mt, built, seed)
    g_walls, launches, g_rec = drive_tracking_path(mt, poses, frames, first,
                                                   counters, graphs=True)
    n = sum(same_bits(f"frame {first + k}", e, g)
            for k, (e, g) in enumerate(zip(e_rec, g_rec)))
    if not (POSE_LAUNCHES["tracking_graph"] == POSE_LAUNCHES["tracking_eager"]
            >= 2 * TRACK_FRAMES):
        raise AssertionError("the graph frames launched the pose-LM kernel "
                             "otherwise than their eager twins, or less "
                             "than twice a frame")
    n += same_bits("the arena after the frames", e_arena, arena_host(mt))
    log(f"[track] graph frames against eager frames: {len(g_rec)} frames "
        f"and the arena bitwise equal ({n} tensors); wall ms median eager "
        f"{float(np.median(e_walls)):.3f} (each stage synchronised), graph "
        f"{float(np.median(g_walls)):.3f}")
    return g_walls, launches, e_walls, built, seed


def profiled_tracking(mt, poses, frames, start, graphs):
    """Frames of MapTracker under profile_stages: TRACK_PROFILE_FRAMES eager
    frames (``stage_times`` set) by stage, or GRAPH_PROFILE_FRAMES graph
    frames as a whole (a replay has no stage ranges)."""
    n = GRAPH_PROFILE_FRAMES if graphs else TRACK_PROFILE_FRAMES
    mt.stage_times = None if graphs else {}
    it = iter(range(start, start + n))
    got = []

    def step():
        i = next(it)
        got.append((i, mt.track_fisheye(frames[i], i / mt.cfg.fps)))

    prof = profile_stages(step, () if graphs else TRACK_STAGES, n)
    mt.stage_times = None
    for i, T in got:
        check_tracked(mt, T, i, poses)
    return prof


def restore_tracked(mt, arena, seed, assoc=None):
    """The state ``reseed`` gives (the map as built, the last frame
    ``seed`` with its association replaced by ``assoc`` if given, no motion
    model), with the map written into the tracker's arena in place, so
    that its graphs stay and replay."""
    for t, b in zip(mt.arena, arena):
        t.copy_(b)
    mt.last = seed if assoc is None else seed._replace(assoc=assoc)
    mt.ref_kf, mt.velocity = seed.ref_kf, None
    mt.frame_id = seed.frame_id + 1
    mt.refresh_graph_cache()


def forced_input(mt, frames, first, built, seed, name):
    """Restore the map as built and return forced path ``name``'s frame:
    ``emptied`` the next frame after the last association was emptied,
    ``gate`` the next frame with a velocity above the 0.2 rad gate,
    ``blank`` a blank frame."""
    empty = torch.full_like(seed.assoc, -1) if name == "emptied" else None
    restore_tracked(mt, built, seed, assoc=empty)
    if name == "gate":
        mt.velocity = (so3_exp(torch.tensor([0.0, GATE_ROT_RAD, 0.0],
                                            device=mt.device)),
                       torch.zeros(3, device=mt.device))
    return np.zeros_like(frames[first]) if name == "blank" else frames[first]


def forced_branches(mt, poses, frames, first, built, seed, counters, graphs):
    """The forced paths of ``FORCED``, each 1 + FORCED_REPEATS times from
    the map as built (restored in place): an emptied last association
    (widen -> zero velocity -> reference keyframe, and still tracks), a
    velocity above the 0.2 rad gate (predicts from the last pose, so the 15
    px match suffices) and a blank frame (every fallback, then lost, None,
    no exception); eagerly (``stage_times`` set) or through the graphs,
    which the first frame of each path captures where it runs one for the
    first time (A and B were captured by the steady graph frames, so the
    pool's growth is W's, Z's, R's and S's) and every repeat replays: the
    graphs named in ``FORCED``, none captured. Every repeat is bitwise
    its path's first frame. Then GRAPH_PROFILE_FRAMES frames of each path
    under the profiler. Returns (the first frame's record by path, the
    report by path: walls, pose-LM launches a frame, profile, the pool's
    MiB before and after) and the launches of the whole pass."""
    tag = "graph" if graphs else "eager"
    mt.stage_times = None if graphs else {}
    fps = mt.cfg.fps
    zero_launches(counters)
    records, report = {}, {}
    for name, (branches, replayed) in FORCED.items():
        pool = mt.fused_step.capture_mib if graphs else 0.0
        walls, lm_launches = [], []
        for rep in range(1 + FORCED_REPEATS):
            img = forced_input(mt, frames, first, built, seed, name)
            n0 = PO.POSE_LM.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T = mt.track_fisheye(img, first / fps)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            lm_launches.append(PO.POSE_LM.launches - n0)
            row = mt.metrics[-1]
            rec = frame_record(mt, T)
            if name == "blank":
                err = None
                if T is not None or row["track_ok"]:
                    raise AssertionError("the blank frame was not lost")
            else:
                row, err = check_tracked(mt, T, first, poses)
            log(f"[branch-{tag}] {name} {rep}: "
                + track_row_line(first, row, err)
                + f"; graphs captured {row['graph_captures']}, replayed "
                f"{'>'.join(row['graph_replayed']) or 'none'}; pose_lm "
                f"launches {lm_launches[-1]}; wall {walls[-1]:.3f} ms")
            if row["path"] != branches:
                raise AssertionError(f"forced {name} took {row['path']}")
            if rep == 0:
                records[name] = rec
            else:
                same_bits(f"forced {name}, repeat {rep}", records[name], rec)
                if graphs and (row["graph_captures"]
                               or row["graph_replayed"] != replayed):
                    raise AssertionError(
                        f"forced {name} repeat {rep} captured "
                        f"{row['graph_captures']} graphs and replayed "
                        f"{row['graph_replayed']}, not {replayed}")
        after = mt.fused_step.capture_mib if graphs else 0.0
        prof = profile_stages(
            lambda: mt.track_fisheye(img, first / fps), (),
            GRAPH_PROFILE_FRAMES,
            before=lambda: forced_input(mt, frames, first, built, seed,
                                        name))
        rows = mt.metrics[-GRAPH_PROFILE_FRAMES:]
        reads = max(r["host_reads"] for r in rows)
        log(f"[branch-{tag}] {name}: wall ms first {walls[0]:.3f}, repeats' "
            f"median {float(np.median(walls[1:])):.3f} (all "
            f"{float(np.median(walls)):.3f}); profiled: wall "
            f"{prof['wall_ms']:.3f}, device busy "
            f"{prof['device_busy_ms']:.3f} ms in {prof['device_ops']:.0f} "
            f"operations, host waits {prof['host_waits']:.2f} a frame "
            f"(reads {reads} + the upload"
            f"{'' if graphs else ' + 2 stage synchronisations'}), by source "
            f"{[(k, round(v, 2)) for k, v in prof['wait_sources']]}; pool "
            f"{pool:.1f} -> {after:.1f} MiB")
        if graphs and (prof["host_waits"] > reads + 1 or any(
                r["graph_replayed"] != replayed for r in rows)):
            raise AssertionError(f"a profiled forced {name} frame waited "
                                 f"more than its reads and the upload, or "
                                 f"did not replay {replayed}")
        report[name] = dict(walls=walls, pose_lm=lm_launches, prof=prof,
                            reads=reads, pool=(pool, after))
    mt.stage_times = None
    n = len(FORCED) * (1 + FORCED_REPEATS)
    launches = {k: {c.symbol: c.launches for c in g}
                for k, g in counters.items()}
    log(f"[branch-{tag}] launches in {n} forced frames and "
        f"{len(FORCED) * GRAPH_PROFILE_FRAMES} profiled: {launches}")
    pose_launches(f"forced_{tag}", n)
    return records, report, launches


def check_forced(e_rec, e_rep, g_rec, g_rep):
    """The forced paths through the graphs against their eager twins: the
    first frames bitwise equal, the same pose-LM launches a frame; the
    walls, busy time, operations and waits side by side."""
    for name in FORCED:
        same_bits(f"forced {name}", e_rec[name], g_rec[name])
        e, g = e_rep[name], g_rep[name]
        if e["pose_lm"] != g["pose_lm"]:
            raise AssertionError(f"forced {name}: pose_lm launches eager "
                                 f"{e['pose_lm']}, graph {g['pose_lm']}")
        log(f"[branch] {name} ({'>'.join(FORCED[name][1])}): graph bitwise "
            f"eager; wall ms eager median {float(np.median(e['walls'])):.3f}"
            f", graph capturing {g['walls'][0]:.3f}, replaying median "
            f"{float(np.median(g['walls'][1:])):.3f}; device busy eager "
            f"{e['prof']['device_busy_ms']:.3f} / graph "
            f"{g['prof']['device_busy_ms']:.3f} ms; operations "
            f"{e['prof']['device_ops']:.0f} / {g['prof']['device_ops']:.0f}"
            f"; host waits {e['prof']['host_waits']:.2f} / "
            f"{g['prof']['host_waits']:.2f} (reads {g['reads']}); pose_lm "
            f"{g['pose_lm'][0]} a frame; pool MiB {g['pool'][0]:.1f} -> "
            f"{g['pool'][1]:.1f}")


def map_tracking_phase(cfg, counters):
    """The map, the tracking path eagerly and through the graphs, the
    profiled frames of each, the forced branches both ways and the small
    card-against-CPU check. Returns the graph run's launches, the forced
    graph pass's and the pose-LM kernel's row."""
    mt, poses, frames, first = build_map_phase(cfg)
    t_walls, t_launches, e_walls, built, seed = eager_and_graph_tracking(
        mt, poses, frames, first, counters)
    start = first + 1 + TRACK_FRAMES
    t_prof = profiled_tracking(mt, poses, frames, start, graphs=False)
    log_profile("track-profile", t_prof, e_walls)
    reads = [r["host_reads"] for r in mt.metrics[-TRACK_PROFILE_FRAMES:]]
    log(f"[track] eager frames: host reads a frame, counted by the tracker: "
        f"{sorted(set(reads))}; host waits a frame, from the profiler: "
        f"{t_prof['host_waits']:.2f} (with the 2 stage synchronisations)")
    # every read is a wait, so the profiler must see at least as many
    if t_prof["host_waits"] < max(reads):
        raise AssertionError("the profiler saw fewer host waits than the "
                             "tracker's own reads")
    g_prof = profiled_tracking(mt, poses, frames,
                               start + TRACK_PROFILE_FRAMES, graphs=True)
    log_profile("graph-profile", g_prof, t_walls)
    rows = mt.metrics[-GRAPH_PROFILE_FRAMES:]
    reads = max(r["host_reads"] for r in rows)
    log(f"[track] graph frames: device busy {g_prof['device_busy_ms']:.3f} "
        f"ms a frame, idle share {g_prof['idle_share']:.4f} of the profiled "
        f"wall ({1.0 - g_prof['device_busy_ms'] / float(np.mean(t_walls)):.4f}"
        f" of the unprofiled); host reads {reads}, host waits "
        f"{g_prof['host_waits']:.2f} a frame (the upload and the reads: "
        f"{reads + 1}); graphs replayed a frame "
        f"{[r['graph_replays'] for r in rows]}")
    if g_prof["host_waits"] > reads + 1 or any(
            r["graph_replays"] != 2 for r in rows):
        raise AssertionError("a graph frame waited more than an eager one, "
                             "or did not replay both graphs")
    if not g_prof["device_ops"] < GRAPH_MAX_OPS:
        raise AssertionError(f"a graph frame ran {g_prof['device_ops']:.0f} "
                             f"device operations (at most {GRAPH_MAX_OPS})")
    e_rec, e_rep, _ = forced_branches(mt, poses, frames, first, built, seed,
                                      counters, graphs=False)
    g_rec, g_rep, f_launches = forced_branches(mt, poses, frames, first,
                                               built, seed, counters,
                                               graphs=True)
    check_forced(e_rec, e_rep, g_rec, g_rep)
    del mt
    small_map_reference_check()
    pose_row = check_pose_lm(cfg, LM_INPUTS[0])
    return t_launches, f_launches, pose_row


def small_map_reference_check():
    """MapTracker on the card against MapTracker(device="cpu") on one map
    built on the CPU at a small size (128^2 faces, 256 features, 4 levels,
    K=16, L=2048), same warp map and mask, over 2 frames: poses within
    1e-3, associations equal on >= 98% of matched rows, packed counts
    within 2%."""
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4, max_keyframes=16, max_landmarks=2048)
    ref = MapTracker(cfg, device="cpu")
    poses = S.forward_trajectory(12, step=TRAJ_STEP, yaw_rate=TRAJ_YAW)
    world = S.make_world(np.random.default_rng(SEED + 3), n=500,
                         centers=S.camera_centres(poses), fx=64.0)
    S.build_map(ref, world, poses, 4, kf_stride=3)
    card = MapTracker(cfg, device="cuda")
    card.set_warp_map(ref.warp_map)
    card.mask = ref.mask.to("cuda")
    last = ref.last
    card.seed(ref.arena, last.kp, last.assoc, last.outlier, last.R, last.t,
              last.ref_kf, frame_id=last.frame_id)
    render = S.Renderer(ref.cam, cfg)
    worst = (0.0, 1.0, 0.0)
    for i in (10, 11):
        img = S.to_u8(render.render(*world, *poses[i])[0])
        T_c = ref.track_fisheye(img, i / cfg.fps)
        T_g = card.track_fisheye(img, i / cfg.fps)
        if T_c is None or T_g is None:
            raise AssertionError(f"small map check: frame {i} lost")
        r_c, r_g = ref.metrics[-1], card.metrics[-1]
        a_c, a_g = ref.last.assoc, card.last.assoc.cpu()
        matched = (a_c >= 0) | (a_g >= 0)
        agree = float((a_c == a_g)[matched].float().mean())
        dpose = float(np.abs(T_c - T_g).max())
        dcount = max(abs(r_c[k] - r_g[k]) / max(r_c[k], 1)
                     for k in ("matches", "inliers_mm", "inliers",
                               "local_matched"))
        worst = (max(worst[0], dpose), min(worst[1], agree),
                 max(worst[2], dcount))
        log(f"[ref-map] frame {i}: |dpose| {dpose:.3g}, associations agree "
            f"on {agree:.4f} of {int(matched.sum())} matched rows, counts "
            f"card {r_g['matches']}/{r_g['inliers']} vs CPU "
            f"{r_c['matches']}/{r_c['inliers']}, paths {r_g['path']} / "
            f"{r_c['path']}")
    if not (worst[0] < 1e-3 and worst[1] >= 0.98 and worst[2] <= 0.02):
        raise AssertionError(f"card and CPU MapTrackers disagree: {worst}")


# ---------------------------------------------------------------------------
# The whole system from the first frame (CubemapSLAM)
# ---------------------------------------------------------------------------

def slam_sequence(cfg):
    """A seeded world and a forward trajectory of SLAM_FRAMES frames and the
    profiled ones after them, rendered on the host before any timing."""
    n = SLAM_FRAMES + SLAM_PROFILE_MAX
    poses = S.forward_trajectory(n, step=TRAJ_STEP, yaw_rate=TRAJ_YAW)
    world = S.make_world(np.random.default_rng(SEED + 4), n=SLAM_BILLBOARDS,
                         centers=S.camera_centres(poses),
                         fx=cfg.cube_face_w / 2.0)
    render = S.Renderer(CubemapCamera.from_config(cfg, "cpu"), cfg)
    t0 = time.perf_counter()
    frames = [S.to_u8(render.render(*world, *p)[0]) for p in poses]
    log(f"[slam] {n} frames rendered in {time.perf_counter() - t0:.1f} s "
        f"({SLAM_BILLBOARDS} billboards, {TRAJ_STEP} map units and "
        f"{TRAJ_YAW} rad of yaw a frame)")
    return poses, frames


def slam_row_line(i, row, wall):
    keys = ("inliers", "matches", "init_matches", "host_reads",
            "graph_init_captures", "graph_init_replays", "eigh_waits",
            "loop_detect_ms")
    counts = {k: row[k] for k in keys if k in row}
    st = ", ".join(f"{k} {v:.3f}" for k, v in row.get("stage_ms", {}).items())
    return (f"frame {i}: {row['state']}; {counts}; keyframe "
            f"{bool(row.get('keyframe'))}, deferred BA "
            f"{bool(row.get('ba'))}; stage ms: {st}; wall {wall:.3f} ms")


def drive_slam(slam, poses, frames, counters):
    """CubemapSLAM over SLAM_FRAMES frames from the first, with stage
    timing (each stage synchronises) and the launch counters set to 0 just
    before. Checks: initialized within SLAM_INIT_BY frames, every frame
    after it tracked, SLAM_MIN_NEW_KF keyframes beyond the first 2, new
    landmarks triangulated, a deferred BA run, the launches, and the ATE of
    the Sim3-aligned trajectory."""
    cfg = slam.cfg
    zero_launches(counters)
    seg = {}
    torch.cuda.reset_peak_memory_stats()
    slam.stage_times = {}
    walls, n_new, first_ok = [], [], None
    with seg_tally(slam.mapping, ("mapping_step", "local_ba"), seg), \
            recording_triangulation(TRI_INPUTS), \
            recording_essential(INIT_EIG_INPUTS):
        for i in range(SLAM_FRAMES):
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            T = slam.track_fisheye(frames[i], i / cfg.fps)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t_start) * 1e3)
            row = slam.metrics[-1]
            log("[slam] " + slam_row_line(i, row, walls[-1]))
            if T is not None and first_ok is None:
                first_ok = i
            if first_ok is not None and T is None:
                raise AssertionError(f"frame {i} after initialization was "
                                     f"lost")
            if row.get("keyframe") and row.get("stage") != "init":
                n_new.append(int(slam._last_mapping_info[2]))
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    SEG_LAUNCHES["slam"] = dict(total=SG.SEG_SUM.launches, **seg)
    pose_launches("slam", SLAM_FRAMES)
    tri_launches("slam", SLAM_FRAMES)
    eig_launches("slam")
    log(f"[slam] seg_sum: launches in {SLAM_FRAMES} frames "
        f"{SEG_LAUNCHES['slam']} (by MappingKernels method)")
    if not (seg.get("mapping_step") and seg.get("local_ba")):
        raise AssertionError("the mapping step or the local BA launched no "
                             "segmented sum")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    times, slam.stage_times = slam.stage_times, None
    for name, by_kernel in launches.items():
        log(f"[slam] {name}: launches in {SLAM_FRAMES} frames {by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * SLAM_FRAMES:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in {SLAM_FRAMES} frames of CubemapSLAM")
    stages = ", ".join(f"{k} {float(np.median(v)):.3f} (x{len(v)})"
                       for k, v in times.items())
    log(f"[slam] stage wall ms, median (count): {stages}; peak memory "
        f"{peak:.1f} MiB")
    live = int(slam.arena.kf_valid.sum())
    log(f"[slam] initialized at frame {first_ok}; {slam.n_kf} keyframes "
        f"created, {live} live; new landmarks by mapping step {n_new}; "
        f"deferred BAs {slam.ba_runs}; "
        f"{int(slam.arena.lm_valid.sum())} live landmarks")
    detect = [round(r["loop_detect_ms"], 3) for r in slam.metrics
              if "loop_detect_ms" in r]
    log(f"[slam] loop detection wall ms by keyframe (from the tenth): "
        f"{detect}; loops closed {slam.n_loops_closed} (the trajectory "
        f"revisits nothing)")
    if slam.n_loops_closed != 0:
        raise AssertionError("a loop was closed on a trajectory that "
                             "revisits nothing")
    if first_ok is None or first_ok >= SLAM_INIT_BY:
        raise AssertionError(f"not initialized within {SLAM_INIT_BY} frames")
    if slam.n_kf < 2 + SLAM_MIN_NEW_KF:
        raise AssertionError(f"only {slam.n_kf} keyframes")
    if not n_new or max(n_new) <= 0:
        raise AssertionError("mapping triangulated no landmark")
    if slam.ba_runs < 1:
        raise AssertionError("no deferred BA ran")
    err, path, align = trajectory_ate(slam, poses)
    log(f"[slam] ATE {err:.5f} over a path of {path:.5f} ({err / path:.5f} "
        f"of it; bound {SLAM_ATE_FRAC}), {slam.tracked_frames} frames "
        f"tracked")
    if not err < SLAM_ATE_FRAC * path:
        raise AssertionError("the trajectory is beyond the ATE bound")
    return walls, launches, first_ok, (align, path)


def trajectory_ate(slam, poses):
    """RMS distance of the tracked camera centres to the ground truth after
    a Sim3 alignment by the port's horn_alignment, the path length, and the
    alignment from map to world coordinates: (s, R, t) of the centres, and
    the rotation Q with R_map @ Q nearest R_world over the tracked frames
    (the centres of a near-straight path leave the rotation about it
    free)."""
    fps = slam.cfg.fps
    idx = [int(round(ts * fps)) for ts, _, _ in slam.trajectory]
    est = np.stack([-R.T @ t for _, R, t in slam.trajectory])
    gt = S.camera_centres(poses)[idx]
    s, Ra, ta = horn_alignment(torch.as_tensor(gt, dtype=torch.float32),
                               torch.as_tensor(est, dtype=torch.float32))
    al = float(s) * (Ra.numpy() @ est.T).T + ta.numpy()
    err = float(np.sqrt(np.mean(np.sum((al - gt) ** 2, axis=1))))
    m = sum(R.T @ np.asarray(poses[i][0], np.float64)
            for i, (_, R, _) in zip(idx, slam.trajectory))
    u, _, vt = np.linalg.svd(m)
    q = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    return (err, float(np.linalg.norm(gt[-1] - gt[0])),
            (float(s), Ra.numpy().astype(np.float64),
             ta.numpy().astype(np.float64), q))


def aligned_error(T, pose, align):
    """(degrees, world units) between a 4x4 world->camera pose in map
    coordinates and the ground-truth (R, t), through the Sim3 ``align``
    (s, Ra, ta, Q) of ``trajectory_ate``: the rotation, and the distance
    of the camera centres."""
    s, Ra, ta, q = align
    R, t = T[:3, :3], T[:3, 3]
    R_gt, t_gt = pose
    centre = s * Ra @ (-R.T @ t) + ta
    dR = torch.as_tensor((R @ q) @ np.asarray(R_gt, np.float64).T)
    ang = math.degrees(float(torch.linalg.norm(so3_log(dR))))
    return ang, float(np.linalg.norm(centre - (-R_gt.T @ t_gt)))


def profiled_slam(slam, frames, walls, graph_walls, tag, replays):
    """Frames after the driven ones, each under profile_stages on its own,
    until one keyframe frame (insert + mapping_step + loop detection) and
    one deferred-BA frame are found (the frame after the profiled keyframe
    frame has its insertion held, so that its pending BA runs); the host
    waits of each may be no more than its stated reads (loop detection's
    among them), its eigen-solve waits, the frame's upload and one for
    each graph it captured. These frames run with ``stage_times`` unset, so
    their tracking replays the captured graphs and their insertion and
    mapping step, or their BA, ``FusedMapping``'s graph K or BA; the first
    frame of each kind captures its graphs (the capture's host ms and
    memory are printed). With ``replays`` only frames whose mapping replayed
    its graph are taken (the repeat run's system, whose graphs are
    captured); without, the first of each kind (the driven system, whose
    first such frames capture them, as in the frames that the later phases
    build on). The tracking and mapping stages have no ranges of their own
    there. The idle share is given against ``walls`` (the eager drive's
    frames) and, for replays, against ``graph_walls`` (the repeat run's
    frames of the same kind that captured no graph, by kind)."""
    want = {"keyframe": None, "ba": None}
    for i in range(SLAM_FRAMES, SLAM_FRAMES + SLAM_PROFILE_MAX):
        held = (want["keyframe"] is not None and want["ba"] is None
                and slam.metrics[-1].get("keyframe", False))
        if held:
            # a forced branch: the keyframe gap rule refuses an insertion
            # on this frame, so the BA pending since the last keyframe
            # runs (frames that keep inserting keyframes would never run it)
            slam.last_kf_frame_id = slam.frame_id
        n_tri = TT.TRIANGULATE.launches
        prof = profile_stages(
            lambda: slam.track_fisheye(frames[i], i / slam.cfg.fps),
            SLAM_STAGES, 1)
        n_tri = TT.TRIANGULATE.launches - n_tri
        row = slam.metrics[-1]
        kind = ("keyframe" if row.get("keyframe")
                else "ba" if row.get("ba") else None)
        fm = slam.fused_mapping
        log(f"[{tag}] frame {i}: {kind or 'tracked'}; triangulation "
            f"launches {n_tri}"
            f"{' (keyframe insertion held)' if held else ''}; host reads "
            f"{row.get('host_reads')}; graphs captured "
            f"{row.get('graph_captures', 0)}, replayed "
            f"{row.get('graph_replays', 0)}; mapping graphs captured "
            f"{row.get('graph_mapping_captures', 0)}, replayed "
            f"{row.get('graph_mapping_replays', 0)}; host waits "
            f"{prof['host_waits']:.0f}; wall {prof['wall_ms']:.3f} ms; "
            f"device busy {prof['device_busy_ms']:.3f} ms")
        if row.get("graph_mapping_captures"):
            log(f"[{tag}] frame {i} captured a mapping graph: "
                f"FusedMapping has {fm.captures} graphs, "
                f"{fm.capture_ms:.3f} ms of host time in torch.cuda.graph, "
                f"{fm.capture_mib:.1f} MiB reserved by their pool")
        if row["state"] != "OK":
            raise AssertionError(f"profiled frame {i} was not tracked")
        if n_tri != (1 if kind == "keyframe" else 0):
            raise AssertionError(f"profiled {kind or 'tracked'} frame {i} "
                                 f"launched the triangulation kernel {n_tri} "
                                 f"times (a mapping step: 1, else 0)")
        replayed = (row.get("graph_mapping_replays", 0) > 0
                    and row.get("graph_mapping_captures", 0) == 0)
        if kind and (replayed or not replays) and want[kind] is None:
            want[kind] = prof
            log_profile(f"{tag}-{kind}", prof, walls)
            if (replays and kind == "keyframe"
                    and prof["device_ops"] > KEYFRAME_MAX_OPS):
                raise AssertionError(
                    f"the replayed keyframe frame ran {prof['device_ops']} "
                    f"device operations (at most {KEYFRAME_MAX_OPS})")
            if replays:
                mid = float(np.median(graph_walls[kind]))
                log(f"[{tag}-{kind}] idle share "
                    f"{1 - prof['device_busy_ms'] / mid:.4f} of the median "
                    f"unprofiled wall of the repeat run's {kind} frames that "
                    f"replayed their graphs ({mid:.3f} ms)")
            # each graph captured may wait CAPTURE_WAITS times (the loop
            # closer's counted in its capture waits)
            captured = (CAPTURE_WAITS * (row.get("graph_captures", 0)
                                         + row.get("graph_mapping_captures",
                                                   0))
                        + row.get("graph_loop_capture_waits", 0))
            allowed = (row["host_reads"] + row.get("eigh_waits", 0) + 1
                       + captured)
            log(f"[{tag}-{kind}] host waits {prof['host_waits']:.0f} "
                f"against {allowed} allowed: {row['host_reads']} reads, "
                f"{row.get('eigh_waits', 0)} eigen-solve waits, the "
                f"upload, {captured} capture waits")
            if prof["host_waits"] > allowed:
                raise AssertionError(
                    f"the {kind} frame waited {prof['host_waits']:.0f} "
                    f"times; its stated reads, eigen-solve waits, the "
                    f"upload and its capture waits are {allowed}")
        if all(want.values()):
            return want
    raise AssertionError(f"no keyframe frame and deferred-BA frame "
                         f"{'that replayed the mapping graphs ' if replays else ''}"
                         f"among {SLAM_PROFILE_MAX} profiled frames: {want}")


# bootstraps of the init profile, a reset between: the first captures
# FusedInit's graphs, the middle ones replay them unprofiled (their walls),
# the last replays them under the profiler
INIT_CYCLES = 5
INIT_MIN_REPLAYS = 3          # attempts that replay graphs I1 and I2
INIT_TRACE = ("kp", "idx", "ok", "prev_rays", "E", "R21", "t21", "p3d",
              "good")


def init_record(slam, T):
    """A pre-init frame of ``slam``: its row without the graph counts, its
    pose and clones of the last attempt's ``init_trace`` fields."""
    tr = slam.init_trace or {}
    trace = {k: (tuple(x.clone() for x in tr[k]) if k == "kp"
                 else tr[k].clone()) for k in INIT_TRACE if k in tr}
    row = {k: v for k, v in slam.metrics[-1].items()
           if not k.startswith("graph_")}
    return dict(row=row, T=T, trace=trace)


def same_init(tag, a, b):
    """Two ``init_record``s bitwise equal, else raise."""
    bad = [k for k in INIT_TRACE if (k in a["trace"]) != (k in b["trace"])
           or (k in a["trace"] and not (
               all(same_float_bits(x, y) for x, y in
                   zip(a["trace"][k], b["trace"][k])) if k == "kp"
               else same_float_bits(a["trace"][k], b["trace"][k])))]
    if a["row"] != b["row"] or bad or (a["T"] is None) != (b["T"] is None) \
            or (a["T"] is not None and not np.array_equal(a["T"], b["T"])):
        raise AssertionError(f"{tag}: the graph frame differs from its eager "
                             f"twin (fields {bad}; rows {a['row']} / "
                             f"{b['row']})")


def init_kind(row):
    if row.get("state") == "OK":
        return "success"
    return "attempt" if "init_matches" in row else "reference"


def check_init_profile(tag, kind, row, prof, walls):
    """A profiled ``FusedInit`` frame: logged; no wait in
    ``aten::linalg_svd``, and at most its reads, the upload and its
    captures' CAPTURE_WAITS (the success frame's map creation, eager, is
    not held to it)."""
    caps = row["graph_init_captures"]
    allowed = row["host_reads"] + 1 + CAPTURE_WAITS * caps
    log_profile(f"init-profile-graph-{'capture' if caps else 'replay'}"
                f"-{kind}", prof, walls)
    log(f"[init-profile] {tag} ({kind}): host waits "
        f"{prof['host_waits']:.0f} against {allowed} allowed "
        f"({row['host_reads']} reads, the upload, {caps} captures); device "
        f"busy {prof['device_busy_ms']:.3f} ms in {prof['device_ops']:.0f} "
        f"operations")
    if any("linalg_svd" in src for src, _ in prof["wait_sources"]):
        raise AssertionError(f"{tag} waited in torch.linalg.svd")
    if kind != "success" and prof["host_waits"] > allowed:
        raise AssertionError(f"{tag} waited {prof['host_waits']:.0f} times; "
                             f"its reads, the upload and its capture waits "
                             f"are {allowed}")


def profiled_init(cfg, frames, first_ok, walls):
    """Initialization through ``FusedInit`` beside its eager twin: two
    systems of the same seed over the slam drive's frames up to the one
    that initialized it, INIT_CYCLES times with a reset between (which
    keeps the graphs), one through the graphs and one with ``init_graphs``
    off. Every frame's row, pose and attempt (keypoints, matches, window
    centres, E21, R21, t21, p3d, good) bitwise equal between the two. The
    first cycle's graph frames capture I0, I1 and I2 and are profiled
    alone; the middle cycles replay them and give the unprofiled walls; the
    last cycle's frames are profiled alone in both systems: wall, device
    busy, operations and host waits by source. Held: no wait in
    ``aten::linalg_svd``; each graph frame waits at most its reads, the
    upload and its captures' CAPTURE_WAITS; at least INIT_MIN_REPLAYS
    attempts replay I1 and I2 and capture nothing. ``walls`` are the
    eager drive's (stage timing on) for the idle share."""
    graph = CubemapSLAM(cfg, seed=SEED)
    eager = CubemapSLAM(cfg, seed=SEED)
    eager.init_graphs = False
    walls_by = {}
    replaying = 0
    for cycle in range(INIT_CYCLES):
        profiled = cycle in (0, INIT_CYCLES - 1)
        for i in range(first_ok + 1):
            ts = i / cfg.fps
            tag = f"init-cycle{cycle}-frame{i}"
            if profiled and cycle:
                got = {}
                prof_e = profile_stages(
                    lambda: got.setdefault(
                        "T", eager.track_fisheye(frames[i], ts)),
                    ("warp", "extract", "init"), 1)
                e = init_record(eager, got["T"])
                log_profile(f"init-profile-eager-{init_kind(e['row'])}",
                            prof_e, walls)
                if any("linalg_svd" in src for src, _ in
                       prof_e["wait_sources"]):
                    raise AssertionError("an eager init frame waited in "
                                         "torch.linalg.svd")
            else:
                T, _, wall_e = timed_frame(eager, frames[i], ts)
                e = init_record(eager, T)
                walls_by.setdefault(("eager", init_kind(e["row"])),
                                    []).append(wall_e)
            if profiled:
                got = {}
                prof = profile_stages(
                    lambda: got.setdefault(
                        "T", graph.track_fisheye(frames[i], ts)),
                    ("init",), 1)
                g = init_record(graph, got["T"])
                wall = prof["wall_ms"]
            else:
                T, _, wall = timed_frame(graph, frames[i], ts)
                g = init_record(graph, T)
            row = graph.metrics[-1]
            kind = init_kind(g["row"])
            caps, reps = (row.get("graph_init_captures"),
                          row.get("graph_init_replays"))
            same_init(tag, g, e)
            if kind != "reference" and not caps and reps == 2:
                replaying += 1
            log(f"[init-graph] cycle {cycle} frame {i}: {kind}; host reads "
                f"{row['host_reads']}; init graphs captured {caps}, replayed "
                f"{reps}; matches {row.get('init_matches')}; wall "
                f"{wall:.3f} ms{' (profiled)' if profiled else ''}; bitwise "
                f"its eager twin")
            if caps is None:
                raise AssertionError(f"{tag} did not run through FusedInit")
            if profiled:
                check_init_profile(tag, kind, row, prof, walls)
            else:
                walls_by.setdefault(("graph", kind), []).append(wall)
            if graph.state == TrackState.OK:
                break
        for s in (graph, eager):
            s.reset()
        if graph.fused_init is None:
            raise AssertionError("the reset dropped FusedInit")
    log("[init-graph] unprofiled wall ms by path and kind of frame: "
        + "; ".join(f"{p} {k} (x{len(v)}) median {float(np.median(v)):.3f}, "
                    f"each {[round(w, 3) for w in v]}"
                    for (p, k), v in sorted(walls_by.items())))
    fi = graph.fused_init
    log(f"[init-graph] FusedInit: {fi.captures} captures, {fi.replays} "
        f"replays, {fi.capture_ms:.3f} ms of host time in the captures, "
        f"{fi.capture_mib:.1f} MiB reserved by its pool; {replaying} "
        f"attempts replayed I1 and I2")
    if fi.captures != 3 or replaying < INIT_MIN_REPLAYS:
        raise AssertionError(f"FusedInit captured {fi.captures} graphs (3) "
                             f"and {replaying} attempts replayed (at least "
                             f"{INIT_MIN_REPLAYS})")


# graph K's parts, as ranges around the calls that make them (profiler
# names), each kernel given to the innermost range around it: the insertion
# and BoW row, then the mapping step's own
GRAPH_K_PARTS = {
    "k.insert": "insert + BoW row",
    "k.covis": "incidence, covisibility, observation counts",
    "k.cull_points": "culling (map points)",
    "k.epipolar": "6 epipolar searches",
    "k.triangulate": "triangulate + gates, one launch",
    "k.pair": "the pairs' geometry",
    "k.commit": "the commit",
    "k.fuse": "8 fuses (+ the redirect)",
    "k.stats": "landmark statistics",
    "k.cull_kf": "keyframe culling",
    "k.step": "the rest of mapping_step (neighbours, winner, diagnostics)",
}


@contextlib.contextmanager
def graph_k_ranges(slam):
    """Each call that graph K makes on ``slam`` wrapped in its
    GRAPH_K_PARTS range while the context is open."""
    m = slam.mapping
    targets = [(slam.kernels, "insert_keyframe", "k.insert"),
               (slam, "_update_bow", "k.insert"),
               (SMAP, "incidence_matrix", "k.covis"),
               (SMAP, "covisibility_matrix", "k.covis"),
               (SMAP, "observation_counts", "k.covis"),
               (m, "cull_map_points", "k.cull_points"),
               (TMAP.M, "search_for_triangulation", "k.epipolar"),
               (TMAP, "triangulate_gated", "k.triangulate"),
               (m, "_search_pair", "k.pair"),
               (m, "commit_new_landmarks_multi", "k.commit"),
               (m, "fuse_pair", "k.fuse"),
               (SMAP, "apply_redirect", "k.fuse"),
               (SMAP, "update_landmark_stats_touched", "k.stats"),
               (m, "cull_keyframes", "k.cull_kf"),
               (m, "mapping_step", "k.step")]
    saved = []
    for obj, attr, rng in targets:
        inner = getattr(obj, attr)

        def ranged(*args, _inner=inner, _rng=rng, **kwargs):
            with record_function(_rng):
                return _inner(*args, **kwargs)

        saved.append((obj, attr, obj.__dict__.get(attr), inner))
        setattr(obj, attr, ranged)
    try:
        yield
    finally:
        for obj, attr, own, inner in reversed(saved):
            if own is None and not isinstance(obj, types.ModuleType):
                delattr(obj, attr)          # the method again
            else:
                setattr(obj, attr, inner)


def graph_k_breakdown(cfg, frames, first_ok, first_map):
    """A fresh ``CubemapSLAM`` over the slam drive's frames, eagerly
    (``stage_times`` set), as the drive ran them: the triangulation
    launches of the frames up to the initializing one (the ``init``
    path), then frame ``first_map``, the drive's first mapping step, under
    the profiler with GRAPH_K_PARTS ranges around the calls that graph K
    would replay. Each device operation inside the insertion or the
    mapping step goes to the innermost range around it. Prints each part's
    device busy ms and operations, most first."""
    slam = CubemapSLAM(cfg, seed=SEED)
    slam.stage_times = {}
    TT.TRIANGULATE.launches = 0
    for i in range(first_map):
        slam.track_fisheye(frames[i], i / cfg.fps)
        if i == first_ok:
            tri_launches("init", first_ok + 1)
    n0 = TT.TRIANGULATE.launches
    with graph_k_ranges(slam), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        slam.track_fisheye(frames[first_map], first_map / cfg.fps)
        torch.cuda.synchronize()
    row = slam.metrics[-1]
    if not row.get("keyframe") or TT.TRIANGULATE.launches - n0 != 1:
        raise AssertionError(f"frame {first_map} of the breakdown made no "
                             f"mapping step of one triangulation launch")
    events = raw_events(prof)
    cpu_names = {e[0] for e in events if not e[1]}
    dev = [e for e in events if e[1]]
    spans = [(e[3] - e[2], e[2], e[3], e[0]) for e in dev
             if e[0] in GRAPH_K_PARTS]
    outer = [sp for sp in spans if sp[3] in ("k.insert", "k.step")]
    parts = {k: [0.0, 0] for k in GRAPH_K_PARTS}
    tri_kernels = 0
    for name, _, a, b, *_ in dev:
        if name in cpu_names or not any(o[1] <= a < o[2] for o in outer):
            continue
        part = min(sp for sp in spans if sp[1] <= a < sp[2])[3]
        parts[part][0] += (b - a) / 1e6
        parts[part][1] += 1
        tri_kernels += "triangulate_kernel" in name
    busy = sum(v[0] for v in parts.values())
    ops = sum(v[1] for v in parts.values())
    log(f"[graph-k] frame {first_map}, the slam drive's first mapping step, "
        f"eager under the profiler: graph K's calls {busy:.3f} ms device "
        f"busy in {ops} operations; triangulation kernels {tri_kernels}")
    for k, (ms, n) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
        log(f"[graph-k]   {GRAPH_K_PARTS[k]:58s} {ms:9.3f} ms "
            f"{n:6d} operations")
    if tri_kernels != 1:
        raise AssertionError("the profiled mapping step did not run the "
                             "triangulation kernel once")
    if parts["k.pair"][1] > GRAPH_K_GEOMETRY_MAX_OPS:
        raise AssertionError(f"the pairs' geometry made {parts['k.pair'][1]} "
                             f"device operations (at most "
                             f"{GRAPH_K_GEOMETRY_MAX_OPS})")
    return parts


INTEGER_VIEWS = ("kf_valid", "kf_frame_id", "kf_face", "kf_level", "kf_desc",
                 "kf_kp_valid", "kf_obs_lm", "lm_valid", "lm_desc",
                 "lm_visible", "lm_found", "lm_first_kf", "lm_birth",
                 "lm_first_frame")


def small_mapping_reference_check():
    """mapping_step (without BA) and local_ba on one small arena on the card
    and on the CPU (plain PyTorch): the integer views exactly equal, poses
    within 1e-4, the landmarks that 2 or more keyframes observe within 2e-3
    for 99% and 2e-2 for all. The arena is CubemapSLAM's on the CPU over 9
    rendered frames (160^2 faces, 600 features), just before its last
    mapping step."""
    cfg = SlamConfig(cube_face_w=160, cube_face_h=160, n_features=600,
                     n_levels=3, max_keyframes=24, max_landmarks=4096,
                     min_init_keypoints=80, min_init_matches=60,
                     min_track_inliers=20, fps=5.0)
    poses = S.forward_trajectory(9)
    world = S.make_world(np.random.default_rng(5), n=600,
                         centers=S.camera_centres(poses), fx=80.0)
    arena, slot, n_kf, fid = S.arena_before_last_mapping(
        CubemapSLAM(cfg, device="cpu"), world, poses)
    for stage in ("mapping_step", "local_ba"):
        outs = []
        for dev in ("cpu", "cuda"):
            mk = MappingKernels(cfg, device=dev)
            a = arena.to(dev)
            if stage == "mapping_step":
                a, info = mk.mapping_step(a, slot, n_kf, fid, max_cams=5,
                                          run_ba=False)
                outs.append((a.to("cpu"), info.tolist()))
            else:
                a, _ = mk.local_ba(a, slot, 5)
                outs.append((a.to("cpu"), None))
        (c, info_c), (g, info_g) = outs
        bad = [k for k in INTEGER_VIEWS
               if not torch.equal(getattr(c, k), getattr(g, k))]
        dpose = max(float((c.kf_R - g.kf_R).abs().max()),
                    float((c.kf_t - g.kf_t).abs().max()))
        obs = c.kf_obs_lm[c.kf_valid]
        held = (torch.bincount(obs[obs >= 0], minlength=c.n_lm_cap) >= 2) \
            & c.lm_valid
        d = (c.lm_pos - g.lm_pos).abs().amax(dim=1)[held]
        q99, dmax = float(torch.quantile(d, 0.99)), float(d.max())
        log(f"[ref-mapping] {stage}, card vs CPU: integer views differing "
            f"{bad}; |dpose| {dpose:.3g}; landmarks seen twice or more "
            f"({int(held.sum())}): 99% within {q99:.3g}, max {dmax:.3g}; "
            f"diagnostics card {info_g} vs CPU {info_c}")
        if bad or info_c != info_g or not (dpose < 1e-4 and q99 < 2e-3
                                           and dmax < 2e-2):
            raise AssertionError(f"card and CPU {stage} disagree")


def map_snapshot(slam):
    """Every arena table and the trajectory on the host, the sha256 digest
    of each (``digests``, the trajectory's under "trajectory") and of all
    of them (``digest``: tables in field order, then each pose's timestamp,
    R and t)."""
    tables = {k: getattr(slam.arena, k).detach().cpu().clone()
              for k in slam.arena._fields}
    traj = [(float(ts), np.asarray(R), np.asarray(t))
            for ts, R, t in slam.trajectory]
    h, digests = hashlib.sha256(), {}
    for k, v in tables.items():
        b = v.contiguous().numpy().tobytes()
        digests[k] = hashlib.sha256(b).hexdigest()
        h.update(k.encode())
        h.update(b)
    ht = hashlib.sha256()
    for ts, R, t in traj:
        b = np.float64(ts).tobytes() + R.tobytes() + t.tobytes()
        ht.update(b)
        h.update(b)
    digests["trajectory"] = ht.hexdigest()
    return dict(tables=tables, traj=traj, digest=h.hexdigest(),
                digests=digests)


def repeat_check(cfg, frames, ref, counters, eager_walls):
    """The slam phase's SLAM_FRAMES frames again in a fresh CubemapSLAM
    (the same seed as ``drive_slam``, but ``stage_times`` unset, so every
    tracked frame replays the captured graphs, and its keyframe insertion
    and mapping step, or its deferred BA, replays graph K or graph BA):
    every arena table (keyframe poses, landmark positions, the associations
    among them) and the trajectory bitwise equal to the first run's,
    ``ref``, which ran eagerly; graph K replayed on every keyframe frame
    after the one that captured it and graph BA on every deferred-BA frame
    after its own; the launches of every kernel entry (once a frame) and
    of the segmented sum (as many as the eager drive's). Prints the
    synchronised wall ms by kind of frame beside the eager drive's
    (``eager_walls``, stage timing on). Returns the walls of the repeat
    run's frames that captured no graph, by kind, its system and its
    launches."""
    t0 = time.perf_counter()
    slam = CubemapSLAM(cfg, seed=SEED)
    zero_launches(counters)
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(SLAM_FRAMES):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        slam.track_fisheye(frames[i], i / cfg.fps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t_start) * 1e3)
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    seg = SG.SEG_SUM.launches
    peak = peak_memory()
    if pose_launches("repeat", SLAM_FRAMES) != POSE_LAUNCHES["slam"]:
        raise AssertionError("the repeat run's pose-LM launches differ from "
                             "the eager drive's")
    if tri_launches("repeat", SLAM_FRAMES) != TRI_LAUNCHES["slam"]:
        raise AssertionError("the repeat run's triangulation launches "
                             "differ from the eager drive's")
    if eig_launches("repeat") != EIG_LAUNCHES["slam"]:
        raise AssertionError("the repeat run's sym_eig launches differ from "
                             "the eager drive's")
    rows = slam.metrics
    graph_frames = sum(1 for r in rows if r.get("graph_replays"))
    captures = sum(r.get("graph_captures", 0) for r in rows)
    log(f"[repeat] {graph_frames} of {SLAM_FRAMES} frames replayed graphs, "
        f"{captures} graphs captured")
    init = [r for r in rows if r.get("stage") == "init"]
    log(f"[repeat] init frames through FusedInit: captures "
        f"{[r.get('graph_init_captures') for r in init]}, replays "
        f"{[r.get('graph_init_replays') for r in init]}")
    if not init or any("graph_init_captures" not in r for r in init):
        raise AssertionError("the repeat run's init frames did not run "
                             "through FusedInit")
    if graph_frames < SLAM_FRAMES - SLAM_INIT_BY:
        raise AssertionError("the repeat run's tracked frames did not "
                             "replay the graphs")
    mapped = [r for r in rows if "graph_mapping_replays" in r]
    kf = [r for r in mapped if r["keyframe"]]
    ba = [r for r in mapped if r["ba"] and not r["keyframe"]]
    fm, fs = slam.fused_mapping, slam.fused_step
    log(f"[repeat] graph K: {len(kf)} keyframe frames, the first captured "
        f"{kf[0]['graph_mapping_captures'] if kf else None}, replays on "
        f"the later ones {[r['graph_mapping_replays'] for r in kf[1:]]}; "
        f"graph BA: {len(ba)} deferred-BA frames, the first captured "
        f"{ba[0]['graph_mapping_captures'] if ba else None}, replays on "
        f"the later ones {[r['graph_mapping_replays'] for r in ba[1:]]}; "
        f"FusedMapping {fm.captures} captures, {fm.replays} replays, "
        f"{fm.capture_ms:.3f} ms of host time in torch.cuda.graph, "
        f"{fm.capture_mib:.1f} MiB reserved by its pool; FusedStep "
        f"{fs.capture_ms:.3f} ms, {fs.capture_mib:.1f} MiB")
    if (len(kf) < 2 or len(ba) < 2 or fm.captures != 2
            or kf[0]["graph_mapping_captures"] != 1
            or ba[0]["graph_mapping_captures"] != 1
            or any(r["graph_mapping_captures"] or not r[
                "graph_mapping_replays"] for r in kf[1:] + ba[1:])):
        raise AssertionError("the repeat run's keyframe and deferred-BA "
                             "frames did not replay graphs K and BA")
    by_kind, replayed = {}, {}
    for r, e, g in zip(rows, eager_walls, walls):
        kind = ("init" if r.get("stage") == "init" else "keyframe"
                if r.get("keyframe") else "ba" if r.get("ba") else "tracked")
        by_kind.setdefault(kind, []).append((e, g))
        if not (r.get("graph_captures") or r.get("graph_mapping_captures")
                or r.get("graph_loop_captures")
                or r.get("graph_init_captures")):
            replayed.setdefault(kind, []).append(g)
    log("[repeat] wall ms median by kind of frame, eager drive (stage "
        "timing on) -> graphs: " + "; ".join(
            f"{k} (x{len(v)}) {float(np.median([e for e, _ in v])):.3f} -> "
            f"{float(np.median([g for _, g in v])):.3f}"
            for k, v in by_kind.items()) + "; frames that captured no graph: "
        + "; ".join(f"{k} (x{len(v)}) median {float(np.median(v)):.3f}, mean "
                    f"{float(np.mean(v)):.3f}" for k, v in replayed.items()))
    # loop detection from the tenth keyframe: graph D, captured on the first
    # such keyframe frame and replayed on the later ones
    det = [(r, g) for r, g in zip(rows, walls) if "loop_detect_ms" in r]
    log(f"[repeat] loop detection: graph D captured on keyframe frames "
        f"{[r.get('graph_loop_captures', 0) for r, _ in det]}, replayed "
        f"{[r.get('graph_loop_replays', 0) for r, _ in det]}; detect wall ms "
        f"{[round(r['loop_detect_ms'], 3) for r, _ in det]}; keyframe frames "
        f"that replayed graph D (x{len(det) - 1}) wall ms "
        f"{[round(g, 3) for _, g in det[1:]]}, median "
        f"{float(np.median([g for _, g in det[1:]] or [0])):.3f}; "
        f"{fused_loop_line(slam)}; the run's peak memory {peak}")
    if (not det or det[0][0].get("graph_loop_captures") != 1
            or any(r.get("graph_loop_captures") or not r.get(
                "graph_loop_replays") for r, _ in det[1:])):
        raise AssertionError("the repeat run's loop detection did not "
                             "capture graph D once and replay it after")
    SEG_LAUNCHES["repeat"] = {"total": seg}
    log(f"[repeat] seg_sum: launches in {SLAM_FRAMES} frames {seg} (the "
        f"eager drive: {SEG_LAUNCHES['slam']['total']})")
    if seg != SEG_LAUNCHES["slam"]["total"]:
        raise AssertionError("the repeat run's segmented-sum launches differ "
                             "from the eager drive's")
    for name, by_kernel in launches.items():
        log(f"[repeat] {name}: launches in {SLAM_FRAMES} frames {by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * SLAM_FRAMES:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in the repeat run's {SLAM_FRAMES} "
                                     f"frames")
    snap = map_snapshot(slam)
    a, b = ref["tables"], snap["tables"]
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    traj_same = len(ref["traj"]) == len(snap["traj"]) and all(
        x[0] == y[0] and np.array_equal(x[1], y[1])
        and np.array_equal(x[2], y[2])
        for x, y in zip(ref["traj"], snap["traj"]))
    gaps = {k: float((a[k].double() - b[k].double()).abs().max())
            for k in ("kf_R", "kf_t", "lm_pos")}
    log(f"[repeat] the slam phase's {SLAM_FRAMES} frames again in a fresh "
        f"CubemapSLAM: map digest {snap['digest']} (first run "
        f"{ref['digest']}); tables differing {bad}; trajectory bitwise "
        f"equal {traj_same}; largest differences {gaps}; "
        f"{time.perf_counter() - t0:.1f} s")
    if bad or not traj_same:
        raise AssertionError("the slam phase's map differs between two runs "
                             "from the same frames")
    return replayed, slam, launches


def init_pool_held(system):
    """What ``FusedInit``'s pool holds of the card's reserved memory after
    a whole run that kept it (a reset would replay it): the memory reserved
    once the other graphs are dropped (``drop_graphs(keep_init=True)``),
    then once ``FusedInit`` is dropped too, the allocator's cache emptied
    each time."""
    reserved = []
    for keep in (True, False):
        system.drop_graphs(keep_init=keep)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved() / 2 ** 20)
    log(f"[init-graph] the run's end: {reserved[0]:.1f} MiB reserved with "
        f"FusedInit kept, {reserved[1]:.1f} MiB without it: its pool held "
        f"{reserved[0] - reserved[1]:.1f} MiB through the run")


def slam_phase(cfg, counters):
    """The whole system at full width from its first frame, with the
    pretrained vocabulary: the driven frames, the profiled keyframe and
    deferred-BA frames, and the small card-against-CPU mapping check.
    Returns the system, the poses and frames, the drive's launches, the
    repeat run's (through the graphs) and the ATE's (alignment, path
    length)."""
    cfg = dataclasses.replace(cfg, vocab_path=str(VOCAB_PATH))
    poses, frames = slam_sequence(cfg)
    t0 = time.perf_counter()
    slam = CubemapSLAM(cfg, seed=SEED)          # the card, by default
    torch.cuda.synchronize()
    log(f"[slam] CubemapSLAM at {cfg.cube_w}x{cfg.cube_h}, {cfg.n_features} "
        f"features ({cfg.n_features * cfg.init_features_factor} at init), "
        f"arena K={slam.arena.n_kf_cap} N={slam.arena.n_feat} "
        f"L={slam.arena.n_lm_cap}, vocabulary of {slam.vocab.n_words} words "
        f"({VOCAB_PATH.name}), built in {time.perf_counter() - t0:.1f} s")
    walls, launches, first_ok, ate = drive_slam(slam, poses, frames,
                                                counters)
    snap = map_snapshot(slam)
    log(f"[slam-digest] sha256 of the map after frame {SLAM_FRAMES - 1}: "
        f"{snap['digest']}; {slam.n_kf} keyframes, {slam.ba_runs} deferred "
        f"BAs (with the pose solve as masked eager iterations, its sums in "
        f"PyTorch's order: {DIGEST_MASKED_LM}..., 14 keyframes, 13 BAs)")
    graph_walls, replay_slam, g_launches = repeat_check(
        cfg, frames, snap, counters, walls)
    profiled_slam(slam, frames, walls, graph_walls, "slam-profile", False)
    profiled_slam(replay_slam, frames, walls, graph_walls, "slam-replay",
                  True)
    init_pool_held(replay_slam)
    del replay_slam
    profiled_init(cfg, frames, first_ok, walls)
    first_map = next(i for i, r in enumerate(slam.metrics[:SLAM_FRAMES])
                     if r.get("keyframe") and r.get("stage") != "init")
    graph_k_breakdown(cfg, frames, first_ok, first_map)
    del snap
    small_mapping_reference_check()
    return slam, poses, frames, launches, g_launches, ate


# ---------------------------------------------------------------------------
# Relocalization, localization mode and map save/load on the slam map
# ---------------------------------------------------------------------------

def zero_launches(counters):
    for group in counters.values():
        for c in group:
            c.launches = 0
    SG.SEG_SUM.launches = 0
    PO.POSE_LM.launches = 0
    TT.TRIANGULATE.launches = 0
    SE.SYM_EIG.launches = 0


def read_launches(counters, tag, n_frames):
    """The launches since ``zero_launches``; each kernel entry must have
    launched once a frame."""
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    SEG_LAUNCHES[tag] = {"total": SG.SEG_SUM.launches}
    log(f"[{tag}] seg_sum: launches in {n_frames} frames "
        f"{SG.SEG_SUM.launches}")
    pose_launches(tag, n_frames)
    tri_launches(tag, n_frames, required=False)
    eig_launches(tag, required=False)
    for name, by_kernel in launches.items():
        log(f"[{tag}] {name}: launches in {n_frames} frames {by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * n_frames:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in {n_frames} frames of the {tag} "
                                     f"path")
    return launches


def timed_frame(slam, frame, ts):
    """One synchronised ``track_fisheye``: (pose or None, its row, wall
    ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T = slam.track_fisheye(frame, ts)
    torch.cuda.synchronize()
    return T, slam.metrics[-1], (time.perf_counter() - t0) * 1e3


def reloc_row_line(row, wall):
    keys = ("state", "stage", "reloc_candidates", "relocalized",
            "reloc_inliers", "inliers", "matches", "vo", "host_reads",
            "eigh_waits")
    counts = {k: row[k] for k in keys if k in row}
    st = ", ".join(f"{k} {v:.3f}" for k, v in row.get("stage_ms", {}).items())
    return f"{counts}; stage ms: {st}; wall {wall:.3f} ms"


def check_near_truth(tag, T, pose, align, path):
    ang, dist = aligned_error(T, pose, align)
    log(f"[{tag}] against the ground truth (Sim3-aligned): {ang:.4f} deg, "
        f"{dist:.5f} ({dist / path:.5f} of the path; bounds "
        f"{RELOC_BOUND_DEG} deg, {RELOC_BOUND_FRAC})")
    if not (ang < RELOC_BOUND_DEG and dist < RELOC_BOUND_FRAC * path):
        raise AssertionError(f"{tag}: pose beyond the bound of the ground "
                             f"truth")
    return ang, dist


def go_lost(slam, n, ts):
    """``n`` blank frames: each is lost, and the map keeps its keyframes."""
    n_kf = slam.n_kf
    blank = np.full((slam.cfg.fisheye_height, slam.cfg.fisheye_width), 20,
                    np.uint8)
    for k in range(n):
        T, row, wall = timed_frame(slam, blank, ts + k)
        log(f"[reloc] blank frame: " + reloc_row_line(row, wall))
        if T is not None or slam.state != TrackState.LOST \
                or slam.n_kf != n_kf:
            raise AssertionError("a blank frame did not leave the system "
                                 "LOST with its keyframes")


def lost_state(slam):
    """What a relocalization changes on a LOST system (it leaves the arena
    as it is): the tracking state, the last frame, the reference keyframe,
    the motion model, mbVO, the inlier peak and the generator's state."""
    return (slam.state, slam.last, slam.ref_kf, slam.velocity, slam.mb_vo,
            slam._kf_inlier_peak, slam.generator.get_state())


def restore_lost(slam, st):
    (slam.state, slam.last, slam.ref_kf, slam.velocity, slam.mb_vo,
     slam._kf_inlier_peak, gen) = st
    slam.generator.set_state(gen)


def reloc_record(slam, T, row):
    """A relocalization's outcome: the pose, the row's reads, scores and
    counts, and the last frame's associations, outliers and pose."""
    keys = ("reloc_candidates", "relocalized", "reloc_inliers",
            "reloc_scores", "host_reads", "eigh_waits")
    last = [x.cpu() for x in (slam.last.assoc, slam.last.outlier,
                              slam.last.R, slam.last.t)]
    return T, {k: row.get(k) for k in keys}, last


def same_reloc(tag, a, b):
    (Ta, ra, xa), (Tb, rb, xb) = a, b
    same = (np.array_equal(Ta, Tb) and ra == rb
            and all(torch.equal(x, y) for x, y in zip(xa, xb)))
    log(f"[reloc] {tag}: bitwise equal to the eager frame {same}")
    if not same:
        raise AssertionError(f"the {tag} reloc frame differs from the eager "
                             f"one: {ra} against {rb}")


def reloc_phase(slam, poses, frames, ate, counters):
    """Blank frames make the system LOST (more than 5 live keyframes, so no
    reset); from that state the frame at the ground-truth pose of
    RELOC_FRAME relocalizes three times: eagerly (``reloc_graphs`` off, as
    for the blank frames before; the inputs of its first PnP's six
    eigen-solves are recorded for ``check_sym_eig``), through
    ``FusedLocalization``'s graph X (the front end) and ``FusedReloc``
    capturing graphs X, R and W,
    and replaying them with the launch counters set to 0 just before it;
    the graph frames bitwise equal to the eager one, each within the bound.
    A blank frame again, and the same frame relocalizes under the profiler,
    eagerly, then (after another blank frame) replaying the graphs: each
    one's host waits may be no more than the frame's stated reads and the
    upload (no eigen-solve wait). Returns the launches."""
    align, path = ate
    live = int(slam.arena.kf_valid.sum())
    fids = slam.arena.kf_frame_id[slam.arena.kf_valid].tolist()
    log(f"[reloc] {live} live keyframes (frames {sorted(fids)}), "
        f"{slam.n_kf} created")
    if live <= 5:
        raise AssertionError("5 or fewer live keyframes: LOST would reset")
    ts = 100.0
    # eagerly until the capturing frame: a LOST blank frame tries to
    # relocalize too
    slam.reloc_graphs = False
    go_lost(slam, RELOC_BLANK, ts)
    lost = lost_state(slam)
    with recording_eigh(EIG_INPUTS):
        T, row, wall = timed_frame(slam, frames[RELOC_FRAME], ts + 10)
    slam.reloc_graphs = True
    eager = reloc_record(slam, T, row)
    log(f"[reloc] frame {RELOC_FRAME} eager: " + reloc_row_line(row, wall))
    walls = {"eager": wall}
    for kind in ("capturing", "replaying"):
        restore_lost(slam, lost)
        if kind == "replaying":
            zero_launches(counters)
        T, row, wall = timed_frame(slam, frames[RELOC_FRAME], ts + 10)
        if kind == "replaying":
            launches = read_launches(counters, "reloc", 1)
            eig_launches("reloc")
        walls[kind] = wall
        fr = slam.fused_reloc
        log(f"[reloc] frame {RELOC_FRAME} {kind}: "
            + reloc_row_line(row, wall)
            + f"; graphs captured {row.get('graph_reloc_captures')}, "
              f"replayed {row.get('graph_reloc_replays')}"
            + (f"; capture {fr.capture_ms:.3f} ms, pool "
               f"{fr.capture_mib:.1f} MiB" if kind == "capturing" else ""))
        captured = row.get("graph_reloc_captures", 0)
        if captured != (2 if kind == "capturing" else 0) \
                or not row.get("graph_reloc_replays", 0) + captured:
            raise AssertionError(f"the {kind} reloc frame captured "
                                 f"{captured} graphs")
        x = loc_graph_counts(row)
        log(f"[reloc] frame {RELOC_FRAME} {kind}: graph X (the front end) "
            f"captured, replayed {x}")
        if x != ((1, 0) if kind == "capturing" else (0, 1)):
            raise AssertionError(f"the {kind} LOST frame's front end did not "
                                 f"run through graph X: {x}")
        same_reloc(kind, reloc_record(slam, T, row), eager)
        if T is None or slam.state != TrackState.OK \
                or not row["relocalized"]:
            raise AssertionError(f"the {kind} frame did not relocalize")
    log(f"[reloc] frame wall ms: eager {walls['eager']:.3f}, capturing "
        f"{walls['capturing']:.3f}, replaying {walls['replaying']:.3f}")
    near = min(fids, key=lambda f: abs(f - RELOC_FRAME))
    slot = int(torch.nonzero(slam.arena.kf_valid
                             & (slam.arena.kf_frame_id == near))[0])
    d_kf = float(np.linalg.norm(T[:3, 3] - slam.arena.kf_t[slot].cpu().numpy()))
    log(f"[reloc] {d_kf:.5f} map units from the keyframe of frame {near}, "
        f"the live keyframe nearest frame {RELOC_FRAME}")
    check_near_truth("reloc", T, poses[RELOC_FRAME], align, path)
    for kind in ("eager", "replaying"):
        slam.reloc_graphs = kind != "eager"
        go_lost(slam, 1, ts + 20)
        prof = profile_stages(
            lambda: slam.track_fisheye(frames[RELOC_FRAME], ts + 30),
            RELOC_STAGES, 1)
        row = slam.metrics[-1]
        tag = f"reloc-profile-{kind}"
        log(f"[{tag}] frame {RELOC_FRAME}: " + reloc_row_line(
            row, prof["wall_ms"]))
        log_profile(tag, prof, [walls[kind]])
        if slam.state != TrackState.OK or not row["relocalized"]:
            raise AssertionError(f"the profiled {kind} frame did not "
                                 f"relocalize")
        if row.get("eigh_waits", 0) or row.get("graph_reloc_captures", 0):
            raise AssertionError(f"the profiled {kind} reloc frame counted "
                                 f"eigen-solve waits or captured a graph")
        allowed = row["host_reads"] + 1
        log(f"[{tag}] host waits {prof['host_waits']:.0f} against "
            f"{allowed} allowed: {row['host_reads']} reads and the upload")
        if prof["host_waits"] > allowed:
            raise AssertionError(f"the {kind} reloc frame waited "
                                 f"{prof['host_waits']:.0f} times; its "
                                 f"stated reads and the upload are "
                                 f"{allowed}")
    return launches


def map_counts(slam):
    a = slam.arena
    return slam.n_kf, int(a.kf_valid.sum()), int(a.lm_valid.sum())


LOC_STAGES = ("warp", "extract", "localization")


def loc_state(slam):
    """What localization-mode frames change: the arena's tables (copies;
    the counters move), the tracking state, the last frame, the reference
    keyframe, the motion model, mbVO, the frame counter and the
    generator's state."""
    return ({k: getattr(slam.arena, k).clone() for k in slam.arena._fields},
            slam.state, slam.last, slam.ref_kf, slam.velocity, slam.mb_vo,
            slam.frame_id, slam.generator.get_state())


def restore_loc(slam, st):
    """``loc_state``'s state back, the arena written in place (the graphs
    check its tensors by ``data_ptr``)."""
    (tables, slam.state, slam.last, slam.ref_kf, slam.velocity, slam.mb_vo,
     slam.frame_id, gen) = st
    for k, v in tables.items():
        getattr(slam.arena, k).copy_(v)
    slam.generator.set_state(gen)


def loc_record(slam, T):
    """A localization-mode frame's outcome on the host: ``frame_record``
    without the graph counts, with mbVO and the arena's counters."""
    rec = frame_record(slam, T)
    rec["row"] = {k: v for k, v in slam.metrics[-1].items()
                  if not k.startswith("graph_") and not k.endswith("_ms")}
    rec["row"]["mb_vo"] = slam.mb_vo
    rec["tensors"].update(lm_visible=slam.arena.lm_visible.cpu().clone(),
                          lm_found=slam.arena.lm_found.cpu().clone())
    return rec


def loc_graph_counts(row):
    return (row.get("graph_localization_captures", 0),
            row.get("graph_localization_replays", 0))


def drive_localization(slam, poses, frames, idx, ate, tag):
    """``idx``'s frames in localization mode, each tracked within the
    bound: (walls, records, errors by frame)."""
    align, path = ate
    walls, recs, errs = [], [], {}
    for i in idx:
        T, row, wall = timed_frame(slam, frames[i], 200.0 + i)
        walls.append(wall)
        recs.append(loc_record(slam, T))
        log(f"[localization-{tag}] frame {i}: " + reloc_row_line(row, wall)
            + f"; graphs captured, replayed {loc_graph_counts(row)}")
        if T is None or row.get("stage") != "localization" or row["vo"]:
            raise AssertionError(f"localization frame {i} was not tracked "
                                 f"against the map")
        errs[i] = check_near_truth("localization", T, poses[i], align, path)
    return walls, recs, errs


LOC_FORCED_GRAPHS = ("L1", "L2", "LR", "L3")


def forced_localization(slam, poses, frames, i, ate, graphs, end):
    """Frame ``i`` after the last association was emptied, 1 +
    FORCED_REPEATS times from the state ``end`` (``restore_loc``): no match
    at 15 px nor 30 px (graph L2 on the card), the reference-keyframe
    fallback (graph LR), then TrackLocalMap (graph L3 on the stage tuple
    LR's was copied into); tracked within the bound, every repeat bitwise
    the first, and through the graphs every repeat replays L1, L2, LR and
    L3 and captures none. Then GRAPH_PROFILE_FRAMES such frames under the
    profiler. Returns (the first frame's record, the report: walls, pose-LM
    launches a frame, profile, reads, the pool's MiB before and after)."""
    slam.localization_graphs = graphs
    tag = "graph" if graphs else "eager"
    fl = slam.fused_localization
    pool = fl.capture_mib if graphs and fl else 0.0

    def emptied():
        restore_loc(slam, end)
        slam.last = slam.last._replace(
            assoc=torch.full_like(slam.last.assoc, -1))

    walls, lm_launches, first = [], [], None
    for rep in range(1 + FORCED_REPEATS):
        emptied()
        n0 = PO.POSE_LM.launches
        T, row, wall = timed_frame(slam, frames[i], 200.0 + i)
        walls.append(wall)
        lm_launches.append(PO.POSE_LM.launches - n0)
        names = row.get("graph_localization_replayed", ())
        log(f"[localization-{tag}] frame {i}, last association emptied, "
            f"{rep}: " + reloc_row_line(row, wall)
            + f"; graphs captured, replayed {loc_graph_counts(row)} "
            f"({'>'.join(names) or 'none'}); pose_lm launches "
            f"{lm_launches[-1]}")
        if T is None or row["vo"] or row["host_reads"] != 4:
            raise AssertionError("the emptied frame did not widen, fall back "
                                 "to the reference keyframe and track the "
                                 "map")
        check_near_truth("localization", T, poses[i], ate[0], ate[1])
        rec = loc_record(slam, T)
        if rep == 0:
            first = rec
            if graphs and sum(loc_graph_counts(row)) != 4:
                raise AssertionError("the emptied frame did not run graphs "
                                     "L1, L2, LR and L3")
        else:
            same_bits(f"the emptied localization frame, repeat {rep}", first,
                      rec)
            if graphs and (row["graph_localization_captures"]
                           or names != LOC_FORCED_GRAPHS):
                raise AssertionError(f"the emptied frame's repeat {rep} "
                                     f"captured or replayed {names}, not "
                                     f"{LOC_FORCED_GRAPHS}")
    after = slam.fused_localization.capture_mib if graphs else 0.0
    prof = profile_stages(lambda: slam.track_fisheye(frames[i], 200.0 + i),
                          (), GRAPH_PROFILE_FRAMES, before=emptied)
    rows = slam.metrics[-GRAPH_PROFILE_FRAMES:]
    reads = max(r["host_reads"] for r in rows)
    log(f"[localization-{tag}] the emptied frame: wall ms first "
        f"{walls[0]:.3f}, repeats' median {float(np.median(walls[1:])):.3f} "
        f"(all {float(np.median(walls)):.3f}); profiled: device busy "
        f"{prof['device_busy_ms']:.3f} ms in {prof['device_ops']:.0f} "
        f"operations, host waits {prof['host_waits']:.2f} a frame (reads "
        f"{reads} + the upload: {reads + 1}); pool {pool:.1f} -> "
        f"{after:.1f} MiB")
    if graphs and (prof["host_waits"] > reads + 1 or any(
            r.get("graph_localization_replayed") != LOC_FORCED_GRAPHS
            for r in rows)):
        raise AssertionError("a profiled emptied localization frame waited "
                             "more than its reads and the upload, or did not "
                             "replay L1, L2, LR and L3")
    slam.localization_graphs = True
    return first, dict(walls=walls, pose_lm=lm_launches, prof=prof,
                       reads=reads, pool=(pool, after))


def profiled_localization(slam, frames, idx, graphs, walls):
    """``idx``'s frames under ``profile_stages``, through the graphs or
    eagerly; logged with their host waits against the stated reads and the
    upload. Returns the profile."""
    slam.localization_graphs = graphs
    it = iter(idx)

    def step():
        i = next(it)
        slam.track_fisheye(frames[i], 200.0 + i)

    tag = "localization-profile-" + ("graph" if graphs else "eager")
    prof = profile_stages(step, LOC_STAGES, len(idx))
    slam.localization_graphs = True
    log_profile(tag, prof, walls)
    rows = slam.metrics[-len(idx):]
    reads = max(r["host_reads"] for r in rows)
    log(f"[{tag}] device busy {prof['device_busy_ms']:.3f} ms a frame in "
        f"{prof['device_ops']:.0f} operations; host reads {reads}, host "
        f"waits {prof['host_waits']:.2f} a frame (the reads and the upload: "
        f"{reads + 1}); graphs captured, replayed "
        f"{[loc_graph_counts(r) for r in rows]}")
    if prof["host_waits"] > reads + 1:
        raise AssertionError(f"a {tag} frame waited {prof['host_waits']:.2f}"
                             f" times; its reads and the upload are "
                             f"{reads + 1}")
    if graphs and (not prof["device_ops"] < GRAPH_MAX_OPS or any(
            loc_graph_counts(r) != (0, 2) for r in rows)):
        raise AssertionError(f"a localization graph frame ran "
                             f"{prof['device_ops']:.0f} device operations "
                             f"(at most {GRAPH_MAX_OPS}) or did not replay "
                             f"L1 and L3 alone")
    return prof


def localization_phase(slam, poses, frames, ate, counters):
    """LOC_FRAMES frames after RELOC_FRAME in localization mode through
    ``FusedLocalization``'s graphs (L1 and L3 captured on the first, then
    replayed), with the launch counters set to 0 just before: each tracked
    within the bound, no mbVO, the map's keyframe and landmark counts
    unchanged. Then, from the arena and tracker state restored, the same
    frames eagerly (``localization_graphs`` off): bitwise equal frame by
    frame, the arena's counters too. A frame with the last association
    emptied (graphs L1, L2, LR: the reference-keyframe fallback, and L3)
    through the graphs and eagerly, each 1 + FORCED_REPEATS times from the
    same state and profiled (``forced_localization``), bitwise equal; two
    frames of each kind under the profiler, whose host waits may not
    exceed the stated reads and the upload. Last, landmarks perturbed by
    LOC_SIGMA engage mbVO (a ``vo`` row), and restored, the next frame
    relocalizes (``FusedReloc`` on graph L1's keypoints) and clears it.
    Returns the launches of the graph run and of the eager run."""
    align, path = ate
    slam.activate_localization_mode()
    slam.localization_graphs = True
    before = map_counts(slam)
    start = loc_state(slam)
    first = RELOC_FRAME + 1
    idx = list(range(first, first + LOC_FRAMES))
    zero_launches(counters)
    g_walls, g_rec, errs = drive_localization(slam, poses, frames, idx, ate,
                                              "graph")
    launches = read_launches(counters, "localization", LOC_FRAMES)
    counts = [loc_graph_counts(r) for r in slam.metrics[-LOC_FRAMES:]]
    if counts[0][0] < 2 or counts[0][1] or any(
            c[1] < 2 for c in counts[1:]):
        raise AssertionError(f"the localization frames captured and "
                             f"replayed {counts}: L1 and L3 captured on the "
                             f"first, replayed after")
    fl = slam.fused_localization
    log(f"[localization] graphs captured, replayed a frame {counts}; "
        f"{fl.captures} captures in {fl.capture_ms:.3f} ms (graph X's in "
        f"the reloc phase included), pool {fl.capture_mib:.1f} MiB")
    end = loc_state(slam)
    restore_loc(slam, start)
    slam.localization_graphs = False
    zero_launches(counters)
    e_walls, e_rec, _ = drive_localization(slam, poses, frames, idx, ate,
                                           "eager")
    e_launches = read_launches(counters, "localization_eager", LOC_FRAMES)
    slam.localization_graphs = True
    n = sum(same_bits(f"localization frame {i}", e, g)
            for i, e, g in zip(idx, e_rec, g_rec))
    n += same_bits("the arena after the localization frames",
                   {k: v.cpu() for k, v in end[0].items()},
                   {k: getattr(slam.arena, k).cpu() for k in end[0]})
    log(f"[localization] graph frames against eager frames: {LOC_FRAMES} "
        f"frames and the arena bitwise equal ({n} tensors); wall ms eager "
        f"median {float(np.median(e_walls)):.3f}, capturing "
        f"{g_walls[0]:.3f}, replaying median "
        f"{float(np.median(g_walls[1:])):.3f}")
    i = first + LOC_FRAMES
    forced = {}
    for graphs in (True, False):
        zero_launches(counters)
        forced[graphs] = forced_localization(slam, poses, frames, i, ate,
                                             graphs, end)
        pose_launches(f"localization_forced_{'graph' if graphs else 'eager'}",
                      1 + FORCED_REPEATS + GRAPH_PROFILE_FRAMES)
    (g_first, g), (e_first, e) = forced[True], forced[False]
    same_bits("the emptied localization frame", e_first, g_first)
    if e["pose_lm"] != g["pose_lm"]:
        raise AssertionError(f"the emptied localization frame launched "
                             f"pose_lm {g['pose_lm']} through the graphs, "
                             f"{e['pose_lm']} eagerly")
    log(f"[localization] the emptied frame through graphs "
        f"{', '.join(LOC_FORCED_GRAPHS)} is bitwise the eager one; wall ms "
        f"eager median {float(np.median(e['walls'])):.3f}, graph capturing "
        f"{g['walls'][0]:.3f}, replaying median "
        f"{float(np.median(g['walls'][1:])):.3f}; device busy eager "
        f"{e['prof']['device_busy_ms']:.3f} / graph "
        f"{g['prof']['device_busy_ms']:.3f} ms; operations "
        f"{e['prof']['device_ops']:.0f} / {g['prof']['device_ops']:.0f}; "
        f"host waits {e['prof']['host_waits']:.2f} / "
        f"{g['prof']['host_waits']:.2f} (reads {g['reads']}); pose_lm "
        f"{g['pose_lm'][0]} a frame; pool MiB {g['pool'][0]:.1f} -> "
        f"{g['pool'][1]:.1f}")
    for graphs, walls in ((True, g_walls[1:]), (False, e_walls)):
        restore_loc(slam, start)
        profiled_localization(slam, frames, idx[:GRAPH_PROFILE_FRAMES],
                              graphs, walls)
    restore_loc(slam, end)
    worst = max(errs, key=lambda i: errs[i][1])
    frac = errs[worst][1] / path
    log(f"[localization] worst frame {worst}: {frac:.5f} of the path, "
        f"{errs[worst][0]:.4f} deg; margin to the bound {RELOC_BOUND_FRAC}: "
        f"{RELOC_BOUND_FRAC - frac:.5f} ({frac / RELOC_BOUND_FRAC:.3f} of "
        f"it); by frame "
        f"{ {i: round(e[1] / path, 5) for i, e in errs.items()} }")
    after = map_counts(slam)
    log(f"[localization] {LOC_FRAMES} frames: (keyframes created, live, live "
        f"landmarks) before {before}, after {after}")
    if after != before:
        raise AssertionError("localization mode changed the map")
    a = slam.arena
    clean = a.lm_pos.clone()
    gen = torch.Generator(device=a.lm_pos.device).manual_seed(SEED)
    a.lm_pos.add_(LOC_SIGMA * torch.randn(clean.shape, generator=gen,
                                          device=clean.device))
    zero_launches(counters)
    T, row, wall = timed_frame(slam, frames[i], 200.0 + i)
    log(f"[localization] frame {i}, landmarks perturbed by sigma "
        f"{LOC_SIGMA}: mbVO {slam.mb_vo}; " + reloc_row_line(row, wall)
        + f"; graphs captured, replayed {loc_graph_counts(row)}")
    if not (slam.mb_vo and row.get("vo")):
        raise AssertionError("mbVO did not engage on perturbed landmarks")
    a.lm_pos.copy_(clean)
    i += 1
    T, row, wall = timed_frame(slam, frames[i], 200.0 + i)
    log(f"[localization] frame {i}, landmarks restored: mbVO {slam.mb_vo}; "
        + reloc_row_line(row, wall)
        + f"; graphs captured, replayed {loc_graph_counts(row)}")
    if T is None or slam.mb_vo or not row.get("relocalized"):
        raise AssertionError("the restored map did not relocalize and clear "
                             "mbVO")
    check_near_truth("localization", T, poses[i], align, path)
    if map_counts(slam) != before:
        raise AssertionError("localization mode changed the map")
    # the eigen-solves run where a frame relocalizes: the mbVO frame's try
    # and the restored frame's
    eig_launches("localization")
    slam.deactivate_localization_mode()
    return launches, e_launches


def save_load_check(slam, poses, frames, ate):
    """``save_map`` the map to a file under the checkout's ``build/``,
    ``load_map`` it into a fresh CubemapSLAM on the card: the arena equal
    table by table, LOST, and the next frame relocalizes within the
    bound."""
    align, path = ate
    out = pathlib.Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as d:
        f = pathlib.Path(d) / "map.npz"
        t0 = time.perf_counter()
        serialize.save_map(slam, str(f))
        t_save = time.perf_counter() - t0
        size = f.stat().st_size / 2 ** 20
        fresh = CubemapSLAM(slam.cfg, device=slam.device, seed=SEED + 1)
        t0 = time.perf_counter()
        serialize.load_map(fresh, str(f))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    bad = [k for k in slam.arena._fields
           if not torch.equal(getattr(slam.arena, k),
                              getattr(fresh.arena, k))]
    bad += [] if torch.equal(slam.bow_table, fresh.bow_table) else ["bow"]
    log(f"[saveload] map saved in {t_save:.2f} s ({size:.1f} MiB), loaded "
        f"in {t_load:.2f} s; tables differing {bad}; state "
        f"{fresh.state.name}")
    if bad or fresh.state != TrackState.LOST \
            or fresh.vocab.n_words != slam.vocab.n_words:
        raise AssertionError("the loaded map differs from the saved one")
    T, row, wall = timed_frame(fresh, frames[SAVELOAD_FRAME], 300.0)
    log(f"[saveload] frame {SAVELOAD_FRAME} on the loaded map: "
        + reloc_row_line(row, wall))
    if T is None or not row.get("relocalized"):
        raise AssertionError("the loaded map did not relocalize")
    check_near_truth("saveload", T, poses[SAVELOAD_FRAME], align, path)


def perturbed_copies(desc, rng, flips):
    """(N, 8) uint32 descriptors with ``flips`` random bits flipped each."""
    out = desc.copy()
    rows = np.repeat(np.arange(len(out)), flips)
    words = rng.integers(0, 8, len(rows))
    bits = rng.integers(0, 32, len(rows)).astype(np.uint32)
    np.bitwise_xor.at(out, (rows, words), np.uint32(1) << bits)
    return out


def pnp_scene(cam, rng, n=150, n_out=0):
    """``n`` points in front of ``cam`` at a known pose, their bearings
    and cross pixels (noise-free), ``n_out`` of the matches scrambled:
    (R, t, pts, rays, uv, valid) on the CPU."""
    pts = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    R = so3_exp(torch.tensor([0.2, -0.3, 0.1]))
    t = torch.tensor([0.4, -0.2, 0.6])
    pw = torch.as_tensor(pts)
    pc = pw @ R.T + t
    rays = pc / torch.linalg.norm(pc, dim=1, keepdim=True)
    uv, face = TC.ray_to_cubemap(cam, rays)
    valid = face != TC.UNKNOWN_FACE
    if n_out:
        idx = rng.choice(np.nonzero(valid.numpy())[0], n_out, replace=False)
        perm = torch.as_tensor(rng.permutation(idx))
        idx = torch.as_tensor(idx)
        rays[idx], uv[idx] = rays[perm].clone(), uv[perm].clone()
    return R, t, pw, rays, uv, valid


def small_reloc_reference_check(card="cuda"):
    """Place recognition and PnP on the card against the CPU (plain
    PyTorch) on seeded inputs: ``word_ids`` exactly equal and
    ``bow_vector`` rows within 1e-6 (the pretrained vocabulary, 500
    descriptors); ``detect_candidates`` the same candidates and flags (a
    K=32 table, 4 keyframes near the query, covisibility with ties);
    ``pnp_ransac`` with the same CPU-drawn minimal sets on noise-free
    scenes: both succeed with inlier counts within 5%, each pose within 1
    deg and 50 mm of the truth (the bounds of the JAX package's PnP test),
    and with no scrambled match the two poses within 0.05 deg and 1 mm.
    With 30% of the matches scrambled the two are held to the outcome
    only: each hypothesis starts from a null basis of its own (cuSOLVER's,
    LAPACK's), so the best inlier set can differ, and its linear refit
    moves with a scrambled match that lands near its true pixel."""
    rng = np.random.default_rng(SEED + 6)
    voc = PL.load_vocabulary(str(VOCAB_PATH), "cpu")
    voc_g = voc.to(card)
    desc = rng.integers(0, 2 ** 32, (500, 8), dtype=np.uint32)
    valid = torch.as_tensor(rng.uniform(size=500) < 0.9)
    d_c = interop.desc_from_numpy(desc)
    w_c, w_g = PL.word_ids(voc, d_c), PL.word_ids(voc_g, d_c.to(card))
    b_c = PL.bow_vector(voc, d_c, valid)
    b_g = PL.bow_vector(voc_g, d_c.to(card), valid.to(card))
    ids_equal = torch.equal(w_c, w_g.cpu())
    d_bow = float((b_c - b_g.cpu()).abs().max())
    # a K=32 table: 4 keyframes near the query, two covisible pairs
    K = 32
    query = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    kf = [rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
          for _ in range(K)]
    for s, flips in ((5, 1), (6, 2), (17, 1), (23, 2)):
        kf[s] = perturbed_copies(query, rng, flips)
    ones = torch.ones(K, 300, dtype=torch.bool)
    table = PL.bow_vectors(voc, interop.desc_from_numpy(np.stack(kf)), ones)
    qb = PL.bow_vector(voc, interop.desc_from_numpy(
        perturbed_copies(query, rng, 1)), ones[0])
    kf_valid = torch.ones(K, dtype=torch.bool)
    kf_valid[[11, 30, 31]] = False
    covis = np.triu(rng.integers(0, 4, (K, K)), 1)
    covis = covis + covis.T
    covis[5, 6] = covis[6, 5] = covis[17, 23] = covis[23, 17] = 40
    args = (qb, table, kf_valid, torch.zeros(K, dtype=torch.bool),
            torch.as_tensor(covis))
    i_c, ok_c = PL.detect_candidates(*args, 0.0)
    i_g, ok_g = PL.detect_candidates(*(x.to(card) for x in args), 0.0)
    cand_equal = torch.equal(ok_c, ok_g.cpu()) and torch.equal(
        i_c[ok_c], i_g.cpu()[ok_c])
    # PnP RANSAC with the same minimal sets: a clean scene, where every
    # hypothesis and the refit are exact, and one with scrambled matches
    cfg = SlamConfig()
    cams = {"cpu": CubemapCamera.from_config(cfg, "cpu"),
            "card": CubemapCamera.from_config(cfg, card)}

    def apart(R1, t1, R2, t2):
        return (math.degrees(float(torch.linalg.norm(so3_log(R1 @ R2.T)))),
                float(torch.linalg.norm(t1 - t2)) * 1e3)

    ok_pnp = True
    for n_out in (0, 45):
        R, t, pw, rays, uv, pvalid = pnp_scene(cams["cpu"], rng, n_out=n_out)
        sets = sample_minimal_sets(torch.Generator().manual_seed(SEED),
                                   pvalid, cfg.pnp_ransac_iters, PNP.MIN_SET)
        res = {}
        for d, cam in cams.items():
            r = PNP.pnp_ransac(cam, None, *(x.to(cam.device) for x in (
                pw, rays, uv, torch.ones(pw.shape[0]), pvalid)),
                n_iters=cfg.pnp_ransac_iters, sets=sets)
            res[d] = (bool(r.success), int(r.n_inliers), r.R.cpu(),
                      r.t.cpu())
        pair = apart(res["cpu"][2], res["cpu"][3], res["card"][2],
                     res["card"][3])
        truth = [apart(r[2], r[3], R, t) for r in res.values()]
        n_c, n_g = res["cpu"][1], res["card"][1]
        log(f"[ref-reloc] pnp_ransac, {n_out} of 150 matches scrambled: "
            f"success and inliers card {res['card'][:2]} vs CPU "
            f"{res['cpu'][:2]}, poses apart {pair[0]:.4g} deg / "
            f"{pair[1]:.4g} mm, from the truth "
            + ", ".join(f"{a:.4g} deg / {m:.4g} mm" for a, m in truth))
        ok_pnp &= res["cpu"][0] and res["card"][0] \
            and abs(n_c - n_g) <= 0.05 * n_c
        if n_out == 0:
            ok_pnp &= pair[0] < 0.05 and pair[1] < 1.0
        ok_pnp &= all(a < 1.0 and m < 50.0 for a, m in truth)
    log(f"[ref-reloc] card vs CPU: word ids equal {ids_equal}, BoW rows "
        f"within {d_bow:.3g}; candidates {i_g[ok_g].tolist()} vs "
        f"{i_c[ok_c].tolist()}, equal {cand_equal}")
    if not (ids_equal and d_bow <= 1e-6 and cand_equal and ok_c.any()):
        raise AssertionError("card and CPU place recognition disagree")
    if not ok_pnp:
        raise AssertionError("card and CPU pnp_ransac disagree")


# ---------------------------------------------------------------------------
# Loop closing at full width on the constructed-drift arena
# ---------------------------------------------------------------------------

class LoopSystem(LoopGraphOwner):
    """What ``LoopCloser.process`` reads of a system (the arena, the
    keyframe counter, the BoW table and the generator), owning its loop
    graphs as ``CubemapSLAM`` does."""

    def __init__(self, arena, n_kf, bow_table, generator):
        self.arena, self.n_kf = arena, n_kf
        self.bow_table, self.generator = bow_table, generator


def loop_system(cfg, device, vocab, n_pts, seed):
    """The constructed-drift arena at ``cfg``'s capacities on ``device``,
    the BoW rows of its keyframes, and the system fields that
    ``LoopCloser.process`` reads (a ``LoopSystem``)."""
    arena, _, desc, _ = S.build_drifted_loop_arena(
        cfg, np.random.default_rng(seed), n_pts=n_pts, device=device)
    if vocab is None:
        vocab = PL.train_vocabulary(desc, k=8, depth=3, device=device)
    n = S.LOOP_KEYFRAMES
    bow = torch.zeros(cfg.max_keyframes, vocab.n_words, device=device)
    bow[:n] = PL.bow_vectors(vocab, arena.kf_desc[:n], arena.kf_kp_valid[:n])
    gen = torch.Generator(device=device).manual_seed(SEED)
    return LoopSystem(arena, n, bow, gen)


def segment_b_error(arena) -> float:
    """Summed distance of the segment-B keyframes' t to the ground truth."""
    t = arena.kf_t[10:14].cpu().numpy()
    return float(sum(np.linalg.norm(t[j] - S.loop_gt_pose(j)[1])
                     for j in range(4)))


def close_constructed_loop(cfg, system, seg=None, graphs=True):
    """``LoopCloser.process`` on slots 12 then 13 at consistency_th = 1,
    its solves through CUDA graphs or eagerly (``graphs``), with the
    segmented sums of the correction and the global BA counted into
    ``seg`` when given. Returns (the closer, the closure's wall ms, what
    each call returned)."""
    lc = LoopCloser(cfg, CubemapCamera.from_config(cfg,
                                                   system.arena.device))
    lc.consistency_th = 1
    lc.graphs = graphs
    with (contextlib.nullcontext() if seg is None else
          seg_tally(lc, ("_correct", "_global_ba"), seg)):
        closed = [lc.process(system, 12)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        closed.append(lc.process(system, 13))
        torch.cuda.synchronize()
    return lc, (time.perf_counter() - t0) * 1e3, closed


LOOP_MODES = (("eager", False), ("graph", True))


def loop_arena_tables(arena):
    """Every arena table on the host and the sha256 digest of all of them
    (tables in field order)."""
    tables = {k: getattr(arena, k).detach().cpu().clone()
              for k in arena._fields}
    h = hashlib.sha256()
    for k, v in tables.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return tables, h.hexdigest()


def graph_counts_line(lc):
    g = lc.graph_counts
    return (f"captures {g['captures']}, replays {g['replays']}, capture "
            f"{g['capture_ms']:.3f} ms, pool {g['capture_mib']:.1f} MiB, "
            f"capture waits {lc.capture_waits}")


def restore_loop_system(system, tables):
    """Write ``tables`` (``loop_arena_tables``) back into the system's arena
    in place and seed its generator anew: the same closure again on the
    same tensors, so that graphs captured on them replay."""
    for k, v in tables.items():
        getattr(system.arena, k).copy_(v)
    system.generator.manual_seed(SEED)


@contextlib.contextmanager
def recording_sim3_eigh(store):
    """Record clones of the inputs of the first ``sim3_ransac``'s two Horn
    eigen-solves (the hypotheses' (n_iters, 4, 4) batch, the refit's 4x4)
    into ``store`` while the context is open."""
    inner = S3.horn_alignment

    def recorded(*args, eigh, **kw):
        def solve(A):
            if len(store) < len(SIM3_EIG_SITES):
                store.append(A.reshape(-1, 4, 4).clone())
            return eigh(A)
        return inner(*args, eigh=solve, **kw)

    S3.horn_alignment = recorded
    try:
        yield store
    finally:
        S3.horn_alignment = inner


def peak_memory() -> str:
    """The card's peak memory since the last reset of its statistics:
    allocated to tensors, and reserved by the caching allocator (the CUDA
    graphs' pools among it)."""
    return (f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB "
            f"allocated, {torch.cuda.max_memory_reserved() / 2 ** 20:.1f} "
            f"MiB reserved")


def fused_loop_line(system):
    fl = system.fused_loop
    if fl is None:
        return "no FusedLoop"
    fc, fg = fl.correction, fl.global_ba
    return (f"FusedLoop: {fl.captures} graphs captured, {fl.replays} "
            f"replays, {fl.capture_ms:.3f} ms in torch.cuda.graph, pool "
            f"{fl.capture_mib:.1f} MiB; FusedCorrect: {fc.captures} "
            f"captured (edge capacities {fc.capacities}), {fc.replays} "
            f"replays, {fc.capture_ms:.3f} ms in torch.cuda.graph, pool "
            f"{fc.capture_mib:.1f} MiB; FusedGlobalBA: {fg.captures} "
            f"captured (edge capacities {fg.capacities}), {fg.replays} "
            f"replays, {fg.capture_ms:.3f} ms in torch.cuda.graph, pool "
            f"{fg.capture_mib:.1f} MiB")


def part_counts(system, part):
    """(captures, pool MiB) so far of the system's ``FusedLoop`` part
    ``part`` (``correction``: its ``FusedCorrect``; ``global_ba``: its
    ``FusedGlobalBA``)."""
    fl = system.fused_loop
    if fl is None:
        return (0, 0.0)
    g = getattr(fl, part)
    return (g.captures, g.capture_mib)


def loop_phase(cfg):
    """The constructed-drift closure at SlamConfig() capacities, once
    eagerly (``LoopCloser.graphs`` off) and once through the CUDA graphs
    (DetectLoop and ComputeSim3 through ``FusedLoop``'s graphs D, M and S,
    CorrectLoop through its ``FusedCorrect``, the global BA through its
    ``FusedGlobalBA``), each on a fresh copy
    of the arena: both must close the loop, cut the segment-B error to
    LOOP_ERR_FRAC, launch the segmented sum LOOP_SEG_LAUNCHES times by
    stage and the eigen-solve kernel twice (one Sim3 RANSAC; its inputs
    are recorded from the eager closure), and leave every arena table
    bitwise equal; the graph system's arena restored in place and closed
    again must replay graphs D, M and S, capture none of them and give the
    same tables. Then a warm closure eagerly, capturing (a fresh copy) and
    replaying (that copy restored) for the stage times, host reads,
    eigen-solve waits, capture waits and peak memory; then the same three
    under the profiler (process(12), DetectLoop only, and process(13), the
    closure) by stage and sub-range (host waits at most the stated reads,
    eigen-solve waits and capture waits). Returns the segmented sum's row
    and the Sim3 RANSAC's recorded eigen-solve inputs."""
    vocab = PL.load_vocabulary(str(VOCAB_PATH))
    t0 = time.perf_counter()
    system = loop_system(cfg, "cuda", vocab, LOOP_POINTS, SEED + 7)
    a = system.arena
    rows = (a.kf_obs_lm[:S.LOOP_KEYFRAMES] >= 0).sum(1).tolist()
    log(f"[loop] constructed-drift arena K={a.n_kf_cap} N={a.n_feat} "
        f"L={a.n_lm_cap}: {int(a.lm_valid.sum())} landmarks, observations "
        f"by keyframe {rows}, built in {time.perf_counter() - t0:.1f} s")
    if min(rows[:6] + rows[10:14]) < LOOP_MIN_ROW:
        raise AssertionError("a segment keyframe holds fewer than "
                             f"{LOOP_MIN_ROW} observations")
    inv_s2 = 1.0 / torch.tensor(cfg.level_sigma2, dtype=torch.float32,
                                device="cuda")
    seg_row = check_seg_sum(CubemapCamera.from_config(cfg, "cuda"), a,
                            inv_s2)
    before = segment_b_error(a)
    closed_tables, sim3_eig = {}, []
    for mode, graphs in LOOP_MODES:
        system = loop_system(cfg, "cuda", vocab, LOOP_POINTS, SEED + 7)
        initial, _ = loop_arena_tables(system.arena)
        SG.SEG_SUM.launches = SE.SYM_EIG.launches = 0
        seg = {}
        with (contextlib.nullcontext() if graphs else
              recording_sim3_eigh(sim3_eig)):
            lc, cold, closed = close_constructed_loop(cfg, system, seg,
                                                      graphs)
        launches = dict(total=SG.SEG_SUM.launches, **seg)
        SEG_LAUNCHES["loop" if graphs else "loop_eager"] = launches
        log(f"[loop] {mode}: seg_sum launches in the closure {launches} (by "
            f"LoopCloser stage; required {LOOP_SEG_LAUNCHES})")
        if seg != LOOP_SEG_LAUNCHES:
            raise AssertionError(f"the {mode} closure launched the "
                                 f"segmented sum {seg} times")
        n_eig = eig_launches("loop" if graphs else "loop_eager")
        if n_eig != 2:
            raise AssertionError(f"the {mode} closure launched the "
                                 f"eigen-solve kernel {n_eig} times (one "
                                 f"Sim3 RANSAC: 2)")
        after = segment_b_error(system.arena)
        log(f"[loop] {mode}: process(12), process(13): {closed}; the first "
            f"closure's wall {cold:.3f} ms (cold: first use of its "
            f"operations); {graph_counts_line(lc)}; {fused_loop_line(system)}")
        log(f"[loop] {mode}: segment-B centre error {before:.5f} -> "
            f"{after:.5f} ({after / before:.4f} of it; bound "
            f"{LOOP_ERR_FRAC}); loop edges {lc.loop_edges}")
        if closed != [False, True]:
            raise AssertionError("the constructed loop was not closed")
        if not after <= LOOP_ERR_FRAC * before:
            raise AssertionError("the loop closure did not reduce the "
                                 "segment-B drift enough")
        fl = system.fused_loop
        if graphs and (lc.graph_counts["captures"] != LOOP_CLOSURE_CAPTURES
                       or fl.captures != LOOP_FUSED_GRAPHS
                       or fl.correction.captures != LOOP_CORRECT_GRAPHS
                       or fl.global_ba.captures != LOOP_GBA_GRAPHS):
            raise AssertionError("the graph closure did not capture graphs "
                                 "D, M, S, C, a step, F and the global "
                                 "BA's B, P, L, X and W")
        if not graphs and (lc.graph_counts["captures"] or fl is not None):
            raise AssertionError("the eager closure captured a graph")
        closed_tables[mode] = loop_arena_tables(system.arena)
        if graphs:
            captured = system
        del system, lc
    if len(sim3_eig) != len(SIM3_EIG_SITES):
        raise AssertionError("the eager closure's Sim3 RANSAC made no two "
                             "eigen-solves")
    (e_tab, e_dig), (g_tab, g_dig) = (closed_tables["eager"],
                                      closed_tables["graph"])
    differ = [k for k in e_tab
              if e_tab[k].numpy().tobytes() != g_tab[k].numpy().tobytes()]
    log(f"[loop-digest] the closed arena, eager sha256 {e_dig}, graph "
        f"{g_dig}: tables that differ {differ}")
    if differ:
        raise AssertionError(f"the graph closure's tables {differ} differ "
                             f"from the eager closure's")
    fl = captured.fused_loop
    fc, fg = fl.correction, fl.global_ba
    n_cap, n_rep = fl.captures, fl.replays
    c_cap, c_rep = fc.captures, fc.replays
    g_cap, g_rep = fg.captures, fg.replays
    restore_loop_system(captured, initial)
    lc, wall, closed = close_constructed_loop(cfg, captured, None, True)
    r_tab, r_dig = loop_arena_tables(captured.arena)
    log(f"[loop] replaying: the graph closure's arena restored in place and "
        f"closed again: {closed}; sha256 {r_dig}; {graph_counts_line(lc)}; "
        f"{fused_loop_line(captured)}")
    if (closed != [False, True] or r_dig != g_dig or fl.captures != n_cap
            or fl.replays != n_rep + 4 or fc.captures != c_cap
            or fc.replays != c_rep + 2 + LC.POSE_GRAPH_ITERS
            or fg.captures != g_cap or fg.replays != g_rep + LOOP_GBA_REPLAYS
            or lc.graph_counts["captures"]):
        raise AssertionError("the closure on the restored arena did not "
                             "replay graphs D (twice), M, S, C, the step, "
                             "F, B, P, L, X and W, capturing none, to the "
                             "same tables")
    del captured, lc
    walls, pools = {}, {}
    modes = (("eager", False), ("capturing", True), ("replaying", True))
    for mode, graphs in modes:
        if mode != "replaying":
            system = loop_system(cfg, "cuda", vocab, LOOP_POINTS, SEED + 7)
        else:
            restore_loop_system(system, initial)
        torch.cuda.reset_peak_memory_stats()
        parts = ("correction", "global_ba")
        before = [part_counts(system, p)[0] for p in parts]
        lc, wall, closed = close_constructed_loop(cfg, system, None, graphs)
        peak = peak_memory()
        walls[mode] = wall
        c_new, b_new = (part_counts(system, p)[0] - n
                        for p, n in zip(parts, before))
        first = mode == "capturing"
        if (c_new, b_new) != (LOOP_CORRECT_GRAPHS * first,
                              LOOP_GBA_GRAPHS * first):
            raise AssertionError(f"the warm {mode} closure captured {c_new} "
                                 f"correction and {b_new} global BA graphs")
        times = {k: [round(x * 1e3, 3) for x in v]
                 for k, v in lc.timings.items()}
        log(f"[loop] warm {mode} closure: {closed}; wall {wall:.3f} ms; "
            f"stage wall ms {times}; host reads {lc.reads}, eigen-solve "
            f"waits {lc.eigh_waits}; {graph_counts_line(lc)}; "
            f"{fused_loop_line(system)}; peak memory {peak}")
        if closed != [False, True]:
            raise AssertionError(f"the warm {mode} closure did not close")
        del lc
    del system
    profs, detects = {}, {}
    stages = LOOP_STAGES + LOOP_SIM3_SUBRANGES + LOOP_SUBRANGES
    for mode, graphs in modes:
        if mode != "replaying":
            fresh = loop_system(cfg, "cuda", vocab, LOOP_POINTS, SEED + 7)
        else:
            restore_loop_system(fresh, initial)
        pool0 = getattr(fresh.fused_loop, "capture_mib", 0.0)
        cpool0 = part_counts(fresh, "correction")[1]
        gpool0 = part_counts(fresh, "global_ba")[1]
        lc2 = LoopCloser(cfg, CubemapCamera.from_config(cfg, "cuda"))
        lc2.consistency_th = 1
        lc2.graphs = graphs
        detects[mode] = (profile_stages(lambda: lc2.process(fresh, 12),
                                        ("loop.detect",), 1),
                         lc2.reads, lc2.capture_waits)
        pool1 = getattr(fresh.fused_loop, "capture_mib", 0.0)
        prof = profile_stages(lambda: lc2.process(fresh, 13), stages, 1)
        pools[mode] = (pool1 - pool0,
                       getattr(fresh.fused_loop, "capture_mib", 0.0) - pool1,
                       part_counts(fresh, "correction")[1] - cpool0,
                       part_counts(fresh, "global_ba")[1] - gpool0)
        tag = f"loop-profile-{mode}"
        log_profile(tag, prof, [walls[mode]])
        allowed = lc2.reads + lc2.eigh_waits + lc2.capture_waits
        log(f"[{tag}] host reads {lc2.reads}, eigen-solve waits "
            f"{lc2.eigh_waits}, capture waits {lc2.capture_waits}; host "
            f"waits {prof['host_waits']:.0f}; {graph_counts_line(lc2)}; "
            f"{fused_loop_line(fresh)}")
        if not lc2.loop_edges:
            raise AssertionError(f"the profiled {mode} closure did not "
                                 f"close")
        d_prof, d_reads, d_waits = detects[mode]
        for tag_, p_, allowed_ in ((tag, prof, allowed),
                                   (f"{tag}-detect", d_prof,
                                    d_reads + d_waits)):
            if p_["host_waits"] > allowed_:
                raise AssertionError(
                    f"[{tag_}] waited {p_['host_waits']:.0f} times; its "
                    f"stated reads, eigen-solve waits and capture waits are "
                    f"{allowed_}")
        for st, most in (("loop.correct", LOOP_CORRECT_WAITS),
                         ("loop.gba", LOOP_GBA_WAITS)):
            waits = prof["stages"][st]["host_waits"]
            if mode == "replaying" and waits > most:
                raise AssertionError(f"the replaying closure's {st} waited "
                                     f"{waits:.0f} times; at most {most}")
        profs[mode] = prof
        del lc2
    del fresh
    for st, src, k in (("loop.detect", "detect", 0),
                       ("loop.sim3", "closure", 1),
                       ("loop.correct", "closure", 2),
                       ("loop.gba", "closure", 3)):
        for mode, _ in modes:
            v = (detects[mode][0] if src == "detect"
                 else profs[mode])["stages"][st]
            pool = pools[mode][k]
            log(f"[loop-{st[5:]}] {mode:10s}: host {v['host_ms']:.3f} ms, "
                f"device busy {v['device_busy_ms']:.3f} ms, "
                f"{v['device_ops']:.0f} device operations, "
                f"{v['host_waits']:.0f} host waits; pool MiB captured "
                f"{pool:.1f}")
    for st in stages:
        e, c, g = (profs[m]["stages"][st] for m, _ in modes)
        log(f"[loop-compare] {st:29s} eager / capturing / replaying: host "
            f"{e['host_ms']:.3f} / {c['host_ms']:.3f} / {g['host_ms']:.3f} "
            f"ms, device busy {e['device_busy_ms']:.3f} / "
            f"{c['device_busy_ms']:.3f} / {g['device_busy_ms']:.3f} ms, "
            f"{e['device_ops']:.0f} / {c['device_ops']:.0f} / "
            f"{g['device_ops']:.0f} device operations, "
            f"{e['host_waits']:.0f} / {c['host_waits']:.0f} / "
            f"{g['host_waits']:.0f} host waits")
    return seg_row, sim3_eig


def check_sym_eig_sim3(inputs, row):
    """The eigen-solve kernel on the Sim3 RANSAC's two Horn solves of the
    loop phase's eager closure (recorded as it ran): bitwise against
    ``sym_eig_ordered`` eagerly and from a CUDA graph (``eig_case``), timed
    (a wrapper call, the device's time from a graph, the plain version,
    ``torch.linalg.eigh`` of the same matrices) beside the bound. Adds them
    to the kernel's ``row`` as ``sim3_sites``."""
    sites = {}
    for site, A in zip(SIM3_EIG_SITES, inputs):
        A = A.contiguous()
        c = eig_case(f"loop, {site}", A)
        _, _, rot, sw, st = SE.sym_eig_ordered(A, counts=True)
        b_ms, b_by = eig_bound(A, rot, sw)
        v = sites[site] = dict(
            shape=list(A.shape), ms=time_ms(lambda: SE.sym_eig_cuda(A)),
            device_ms=graph_ms(lambda: SE.sym_eig_cuda(A)),
            plain_ms=wall_ms(lambda: SE.sym_eig_ordered(A)),
            library_ms=time_ms(lambda: torch.linalg.eigh(A)),
            library_wall_ms=wall_ms(lambda: torch.linalg.eigh(A)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=c["max_abs_err"],
            bitwise=c["bitwise"] and c["graph_bitwise"],
            mean_rotations=float(rot.double().mean()),
            max_sweeps=int(sw.max()), max_steps=int(st.max()))
        log(f"[sym_eig] {site} {tuple(A.shape)}: kernel {v['ms']:.5f} ms "
            f"(device {v['device_ms']:.5f}), plain {v['plain_ms']:.3f} ms, "
            f"library (eigh, waits) {v['library_ms']:.5f} ms (wall "
            f"{v['library_wall_ms']:.5f}); bound {b_ms:.6f} ms ({b_by}); "
            f"{v['mean_rotations']:.1f} rotations a matrix, at most "
            f"{v['max_sweeps']} sweeps ({v['max_steps']} steps)")
    row["sim3_sites"] = sites
    row["cases"] += [dict(name=f"loop, {k}", bitwise=v["bitwise"])
                     for k, v in sites.items()]
    row["max_abs_err"] = max(row["max_abs_err"],
                             *(v["max_abs_err"] for v in sites.values()))
    row["bitwise"] = row["bitwise"] and all(v["bitwise"]
                                            for v in sites.values())


def arena_gap(c, g):
    """(pose difference, 99% and largest landmark difference over the
    landmarks live in both, share of the live observation table equal) of
    two arenas on the CPU."""
    v = c.kf_valid
    dpose = max(float((c.kf_R - g.kf_R)[v].abs().max()),
                float((c.kf_t - g.kf_t)[v].abs().max()))
    live = c.lm_valid & g.lm_valid
    d = (c.lm_pos - g.lm_pos).abs().amax(dim=1)[live]
    obs_c, obs_g = c.kf_obs_lm[v], g.kf_obs_lm[v]
    either = (obs_c >= 0) | (obs_g >= 0)
    return (dpose, float(torch.quantile(d, 0.99)), float(d.max()),
            float((obs_c == obs_g)[either].float().mean()))


def small_loop_closure(cfg, dev, refined=None, graphs=True):
    """The small constructed-drift closure (``process`` on slots 12 and 13
    at consistency_th = 1) on ``dev`` with the global BA held back; on the
    card DetectLoop and ComputeSim3 replay the system's ``FusedLoop``
    unless ``graphs`` (``LoopCloser.graphs``) is off. Records, on the CPU,
    the closing ComputeSim3's ``LoopCloser.sim3_trace``: the RANSAC Sim3 (as
    the widening receives it) with its inlier count, the widened match
    count and the refinement's output. With ``refined`` (another run's
    refinement, on the CPU) the refinement stage returns that Sim3 in place
    of its own, in graph S too. Returns (what each call returned, the
    corrected arena on the CPU, the records, the closer)."""
    system = loop_system(cfg, dev, None, 500, SEED + 8)
    lc = LoopCloser(cfg, CubemapCamera.from_config(cfg, dev))
    lc.consistency_th = 1
    lc.graphs = graphs
    lc._global_ba = lambda system: None
    if refined is not None:
        given = tuple(x.to(dev) for x in refined)
        lc.k.refine_sim3 = lambda *args: given
    closed = [lc.process(system, slot) for slot in (12, 13)]
    tr = lc.sim3_trace
    rec = dict(ransac=[x.cpu() for x in tr["ransac"]],
               ransac_inliers=int(tr["ransac_inliers"]),
               widened=int(tr["widened"]),
               refined=[x.cpu() for x in tr["refined"]])
    return closed, system.arena.to("cpu"), rec, lc


def small_loop_reference_check(card="cuda"):
    """The constructed-drift closure at the tier-1 test's size (K=64, N=600,
    L=8192, 500 points) on the card against the CPU, in three parts.

    ComputeSim3: the RANSAC Sim3 within LOOP_REF_SIM3 with the same inlier
    count (each device draws its own sets; on this exact scene every
    all-inlier set gives the drift up to rounding), the widened and refined
    match counts equal, and the refined rotation and translation within
    LOOP_REF_SIM3; on the card ComputeSim3 replays graph S. The refined
    scale is not held: segment B revisits segment A's viewpoints exactly,
    so the loop keyframes' relative translation is of the order of 1e-7,
    the refinement sees the scale only through it (and the 1e-6 damping),
    and each device's rounding moves it its own way.

    The correction, from the CPU's refined Sim3 on both devices: both
    close, keyframe poses within LOOP_REF_CORRECT[0], the landmarks live in
    both within [1] for 99% and [2] for all, the live observation table
    equal on [3] of its entries. Then the global BA from the CPU's
    corrected arena on each device, within LOOP_REF_GBA (on the card
    through a ``FusedGlobalBA`` made for the solve, its graphs captured,
    as the main path's are): the card's scatter-adds sum in their own
    order, and LM and CG carry the difference along."""
    cfg = SlamConfig(**LOOP_SMALL)
    c_closed, c, c_rec, _ = small_loop_closure(cfg, "cpu")
    _, _, g_rec, _ = small_loop_closure(cfg, card)
    d_ransac = max(float((a - b).abs().max())
                   for a, b in zip(c_rec["ransac"], g_rec["ransac"]))
    d_rt = max(float((a - b).abs().max())
               for a, b in zip(c_rec["refined"][1:3], g_rec["refined"][1:3]))
    counts = {key: (c_rec[key], g_rec[key])
              for key in ("ransac_inliers", "widened")}
    counts["refined_inliers"] = (int(c_rec["refined"][4]),
                                 int(g_rec["refined"][4]))
    log(f"[ref-loop] ComputeSim3, card vs CPU: RANSAC Sim3 within "
        f"{d_ransac:.3g}; refined R, t within {d_rt:.3g} (bound "
        f"{LOOP_REF_SIM3}); refined scale CPU "
        f"{float(c_rec['refined'][0]):.6f}, card "
        f"{float(g_rec['refined'][0]):.6f} (RANSAC "
        f"{float(c_rec['ransac'][0]):.6f}); counts (CPU, card) {counts}")
    sim3_ok = (d_ransac < LOOP_REF_SIM3 and d_rt < LOOP_REF_SIM3
               and all(a == b for a, b in counts.values()))

    g_closed, g, _, _ = small_loop_closure(cfg, card,
                                           refined=c_rec["refined"])
    gap = arena_gap(c, g)
    log(f"[ref-loop] correction from the CPU's refined Sim3, card "
        f"{g_closed} vs CPU {c_closed}: |dpose| {gap[0]:.3g}; landmarks 99% "
        f"within {gap[1]:.3g}, max {gap[2]:.3g}; observation table equal on "
        f"{gap[3]:.5f} (bounds {LOOP_REF_CORRECT})")
    after = {}
    for dev in ("cpu", card):
        system = types.SimpleNamespace(arena=c.to(dev))
        LoopCloser(cfg, CubemapCamera.from_config(cfg, dev))._global_ba(
            system)
        after[dev] = system.arena.to("cpu")
    gap_b = arena_gap(after["cpu"], after[card])
    log(f"[ref-loop] global BA from the CPU's corrected arena, card vs CPU: "
        f"|dpose| {gap_b[0]:.3g}; landmarks 99% within {gap_b[1]:.3g}, max "
        f"{gap_b[2]:.3g}; observation table equal on {gap_b[3]:.5f} (bounds "
        f"{LOOP_REF_GBA})")

    def within(gap, bounds):
        return (gap[0] < bounds[0] and gap[1] < bounds[1]
                and gap[2] < bounds[2] and gap[3] >= bounds[3])

    if not (sim3_ok and c_closed == g_closed == [False, True]
            and within(gap, LOOP_REF_CORRECT) and within(gap_b, LOOP_REF_GBA)):
        raise AssertionError("card and CPU loop closures disagree")


# ---------------------------------------------------------------------------
# The dataset runner and the sharded global BA
# ---------------------------------------------------------------------------

def write_pgm(path, img) -> None:
    with open(path, "wb") as f:
        f.write(f"P5 {img.shape[1]} {img.shape[0]} 255\n".encode())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def centre_ate(idx, est, poses):
    """RMS distance of camera centres ``est`` of frames ``idx`` to the
    ground truth after a Sim3 alignment, and the path length between the
    first and last."""
    gt = S.camera_centres(poses)[idx]
    s, Ra, ta = horn_alignment(torch.as_tensor(gt, dtype=torch.float32),
                               torch.as_tensor(est, dtype=torch.float32))
    al = float(s) * (Ra.numpy() @ est.T).T + ta.numpy()
    return (float(np.sqrt(np.mean(np.sum((al - gt) ** 2, axis=1)))),
            float(np.linalg.norm(gt[-1] - gt[0])))


def app_phase(poses, frames, counters, settings="none", device=None):
    """``run_sequence.main`` over ``frames`` written as PGM with a Lafida
    list, with the launch counters set to 0 just before and read just
    after (each kernel entry once a frame). Checks the loader, that every
    frame from the first tracked one on was tracked (the system's
    ``track_fisheye`` results are recorded), and that the perf file's ratio
    says so, no loop, and the ATE of the tracked frames (the keyframes' ATE
    from the TUM file is printed). Returns the launches."""
    shutil.rmtree(APP_DIR, ignore_errors=True)
    APP_DIR.mkdir(parents=True)
    fps = (SlamConfig() if settings == "none" else
           load_config(settings)).fps
    lines = []
    for i, img in enumerate(frames):
        write_pgm(APP_DIR / f"frame_{i:04d}.pgm", img)
        lines.append(f"{i} {i / fps:.6f} frame_{i:04d}.pgm")
    (APP_DIR / "list.txt").write_text("\n".join(lines) + "\n")
    traj, perf = APP_DIR / "kf.tum", APP_DIR / "perf.txt"
    argv = [str(VOCAB_PATH), settings, str(APP_DIR), str(APP_DIR / "list.txt"),
            "none", str(traj), str(perf)]
    log(f"[app] python -m cubemapslam_tpu_torch.apps.run_sequence "
        f"{' '.join(argv)}")
    out = io.StringIO()
    # the pose the runner's system returned for each frame (None: lost)
    returned = []
    track = CubemapSLAM.track_fisheye

    def recorded(self, *args, **kwargs):
        T = track(self, *args, **kwargs)
        returned.append(T)
        return T

    zero_launches(counters)
    t0 = time.perf_counter()
    CubemapSLAM.track_fisheye = recorded
    try:
        with contextlib.redirect_stdout(out):
            rc = run_sequence.main(argv, device=device)
    finally:
        CubemapSLAM.track_fisheye = track
    wall = time.perf_counter() - t0
    launches = read_launches(counters, "app", len(frames))
    if not SEG_LAUNCHES["app"]["total"]:
        raise AssertionError("the runner's mapping launched no segmented "
                             "sum")
    if not TRI_LAUNCHES["app"]:
        raise AssertionError("the runner launched no triangulation kernel")
    for line in out.getvalue().splitlines():
        log(f"[app] | {line}")
    if rc != 0:
        raise AssertionError(f"run_sequence.main returned {rc}")
    loader = [ln for ln in out.getvalue().splitlines()
              if ln.startswith("image loader:")]
    kv = dict(ln.split() for ln in perf.read_text().splitlines())
    rows = [np.array(ln.split(), np.float64)
            for ln in traj.read_text().splitlines()]
    if list(kv) != ["median_tracking_time_s", "mean_tracking_time_s",
                    "tracked_frames_ratio", "loops_closed"] \
            or any(len(r) != 8 for r in rows) or len(rows) < 2:
        raise AssertionError("malformed perf or TUM file")
    kf_idx = [int(round(r[0] * fps)) for r in rows]
    kf_ate, kf_path = centre_ate(kf_idx, np.stack([r[1:4] for r in rows]),
                                 poses)
    tracked = [T is not None for T in returned]
    n = len(frames)
    first_ok = tracked.index(True) if True in tracked else n
    idx = [i for i, ok in enumerate(tracked) if ok]
    ate, path = centre_ate(idx, np.stack([
        -returned[i][:3, :3].T @ returned[i][:3, 3] for i in idx]), poses)
    ratio = float(kv["tracked_frames_ratio"])
    log(f"[app] {loader[0] if loader else 'no loader line'}; initialized at "
        f"frame {first_ok}; tracked ratio {ratio:.6f} (every frame from it "
        f"on: {(n - first_ok) / n:.6f}); loops {kv['loops_closed']}; median "
        f"frame {float(kv['median_tracking_time_s']) * 1e3:.3f} ms, mean "
        f"{float(kv['mean_tracking_time_s']) * 1e3:.3f} ms; ATE of the "
        f"tracked frames {ate:.5f} over {path:.5f} ({ate / path:.5f} of it; "
        f"bound {SLAM_ATE_FRAC}); {len(rows)} live keyframes in the TUM file "
        f"(frames {kf_idx}), their ATE {kf_ate / kf_path:.5f} of their path; "
        f"main's wall {wall:.1f} s")
    variant = next((c for c in native.CODECS
                    if native.load_library(c) is not None), None)
    log(f"[app] native loader variant: "
        f"{'PGM only' if variant == () else variant} (the first of "
        f"{native.CODECS} that builds and loads here)")
    if loader != ["image loader: NativeImageLoader"]:
        raise AssertionError(f"the native loader was not taken: {loader}")
    if first_ok >= SLAM_INIT_BY or not all(tracked[first_ok:]) \
            or len(tracked) != n or abs(ratio - (n - first_ok) / n) > 1e-6:
        raise AssertionError("not initialized in time, or a frame after "
                             "initialization was not tracked")
    if int(kv["loops_closed"]) != 0:
        raise AssertionError("the runner closed a loop on a trajectory that "
                             "revisits nothing")
    if not ate < SLAM_ATE_FRAC * path:
        raise AssertionError("the runner's trajectory is beyond the ATE "
                             "bound")
    return launches


def sharded_gap(res, ref, ref_inl, live_valid):
    """(pose difference, 99% and largest point difference, share of the
    live edges with the same inlier verdict) of a sharded solve's host
    result against the single-process one."""
    dpose = max(float((res["R"] - ref.R.cpu()).abs().max()),
                float((res["t"] - ref.t.cpu()).abs().max()))
    d = (res["X"] - ref.X.cpu()).abs().amax(dim=1)
    live = live_valid.cpu()
    same = (res["inl"] == ref_inl.cpu())[live].float().mean()
    return dpose, float(torch.quantile(d, 0.99)), float(d.max()), float(same)


def check_sharded(tag, res, ref, ref_inl, valid, ref_ms):
    gap = sharded_gap(res, ref, ref_inl, valid)
    log(f"[dist] {tag}: wall {res['wall_s'] * 1e3:.3f} ms against "
        f"{ref_ms:.3f} ms single-process; pose gap {gap[0]:.3e}, point gap "
        f"99% {gap[1]:.3e} / max {gap[2]:.3e}, inlier verdicts equal on "
        f"{gap[3]:.6f} of the live edges (bounds {DIST_REF})")
    if not (gap[0] < DIST_REF[0] and gap[1] < DIST_REF[1]
            and gap[2] < DIST_REF[2] and gap[3] >= DIST_REF[3]):
        raise AssertionError(f"the {tag} sharded solve disagrees with the "
                             "single-process one")


def single_solve(cam, sharded, dev):
    """The single-process solve of a sharded layout and its wall ms."""
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    ref, inl = bundle_adjust(cam, sharded.prob, phase_iters=DIST_PHASES,
                             solver="cg", cg_iters=DIST_CG_ITERS)
    sync()
    return ref, inl, (time.perf_counter() - t0) * 1e3


def dist_phase(cfg, dev="cuda", n_pts=LOOP_POINTS):
    """The sharded global BA of the loop phase's arena at world size 1 over
    NCCL in this process (gloo off the card) and 2 over gloo in two spawned
    ranks, each against the single-process solve of its layout."""
    vocab = PL.load_vocabulary(str(VOCAB_PATH), dev)
    arena = loop_system(cfg, dev, vocab, n_pts, SEED + 7).arena
    cam = CubemapCamera.from_config(cfg, dev)
    inv_s2 = 1.0 / torch.tensor(cfg.level_sigma2, dtype=torch.float32,
                                device=dev)
    prob = D.global_ba_problem_from_arena(cam, arena, inv_s2)
    keep = prob.obs_valid.nonzero()[:, 0]
    live = prob._replace(**{f: getattr(prob, f)[keep] for f in D.EDGE_FIELDS})
    M, P = prob.R.shape[0], prob.X.shape[0]
    log(f"[dist] the loop arena's global BA: {M} camera slots "
        f"({int(prob.cam_valid.sum())} live), {P} point slots "
        f"({int(prob.pt_valid.sum())} live), {keep.numel()} live edges of "
        f"{prob.obs_valid.numel()}; LM steps by phase {DIST_PHASES}, "
        f"{DIST_CG_ITERS} CG iterations each")

    # world size 1 over NCCL, in this process
    sharded = D.shard_ba_problem(live, 1, shard_points=True)
    ref, ref_inl, ref_ms = single_solve(cam, sharded, dev)
    backend = "nccl" if dev == "cuda" else "gloo"
    SG.SEG_SUM.launches = 0
    store_dir = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(f"{store_dir}/store", 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=DIST_TIMEOUT),
            device_id=torch.device(dev, 0) if dev == "cuda" else None)
        try:
            res = D.rank_bundle_adjust(D.make_mesh(), cam, sharded, dev,
                                       DIST_PHASES, DIST_CG_ITERS)
            launches = SG.SEG_SUM.launches
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    SEG_LAUNCHES["dist"] = {"total": launches}
    log(f"[dist] world size 1 over {backend}: boundary rows reduced each CG "
        f"iteration {sharded.n_boundary} (and the {M}x6 camera table); "
        f"seg_sum launches of the rank's solve {launches}")
    if not launches:
        raise AssertionError("the sharded BA launched no segmented sum")
    check_sharded(f"world size 1 ({backend})", res, ref, ref_inl,
                  sharded.prob.obs_valid, ref_ms)

    # world size 2 over gloo, two spawned ranks on the same device
    sharded = D.shard_ba_problem(live, 2, shard_points=True)
    ref, ref_inl, ref_ms = single_solve(cam, sharded, dev)
    host = sharded._replace(
        prob=BAProblem(*(t.cpu() for t in sharded.prob)),
        owner_shard=sharded.owner_shard.cpu())
    t0 = time.perf_counter()
    ranks = D.run_ranks(D.rank_bundle_adjust, 2,
                        args=(CubemapCamera.from_config(cfg, "cpu"), host, dev,
                              DIST_PHASES, DIST_CG_ITERS),
                        timeout=DIST_TIMEOUT,
                        workdir=str(ROOT / "build"))
    spawn_s = time.perf_counter() - t0
    log(f"[dist] world size 2 over gloo: {sharded.n_boundary} boundary rows "
        f"of {P} reduced each CG iteration (and the {M}x6 camera table); "
        f"edge blocks of {sharded.prob.obs_cam.numel() // 2}; ranks' walls "
        f"{[round(r['wall_s'] * 1e3, 3) for r in ranks]} ms; spawn to join "
        f"{spawn_s:.1f} s")
    for k in ("R", "t", "X", "inl"):
        if not torch.equal(ranks[0][k], ranks[1][k]):
            raise AssertionError(f"the two ranks' {k} differ")
    res = dict(ranks[0], wall_s=max(r["wall_s"] for r in ranks))
    check_sharded("world size 2 (gloo)", res, ref, ref_inl,
                  sharded.prob.obs_valid, ref_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_run = time.perf_counter()

    def done(phase):
        log(f"[time] {phase} done, {time.perf_counter() - t_run:.1f} s into "
            f"the run")

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    t_b = time.perf_counter()
    logs = _build.build_all(SOURCES)
    log(f"[build] {len(logs)} kernel sources built in "
        f"{time.perf_counter() - t_b:.1f} s")
    for src, text in logs.items():
        if src == "pose_lm.cu":
            for line in lm_ptxas_lines(text):
                log(f"[build] {src} {line}")
                size, _, info = line.partition(": ")
                LM_PTXAS.setdefault(int(size[2:]), []).append(info)
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    cfg = SlamConfig()
    t_s = time.perf_counter()
    tracker = FrameTracker(cfg)            # the card, by default
    torch.cuda.synchronize()
    log(f"[setup] FrameTracker at {cfg.cube_w}x{cfg.cube_h}, "
        f"{cfg.n_features} features, {cfg.n_levels} levels built in "
        f"{time.perf_counter() - t_s:.1f} s")
    frame = torch.as_tensor(synthetic_fisheye(cfg, SEED), device="cuda")

    rows = check_kernels(tracker, frame)
    done("kernel checks")
    # kernel D is two launches, each counted by its own wrapper
    counters = {"warp_remap": (warp_cuda.WARP_REMAP,),
                "orb_detect": (TE.ORB_FAST, TE.ORB_SELECT),
                "orb_describe": (TE.ORB_DESCRIBE,)}

    rng = np.random.default_rng(SEED)
    kp0 = tracker.extract(tracker.warp(frame))
    lms = landmarks_from_keypoints(kp0, N_LANDMARKS, rng, cfg.n_levels)
    log(f"[path] {int(kp0.valid.sum())} valid keypoints on frame 0; "
        f"{N_LANDMARKS} landmarks")
    starts = [perturbed_pose(rng, tracker.device) for _ in range(N_FRAMES)]
    zero_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    walls, cpus, results = drive_main_path(tracker, frame, lms, starts)
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    if pose_launches("frame_step", N_FRAMES) != N_FRAMES:
        raise AssertionError("the frame step did not launch the pose-LM "
                             "kernel once a frame")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check_results(results, cfg)
    log(f"[path] frame step wall ms (synchronised; graph F, captured on "
        f"the first): "
        f"{', '.join(f'{w:.3f}' for w in walls)}; median of the last "
        f"{N_FRAMES - 1} {float(np.median(walls[1:])):.3f}; host thread CPU "
        f"ms: {', '.join(f'{c:.3f}' for c in cpus)}; peak memory "
        f"{peak:.1f} MiB")
    for name, by_kernel in launches.items():
        log(f"[path] {name}: launches in {N_FRAMES} frames {by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * N_FRAMES:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in {N_FRAMES} frames on the main path")
    frame_step_twins(tracker, frame, lms, starts, results, walls)
    prof = profiled_frames(tracker, frame, lms, rng)
    log_profile("profile", prof, walls[1:])

    small_reference_check()
    done("frame step")

    t_launches, f_launches, pose_row = map_tracking_phase(cfg, counters)
    done("map tracking")
    slam, s_poses, s_frames, s_launches, g_launches, ate = slam_phase(
        cfg, counters)
    done("slam")
    if not TRI_INPUTS:
        raise AssertionError("the slam drive's mapping made no triangulation")
    tri_row = check_triangulate(TRI_INPUTS.pop(), slam.mapping)
    done("triangulate")
    r_launches = reloc_phase(slam, s_poses, s_frames, ate, counters)
    done("reloc")
    if len(EIG_INPUTS) != len(EIG_SITES):
        raise AssertionError("the reloc frame's PnP made no six eigen-solves")
    eig_row = check_sym_eig(EIG_INPUTS)
    if set(INIT_EIG_INPUTS) != {"rays", "E"}:
        raise AssertionError("the slam drive made no two-view RANSAC")
    eig_row["init_sites"] = check_sym_eig_init(INIT_EIG_INPUTS)
    done("sym_eig")
    l_launches, le_launches = localization_phase(slam, s_poses, s_frames, ate,
                                                 counters)
    done("localization")
    save_load_check(slam, s_poses, s_frames, ate)
    del slam
    small_reloc_reference_check()
    done("save/load and the reloc reference check")
    seg_row, sim3_eig = loop_phase(cfg)
    check_sym_eig_sim3(sim3_eig, eig_row)
    done("loop")
    small_loop_reference_check()
    done("the loop reference check")
    a_launches = app_phase(s_poses, s_frames, counters)
    done("app")
    del s_frames
    dist_phase(cfg)
    done("dist")

    for r in rows:
        r["launches"] = sum(launches[r["name"]].values())
        r["launches_by_kernel"] = launches[r["name"]]
        r["launches_tracking"] = sum(t_launches[r["name"]].values())
        r["launches_tracking_by_kernel"] = t_launches[r["name"]]
        r["launches_forced"] = sum(f_launches[r["name"]].values())
        r["launches_slam"] = sum(s_launches[r["name"]].values())
        r["launches_slam_by_kernel"] = s_launches[r["name"]]
        r["launches_repeat"] = sum(g_launches[r["name"]].values())
        r["launches_reloc"] = sum(r_launches[r["name"]].values())
        r["launches_localization"] = sum(l_launches[r["name"]].values())
        r["launches_localization_eager"] = sum(
            le_launches[r["name"]].values())
        r["launches_app"] = sum(a_launches[r["name"]].values())
    # the segmented sum runs a data-dependent number of times: on the slam
    # path (mapping and local BA), the loop closure, the runner and the
    # sharded BA, each counted from 0 around its drive
    seg_row["launches"] = SEG_LAUNCHES["slam"]["total"]
    seg_row["launches_by_path"] = SEG_LAUNCHES
    rows.append(seg_row)
    # the pose-LM kernel: one launch a solve, counted on each path
    pose_row["launches"] = POSE_LAUNCHES["frame_step"]
    pose_row["launches_by_path"] = POSE_LAUNCHES
    rows.append(pose_row)
    # the triangulation kernel: one launch a call, 6 a mapping step and 4 a
    # two-view reconstruction, counted on each path
    tri_row["launches"] = TRI_LAUNCHES["slam"]
    tri_row["launches_by_path"] = TRI_LAUNCHES
    rows.append(tri_row)
    # the eigen-solve kernel: 6 launches a relocalization candidate's PnP
    # and 3 a two-view attempt, counted on each path (reloc: one replaying
    # frame)
    eig_row["launches"] = EIG_LAUNCHES["reloc"]
    eig_row["launches_by_path"] = EIG_LAUNCHES
    rows.append(eig_row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
