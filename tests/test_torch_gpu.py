"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA card every test skips (decided in a fixture).
This file imports nothing of JAX, so it also runs on a machine without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: kernel W within 1e-3 of the plain resampler (it rounds each
product and sum as the plain version does, so it is bitwise in practice);
kernel D's candidates bitwise, subpixel offsets within 1e-6; the describe
kernel's angles within 1e-4 rad, bins on >= 99.5% of keypoints, bits where
the plain score is farther than 1e-2 from 0 (it sums in another order).
``MapTracker`` on the card against the CPU on one map: poses within 1e-3,
associations equal on >= 98% of matched rows, packed counts within 2%.
Kernels D and describe also at the init extractor's shape (6000
features), with the same tolerances. ``mapping_step`` and ``local_ba`` on
the card against the CPU on one small arena: integer views exactly equal,
poses within 1e-4, landmarks observed twice or more within 2e-3 for 99%
and 2e-2 for all. Place recognition on the card against the CPU:
``word_ids`` exactly equal, ``bow_vector`` rows within 1e-6 and
``detect_candidates`` the same candidates and flags; ``pnp_ransac`` with
the same CPU-drawn minimal sets: both succeed, inlier counts within 5%,
poses within 1 deg / 0.05 of the truth, and within 0.05 deg and 1e-3 of
each other when no match is scrambled. ``prefetch_image``'s tensor tracks
to the same pose as the host frame (1e-5). The constructed-drift loop
closure on the card against the CPU, with the bounds of ``chip_smoke.py``
(ComputeSim3, the correction from the CPU's refined Sim3, the global BA);
``sim3_ransac`` waits ``sim3.EIGH_WAITS`` = 0 times (two ``sym_eig``
launches); DetectLoop and ComputeSim3 through ``FusedLoop``'s graphs D, M
and S bitwise the eager closure (the same generator state, two reads
fewer; CorrectLoop through ``FusedCorrect``'s graphs C, the padded step
and F too, one read fewer; the global BA through ``FusedGlobalBA``'s
graphs B, P, L, X and W, the same reads; the global BA padded to its
edge capacity and to all K*N slots bitwise its compacted solve), a second
closure on the restored arena replaying them without a capture, a count that crosses into another
edge capacity capturing that step only (and a global BA whose live count
crosses into another capacity capturing that capacity's P, L, X and W
only), a replaced arena or BoW table raising,
``drop_loop_graphs`` forgetting the correction's graphs, and the kernel bitwise
against ``sym_eig_ordered`` on the Sim3 RANSAC's recorded (300,4,4) and
(1,4,4) solves. The segmented-sum
kernel at the main path's shapes (the global BA's camera and point sums,
the local BA's coupling and point sums, the pose graph's normal matrix, the
landmark normals with their dump row) and at the edge shapes of
``chip_smoke.SEG_EDGES`` (segments of 32, 33 and 2,049 rows, the lane
counts 1, 3, 6, 9, 18, 36 and 49, every row dropped, strided values, and
49-lane segments of 32 rows that overflow the kernel's staging room):
bitwise equal to its kernel-order plain version, two launches on one plan
bitwise equal, and within
len * 2^-23 * sum|v| of the CPU's ``index_add_`` per segment; strided
rows, one lane and no rows as their plain version. Run twice on the card
from one arena, bitwise equal: ``mapping_step`` with its BA, ``local_ba``,
the loop correction from the CPU's refined Sim3, the global BA, and the
pose graph, each also through its captured loop graph
(``CapturedLoop``: one capture a solve, a replay for every later
iteration, the same segmented-sum launches); ``CapturedLoop`` itself
advancing its state exactly n = 1, 2, 5 iterations (a counter and a
segmented sum, whose launches count on every replay) and raising on a body
that reads the host. ``MapTracker``'s frames through the captured CUDA graphs
(``runtime/fused_step.py``) bitwise equal to its eager frames over 8
frames and the forced branches (fallbacks, velocity gate, blank frame),
with one launch a frame of W, D's two entries and describe, captured anew
after ``seed``, and raising on a moved arena and on a capture that meets
a host read. ``CubemapSLAM``'s keyframe and deferred-BA frames through
graphs K and BA (``runtime/fused_mapping.py``) bitwise equal to its eager
frames over 12 frames from the first (keyframes into 5 slots), every
table and the mapping diagnostics at every frame, with every kernel's and
the segmented sum's launches equal frame by frame; ``insert_keyframe``,
``mapping_step`` (with and without BA) and ``ba_step`` with 0-d CUDA
tensors bitwise the calls with Python numbers; and a loop closed between
graph frames (forced on the fourth keyframe, against the one before it)
bitwise equal to an eager twin at every frame, the frames after it
replaying the graphs. The pose-LM kernel (``csrc/pose_lm.cu``) on a
cluster of 1, 2, 4 and 8 blocks against ``pose_optimization_ordered`` at
N = 1, 37, 2000 and 6000, on the CPU tests' seeded problems, past the
edges the cluster holds in registers and replayed from a CUDA graph: the same
iterations a round, R and t bitwise equal (1e-6 is the bound asked for),
the inlier masks equal; with no valid edge and no edge; each case failing
after LM_CASE_SECONDS if a cluster hangs; its wrapper raising on a device
mix, a strided input, a wrong dtype and a cluster size of 3 or 16; and
two launches a graph frame of ``MapTracker``. The triangulation kernel
(``csrc/triangulate.cu``) under 1, 4 and 6 pairs of N = 0, 1, 37, 2000,
6000 rows with degenerate rows: ungated against
``triangulate_rays_ordered`` on ``chip_smoke.tri_problem`` inputs (and a
zero baseline, zero pivots) and against its one-pair launches, within
``chip_smoke.TRI_REF_RTOL`` of the matmul path it replaced on rows of
wide parallax; gated against ``triangulate_gated_ordered`` on
``chip_smoke.tri_gated_problem`` inputs (points, masks, cosines and gate
counts); bitwise, NaN where NaN, eagerly and from a CUDA graph, one launch
a call; the gated launch's decisions against the eager gates it replaced
on the small map's mapping step, each row decided otherwise within
``chip_smoke.TRI_FLIP_ULPS`` of its gate; no build for CPU tensors; the
wrappers raising on a wrong dtype, shape or device and a strided input;
one launch a keyframe frame (graph K's replays included) and one a
two-view reconstruction. The eigen-solve kernel (``csrc/sym_eig.cu``) on
the six solves of a card ``pnp_ransac`` and on special matrices (ties,
zero, rank one, badly scaled, NaN and inf entries; batches of 1, 5, 8):
bitwise equal to ``sym_eig_ordered``, eagerly and from a CUDA graph, one
launch a call; against ``torch.linalg.eigh`` by the invariants of
``tests/test_torch_sym_eig.py``; its wrapper raising on a wrong size,
dtype or shape and launching nothing for an empty batch. ``pnp_ransac``
on the card making 0 host waits (6 launches of the kernel) and captured
in a CUDA graph bitwise equal to its eager calls; relocalization through
``FusedReloc``'s graphs R and W bitwise equal to the eager path on a map
loaded on the card, over relocalizing and blank frames; localization-mode
and LOST frames through ``FusedLocalization``'s graphs L1, L2, L3 and X
bitwise equal to the eager path on that map (plain, emptied-association,
perturbed and restored-landmark, blank and LOST frames), with the same
launches a frame. The eigen-solve kernel on a card two-view attempt's
solves ((200,9,9) float64 normal matrices, (200,3,3) and (1,3,3) EᵀE)
and float64 specials at n = 9, bitwise its ordered version, the null
vectors within 1e-4 of cuSOLVER's SVD of the 8x9 systems;
pre-initialization frames through ``FusedInit``'s graphs I0, I1 and I2
bitwise equal to the eager path across a reset that keeps them, with the
same ``sym_eig`` launches; a replaying attempt waiting only for its 2
reads and the upload, with ``torch.linalg.svd`` patched to raise.
"""

import faulthandler
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from cubemapslam_tpu_torch import SlamConfig
from cubemapslam_tpu_torch import warp as TW
from cubemapslam_tpu_torch import warp_cuda
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.geometry import so3_exp
from cubemapslam_tpu_torch.features import extractor as TE
from cubemapslam_tpu_torch.runtime import FrameTracker
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.fused_step import CapturedLoop
from cubemapslam_tpu_torch.runtime.tracking import MapTracker

pytestmark = pytest.mark.gpu

SMALL = dict(cube_face_w=128, cube_face_h=128, n_features=256, n_levels=4)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def textured(H, W, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (H // 4 + 1, W // 4 + 1)).astype(np.float32)
    img = np.kron(coarse, np.ones((4, 4), np.float32))[:H, :W]
    return img + rng.normal(0, 3, img.shape).astype(np.float32)


def tied(H, W):
    img = np.full((H, W), 40.0, np.float32)
    for y in range(-2, H, 23):
        for x in range(-1, W, 29):
            img[max(y, 0):y + 9, max(x, 0):x + 9] = 200.0
    return img


def test_warp_kernel(cuda):
    cfg = SlamConfig(**SMALL)
    wm = TW.build_warp_map(CubemapCamera.from_config(cfg, cuda), cfg.cube_w,
                           cfg.cube_h)
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.integers(0, 256, (cfg.fisheye_height,
                                                cfg.fisheye_width),
                                       dtype=np.uint8), device=cuda)
    n0 = warp_cuda.WARP_REMAP.launches
    out = warp_cuda.warp_to_cross(img, wm)
    torch.cuda.synchronize()
    assert warp_cuda.WARP_REMAP.launches == n0 + 1
    ref = TW.warp_bilinear(img, wm)
    assert float((out - ref).abs().max()) <= 1e-3
    assert (out[~wm.valid] == 0).all()
    with pytest.raises(ValueError):               # a map off the card
        warp_cuda.warp_to_cross(img, wm._replace(xy=wm.xy.cpu()))


def pyramid(img, n_levels, device):
    """The level images of ``img`` as the extractor makes them."""
    plan = TE.plan_levels(256, n_levels, 1.2, img.shape)
    t = torch.as_tensor(img, device=device)
    return [t] + [TE.pyramid_level(t, A, Bt)
                  for A, Bt in TE.pyramid_operators(plan.level_hw, device)]


@pytest.mark.parametrize("shape,cell,kind", [
    ((157, 201), 32, "textured"), ((150, 203), 32, "tied"),
    ((96, 130), 16, "textured"), ((1950, 1950), 32, "textured")])
def test_detect_kernel(cuda, shape, cell, kind):
    img = textured(*shape, seed=1) if kind == "textured" else tied(*shape)
    levels = pyramid(img, 8 if shape[0] > 1000 else 4, cuda)
    n0 = (TE.ORB_FAST.launches, TE.ORB_SELECT.launches)
    kern = TE.detect_cells_levels(levels, cell, 20, 7)
    torch.cuda.synchronize()
    assert (TE.ORB_FAST.launches, TE.ORB_SELECT.launches) == (n0[0] + 1,
                                                              n0[1] + 1)
    start = 0
    for lv in levels:
        plain = TE._detect_cells_plain(lv, cell, 20, 7)
        n = plain[0].shape[0]
        for a, b in zip(kern[:3], plain[:3]):
            assert a.dtype == b.dtype
            assert torch.equal(a[start:start + n], b)
        for a, b in zip(kern[3:], plain[3:]):
            assert float((a[start:start + n] - b).abs().max()) <= 1e-6
        start += n
    assert start == kern[0].shape[0]
    assert (kern[0] > 0).sum() > 10
    with pytest.raises(ValueError):               # no kernel for this cell
        TE.detect_cells_levels(levels, 8, 20, 7)


def unpack_bits(desc):
    shifts = torch.arange(32, device=desc.device)
    return ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256)


@pytest.mark.parametrize("case", ["edges", "levels"])
def test_describe_kernel(cuda, case):
    """Angles within 1e-4 rad (mod 2 pi), bins equal on >= 99.5% of the
    keypoints, and on those, bits equal wherever the plain score is farther
    than 1e-2 from 0: the kernel sums in another order than the plain
    version's dense product."""
    rng = np.random.default_rng(3)
    if case == "edges":        # keypoints clamped at the image's edges
        levels = [torch.as_tensor(textured(157, 201, seed=2), device=cuda)]
        H, W = levels[0].shape
        ys = np.concatenate([rng.integers(0, H, 300), [-5, 0, H - 1, H + 7]])
        xs = np.concatenate([rng.integers(0, W, 300), [2, -9, W + 3, W - 1]])
        level_k = [len(ys)]
    else:
        levels = pyramid(textured(400, 520, seed=5), 4, cuda)
        level_k = [200, 150, 100, 60]
        ys = np.concatenate([rng.integers(0, lv.shape[0], k)
                             for lv, k in zip(levels, level_k)])
        xs = np.concatenate([rng.integers(0, lv.shape[1], k)
                             for lv, k in zip(levels, level_k)])
    table = TE.desc_table(cuda)
    args = (levels, torch.as_tensor(ys, device=cuda),
            torch.as_tensor(xs, device=cuda), level_k, table)
    n0 = TE.ORB_DESCRIBE.launches
    ang, desc = TE.describe_keypoints(*args)
    torch.cuda.synchronize()
    assert TE.ORB_DESCRIBE.launches == n0 + 1
    ang_p, desc_p = TE._describe_plain(*args)
    d = torch.remainder(ang - ang_p + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) <= 1e-4
    bins = [torch.remainder(torch.round(a * (32 / (2 * np.pi))).long(), 32)
            for a in (ang, ang_p)]
    same = bins[0] == bins[1]
    assert float(same.float().mean()) >= 0.995
    K = len(ys)
    b = np.concatenate([[0], np.cumsum(level_k)])
    flat = TE._bf16_round(torch.cat([
        TE._gather_patches_plain(lv, args[1][b[i]:b[i + 1]],
                                 args[2][b[i]:b[i + 1]])
        for i, lv in enumerate(levels)]).reshape(K, -1))
    scores = (flat @ TE.desc_operator(cuda))[:, :32 * 256].reshape(
        K, 32, 256)[torch.arange(K, device=cuda), bins[1]]
    firm = (scores.abs() > 1e-2) & same[:, None]
    assert torch.equal(unpack_bits(desc)[firm], unpack_bits(desc_p)[firm])


def test_frame_tracker_card_against_cpu(cuda):
    cfg = SlamConfig(**SMALL)
    ref = FrameTracker(cfg, device="cpu")
    card = FrameTracker(cfg)                       # default: the card
    assert card.device == cuda
    card.set_warp_map(ref.warp_map)
    card.mask = ref.mask.to(cuda)
    img = torch.as_tensor(textured(cfg.fisheye_height, cfg.fisheye_width,
                                   seed=4).clip(0, 255).astype(np.uint8))
    kp0 = ref.extract(ref.warp(img))
    v = kp0.valid
    n = int(v.sum())
    gen = torch.Generator().manual_seed(0)
    lm_pos = kp0.rays[v] * (3 + 5 * torch.rand(n, 1, generator=gen))
    args = (img, lm_pos, kp0.desc[v], kp0.level[v],
            torch.ones(n, dtype=torch.bool), torch.eye(3),
            torch.tensor([0.01, 0.0, -0.01]))
    _, a_c, R_c, t_c, _, n_c = ref(*args)
    _, a_g, R_g, t_g, _, n_g = card(*[a.to(cuda) for a in args])
    assert float((R_c - R_g.cpu()).abs().max()) < 1e-3
    assert float((t_c - t_g.cpu()).abs().max()) < 1e-3
    matched = (a_c >= 0) | (a_g.cpu() >= 0)
    assert int(matched.sum()) > 50
    assert float((a_c == a_g.cpu())[matched].float().mean()) >= 0.98


@pytest.mark.parametrize("path", ["steady", "reference_kf"])
def test_map_tracker_card_against_cpu(cuda, path):
    """One map, built on the CPU, tracked over 2 frames by MapTracker on
    the CPU and on the card (same warp map and mask); ``reference_kf``
    empties the last association first, so both take the fallbacks."""
    cfg = SlamConfig(**SMALL, max_keyframes=16, max_landmarks=2048)
    ref = MapTracker(cfg, device="cpu")
    poses = S.forward_trajectory(12, step=0.04, yaw_rate=0.003)
    world = S.make_world(np.random.default_rng(11), n=500,
                         centers=S.camera_centres(poses), fx=64.0)
    S.build_map(ref, world, poses, 4, kf_stride=3)
    card = MapTracker(cfg)                         # default: the card
    assert card.device == cuda
    card.set_warp_map(ref.warp_map)
    card.mask = ref.mask.to(cuda)
    last = ref.last
    assoc = last.assoc if path == "steady" else torch.full_like(last.assoc,
                                                                -1)
    for tr in (ref, card):
        tr.seed(ref.arena, last.kp, assoc, last.outlier, last.R, last.t,
                last.ref_kf, frame_id=last.frame_id)
    render = S.Renderer(ref.cam, cfg)
    for i in (10, 11):
        img = S.to_u8(render.render(*world, *poses[i])[0])
        T_c, T_g = ref.track_fisheye(img, i / 30.0), card.track_fisheye(
            img, i / 30.0)
        assert T_c is not None and T_g is not None
        assert np.abs(T_c - T_g).max() < 1e-3
        r_c, r_g = ref.metrics[-1], card.metrics[-1]
        assert r_c["path"] == r_g["path"]
        for k in ("matches", "inliers_mm", "inliers", "local_matched"):
            assert abs(r_c[k] - r_g[k]) <= 0.02 * r_c[k]
        a_c, a_g = ref.last.assoc, card.last.assoc.cpu()
        matched = (a_c >= 0) | (a_g >= 0)
        assert float((a_c == a_g)[matched].float().mean()) >= 0.98
    if path == "reference_kf":
        assert "reference_kf" in card.metrics[0]["path"]


def test_init_extractor_shape(cuda):
    """Kernels D and describe at the init extractor's shape
    (``n_features * init_features_factor`` = 6000 at ``SlamConfig()``),
    on a textured full-size cross, against their plain versions, with the
    tolerances above."""
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, cuda)
    ext, plan = TE.build_extractor(cfg, cam,
                                   cfg.n_features * cfg.init_features_factor,
                                   (cfg.cube_h, cfg.cube_w))
    assert sum(plan.level_k) == 6000
    img = torch.as_tensor(textured(cfg.cube_h, cfg.cube_w, seed=6),
                          device=cuda)
    ops = ext.ops
    levels = [img] + [TE.pyramid_level(img, A, Bt) for A, Bt in ops.pyr]
    cands = TE.detect_cells_levels(levels, plan.cell, cfg.ini_th_fast,
                                   cfg.min_th_fast)
    start = 0
    for lv in levels:
        plain = TE._detect_cells_plain(lv, plan.cell, cfg.ini_th_fast,
                                       cfg.min_th_fast)
        n = plain[0].shape[0]
        for a, b in zip(cands[:3], plain[:3]):
            assert torch.equal(a[start:start + n], b)
        start += n
    ys, xs, _, _, _ = TE._select_levels(cands, ops.sel_index, ops.sel_take)
    assert ys.shape[0] == 6000
    args = (levels, ys, xs, plan.level_k, ops.desc_table)
    ang, desc = TE.describe_keypoints(*args)
    ang_p, desc_p = TE._describe_plain(*args)
    d = torch.remainder(ang - ang_p + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) <= 1e-4
    bins = [torch.remainder(torch.round(a * (32 / (2 * np.pi))).long(), 32)
            for a in (ang, ang_p)]
    assert float((bins[0] == bins[1]).float().mean()) >= 0.995


def mapping_snapshot():
    """A small map of the port's own (CubemapSLAM on the CPU over 9
    rendered frames, 160^2 faces, 600 features) just before its last
    mapping step: (config, arena on the CPU, slot, keyframe counter,
    frame id)."""
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    cfg = SlamConfig(cube_face_w=160, cube_face_h=160, n_features=600,
                     n_levels=3, max_keyframes=24, max_landmarks=4096,
                     min_init_keypoints=80, min_init_matches=60,
                     min_track_inliers=20, fps=5.0)
    poses = S.forward_trajectory(9)
    world = S.make_world(np.random.default_rng(5), n=600,
                         centers=S.camera_centres(poses), fx=80.0)
    return (cfg,) + S.arena_before_last_mapping(
        CubemapSLAM(cfg, device="cpu"), world, poses)


INTEGER = ("kf_valid", "kf_frame_id", "kf_face", "kf_level", "kf_desc",
           "kf_kp_valid", "kf_obs_lm", "lm_valid", "lm_desc", "lm_visible",
           "lm_found", "lm_first_kf", "lm_birth", "lm_first_frame")


@pytest.mark.parametrize("stage", ["mapping_step", "local_ba"])
def test_mapping_card_against_cpu(cuda, stage):
    """``mapping_step`` (without BA) and ``local_ba`` on the same small
    arena on the card and on the CPU: the integer views exactly equal,
    poses within 1e-4, landmarks observed twice or more within 2e-3 for 99%
    and 2e-2 for all (float32 LM rounds differently on the two devices)."""
    from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
    cfg, arena, slot, n_kf, fid = mapping_snapshot()
    outs = []
    for dev in ("cpu", cuda):
        mk = MappingKernels(cfg, device=dev)
        a = arena.to(dev)
        if stage == "mapping_step":
            a, info = mk.mapping_step(a, slot, n_kf, fid, max_cams=5,
                                      run_ba=False)
            assert int(info[2]) > 50
        else:
            a, _ = mk.local_ba(a, slot, 5)
        outs.append(a.to("cpu"))
    c, g = outs
    for k in INTEGER:
        assert torch.equal(getattr(c, k), getattr(g, k)), k
    assert float((c.kf_R - g.kf_R).abs().max()) < 1e-4
    assert float((c.kf_t - g.kf_t).abs().max()) < 1e-4
    obs = c.kf_obs_lm[c.kf_valid]
    cnt = torch.bincount(obs[obs >= 0], minlength=c.n_lm_cap)
    held = (cnt >= 2) & c.lm_valid
    d = (c.lm_pos - g.lm_pos).abs().amax(dim=1)[held]
    assert float(torch.quantile(d, 0.99)) < 2e-3 and float(d.max()) < 2e-2


VOCAB = pathlib.Path(__file__).resolve().parents[1] / "artifacts" / \
    "vocab_synth_10k.npz"


def flipped(desc, rng, n):
    """(N, 8) uint32 descriptors with ``n`` random bits flipped in each."""
    out = desc.copy()
    rows = np.repeat(np.arange(len(out)), n)
    np.bitwise_xor.at(out, (rows, rng.integers(0, 8, len(rows))),
                      np.uint32(1) << rng.integers(0, 32, len(rows))
                      .astype(np.uint32))
    return out


def test_place_card_against_cpu(cuda):
    from cubemapslam_tpu_torch import interop
    from cubemapslam_tpu_torch import place as PL
    rng = np.random.default_rng(8)
    voc = PL.load_vocabulary(str(VOCAB), "cpu")
    voc_g = voc.to(cuda)
    d = interop.desc_from_numpy(rng.integers(0, 2 ** 32, (500, 8),
                                             dtype=np.uint32))
    valid = torch.as_tensor(rng.uniform(size=500) < 0.9)
    assert torch.equal(PL.word_ids(voc, d), PL.word_ids(voc_g, d.to(cuda))
                       .cpu())
    b_c = PL.bow_vector(voc, d, valid)
    b_g = PL.bow_vector(voc_g, d.to(cuda), valid.to(cuda)).cpu()
    assert float((b_c - b_g).abs().max()) <= 1e-6
    K = 32
    query = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    kf = [rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
          for _ in range(K)]
    for slot, n in ((5, 1), (6, 2), (17, 1), (23, 2)):
        kf[slot] = flipped(query, rng, n)
    ones = torch.ones(K, 300, dtype=torch.bool)
    table = PL.bow_vectors(voc, interop.desc_from_numpy(np.stack(kf)), ones)
    qb = PL.bow_vector(voc, interop.desc_from_numpy(flipped(query, rng, 1)),
                       ones[0])
    kf_valid = torch.ones(K, dtype=torch.bool)
    kf_valid[[11, 30, 31]] = False
    covis = np.triu(rng.integers(0, 4, (K, K)), 1)
    covis = covis + covis.T
    covis[5, 6] = covis[6, 5] = covis[17, 23] = covis[23, 17] = 40
    args = (qb, table, kf_valid, torch.zeros(K, dtype=torch.bool),
            torch.as_tensor(covis))
    i_c, ok_c = PL.detect_candidates(*args, 0.0)
    i_g, ok_g = PL.detect_candidates(*(x.to(cuda) for x in args), 0.0)
    assert ok_c.any() and torch.equal(ok_c, ok_g.cpu())
    assert torch.equal(i_c[ok_c], i_g.cpu()[ok_c])


def test_minimal_sets_from_a_host_generator(cuda):
    """A host generator gives the card the host's minimal sets: the same
    draws, and so the same sets, as on the CPU."""
    from cubemapslam_tpu_torch.solvers.sampling import sample_minimal_sets
    valid = torch.as_tensor(np.random.default_rng(4).uniform(size=600) > 0.3)
    host = sample_minimal_sets(torch.Generator().manual_seed(5), valid, 300,
                               8)
    card = sample_minimal_sets(torch.Generator().manual_seed(5),
                               valid.to(cuda), 300, 8)
    assert card.device.type == "cuda" and torch.equal(card.cpu(), host)


@pytest.mark.parametrize("n_out", [0, 45, 90])
def test_pnp_ransac_card_against_cpu(cuda, n_out):
    """With no scrambled match the two poses agree; with scrambled ones each
    hypothesis starts from a null basis of its own (the ``sym_eig`` kernel's
    Jacobi basis on the card, LAPACK's on the CPU), so both are held to the
    outcome: success, inlier counts within 5%, the truth within 1 deg /
    0.05."""
    from cubemapslam_tpu_torch import camera as C
    from cubemapslam_tpu_torch.geometry import so3_exp, so3_log
    from cubemapslam_tpu_torch.solvers import pnp as PNP
    from cubemapslam_tpu_torch.solvers.sampling import sample_minimal_sets
    cfg = SlamConfig()
    rng = np.random.default_rng(n_out)
    pw = torch.as_tensor(rng.uniform(-3.0, 3.0, (150, 3)).astype(np.float32))
    pw[:, 2] += 5.0
    R = so3_exp(torch.tensor([0.15, 0.25, -0.2]))
    t = torch.tensor([-0.3, 0.1, 0.5])
    pc = pw @ R.T + t
    rays = pc / torch.linalg.norm(pc, dim=1, keepdim=True)
    cams = [CubemapCamera.from_config(cfg, d) for d in ("cpu", cuda)]
    uv, face = C.ray_to_cubemap(cams[0], rays)
    valid = face != C.UNKNOWN_FACE
    if n_out:
        idx = rng.choice(np.nonzero(valid.numpy())[0], n_out, replace=False)
        perm = torch.as_tensor(rng.permutation(idx))
        idx = torch.as_tensor(idx)
        rays[idx], uv[idx] = rays[perm].clone(), uv[perm].clone()
    sets = sample_minimal_sets(torch.Generator().manual_seed(0), valid, 300,
                               PNP.MIN_SET)
    out = []
    for cam in cams:
        r = PNP.pnp_ransac(cam, None, *(x.to(cam.device) for x in (
            pw, rays, uv, torch.ones(150), valid)), sets=sets)
        assert bool(r.success)
        out.append((r.R.cpu(), r.t.cpu(), int(r.n_inliers)))
    assert abs(out[0][2] - out[1][2]) <= 0.05 * out[0][2]
    pairs = [(out[0], (R, t)), (out[1], (R, t))]
    if not n_out:
        pairs.append((out[0], out[1]))
    for (R1, t1, *_), (R2, t2, *_) in pairs:
        ang = math.degrees(float(torch.linalg.norm(so3_log(R1 @ R2.T))))
        dist = float(torch.linalg.norm(t1 - t2))
        if R2 is R:
            assert ang < 1.0 and dist < 0.05
        else:
            assert ang < 0.05 and dist < 1e-3


def test_prefetch_image_feeds_track_fisheye(cuda):
    """``prefetch_image`` returns the frame as a uint8 tensor on the card,
    which ``track_fisheye`` takes as it is: the pose equals the one from
    the host array, within 1e-5."""
    cfg = SlamConfig(**SMALL, max_keyframes=16, max_landmarks=2048)
    ref = MapTracker(cfg, device="cpu")
    poses = S.forward_trajectory(12, step=0.04, yaw_rate=0.003)
    world = S.make_world(np.random.default_rng(11), n=500,
                         centers=S.camera_centres(poses), fx=64.0)
    S.build_map(ref, world, poses, 4, kf_stride=3)
    img = S.to_u8(S.Renderer(ref.cam, cfg).render(*world, *poses[10])[0])
    out = []
    for prefetch in (True, False):
        card = MapTracker(cfg)
        card.set_warp_map(ref.warp_map)
        card.mask = ref.mask.to(cuda)
        last = ref.last
        card.seed(ref.arena, last.kp, last.assoc, last.outlier, last.R,
                  last.t, last.ref_kf, frame_id=last.frame_id)
        frame = img
        if prefetch:
            frame = card.prefetch_image(img)
            assert frame.device == cuda and frame.dtype == torch.uint8
            assert torch.equal(frame.cpu(), torch.as_tensor(img))
        out.append(card.track_fisheye(frame, 10 / 30.0))
    assert out[0] is not None and np.abs(out[0] - out[1]).max() < 1e-5


def test_loop_closure_card_against_cpu(cuda):
    """``chip_smoke.small_loop_reference_check`` on the card: the
    constructed-drift closure at the tier-1 test's size against the CPU,
    ComputeSim3 (RANSAC and the refined rotation and translation within
    1e-4, equal match counts), the correction from the CPU's refined Sim3
    (poses within 1e-4, landmarks within 1e-3 for 99% and 1e-2 for all, the
    observation table equal on 99.5%) and the global BA from the CPU's
    corrected arena (poses within 1e-5, landmarks within 1e-3 / 5e-3); the
    reasons are in ``chip_smoke.py``. On the card the closing call reads 6
    times (detection, ComputeSim3's two reads through ``FusedLoop``, the
    pose graph's edge count through ``FusedCorrect``, whose statistics read
    nothing) and synchronizes twice to time its last stages (the global
    BA, held back here, reads once more); its Sim3 RANSAC waits 0 times
    (the ``sym_eig`` kernel)."""
    chip_smoke.small_loop_reference_check(card=cuda)
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    closed, _, _, lc = chip_smoke.small_loop_closure(cfg, cuda)
    assert closed == [False, True]
    assert (lc.reads, lc.eigh_waits) == (6, 0)


def test_sim3_ransac_eigh_waits(cuda):
    """One ``sim3_ransac`` on the card waits ``sim3.EIGH_WAITS`` = 0 times
    (its two Horn eigen-solves are launches of the ``sym_eig`` kernel),
    counted as ``chip_smoke.py`` counts host waits."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from cubemapslam_tpu_torch import camera as TC
    from cubemapslam_tpu_torch.geometry import so3_exp
    from cubemapslam_tpu_torch.solvers import sim3 as S3
    cfg = SlamConfig()
    cam_c = CubemapCamera.from_config(cfg, "cpu")
    rng = np.random.default_rng(3)
    p2 = torch.as_tensor(rng.uniform(-3, 3, (500, 3)).astype(np.float32))
    p2[:, 2] += 5.0
    R = so3_exp(torch.tensor([0.1, 0.2, -0.05]))
    p1 = 1.3 * p2 @ R.T + torch.tensor([0.5, -0.3, 0.2])
    uv1, f1 = TC.ray_to_cubemap(cam_c, p1)
    uv2, f2 = TC.ray_to_cubemap(cam_c, p2)
    valid = (f1 >= 0) & (f2 >= 0)
    args = [x.to(cuda) for x in (p1, p2, uv1, uv2, torch.ones(500),
                                 torch.ones(500), valid)]
    cam = CubemapCamera.from_config(cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    from cubemapslam_tpu_torch.solvers import sym_eig as SE
    S3.sim3_ransac(cam, gen, *args)
    torch.cuda.synchronize()
    n0 = SE.SYM_EIG.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("sim3"):
            res = S3.sim3_ransac(cam, gen, *args)
        torch.cuda.synchronize()
    assert SE.SYM_EIG.launches == n0 + 2
    ev = prof.events()
    span = [(e.time_range.start, e.time_range.end) for e in ev
            if e.name == "sim3" and e.device_type == DeviceType.CPU]
    waits = [e for e in ev if e.device_type == DeviceType.CPU
             and ("Synchronize" in e.name or e.name == "cudaMemcpy")
             and any(a <= e.time_range.start < b for a, b in span)]
    assert len(waits) == S3.EIGH_WAITS == 0, [e.name for e in waits]
    assert bool(res.success) and abs(float(res.s12) - 1.3) < 1e-3


@pytest.mark.parametrize("name", list(chip_smoke.SEG_SHAPES)
                         + list(chip_smoke.SEG_EDGES))
def test_seg_sum_kernel_bitwise(cuda, name):
    """The segmented-sum kernel bitwise equal to its kernel-order plain
    version on the card, two launches on one plan bitwise equal, and within
    len * 2^-23 * sum|v| of the CPU's index_add_ (its own summation
    order), at the main path's shapes and the edge shapes (segments of 32,
    33 and 2,049 rows, each lane count of the call sites, every row
    dropped, strided values)."""
    from cubemapslam_tpu_torch import segment as SG
    plan, v = chip_smoke.seg_case(name, cuda)
    n0 = SG.SEG_SUM.launches
    a = SG.segment_sum(plan, v)
    b = SG.segment_sum(plan, v)
    torch.cuda.synchronize()
    assert SG.SEG_SUM.launches == n0 + 2
    ref = SG.segment_sum_ordered(plan, v)
    assert a.shape == ref.shape == (plan.n,) + tuple(v.shape[1:])
    assert torch.equal(a, ref) and torch.equal(a, b)
    idx_c, v_c = plan.idx.cpu(), v.cpu()
    cpu = SG.segment_sum(SG.SegmentPlan(idx_c, plan.n), v_c)
    lens = torch.bincount(idx_c, minlength=plan.n + 1)[:plan.n].float()
    mag = SG.segment_sum(SG.SegmentPlan(idx_c, plan.n), v_c.abs())
    bound = lens.view((-1,) + (1,) * (v.dim() - 1)) * 2.0 ** -23 * mag
    assert bool(((a.cpu() - cpu).abs() <= bound).all())


def test_seg_sum_kernel_strided_and_empty(cuda):
    """Rows read through strides (a transposed view), one lane, no rows at
    all: each as its plain version."""
    from cubemapslam_tpu_torch import segment as SG
    rng = np.random.default_rng(1)
    idx = torch.as_tensor(rng.integers(0, 40, 3000)).to(cuda)
    plan = SG.SegmentPlan(idx, 40)
    lanes = torch.as_tensor(rng.normal(size=(9, 3000)).astype(
        np.float32)).to(cuda)
    assert torch.equal(SG.segment_sum(plan, lanes.T),
                       SG.segment_sum_ordered(plan, lanes.T.contiguous()))
    assert torch.equal(SG.segment_sum(plan, lanes[0]),
                       SG.segment_sum_ordered(plan, lanes[0]))
    empty = SG.SegmentPlan(torch.zeros(0, dtype=torch.int64, device=cuda), 5)
    out = SG.segment_sum(empty, torch.zeros(0, 7, device=cuda))
    assert torch.equal(out, torch.zeros(5, 7, device=cuda))


def _lm_cases():
    return ([("full", n, 1) for n in (1,) + chip_smoke.LM_SIZES]
            + [("small", 300, seed) for seed in chip_smoke.LM_SEEDS])


# seconds a pose-LM case may take once the kernel is built: the kernel's
# cluster barrier waits for every block, so a block that left a round on
# another pass would hang the card; the case then fails (the process exits
# with a traceback) instead of eating the suite's clock
LM_CASE_SECONDS = 120


@pytest.fixture
def lm_hang_limit(cuda):
    """Build the pose-LM kernel, then fail the case if it runs longer than
    LM_CASE_SECONDS."""
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    PO.POSE_LM.build()
    faulthandler.dump_traceback_later(LM_CASE_SECONDS, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _lm_check(cam, args, cluster, graph=False):
    """The kernel on ``cluster`` blocks against
    ``pose_optimization_ordered``: one launch a call (with ``graph``, a
    warm-up call, then the call captured in a CUDA graph, its outputs
    overwritten and the graph replayed), the iterations of each round
    equal, R, t, the inlier mask and its count bitwise equal. Returns the
    kernel's (R, t, inl, n_inl, iters)."""
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    n0 = PO.POSE_LM.launches
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            PO.pose_lm(cam, *args, cluster=cluster)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = PO.pose_lm(cam, *args, cluster=cluster)
        for x in out:
            x.fill_(7)
        g.replay()
        torch.cuda.synchronize()
        assert PO.POSE_LM.launches == n0 + 2
    else:
        out = PO.pose_lm(cam, *args, cluster=cluster)
        torch.cuda.synchronize()
        assert PO.POSE_LM.launches == n0 + 1
    R, t, inl, n_inl, iters = out
    ref = PO.pose_optimization_ordered(cam, *args)
    assert torch.equal(iters.long(), ref[4].long()), (iters, ref[4])
    assert torch.equal(R, ref[0]) and torch.equal(t, ref[1])
    assert torch.equal(inl, ref[2]) and int(n_inl) == int(ref[3])
    return out


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("size,n,seed", _lm_cases())
def test_pose_lm_kernel(cuda, lm_hang_limit, size, n, seed, cluster):
    """The pose-LM kernel (``csrc/pose_lm.cu``) on a cluster of 1, 2, 4 and
    8 blocks against ``pose_optimization_ordered`` on the card: seeded
    problems at N = 1, 37, 2000 and 6000 on ``SlamConfig()``'s faces, and
    the CPU tests' seeded problems (N = 300, 128^2 faces). One launch a
    solve; the iterations of each round equal; R and t bitwise equal (the
    bound asked for is 1e-6; the kernel rounds every product and sum as the
    plain version does, in the same order at every cluster size, so
    equality is reached and held), the inlier mask and its count equal."""
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    cfg = SlamConfig() if size == "full" else SlamConfig(cube_face_w=128,
                                                         cube_face_h=128)
    cam = CubemapCamera.from_config(cfg, cuda)
    args = chip_smoke.lm_problem(cfg, n, seed, cuda)
    R, t, inl, n_inl, _ = _lm_check(cam, args, cluster)
    if n >= 37:
        assert int(n_inl) > 0.6 * n
    if cluster == PO.LM_CLUSTER:
        out = PO.pose_optimization(cam, *args)
        assert all(torch.equal(a, b) for a, b in zip(out, (R, t, inl, n_inl)))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_pose_lm_edge_cases(cuda, lm_hang_limit, cluster):
    """No valid edge (the pose unchanged, no inlier) and no edge at all, on
    a cluster of 1, 2, 4 and 8 blocks."""
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, cuda)
    args = list(chip_smoke.lm_problem(cfg, 37, 4, cuda))
    args[6] = torch.zeros_like(args[6])
    for case in (args, [a[:0] if k >= 2 else a for k, a in enumerate(args)]):
        R, t, inl, n_inl, iters = _lm_check(cam, case, cluster)
        assert torch.equal(R, case[0]) and torch.equal(t, case[1])
        assert int(n_inl) == 0 and not bool(inl.any())
        assert iters.tolist() == [10] * 4


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_pose_lm_past_register_cache(cuda, lm_hang_limit, cluster):
    """More edges than the cluster holds in registers at any cluster size
    (4 a thread: 8192 at C = 8): the kernel reads the rest from device
    memory on every pass, in the same order, and stays bitwise its plain
    version."""
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, cuda)
    _lm_check(cam, chip_smoke.lm_problem(cfg, 9193, 6, cuda), cluster)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_pose_lm_graph_replay(cuda, lm_hang_limit, cluster):
    """The cluster launch captured in a CUDA graph and replayed: bitwise
    its plain version."""
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, cuda)
    _lm_check(cam, chip_smoke.lm_problem(cfg, 2000, 7, cuda), cluster,
              graph=True)


def test_pose_lm_wrapper_raises(cuda):
    """The kernel's wrapper raises on a CPU/CUDA mix, a non-contiguous
    input, a wrong dtype and a cluster size outside 1, 2, 4, 8; it launches
    nothing then."""
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, cuda)
    args = list(chip_smoke.lm_problem(cfg, 100, 5, cuda))
    n0 = PO.POSE_LM.launches
    mixed = args[:2] + [args[2].cpu()] + args[3:]
    wide = torch.zeros((100, 4), device=cuda)
    wide[:, :3] = args[2]
    strided = args[:2] + [wide[:, :3]] + args[3:]
    int32 = args[:3] + [args[3].int()] + args[4:]
    for bad in (mixed, strided, int32):
        with pytest.raises(ValueError):
            PO.pose_optimization(cam, *bad)
    for cluster in (3, 16):
        with pytest.raises(ValueError):
            PO.pose_lm(cam, *args, cluster=cluster)
    assert PO.POSE_LM.launches == n0


def _tri_cases():
    return ([("mixed", n, B) for B in chip_smoke.TRI_PAIRS
             for n in chip_smoke.TRI_SIZES]
            + [("zero_baseline", 2000, 1), ("axis", 2000, 1)])


@pytest.mark.parametrize("kind,n,pairs", _tri_cases())
def test_triangulate_kernel_bitwise(cuda, kind, n, pairs):
    """The triangulation kernel (``csrc/triangulate.cu``), ungated, on
    ``chip_smoke.tri_problem`` inputs under 1, 4 and 6 pairs: N = 0, 1, 37,
    2000 and 6000 with parallel, axis-aligned and NaN rows, a zero
    baseline, and an identity rotation whose axis-aligned rows meet zero
    pivots. Against ``triangulate_rays_ordered`` bitwise (NaN where NaN),
    from one launch and from a CUDA graph replay, and against the one-pair
    launches; one launch a call (none at N = 0); within
    ``chip_smoke.TRI_REF_RTOL`` of the matmul path it replaced on the rows
    of wide parallax (``chip_smoke.tri_case`` raises otherwise)."""
    from cubemapslam_tpu_torch.solvers import triangulate as TT
    args = chip_smoke.tri_problem(n, chip_smoke.SEED + 6, cuda, kind, pairs)
    c = chip_smoke.tri_case(f"{kind}, {pairs} x {n} rows", args)
    assert c["bitwise"] and c["graph_bitwise"] and c["per_pair_bitwise"]
    assert c["launches"] == (1 if n else 0)
    n0 = TT.TRIANGULATE.launches
    X = TT.triangulate_pairs(*args)
    assert TT.TRIANGULATE.launches == n0 + (1 if n else 0)
    assert chip_smoke.same_float_bits(X, TT.triangulate_rays_ordered(*args))
    if kind == "mixed" and n >= 37:
        assert not torch.isfinite(X[:, 4::16]).all(-1).any()
        assert torch.isfinite(X[:, 6::16]).all()


@pytest.mark.parametrize("pairs", [1, 4, 6])
@pytest.mark.parametrize("n", [0, 1, 37, 2000, 6000])
def test_triangulate_gated_kernel_bitwise(cuda, pairs, n):
    """The gated form on ``chip_smoke.tri_gated_problem`` inputs (1, 4, 6
    neighbours; N = 0, 1, 37, 2000, 6000; parallel, NaN and axis-aligned
    rows, out-of-range levels, a short baseline): world points, masks,
    parallax cosines and gate counts bitwise ``triangulate_gated_ordered``,
    from one launch and from a CUDA graph replay; one launch a call (none
    at N = 0); its decisions against the eager gates it replaced
    (``chip_smoke.tri_gated_case`` raises otherwise)."""
    from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
    mk = MappingKernels(SlamConfig(), device=cuda)
    args = chip_smoke.tri_gated_problem(pairs, n, chip_smoke.SEED + 8, cuda)
    c = chip_smoke.tri_gated_case(f"{pairs} x {n} rows", args, mk)
    assert c["bitwise"] and c["graph_bitwise"]
    assert c["launches"] == (1 if n else 0)
    if n >= 37:
        assert all(g > 0 for g in c["gates"])


def test_gated_kernel_decisions_against_eager_gates(cuda):
    """On the small map's last mapping step (``mapping_snapshot``, on the
    card), the new keyframe against its 5 other keyframes and an empty
    slot: the one gated launch against the path it replaced (a one-pair
    launch and the eager gates, ``@``, ``linalg.norm`` and
    ``ray_to_cubemap``, a pair at a time). Every row the two decide
    otherwise is named by the gate that turned and lies within
    ``chip_smoke.TRI_FLIP_ULPS`` float32 ulps of it; the count is
    printed."""
    from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
    from cubemapslam_tpu_torch.solvers import triangulate as TT
    cfg, arena, slot, _, _ = mapping_snapshot()
    mk = MappingKernels(cfg, device=cuda)
    a = arena.to(cuda)
    nbs = [3, 0, 6, 4, 1, 2]
    pairs = [mk._search_pair(a, slot, nb) for nb in nbs]
    R21s, t21s, idx, match = (torch.stack(x) for x in zip(*(
        (R21, t21, res.idx, res.ok) for _, _, R21, t21, res in pairs)))
    args = (TT.Keyframes(a.kf_rays, a.kf_uv, a.kf_level, a.kf_R, a.kf_t),
            torch.tensor([slot], device=cuda), torch.tensor(nbs, device=cuda),
            idx, match, R21s, t21s, mk.gate_consts)
    c = chip_smoke.tri_gated_case("mapping_snapshot, 6 neighbours", args, mk)
    print(f"rows decided otherwise than the eager gates: "
          f"{sum(c['flips'].values())} {c['flips']}, within "
          f"{c['flip_ulps']:.3g} ulps")
    assert c["bitwise"] and c["kept"] > 20
    assert "none found" not in c["flips"]
    assert c["flip_ulps"] <= chip_smoke.TRI_FLIP_ULPS


def test_triangulate_cpu_call_builds_nothing(cuda, monkeypatch):
    """A call on CPU tensors takes the plain path: it neither builds nor
    launches the kernel, even with a card present."""
    from cubemapslam_tpu_torch import _build
    from cubemapslam_tpu_torch.solvers import triangulate as TT

    def no_build(source):
        raise AssertionError(f"{source} built for a CPU call")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(TT.TRIANGULATE, "_fn", None)
    n0 = TT.TRIANGULATE.launches
    args = chip_smoke.tri_problem(37, 1, "cpu", pairs=4)
    X = TT.triangulate_rays(*chip_smoke.pair_args(args, 0))
    assert X.device.type == "cpu" and X.shape == (37, 3)
    assert TT.triangulate_pairs(*args).shape == (4, 37, 3)
    c = TT.triangulate_gated(*chip_smoke.tri_gated_problem(6, 37, 1, "cpu"))
    assert c.Xw.device.type == "cpu"
    assert TT.TRIANGULATE.launches == n0 and TT.TRIANGULATE._fn is None


def test_triangulate_wrapper_raises(cuda):
    """The kernel's wrappers raise on a float64 ray, a strided ray, a
    CPU/CUDA mix and a wrong shape (one pair, B pairs), and on an int32
    level table, a strided index, a CPU slot, a wrong shape and a missing
    level table (the gated form); they launch nothing then."""
    from cubemapslam_tpu_torch.solvers import triangulate as TT
    args = list(chip_smoke.pair_args(
        chip_smoke.tri_problem(100, 5, cuda), 0))
    wide = torch.zeros((100, 4), device=cuda)
    wide[:, :3] = args[0]
    bad = [[args[0].double()] + args[1:], [wide[:, :3]] + args[1:],
           args[:3] + [args[3].cpu()], args[:2] + [args[2].reshape(9)]
           + args[3:], [args[0][:50]] + args[1:]]
    pairs = list(chip_smoke.tri_problem(100, 5, cuda, pairs=4))
    bad_pairs = [pairs[:3] + [pairs[3][:3]], pairs[:2] + [pairs[2][0]]
                 + pairs[3:]]
    g = list(chip_smoke.tri_gated_problem(6, 64, 5, cuda))
    kf, consts = g[0], g[7]
    wide_idx = torch.zeros((6, 128), dtype=torch.int64, device=cuda)
    wide_idx[:, ::2] = g[3]
    bad_gated = [[kf._replace(level=kf.level.int())] + g[1:],
                 g[:3] + [wide_idx[:, ::2]] + g[4:],
                 g[:1] + [g[1].cpu()] + g[2:],
                 g[:4] + [g[4][:, :32]] + g[5:],
                 g[:7] + [consts._replace(level_sigma2=consts.level_sigma2[:0],
                                          scale_factors=consts.scale_factors[:0])]]
    n0 = TT.TRIANGULATE.launches
    for b in bad:
        with pytest.raises(ValueError):
            TT.triangulate_rays(*b)
    for b in bad_pairs:
        with pytest.raises(ValueError):
            TT.triangulate_pairs(*b)
    for b in bad_gated:
        with pytest.raises(ValueError):
            TT.triangulate_gated(*b)
    assert TT.TRIANGULATE.launches == n0


def _arena_equal(a, b):
    return [k for k in a._fields
            if not torch.equal(getattr(a, k), getattr(b, k))]


@pytest.mark.parametrize("stage", ["mapping_step", "local_ba"])
def test_mapping_twice_bitwise(cuda, stage):
    """``mapping_step`` (with its BA) and ``local_ba`` run twice on the
    card from one arena: every table of the two results bitwise equal."""
    from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
    cfg, arena, slot, n_kf, fid = mapping_snapshot()
    outs = []
    for _ in range(2):
        mk = MappingKernels(cfg, device=cuda)
        a = arena.to(cuda)
        if stage == "mapping_step":
            a, _ = mk.mapping_step(a, slot, n_kf, fid, max_cams=5)
        else:
            a, _ = mk.local_ba(a, slot, 5)
        outs.append(a.to("cpu"))
    assert _arena_equal(*outs) == []


def test_loop_correction_and_global_ba_twice_bitwise(cuda):
    """The tier-1-size constructed-drift closure on the card twice eagerly
    (``LoopCloser.graphs`` off) and once through the system's loop graphs
    (the correction as ``FusedCorrect``'s graphs C, the Gauss-Newton step
    replayed for its iterations, and F), from the CPU's refined Sim3 (loop
    fusion, the pose graph, SearchAndFuse); then the global BA likewise
    from the CPU's corrected arena: twice eagerly, through the system's
    ``FusedGlobalBA`` (graphs B, P, L, X and W captured on the first
    solve, L replayed for the other 14 LM steps and X for the second cut)
    and on a system that hands out no ``FusedLoop`` (through a
    ``FusedGlobalBA`` made for the solve, which captures its five graphs
    and replays L and X as the system's does): each bitwise equal, with
    the same segmented-sum launches. A second ``_global_ba`` on the ``FusedGlobalBA`` system, its
    arena restored, captures nothing and replays B, P, L 15 times, X twice
    and W, to the same tables."""
    import types
    from cubemapslam_tpu_torch import segment as SG
    from cubemapslam_tpu_torch.runtime.loop_closing import (
        POSE_GRAPH_ITERS, LoopCloser)
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    _, c, rec, _ = chip_smoke.small_loop_closure(cfg, "cpu")
    corrected, counts = [], []
    for graphs in (False, False, True):
        _, arena, _, lc = chip_smoke.small_loop_closure(
            cfg, cuda, refined=rec["refined"], graphs=graphs)
        corrected.append(arena)
        counts.append(lc.graph_counts)
    assert _arena_equal(*corrected[:2]) == []
    assert _arena_equal(corrected[0], corrected[2]) == []
    assert counts[0]["captures"] == 0
    # the closing call through the graphs: graphs M and S captured and
    # graph D replayed (FusedLoop), graphs C, the Gauss-Newton step and F
    # captured (FusedCorrect), the step replayed for every iteration after
    # the first
    assert (counts[2]["captures"], counts[2]["replays"]) == (
        2 + 3, POSE_GRAPH_ITERS - 1 + 1)
    solved, launches = [], []
    for mode in ("eager", "eager", "fused", "made"):
        arena = c.to(cuda)
        system = (types.SimpleNamespace(arena=arena) if mode == "made" else
                  chip_smoke.LoopSystem(arena, 0, None, None))
        lc = LoopCloser(cfg, CubemapCamera.from_config(cfg, cuda))
        lc.graphs = mode != "eager"
        n0 = SG.SEG_SUM.launches
        lc._global_ba(system)
        torch.cuda.synchronize()
        launches.append(SG.SEG_SUM.launches - n0)
        solved.append(system.arena.to("cpu"))
        assert lc.reads == 1
        assert (lc.graph_counts["captures"], lc.graph_counts["replays"]) == (
            (5, 14 + 1) if mode == "made" else (0, 0))
        if mode == "fused":
            fused = system
        else:
            assert getattr(system, "fused_loop", None) is None
    assert _arena_equal(*solved[:2]) == []
    assert _arena_equal(solved[0], solved[2]) == []
    assert _arena_equal(solved[0], solved[3]) == []
    assert len(set(launches)) == 1 and launches[0] > 0
    fg = fused.fused_loop.global_ba
    assert (fg.captures, fg.replays) == (5, 14 + 1)
    assert len(fg.capacities) == 1
    for a, b in zip(fused.arena, c.to(cuda)):
        a.copy_(b)
    n0 = SG.SEG_SUM.launches
    LoopCloser(cfg, CubemapCamera.from_config(cfg, cuda))._global_ba(fused)
    torch.cuda.synchronize()
    assert SG.SEG_SUM.launches - n0 == launches[0]
    assert _arena_equal(solved[0], fused.arena.to("cpu")) == []
    assert (fg.captures, fg.replays) == (5, 15 + 1 + 1 + 15 + 2 + 1)


def test_loop_global_ba_padded_bitwise_compacted(cuda):
    """The global BA of the CPU's corrected tier-1 arena on the card, on its
    live edges compacted and padded (``LoopKernels.padded_ba_problem``) to
    their edge capacity and to all K*N slots: poses, points and the inlier
    verdicts on the live edges bitwise equal. The plans drop the padded
    rows, the cost's one-segment plan among them, so padding moves no bit
    of a sum, and the card's elementwise kernels round a row alike at any
    length."""
    from cubemapslam_tpu_torch import dist as TD
    from cubemapslam_tpu_torch.optim.ba import bundle_adjust
    from cubemapslam_tpu_torch.runtime.loop_closing import LoopKernels
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    _, c, _, _ = chip_smoke.small_loop_closure(cfg, "cpu")
    cam = CubemapCamera.from_config(cfg, cuda)
    inv_s2 = 1.0 / torch.tensor(cfg.level_sigma2, device=cuda)
    prob = TD.global_ba_problem_from_arena(cam, c.to(cuda), inv_s2)
    keep = prob.obs_valid.nonzero()[:, 0]
    live = prob._replace(**{f: getattr(prob, f)[keep]
                            for f in TD.EDGE_FIELDS})
    E = prob.obs_valid.shape[0]
    ref, ref_inl = bundle_adjust(cam, live, solver="cg", cg_iters=50)
    for cap in (LoopKernels.ba_edge_capacity(keep.numel(), E), E):
        padded, slots = LoopKernels.padded_ba_problem(prob, cap)
        out, inl = bundle_adjust(cam, padded, solver="cg", cg_iters=50)
        torch.cuda.synchronize()
        for name in ("R", "t", "X"):
            assert torch.equal(getattr(out, name), getattr(ref, name)), (
                cap, name)
        assert torch.equal(slots[:keep.numel()], keep)
        assert torch.equal(inl[:keep.numel()], ref_inl)
        assert not inl[keep.numel():].any()


def test_loop_global_ba_new_capacity(cuda, monkeypatch):
    """A global BA whose live count falls in another edge capacity: on the
    ``FusedGlobalBA`` of a system that solved the CPU's corrected arena once,
    the same arena with every other live observation unlinked (half the
    count, another capacity; the smallest capacity lowered to 256 so that
    the tier-1 arena's counts are not both at the floor) captures that
    capacity's P, L, X and W and replays B, bitwise the eager solve of the
    same arena; the original arena solved again captures nothing and
    replays the first capacity's graphs, to the first solve's tables. The
    arena with three of four live observations unlinked, a third capacity,
    captures its P, L, X and W and drops the halved arena's, the least
    recently used (``FusedGlobalBA.kept`` = 2); the halved arena solved
    again captures its four anew, to the bits of its first solve."""
    import types
    from cubemapslam_tpu_torch.runtime import loop_closing as LC
    monkeypatch.setattr(LC, "MIN_BA_EDGE_CAPACITY", 256)
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    _, c, _, _ = chip_smoke.small_loop_closure(cfg, "cpu")
    halved, quarter = c.to("cpu"), c.to("cpu")
    obs = halved.kf_obs_lm.reshape(-1)
    live = (obs >= 0).nonzero()[:, 0]
    obs[live[::2]] = -1
    quarter.kf_obs_lm.reshape(-1)[live[torch.arange(len(live)) % 4 != 0]] \
        = -1

    def solve(system, graphs=True):
        lc = LC.LoopCloser(cfg, CubemapCamera.from_config(cfg, cuda))
        lc.graphs = graphs
        lc._global_ba(system)
        torch.cuda.synchronize()
        return system.arena.to("cpu")

    system = chip_smoke.LoopSystem(c.to(cuda), 0, None, None)
    first = solve(system)
    fg = system.fused_loop.global_ba
    (cap1,) = fg.capacities
    assert (fg.captures, fg.replays) == (5, 15)
    for a, b in zip(system.arena, halved.to(cuda)):
        a.copy_(b)
    second = solve(system)
    assert int(fg.outputs["b"][-1]) == len(live) - len(live[::2])
    assert len(fg.capacities) == 2 and cap1 in fg.capacities
    assert (fg.captures, fg.replays) == (5 + 4, 15 + 1 + 14 + 1)
    eager = solve(types.SimpleNamespace(arena=halved.to(cuda)), False)
    assert _arena_equal(second, eager) == []
    for a, b in zip(system.arena, c.to(cuda)):
        a.copy_(b)
    again = solve(system)
    assert _arena_equal(first, again) == []
    assert (fg.captures, fg.replays) == (9, 31 + 1 + 1 + 15 + 2 + 1)
    (cap2,) = set(fg.capacities) - {cap1}
    for a, b in zip(system.arena, quarter.to(cuda)):
        a.copy_(b)
    third = solve(system)
    (cap3,) = set(fg.capacities) - {cap1}
    assert cap3 not in (cap1, cap2) and len(fg.capacities) == 2
    assert not any(n.endswith(str(cap2)) for n in fg.outputs)
    assert (fg.captures, fg.replays) == (13, 51 + 1 + 14 + 1)
    eager = solve(types.SimpleNamespace(arena=quarter.to(cuda)), False)
    assert _arena_equal(third, eager) == []
    for a, b in zip(system.arena, halved.to(cuda)):
        a.copy_(b)
    assert _arena_equal(second, solve(system)) == []
    assert sorted(fg.capacities) == sorted([cap2, cap3])
    assert (fg.captures, fg.replays) == (17, 67 + 1 + 14 + 1)


def test_pose_graph_twice_bitwise(cuda):
    """``optimize_essential_graph`` on a 64-vertex ring with chain,
    covisibility and loop edges, twice on the card and once with its
    iterations replayed from a CUDA graph (``CapturedLoop``): bitwise
    equal, one capture and 9 replays."""
    from cubemapslam_tpu_torch import geometry as G
    from cubemapslam_tpu_torch.optim.pose_graph import \
        optimize_essential_graph
    rng = np.random.default_rng(2)
    m = 64
    xi = torch.as_tensor(rng.normal(0, 0.05, (m, 7)).astype(np.float32))
    s, R, t = G.sim3_exp(xi)
    pairs = [(k, k + 1) for k in range(m - 1)]
    pairs += [(k, k + 3) for k in range(0, m - 3, 2)] + [(m - 1, 0)]
    ei = torch.as_tensor([a for a, _ in pairs])
    ej = torch.as_tensor([b for _, b in pairs])
    meas = G.sim3_exp(torch.as_tensor(
        rng.normal(0, 0.05, (len(pairs), 7)).astype(np.float32)))
    fixed = torch.zeros(m, dtype=torch.bool)
    fixed[0] = True
    args = [x.to(cuda) for x in (s, R, t, torch.ones(m, dtype=torch.bool),
                                 fixed, ei, ej, *meas,
                                 torch.ones(len(pairs), dtype=torch.bool))]
    a = optimize_essential_graph(*args, n_iters=10)
    b = optimize_essential_graph(*args, n_iters=10)
    loop = CapturedLoop(cuda)
    g = optimize_essential_graph(*args, n_iters=10, loop=loop)
    for x, y, z in zip(a, b, g):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert (loop.captures, loop.replays) == (1, 9)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_captured_loop_runs_n_steps(cuda, n):
    """``CapturedLoop.repeat(name, body, n)`` on the card: the first call
    runs the body eagerly and captures it without running it again, every
    later call replays it, so the state advances exactly n steps (a
    counter, and a segmented sum that accumulates into the state); the
    segmented sum's launches are counted on every replay."""
    from cubemapslam_tpu_torch import segment as SG
    count = torch.zeros((), dtype=torch.int64, device=cuda)
    acc = torch.zeros(4, 3, device=cuda)
    plan = SG.SegmentPlan(torch.tensor([0, 2, 2, 3, 3, 3], device=cuda), 4)
    v = torch.arange(18, dtype=torch.float32, device=cuda).reshape(6, 3)

    def body():
        count.add_(1)
        acc.add_(SG.segment_sum(plan, v))

    loop = CapturedLoop(cuda)
    n0 = SG.SEG_SUM.launches
    loop.repeat("count", body, n)
    torch.cuda.synchronize()
    assert int(count) == n
    assert torch.equal(acc.cpu(), n * SG.segment_sum(
        SG.SegmentPlan(plan.idx.cpu(), 4), v.cpu()))
    assert SG.SEG_SUM.launches - n0 == n
    assert (loop.captures, loop.replays) == (1, n - 1)
    loop.repeat("count", body, 2)
    torch.cuda.synchronize()
    assert int(count) == n + 2 and loop.captures == 1


def test_captured_loop_capture_fails_raises(cuda):
    """A loop body that reads the host (``.item()``) cannot be captured:
    ``repeat`` raises after the eager first iteration, and nothing falls
    back to running the rest eagerly."""
    count = torch.zeros((), dtype=torch.int64, device=cuda)

    def body():
        count.add_(int(count.item() >= 0))

    loop = CapturedLoop(cuda)
    with pytest.raises(RuntimeError, match="capture of graph COUNT failed"):
        loop.repeat("count", body, 3)
    torch.cuda.synchronize()
    assert int(count) == 1 and loop.captures == 0


# ---------------------------------------------------------------------------
# The tracked frame as captured CUDA graphs (runtime/fused_step.py)
# ---------------------------------------------------------------------------

GRAPH_FRAMES = 8


@pytest.fixture(scope="module")
def graph_scene(cuda):
    """A small map built on the CPU, the frames after it rendered, and a
    function that seeds a card tracker from the map as built."""
    cfg = SlamConfig(**SMALL, max_keyframes=16, max_landmarks=2048)
    ref = MapTracker(cfg, device="cpu")
    poses = S.forward_trajectory(10 + GRAPH_FRAMES, step=0.04,
                                 yaw_rate=0.003)
    world = S.make_world(np.random.default_rng(11), n=500,
                         centers=S.camera_centres(poses), fx=64.0)
    S.build_map(ref, world, poses, 4, kf_stride=3)
    render = S.Renderer(ref.cam, cfg)
    frames = [S.to_u8(render.render(*world, *poses[i])[0])
              for i in range(10, 10 + GRAPH_FRAMES)]

    def tracker(eager, assoc=None):
        tr = MapTracker(cfg)
        tr.set_warp_map(ref.warp_map)
        tr.mask = ref.mask.to(cuda)
        last = ref.last
        tr.seed(ref.arena, last.kp, last.assoc if assoc is None else assoc,
                last.outlier, last.R, last.t, last.ref_kf,
                frame_id=last.frame_id)
        tr.stage_times = {} if eager else None
        return tr

    return dict(cfg=cfg, ref=ref, frames=frames, tracker=tracker)


def _frame_state(tr, T):
    row = {k: v for k, v in tr.metrics[-1].items()
           if not k.startswith("graph_")}
    last = tr.last
    tensors = [*last.kp, last.assoc, last.outlier, last.R, last.t,
               last.rel_R, last.rel_t]
    if tr.velocity is not None:
        tensors += list(tr.velocity)
    return T, row, [x.cpu() for x in tensors]


def _same_frames(a, b):
    for (Ta, ra, xa), (Tb, rb, xb) in zip(a, b):
        assert (Ta is None) == (Tb is None)
        assert Ta is None or np.array_equal(Ta, Tb)
        assert ra == rb
        assert len(xa) == len(xb)
        assert all(torch.equal(x, y) for x, y in zip(xa, xb))


@pytest.mark.parametrize("branch", ["steady", "fallbacks", "gate", "blank"])
def test_graph_frames_bitwise_eager(cuda, graph_scene, branch):
    """MapTracker's graph frames against its eager frames (``stage_times``
    set) from one seed: ``steady`` over 8 frames; ``fallbacks`` with the
    last association emptied (widen, zero velocity, reference keyframe,
    then graph B on the fallback's stage tuple); ``gate`` a velocity above
    the 0.2 rad gate; ``blank`` a blank frame after a tracked one (graph A
    replayed, then graphs W, Z, R and S captured). Every pose, row,
    last-frame tensor, velocity and the arena after them bitwise equal;
    the graph frames replay."""
    frames = graph_scene["frames"]
    if branch != "steady":
        frames = frames[:2]
    if branch == "blank":
        frames = [frames[0], np.zeros_like(frames[0])]
    runs = []
    for eager in (True, False):
        assoc = None
        if branch == "fallbacks":
            assoc = torch.full_like(graph_scene["ref"].last.assoc, -1)
        tr = graph_scene["tracker"](eager, assoc)
        out = []
        for k, img in enumerate(frames):
            if branch == "gate" and k == 1:
                tr.velocity = (so3_exp(torch.tensor([0.0, 0.3, 0.0],
                                                    device=cuda)),
                               torch.zeros(3, device=cuda))
            out.append(_frame_state(tr, tr.track_fisheye(img, k / 30.0)))
        runs.append((out, tr))
    (e_out, e_tr), (g_out, g_tr) = runs
    _same_frames(e_out, g_out)
    assert _arena_equal(e_tr.arena.to("cpu"), g_tr.arena.to("cpu")) == []
    rows = g_tr.metrics
    assert all(r["graph_replays"] == 0 and r["graph_captures"] == 0
               for r in e_tr.metrics)
    assert rows[0]["graph_captures"] >= 1
    if branch == "fallbacks":
        assert rows[0]["path"][1:4] == ("widen", "zero_velocity",
                                        "reference_kf")
    if branch == "blank":
        assert rows[1]["path"][-1] == "skip_local"
        assert rows[1]["graph_replays"] == 1
    if branch == "steady":
        assert all(r["graph_replays"] == 2 for r in rows[1:])
        assert all(r["path"] == ("motion", "local") for r in rows)


@pytest.mark.parametrize("branch", ["emptied", "blank"])
def test_fallback_graphs_replay_bitwise_eager(cuda, graph_scene, branch):
    """The forced fallback frames 4 times each from the map as built,
    restored in place (``chip_smoke.restore_tracked``): ``emptied`` (the
    last association emptied: graphs A, W, Z, R and B) and ``blank``
    (graphs A, W, Z, R and S), through the graphs and eagerly. Every frame bitwise its eager twin and the first;
    the first graph frame captures the 5 graphs and every later one
    replays them, by name, and captures none; the pose-LM kernel launches
    once a solve on every frame, replays included (A, W, Z, R and B's: 5;
    A, W, Z and R's: 4), as eagerly."""
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    frames = graph_scene["frames"]
    img = np.zeros_like(frames[0]) if branch == "blank" else frames[0]
    assoc = None
    if branch == "emptied":
        assoc = torch.full_like(graph_scene["ref"].last.assoc, -1)
    names = ("A", "W", "Z", "R", "B" if branch == "emptied" else "S")
    runs = []
    for eager in (True, False):
        tr = graph_scene["tracker"](eager, assoc)
        built, seed = [t.clone() for t in tr.arena], tr.last
        out, lm = [], []
        for _ in range(4):
            chip_smoke.restore_tracked(tr, built, seed)
            PO.POSE_LM.launches = 0
            out.append(_frame_state(tr, tr.track_fisheye(img, 1.0)))
            lm.append(PO.POSE_LM.launches)
        runs.append((out, lm, tr))
    (e_out, e_lm, e_tr), (g_out, g_lm, g_tr) = runs
    _same_frames(e_out, g_out)
    _same_frames(e_out[:1] * 4, e_out)
    assert e_lm == g_lm == [len(names) - (branch == "blank")] * 4
    assert _arena_equal(e_tr.arena.to("cpu"), g_tr.arena.to("cpu")) == []
    rows = g_tr.metrics
    assert all(r["path"][1:4] == ("widen", "zero_velocity", "reference_kf")
               for r in rows)
    assert (rows[0]["graph_captures"], rows[0]["graph_replayed"]) == (5, ())
    assert all(r["graph_captures"] == 0 and r["graph_replayed"] == names
               for r in rows[1:])
    fs = g_tr.fused_step
    assert (fs.captures, fs.replays) == (5, 15)
    assert set(fs.outputs) == {n.lower() for n in names}


def test_graph_launch_counts(cuda, graph_scene):
    """Kernels W, D (two entries) and describe count one launch a frame on
    the capture frame and on every replayed frame, the pose-LM kernel two
    (the motion solve in graph A, TrackLocalMap's in graph B); the graph
    frames are bitwise their eager twins
    (``test_graph_frames_bitwise_eager``)."""
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    tr = graph_scene["tracker"](eager=False)
    kernels = (warp_cuda.WARP_REMAP, TE.ORB_FAST, TE.ORB_SELECT,
               TE.ORB_DESCRIBE, PO.POSE_LM)
    for k, img in enumerate(graph_scene["frames"][:4]):
        for c in kernels:
            c.launches = 0
        assert tr.track_fisheye(img, k / 30.0) is not None
        assert [c.launches for c in kernels] == [1, 1, 1, 1, 2]
        row = tr.metrics[-1]
        assert (row["graph_captures"], row["graph_replays"]) == \
            ((2, 0) if k == 0 else (0, 2))
    fs = tr.fused_step
    assert (fs.captures, fs.replays) == (2, 6)


def test_graphs_captured_again_after_reset(cuda, graph_scene):
    """``seed`` drops the graphs, and the next frame captures anew and gives
    the first run's bits; a stale ``FusedStep`` raises on a moved arena,
    as does a frame after the arena is replaced without a drop; and
    ``CubemapSLAM.reset`` drops the graphs."""
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    frames = graph_scene["frames"][:2]
    tr = graph_scene["tracker"](eager=False)
    first = [_frame_state(tr, tr.track_fisheye(img, k / 30.0))
             for k, img in enumerate(frames)]
    stale = tr.fused_step
    ref, last = graph_scene["ref"], graph_scene["ref"].last
    tr.seed(ref.arena, last.kp, last.assoc, last.outlier, last.R, last.t,
            last.ref_kf, frame_id=last.frame_id)
    assert tr.fused_step is None
    again = [_frame_state(tr, tr.track_fisheye(img, k / 30.0))
             for k, img in enumerate(frames)]
    _same_frames(first, again)
    assert tr.metrics[-2]["graph_captures"] == 2
    vel = tr._velocity_args()
    with pytest.raises(RuntimeError, match="moved"):
        stale(tr, frames[0], None, tr.last, vel[:2], vel[2], tr.ref_kf)
    tr.arena = type(tr.arena)(*(t.clone() for t in tr.arena))
    with pytest.raises(RuntimeError, match="moved"):
        tr.track_fisheye(frames[0], 1.0)
    slam = CubemapSLAM(graph_scene["cfg"], device=cuda)
    slam._fused = stale
    slam.reset()
    assert slam.fused_step is None


def test_capture_meets_a_host_read(cuda, graph_scene, monkeypatch):
    """A synchronising operation inside a captured part makes the capture
    raise; the frame does not go on eagerly (no row is written)."""
    tr = graph_scene["tracker"](eager=False)
    inner = tr.kernels.frame_motion

    def reads(*args, **kwargs):
        st, pose, counts = inner(*args, **kwargs)
        return st, pose, counts * int(counts.sum().item() > -1)

    monkeypatch.setattr(tr.kernels, "frame_motion", reads)
    n_rows = len(tr.metrics)
    with pytest.raises(RuntimeError, match="capture of graph A failed"):
        tr.track_fisheye(graph_scene["frames"][0], 0.0)
    assert len(tr.metrics) == n_rows
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The keyframe and deferred-BA frames as captured CUDA graphs
# (runtime/fused_mapping.py)
# ---------------------------------------------------------------------------

SLAM_SMALL = dict(cube_face_w=160, cube_face_h=160, n_features=600,
                  n_levels=3, max_keyframes=24, max_landmarks=4096,
                  min_init_keypoints=80, min_init_matches=60,
                  min_track_inliers=20, fps=5.0)
SLAM_GRAPH_FRAMES = 12
LOOP_AT_KEYFRAME = 4     # the loop closing forced on this keyframe


@pytest.fixture(scope="module")
def slam_frames(cuda):
    """The configuration and 12 fisheye frames of a forward trajectory
    through the billboard world of ``mapping_snapshot``, rendered on the
    host: keyframes on the even frames from 2 (slots 2 to 6), the deferred
    BA on the odd ones from 3."""
    cfg = SlamConfig(**SLAM_SMALL)
    poses = S.forward_trajectory(SLAM_GRAPH_FRAMES)
    world = S.make_world(np.random.default_rng(5), n=600,
                         centers=S.camera_centres(poses), fx=80.0)
    render = S.Renderer(CubemapCamera.from_config(cfg, "cpu"), cfg)
    return cfg, [S.to_u8(render.render(*world, R, t)[0]) for R, t in poses]


def _force_loop_closure(slam, at_keyframe):
    """Close a loop on the ``at_keyframe``-th keyframe that loop closing
    sees, against the keyframe inserted before it (ComputeSim3, CorrectLoop
    and the global BA, ``LoopCloser._try_close``); the other keyframes go
    through ``LoopCloser.process`` as they come."""
    lc = slam.loop_closer
    inner = lc.process
    slots = []

    def process(system, slot):
        slots.append(slot)
        if len(slots) != at_keyframe:
            return inner(system, slot)
        lc.reads = lc.eigh_waits = 0
        return lc._try_close(system, slot, slots[-2])

    lc.process = process


def _slam_state(slam, T):
    row = {k: v for k, v in slam.metrics[-1].items()
           if not k.startswith("graph_") and not k.endswith("_ms")}
    last, tensors = slam.last, []
    if last is not None:
        tensors = [*last.kp, last.assoc, last.outlier, last.R, last.t,
                   last.rel_R, last.rel_t]
    if slam.velocity is not None:
        tensors += list(slam.velocity)
    tensors += [getattr(slam.arena, k) for k in slam.arena._fields]
    if slam.bow_table is not None:
        tensors.append(slam.bow_table)
    if slam._last_mapping_info is not None:
        tensors.append(slam._last_mapping_info)
    return T, row, [x.cpu() for x in tensors]


def _slam_run(cuda, cfg, frames, eager, close_loop=False):
    """``CubemapSLAM`` on the card over ``frames`` from the first, eagerly
    (``stage_times`` set) or through the graphs: (system, per-frame
    ``_slam_state``, per-frame launches of every kernel entry and of the
    segmented sum)."""
    from cubemapslam_tpu_torch import segment as SG
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    from cubemapslam_tpu_torch.solvers import triangulate as TT
    counters = (warp_cuda.WARP_REMAP, TE.ORB_FAST, TE.ORB_SELECT,
                TE.ORB_DESCRIBE, SG.SEG_SUM, TT.TRIANGULATE)
    slam = CubemapSLAM(cfg, device=cuda)
    slam.stage_times = {} if eager else None
    if close_loop:
        _force_loop_closure(slam, LOOP_AT_KEYFRAME)
    states, launches = [], []
    for k, img in enumerate(frames):
        for c in counters:
            c.launches = 0
        T = slam.track_fisheye(img, k / cfg.fps)
        states.append(_slam_state(slam, T))
        launches.append({c.symbol: c.launches for c in counters})
    torch.cuda.synchronize()
    return slam, states, launches


@pytest.fixture(scope="module")
def slam_runs(cuda, slam_frames):
    cfg, frames = slam_frames
    return {eager: _slam_run(cuda, cfg, frames, eager)
            for eager in (True, False)}


def test_mapping_graphs_bitwise_eager(cuda, slam_runs):
    """``CubemapSLAM``'s graph frames (``FusedStep``, then ``FusedMapping``'s
    graphs K and BA) against its eager frames over 12 frames from the
    first: every pose, row, last-frame tensor, arena table, the BoW table
    and the mapping diagnostics bitwise equal at every frame. Graph K is
    captured on the first keyframe frame and replayed on every later one,
    which insert into 4 different slots; graph BA likewise on the
    deferred-BA frames."""
    (e_slam, e_states, _), (g_slam, g_states, _) = (slam_runs[True],
                                                    slam_runs[False])
    _same_frames(e_states, g_states)
    assert all(r["graph_mapping_captures"] == r["graph_mapping_replays"]
               == 0 for r in e_slam.metrics if "graph_mapping_replays" in r)
    assert e_slam.fused_mapping is None
    rows = [r for r in g_slam.metrics if "graph_mapping_replays" in r]
    kf = [r for r in rows if r["keyframe"]]
    ba = [r for r in rows if r["ba"] and not r["keyframe"]]
    assert len(kf) >= 3 and len(ba) >= 2
    assert (kf[0]["graph_mapping_captures"], ba[0]["graph_mapping_captures"]
            ) == (1, 1)
    assert all(r["graph_mapping_replays"] == 1
               and r["graph_mapping_captures"] == 0 for r in kf[1:] + ba[1:])
    assert len({r["first_free"] for r in kf[1:]}) >= 2
    fm = g_slam.fused_mapping
    assert (fm.captures, fm.replays) == (
        2, sum(r["graph_mapping_replays"] for r in rows))


def test_mapping_graph_launch_counts(cuda, slam_runs):
    """Launch counts add up across replays: every kernel entry, the
    segmented sum and the triangulation kernel count, frame by frame, what
    the eager frames launch; W, D's two entries and describe once a frame,
    the segmented sum on every keyframe and deferred-BA frame, the
    triangulation once on a keyframe frame after init (graph K's replays
    included) and once a two-view reconstruction while initializing."""
    (_, e_states, e_launch), (g_slam, _, g_launch) = (slam_runs[True],
                                                      slam_runs[False])
    assert e_launch == g_launch
    mapped = init = 0
    for row, n in zip(g_slam.metrics, g_launch):
        assert [n[s] for s in ("warp_remap_launch", "orb_fast_launch",
                               "orb_select_launch", "orb_describe_launch")
                ] == [1, 1, 1, 1]
        if row.get("keyframe") or row.get("ba"):
            assert n["seg_sum_launch"] > 0
        if row.get("stage") == "init":
            assert n["triangulate_launch"] in (0, 1)
            init += n["triangulate_launch"]
        elif row.get("keyframe"):
            assert n["triangulate_launch"] == 1
            mapped += row.get("graph_mapping_replays", 0) > 0
        else:
            assert n["triangulate_launch"] == 0
    assert init > 0 and mapped > 0


@pytest.fixture(scope="module")
def mapping_snap(cuda):
    return mapping_snapshot()


@pytest.mark.parametrize("stage", ["insert_keyframe", "mapping_step",
                                   "mapping_step_ba", "ba_step"])
def test_mapping_tensor_slots_on_card(cuda, mapping_snap, stage):
    """On the card, eagerly: the slot, keyframe counter, frame id and
    timestamp as 0-d CUDA tensors give every table (and the diagnostics)
    bitwise what the same calls with Python numbers give. A 0-d index that
    PyTorch read to the host or copied, so that an in-place write went
    nowhere, would show here."""
    from cubemapslam_tpu_torch.runtime import mapping as TM
    from cubemapslam_tpu_torch.runtime.kernels import TrackingKernels
    from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
    cfg, arena, slot, n_kf, fid = mapping_snap
    mk = MappingKernels(cfg, device=cuda)
    tk = TrackingKernels(cfg, mk.cam)
    outs = []
    for as_tensors in (False, True):
        a = arena.to(cuda)
        if stage == "insert_keyframe":
            kp = TM._kf_keypoints(a, slot - 1)
            kp = type(kp)(*(x.clone() for x in kp))
            args = (slot + 1, 99, 3.25)
            if as_tensors:
                args = (torch.tensor(slot + 1, device=cuda),
                        torch.tensor(99, device=cuda),
                        torch.tensor(3.25, device=cuda))
            tk.insert_keyframe(a, args[0], kp, a.kf_obs_lm[slot - 1].clone(),
                               torch.zeros_like(kp.valid),
                               a.kf_R[slot - 1].clone(),
                               a.kf_t[slot - 1].clone(), *args[1:])
            extra = []
            assert bool(a.kf_valid[slot + 1])
            assert int(a.kf_frame_id[slot + 1]) == 99
        else:
            args = (slot, n_kf, fid)
            if as_tensors:
                args = tuple(torch.tensor(x, device=cuda) for x in args)
            if stage == "ba_step":
                mk.ba_step(a, args[0], max_cams=5)
                extra = []
            else:
                a, info = mk.mapping_step(a, *args, max_cams=5,
                                          run_ba=stage.endswith("_ba"))
                extra = [info.cpu()]
        outs.append(([getattr(a, k).cpu() for k in a._fields], extra))
    (ti, ei), (tt, et) = outs
    assert all(torch.equal(x, y) for x, y in zip(ti + ei, tt + et))
    if stage != "insert_keyframe":
        before = arena.to("cpu")
        assert not all(torch.equal(getattr(before, k), x)
                       for k, x in zip(before._fields, tt))


def test_graph_frames_after_loop_closure(cuda, slam_frames):
    """ROADMAP Queue 3: a loop closed between graph frames. The 12 frames
    twice, eagerly and through the graphs, with loop closing forced on the
    fourth keyframe frame the loop closer sees (against the keyframe
    before it): both close the loop there, every frame and every table
    bitwise equal, so right after ``loop.correct`` / ``loop.gba`` too, and
    the frames after it replay the tracked frame's graphs and the mapping
    graphs, which read the arena the closure wrote in place."""
    cfg, frames = slam_frames
    (e_slam, e_states, _), (g_slam, g_states, _) = (
        _slam_run(cuda, cfg, frames, eager, close_loop=True)
        for eager in (True, False))
    closed = [i for i, (_, r, _) in enumerate(g_states)
              if r.get("loop_closed")]
    assert len(closed) == 1 and e_slam.n_loops_closed == 1
    assert [i for i, (_, r, _) in enumerate(e_states)
            if r.get("loop_closed")] == closed
    # ComputeSim3 reads twice through FusedLoop's graphs M and S, 4 times
    # eagerly; CorrectLoop once through FusedCorrect, twice eagerly
    e_row, g_row = e_states[closed[0]][1], g_states[closed[0]][1]
    assert g_row["host_reads"] == e_row["host_reads"] - 3
    g_row["host_reads"] = e_row["host_reads"]
    _same_frames(e_states, g_states)
    after = g_slam.metrics[closed[0] + 1:]
    assert after and all(r["state"] == "OK" and r["graph_replays"] == 2
                         for r in after)
    assert any(r["graph_mapping_replays"] for r in after)
    assert g_slam.loop_closer.timings["gba"]
    assert e_slam.fused_loop is None
    assert g_slam.fused_loop.captures == 2          # graphs M and S
    assert g_slam.fused_loop.correction.captures == 3   # C, a step, F
    assert g_slam.fused_loop.global_ba.captures == 5    # B, P, L, X, W


# ---------------------------------------------------------------------------
# DetectLoop and ComputeSim3 as captured CUDA graphs (runtime/fused_loop.py)
# ---------------------------------------------------------------------------

def _loop_closure(cuda, system, graphs, past=()):
    """``process`` on slots 12 and 13 of the small constructed-drift system
    at consistency_th = 1, through the graphs or eagerly, with the past
    loop edges ``past``: (what each call returned, the closer, the closed
    tables and their digest, the generator's state, the eigen-solve
    kernel's launches)."""
    from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser
    from cubemapslam_tpu_torch.solvers import sym_eig as SE
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    lc = LoopCloser(cfg, CubemapCamera.from_config(cfg, cuda))
    lc.consistency_th = 1
    lc.graphs = graphs
    lc.loop_edges = list(past)
    n0 = SE.SYM_EIG.launches
    closed = [lc.process(system, slot) for slot in (12, 13)]
    torch.cuda.synchronize()
    return (closed, lc, chip_smoke.loop_arena_tables(system.arena),
            system.generator.get_state(), SE.SYM_EIG.launches - n0)


def _small_loop_system(cuda):
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    return chip_smoke.loop_system(cfg, cuda, None, 500, chip_smoke.SEED + 8)


def test_loop_graphs_bitwise_eager(cuda):
    """The small constructed-drift closure eagerly and through
    ``FusedLoop``'s graphs D, M and S, its ``FusedCorrect``'s graphs C, the
    Gauss-Newton step at the edge capacity (256) and F, and its
    ``FusedGlobalBA``'s graphs B, P, L, X and W: both close, every table
    bitwise equal, the generator in the same state, two eigen-solve
    launches (one Sim3 RANSAC) each, 0 eigen-solve waits and three reads
    fewer through the graphs. The graph system's arena restored in place
    and closed again (a second closure on the same system) replays D
    twice, M, S, C, the step 12 times, F, B, P, L 15 times, X twice and W,
    captures none of them and gives the same tables."""
    e_sys, g_sys = _small_loop_system(cuda), _small_loop_system(cuda)
    initial = chip_smoke.loop_arena_tables(g_sys.arena)[0]
    e_closed, e_lc, (_, e_dig), e_gen, e_eig = _loop_closure(cuda, e_sys,
                                                             False)
    g_closed, g_lc, (_, g_dig), g_gen, g_eig = _loop_closure(cuda, g_sys,
                                                             True)
    assert e_closed == g_closed == [False, True]
    assert e_dig == g_dig and torch.equal(e_gen, g_gen)
    assert e_eig == g_eig == 2
    assert e_lc.eigh_waits == g_lc.eigh_waits == 0
    assert g_lc.reads == e_lc.reads - 3
    assert e_sys.fused_loop is None
    fl, fc = g_sys.fused_loop, g_sys.fused_loop.correction
    assert (fl.captures, fl.replays) == (3, 1)
    assert (fc.captures, fc.replays, fc.capacities) == (3, 11, [256])
    fg = g_sys.fused_loop.global_ba
    assert (fg.captures, fg.replays) == (5, 15)
    # M, S, C, the step, F, and B, P, L, X, W
    assert g_lc.graph_counts["captures"] == 10
    chip_smoke.restore_loop_system(g_sys, initial)
    r_closed, r_lc, (_, r_dig), r_gen, r_eig = _loop_closure(cuda, g_sys,
                                                             True)
    assert r_closed == [False, True] and r_dig == g_dig
    assert torch.equal(r_gen, g_gen) and r_eig == 2
    assert (fl.captures, fl.replays) == (3, 5)
    assert (fc.captures, fc.replays) == (3, 25)
    assert (fg.captures, fg.replays) == (5, 35)
    assert r_lc.graph_counts["captures"] == 0
    # the closing call: D, M, S; C, the step 12 times, F; B, P, L 15
    # times, X twice, W
    assert r_lc.graph_counts["replays"] == 3 + 14 + 20
    assert r_lc.reads == g_lc.reads


def test_loop_correction_new_capacity(cuda, monkeypatch):
    """A closure whose live-edge count crosses into another capacity
    captures that capacity's Gauss-Newton step and nothing else, bitwise
    the eager closure with the same past loop edges. The smallest capacity
    is lowered to 64, which the 59 live edges of the first closure fill; the
    arena restored and closed again with 6 past loop edges has 65 (128).
    The global BA's live count stays in its capacity: it captures
    nothing."""
    from cubemapslam_tpu_torch.runtime import loop_closing as LC
    monkeypatch.setattr(LC, "MIN_EDGE_CAPACITY", 64)
    g_sys = _small_loop_system(cuda)
    initial = chip_smoke.loop_arena_tables(g_sys.arena)[0]
    closed, _, _, _, _ = _loop_closure(cuda, g_sys, True)
    fl, fc = g_sys.fused_loop, g_sys.fused_loop.correction
    count = int(fc.outputs["c"][-1])
    assert closed == [False, True] and fc.capacities == [64] and count <= 64
    past = [(10 + n % 4, n % 6) for n in range(65 - count)]
    chip_smoke.restore_loop_system(g_sys, initial)
    before = (fl.captures, fc.captures)
    fg = g_sys.fused_loop.global_ba
    ba_before = fg.captures
    closed, lc, (_, g_dig), _, _ = _loop_closure(cuda, g_sys, True, past)
    assert closed == [False, True] and int(fc.outputs["c"][-1]) == 65
    assert (fl.captures, fc.captures) == (before[0], before[1] + 1)
    assert fc.capacities == [64, 128]
    # the global BA's live count (4230 in both closures, as on the CPU)
    # stays in its capacity, 4608: its graphs replay, and the step is the
    # one capture
    assert int(fg.outputs["b"][-1]) == 4230 and fg.capacities == [4608]
    assert fg.captures == ba_before
    assert lc.graph_counts["captures"] == 1
    e_closed, _, (_, e_dig), _, _ = _loop_closure(
        cuda, _small_loop_system(cuda), False, past)
    assert e_closed == closed and e_dig == g_dig


def test_loop_correction_moved_arena_and_drop(cuda):
    """After a graph closure, a replaced arena raises in ``FusedCorrect``
    before any graph runs; ``drop_loop_graphs`` forgets the correction's
    graphs with ``FusedLoop``'s, and the next closure on the restored arena
    captures C, a step and F anew, to the same tables."""
    from cubemapslam_tpu_torch import slam_map as SM
    system = _small_loop_system(cuda)
    initial = chip_smoke.loop_arena_tables(system.arena)[0]
    _, _, (_, dig), _, _ = _loop_closure(cuda, system, True)
    fc = system.fused_loop.correction
    arena = system.arena
    system.arena = SM.MapArena(*(x.clone() for x in arena))
    with pytest.raises(RuntimeError, match="moved"):
        fc.correct(system, 13, 3, [fc.inputs[n] for n in
                                   ("s_cl", "R_cl", "t_cl")],
                   fc.inputs["loop_assoc"], fc.inputs["neigh_pre"], [], 12)
    system.arena = arena
    system.drop_loop_graphs()
    assert system.fused_loop is None
    chip_smoke.restore_loop_system(system, initial)
    closed, _, (_, again), _, _ = _loop_closure(cuda, system, True)
    assert closed == [False, True] and again == dig
    assert system.fused_loop.correction is not fc
    assert system.fused_loop.correction.captures == 3


def test_loop_graphs_moved_tables_raise(cuda):
    """After ``FusedLoop``'s graph D was captured, a replaced arena or BoW
    table raises on the next call."""
    from cubemapslam_tpu_torch import slam_map as SM
    from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    for field in ("arena", "bow_table"):
        system = _small_loop_system(cuda)
        lc = LoopCloser(cfg, CubemapCamera.from_config(cfg, cuda))
        lc.process(system, 12)
        assert system.fused_loop.captures == 1
        if field == "arena":
            system.arena = SM.MapArena(*(x.clone() for x in system.arena))
        else:
            system.bow_table = system.bow_table.clone()
        with pytest.raises(RuntimeError, match="moved"):
            lc.process(system, 13)


@pytest.mark.parametrize("site", chip_smoke.SIM3_EIG_SITES)
def test_sym_eig_sim3_bitwise(cuda, site):
    """The kernel bitwise against ``sym_eig_ordered`` (eagerly and from a
    CUDA graph, one launch) on the Sim3 RANSAC's Horn solves recorded from
    the small closure: the hypotheses' (300,4,4) and the refit's
    (1,4,4)."""
    store = []
    with chip_smoke.recording_sim3_eigh(store):
        _loop_closure(cuda, _small_loop_system(cuda), False)
    A = store[chip_smoke.SIM3_EIG_SITES.index(site)]
    assert A.shape == ((300, 4, 4) if site == "sim3.horn" else (1, 4, 4))
    c = chip_smoke.eig_case(site, A)
    assert c["bitwise"] and c["graph_bitwise"] and c["rotations"] > 0


# ---------------------------------------------------------------------------
# The symmetric eigen-solve kernel (csrc/sym_eig.cu) and relocalization as
# captured CUDA graphs (runtime/fused_reloc.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eig_inputs(cuda):
    """The six eigen-solve inputs of one ``pnp_ransac`` on the card
    (``chip_smoke.pnp_eig_inputs``), each as a (B, n, n) batch."""
    return [A.reshape(-1, *A.shape[-2:])
            for A in chip_smoke.pnp_eig_inputs(cuda)]


@pytest.mark.parametrize("site", chip_smoke.EIG_SITES)
def test_sym_eig_kernel_bitwise(cuda, eig_inputs, site):
    """The kernel bitwise against ``sym_eig_ordered`` (eagerly and from a
    CUDA graph, one launch) on each of the six solves of a PnP: (300,3,3),
    (300,12,12), (900,4,4), (1,3,3), (1,12,12), (3,4,4)."""
    A = eig_inputs[chip_smoke.EIG_SITES.index(site)]
    c = chip_smoke.eig_case(site, A)
    assert c["bitwise"] and c["graph_bitwise"] and c["rotations"] > 0


@pytest.mark.parametrize("n", [3, 4, 9, 12])
@pytest.mark.parametrize("batch", [1, 5, 8])
def test_sym_eig_kernel_specials(cuda, n, batch):
    """Ties, the identity, zero, rank one, indefinite, badly scaled, NaN and
    inf matrices in batches that end inside a block (1, 5) or fill two
    blocks (8): bitwise the ordered version, NaN where it is NaN."""
    A = chip_smoke.eig_specials(n, cuda)[:batch]
    c = chip_smoke.eig_case(f"specials n={n} x {batch}", A)
    assert c["bitwise"] and c["graph_bitwise"]


@pytest.mark.parametrize("site", chip_smoke.EIG_SITES)
def test_sym_eig_kernel_against_eigh(cuda, eig_inputs, site):
    """The kernel against ``torch.linalg.eigh`` (cuSOLVER, float32) by the
    invariants of ``tests/test_torch_sym_eig.py``: eigenvalues within 1e-6
    of the largest |eigenvalue|, V diag(w) Vᵀ within 1e-6 of A and VᵀV
    within 1e-6 of I; for MᵀM the projector onto the 4-dimensional null
    space within 1e-3 of cuSOLVER's; for Horn's 4x4 the quaternion of the
    largest eigenvalue, where it is separated by 1e-2, up to its sign."""
    from cubemapslam_tpu_torch.solvers import sym_eig as SE
    A = eig_inputs[chip_smoke.EIG_SITES.index(site)]
    w, V = SE.sym_eig(A)
    we, Ve = torch.linalg.eigh(A)
    w, V, we, Ve, A = (x.double() for x in (w, V, we, Ve, A))
    scale = we.abs().amax(dim=-1)
    assert ((w - we).abs().amax(dim=-1) <= 1e-6 * scale).all()
    rec = V @ (w[..., :, None] * V.transpose(-1, -2))
    assert ((rec - A).abs().amax(dim=(-1, -2)) <= 1e-6 * scale).all()
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=cuda)
    assert (V.transpose(-1, -2) @ V - eye).abs().max() <= 1e-6
    if site.endswith("null"):
        P, Pe = (X[..., :4] @ X[..., :4].transpose(-1, -2) for X in (V, Ve))
        assert (P - Pe).abs().max() <= 1e-3
    if site.endswith("horn"):
        sep = (we[:, 3] - we[:, 2]) > 1e-2 * scale
        q, qe = V[sep, :, 3], Ve[sep, :, 3]
        d = torch.minimum((q - qe).abs().amax(-1), (q + qe).abs().amax(-1))
        assert sep.any() and (d <= 1e-3).all()


def test_sym_eig_wrapper_raises(cuda):
    from cubemapslam_tpu_torch.solvers import sym_eig as SE
    n0 = SE.SYM_EIG.launches
    for A in (torch.eye(5, device=cuda)[None],
              torch.eye(4, device=cuda, dtype=torch.float16)[None],
              torch.zeros(3, 4, 5, device=cuda)):
        with pytest.raises(ValueError):
            SE.sym_eig_cuda(A)
    assert SE.SYM_EIG.launches == n0
    w, V = SE.sym_eig_cuda(torch.zeros(0, 4, 4, device=cuda))
    assert w.shape == (0, 4) and V.shape == (0, 4, 4)
    assert SE.SYM_EIG.launches == n0
    # a strided batch is solved as its contiguous copy
    A = chip_smoke.eig_specials(4, cuda)[:6]
    w1, V1 = SE.sym_eig_cuda(A.transpose(-1, -2))
    w2, V2 = SE.sym_eig_cuda(A.transpose(-1, -2).contiguous())
    assert chip_smoke.same_float_bits(w1, w2)
    assert chip_smoke.same_float_bits(V1, V2)


def two_view_scene(rng, n=300, noise=5e-4, n_out=45, device="cpu"):
    """Rays and cross uv of ``n`` seeded points seen from the identity and
    from a pose 0.8 map units away, with angular noise and ``n_out``
    scrambled matches: (rays1, rays2, uv1, uv2, valid, R21, t21) on
    ``device``, the camera of ``SlamConfig()``."""
    from cubemapslam_tpu_torch import camera as TC
    cam = CubemapCamera.from_config(SlamConfig(), "cpu")
    pts = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    R21 = so3_exp(torch.tensor([0.03, -0.08, 0.01])).numpy()
    t21 = np.array([0.8, 0.15, -0.1], np.float32)
    out = []
    for P in (pts, pts @ R21.T + t21):
        r = P / np.linalg.norm(P, axis=1, keepdims=True)
        r = r + rng.normal(0, noise, r.shape)
        r = torch.as_tensor((r / np.linalg.norm(r, axis=1, keepdims=True))
                            .astype(np.float32))
        uv, face = TC.ray_to_cubemap(cam, r)
        out.append((r, uv, face >= 0))
    (r1, uv1, v1), (r2, uv2, v2) = out
    valid = v1 & v2
    if n_out:
        idx = rng.choice(np.nonzero(valid.numpy())[0], n_out, replace=False)
        perm = torch.as_tensor(rng.permutation(idx))
        idx = torch.as_tensor(idx)
        r2[idx], uv2[idx] = r2[perm], uv2[perm]
    return tuple(x.to(device) for x in (r1, r2, uv1, uv2, valid)) + (
        torch.as_tensor(R21), torch.as_tensor(t21))


def init_eig_inputs(device, seed=15, n_iters=200):
    """A ``recording_essential`` record of one ``initialize_two_view`` on a
    seeded ``two_view_scene`` on ``device`` (its scores drawn by a host
    generator), and the result."""
    from cubemapslam_tpu_torch.solvers import essential as ES
    from cubemapslam_tpu_torch.solvers.sampling import draw_scores
    r1, r2, uv1, uv2, valid, _, _ = two_view_scene(
        np.random.default_rng(seed), device=device)
    scores = draw_scores(torch.Generator().manual_seed(seed), n_iters,
                         valid.shape[0], device)
    rec = {}
    with chip_smoke.recording_essential(rec):
        res, _ = ES.initialize_two_view(
            CubemapCamera.from_config(SlamConfig(), device), scores, r1, r2,
            uv1, uv2, valid)
    return rec, res


@pytest.fixture(scope="module")
def init_eig(cuda):
    """The essential solver's three eigen-solve inputs of one
    ``initialize_two_view`` on the card (``init_eig_inputs``),
    by site, and its result."""
    rec, res = init_eig_inputs(cuda)
    return chip_smoke.init_eig_cases(rec), res


@pytest.mark.parametrize("site", chip_smoke.INIT_EIG_SITES)
def test_sym_eig_kernel_init_bitwise(cuda, init_eig, site):
    """The kernel bitwise against ``sym_eig_ordered`` (eagerly and from a
    CUDA graph, one launch) on the two-view attempt's solves: the
    (200,9,9) float64 normal matrices, read without a rounding to float32,
    the (200,3,3) and the (1,3,3) EᵀE; and float64 specials at n = 9."""
    cases, res = init_eig
    assert bool(res.success)
    A = cases[site][0]
    assert A.dtype == (torch.float64 if site == "normal" else torch.float32)
    c = chip_smoke.eig_case(site, A)
    assert c["bitwise"] and c["graph_bitwise"] and c["rotations"] > 0
    if site == "normal":
        sp = chip_smoke.eig_case("specials n=9 float64",
                                 chip_smoke.eig_specials(9, cuda).double())
        assert sp["bitwise"] and sp["graph_bitwise"]


def test_essential_null_vector_against_svd(cuda, init_eig):
    """The normal matrices' smallest eigenvector on the card against the
    null vector of cuSOLVER's float32 SVD of the 8x9 systems, up to its
    sign, within 1e-4."""
    from cubemapslam_tpu_torch.solvers import sym_eig as SE
    N, A8 = init_eig[0]["normal"]
    e = SE.sym_eig(N)[1][..., :, 0]
    v = torch.linalg.svd(A8)[2][..., 8, :]
    d = torch.minimum((e - v).abs().amax(-1), (e + v).abs().amax(-1))
    assert d.max() <= 1e-4, float(d.max())


def _pnp_args(cuda, seed=3):
    cfg = SlamConfig()
    _, _, pw, rays, uv, valid = chip_smoke.pnp_scene(
        CubemapCamera.from_config(cfg, "cpu"), np.random.default_rng(seed),
        n=2000, n_out=600)
    cam = CubemapCamera.from_config(cfg, cuda)
    return cfg, cam, [x.to(cuda) for x in (pw, rays, uv, torch.ones(2000),
                                           valid)]


def test_pnp_ransac_waits_on_the_card(cuda):
    """One ``pnp_ransac`` on the card makes the host wait ``pnp.EIGH_WAITS``
    = 0 times, its minimal sets drawn from a generator on the card, counted
    as ``test_sim3_ransac_eigh_waits`` counts them; it launches the
    eigen-solve kernel 6 times and recovers the pose."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from cubemapslam_tpu_torch.solvers import pnp as PNP
    from cubemapslam_tpu_torch.solvers import sym_eig as SE
    cfg, cam, args = _pnp_args(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    PNP.pnp_ransac(cam, gen, *args)
    torch.cuda.synchronize()
    n0 = SE.SYM_EIG.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("pnp"):
            res = PNP.pnp_ransac(cam, gen, *args)
        torch.cuda.synchronize()
    ev = prof.events()
    span = [(e.time_range.start, e.time_range.end) for e in ev
            if e.name == "pnp" and e.device_type == DeviceType.CPU]
    waits = [e for e in ev if e.device_type == DeviceType.CPU
             and ("Synchronize" in e.name or e.name == "cudaMemcpy")
             and any(a <= e.time_range.start < b for a, b in span)]
    assert len(waits) == PNP.EIGH_WAITS == 0, [e.name for e in waits]
    assert SE.SYM_EIG.launches == n0 + 6
    assert bool(res.success) and int(res.n_inliers) > 1000


def test_pnp_ransac_from_a_cuda_graph(cuda):
    """``pnp_ransac`` on scores in a static buffer, captured in a CUDA graph
    (its LU solves on cuSOLVER / cuBLAS's batched LU, its eigen-solves on
    the kernel) and replayed on new scores: bitwise the eager call on the
    same scores each time."""
    from cubemapslam_tpu_torch.solvers import pnp as PNP
    cfg, cam, args = _pnp_args(cuda, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(1)
    scores = torch.rand((cfg.pnp_ransac_iters, 2000), generator=gen,
                        device=cuda)

    def run():
        return list(PNP.pnp_ransac(cam, None, *args, scores=scores))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run()
    for k in range(3):
        scores.copy_(torch.rand(scores.shape, generator=gen, device=cuda))
        graph.replay()
        eager = run()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(static, eager)), k
        assert bool(eager[0])


RELOC_SMALL = dict(SLAM_SMALL, min_track_inliers_after_reloc=30)


@pytest.fixture(scope="module")
def reloc_map(cuda, slam_frames, tmp_path_factory):
    """``CubemapSLAM`` on the card over ``slam_frames``' 12 frames (the
    relocalization gate at 30 inliers, as the CPU reloc tests), saved."""
    from cubemapslam_tpu_torch import serialize
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM, TrackState
    _, frames = slam_frames
    cfg = SlamConfig(**RELOC_SMALL)
    slam = CubemapSLAM(cfg, device=cuda)
    for k, img in enumerate(frames):
        slam.track_fisheye(img, k / cfg.fps)
    assert slam.state == TrackState.OK
    path = str(tmp_path_factory.mktemp("reloc") / "map.npz")
    serialize.save_map(slam, path)
    return cfg, frames, path


def _reloc_run(cuda, reloc_map, graphs):
    """The saved map loaded on the card (LOST), then a relocalizing frame, a
    blank frame, another relocalizing frame, a blank frame and the first
    again, with ``reloc_graphs`` as given: (system, per-frame
    ``_slam_state``, per-frame launches of the eigen-solve and pose-LM
    kernels)."""
    from cubemapslam_tpu_torch import serialize
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    from cubemapslam_tpu_torch.solvers import sym_eig as SE
    cfg, frames, path = reloc_map
    slam = CubemapSLAM(cfg, device=cuda)
    serialize.load_map(slam, path)
    slam.reloc_graphs = graphs
    blank = np.full(frames[0].shape, 20, np.uint8)
    states, launches = [], []
    for k, img in enumerate((frames[6], blank, frames[9], blank, frames[6])):
        SE.SYM_EIG.launches = PO.POSE_LM.launches = 0
        T = slam.track_fisheye(img, 20.0 + k)
        states.append(_slam_state(slam, T))
        launches.append((SE.SYM_EIG.launches, PO.POSE_LM.launches))
    torch.cuda.synchronize()
    return slam, states, launches


def test_reloc_graphs_bitwise_eager(cuda, reloc_map):
    """Relocalization through ``FusedReloc``'s graphs R and W against the
    eager path on the same loaded map and generator: every pose, row (its
    reads and the candidates' scores), last frame, arena table and the BoW
    table bitwise equal at every frame, the same launches; graph R and W
    captured on the first relocalizing frame and replayed after; 6
    eigen-solve launches an ok candidate and 0 eigen-solve waits."""
    (e_slam, e_states, e_launch), (g_slam, g_states, g_launch) = (
        _reloc_run(cuda, reloc_map, graphs) for graphs in (False, True))
    _same_frames(e_states, g_states)
    assert e_launch == g_launch
    assert e_slam.fused_reloc is None
    rows = [r for r in g_slam.metrics if r.get("stage") == "reloc"]
    relocs = [r for r in rows if r.get("reloc_candidates")]
    assert [r["relocalized"] for r in relocs] == [True, True, True]
    assert relocs[0]["graph_reloc_captures"] == 2
    assert all(r["graph_reloc_captures"] == 0 and r["graph_reloc_replays"]
               >= r["reloc_candidates"] + 1 for r in relocs[1:])
    for r, (n_eig, _) in zip(rows, [g_launch[i] for i in (0, 2, 4)]):
        assert r["eigh_waits"] == 0 and r["host_reads"] >= 3
        assert n_eig == 6 * r["reloc_candidates"]
    fr = g_slam.fused_reloc
    assert (fr.captures, fr.replays) == (2, sum(
        r["graph_reloc_replays"] for r in relocs))


def _localization_run(cuda, reloc_map, graphs):
    """The saved map loaded on the card (LOST) and relocalized, then in
    localization mode: two frames, a frame with the last association
    emptied (no match at 15 px nor 30 px, the reference-keyframe fallback,
    TrackLocalMap), a frame on landmarks perturbed by sigma 0.12 and one on
    the restored landmarks, a blank frame and the first frame again (LOST),
    with ``localization_graphs`` and ``reloc_graphs`` as given: (system,
    per-frame ``_slam_state`` with mbVO, per-frame launches of every kernel
    entry of the frame)."""
    from cubemapslam_tpu_torch import serialize
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    cfg, frames, path = reloc_map
    slam = CubemapSLAM(cfg, device=cuda)
    serialize.load_map(slam, path)
    slam.reloc_graphs = slam.localization_graphs = graphs
    kernels = (warp_cuda.WARP_REMAP, TE.ORB_FAST, TE.ORB_SELECT,
               TE.ORB_DESCRIBE, PO.POSE_LM)
    noise = 0.12 * torch.randn(slam.arena.lm_pos.shape,
                               generator=torch.Generator().manual_seed(0))
    clean = None
    states, launches = [], []

    def track(img, ts):
        for k in kernels:
            k.launches = 0
        T = slam.track_fisheye(img, ts)
        states.append((*_slam_state(slam, T), slam.mb_vo))
        launches.append(tuple(k.launches for k in kernels))

    track(frames[6], 20.0)
    slam.activate_localization_mode()
    for k in (7, 8):
        track(frames[k], 20.0 + k)
    slam.last = slam.last._replace(assoc=torch.full_like(slam.last.assoc,
                                                         -1))
    track(frames[9], 29.0)
    clean = slam.arena.lm_pos.clone()
    slam.arena.lm_pos.add_(noise.to(cuda))
    track(frames[10], 30.0)
    slam.arena.lm_pos.copy_(clean)
    track(frames[11], 31.0)
    track(np.full(frames[0].shape, 20, np.uint8), 32.0)
    track(frames[6], 33.0)
    torch.cuda.synchronize()
    return slam, states, launches


def test_localization_graphs_bitwise_eager(cuda, reloc_map):
    """Localization-mode and LOST frames through ``FusedLocalization``'s
    graphs (L1: the front end and the 15 px search; L2: 30 px; L3:
    TrackLocalMap; X: a LOST frame's front end) against the eager path on
    the same loaded map: every pose, row, last frame, velocity, arena table
    (the visible/found counters), the BoW table and mbVO bitwise equal at
    every frame, the same launches of every kernel entry (W, D and describe
    once a frame, from the replays); L1, L3 and X captured once and
    replayed, L2 and LR (the reference-keyframe fallback) on the emptied
    frame."""
    (e_slam, e_states, e_launch), (g_slam, g_states, g_launch) = (
        _localization_run(cuda, reloc_map, graphs)
        for graphs in (False, True))
    _same_frames([s[:3] for s in e_states], [s[:3] for s in g_states])
    assert [s[3] for s in e_states] == [s[3] for s in g_states]
    assert e_launch == g_launch
    assert all(n[:4] == (1, 1, 1, 1) for n in g_launch)
    assert e_slam.fused_localization is None
    fl = g_slam.fused_localization
    assert set(fl.outputs) == {"l1", "l2", "lr", "l3", "x"}
    assert fl.captures == 5 and fl.replays > 5
    rows = [r for r in g_slam.metrics if "frame" in r]
    assert rows[0]["graph_localization_captures"] == 1      # X
    assert rows[-1]["stage"] == "reloc"
    assert rows[-1]["graph_localization_replays"] == 1      # X again
    emptied = rows[3]
    assert emptied["host_reads"] == 4
    assert (emptied["graph_localization_captures"],
            emptied["graph_localization_replays"]) == (2, 2)


def test_localization_reference_graph_replays(cuda, reloc_map):
    """The localization frame with its last association emptied, 4 times
    from one restored state (``chip_smoke.loc_state`` / ``restore_loc``),
    through ``FusedLocalization``'s graphs and eagerly: every frame bitwise
    its eager twin and the first; the first graph frame captures L2 and LR,
    every later one replays L1, L2, LR and L3 by name and captures none;
    the pose-LM kernel launches 4 times a frame both ways (L1, L2, LR,
    L3)."""
    from cubemapslam_tpu_torch import serialize
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    cfg, frames, path = reloc_map
    runs = []
    for graphs in (False, True):
        slam = CubemapSLAM(cfg, device=cuda)
        serialize.load_map(slam, path)
        slam.reloc_graphs = slam.localization_graphs = graphs
        assert slam.track_fisheye(frames[6], 20.0) is not None
        slam.activate_localization_mode()
        assert slam.track_fisheye(frames[7], 27.0) is not None
        state = chip_smoke.loc_state(slam)
        out, lm = [], []
        for _ in range(4):
            chip_smoke.restore_loc(slam, state)
            slam.last = slam.last._replace(
                assoc=torch.full_like(slam.last.assoc, -1))
            PO.POSE_LM.launches = 0
            T = slam.track_fisheye(frames[8], 28.0)
            out.append((*_slam_state(slam, T), slam.mb_vo))
            lm.append(PO.POSE_LM.launches)
        runs.append((out, lm, slam))
    (e_out, e_lm, _), (g_out, g_lm, g_slam) = runs
    _same_frames([s[:3] for s in e_out], [s[:3] for s in g_out])
    _same_frames([s[:3] for s in e_out[:1] * 4], [s[:3] for s in e_out])
    assert [s[3] for s in e_out] == [s[3] for s in g_out]
    assert e_lm == g_lm == [4] * 4
    rows = g_slam.metrics[-4:]
    assert all(r["host_reads"] == 4 and not r["vo"] for r in rows)
    assert rows[0]["graph_localization_captures"] == 2
    assert all(r["graph_localization_captures"] == 0
               and r["graph_localization_replayed"] == ("L1", "L2", "LR",
                                                        "L3")
               for r in rows[1:])


def _profiled(fn):
    """(host events, device operations) of ``fn()`` under ``torch.profiler``
    on the CPU and the card, each as (name, start ns, end ns, correlation
    id); the device side of a host range is not an operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        x = (e.name(), a, a + e.duration_ns(), e.correlation_id())
        (dev if e.device_type() == DeviceType.CUDA else cpu).append(x)
    names = {e[0] for e in cpu}
    return cpu, [e for e in dev if e[0] not in names]


def _op_name(name):
    """A device operation's name, with a copy or a fill named by its kind
    alone: a graph's device-to-device memcpy node runs as one of the
    CUDA runtime's copy kernels (``memcpy32_post``, ``memcpy128``), and the
    profiler names a graph's memset node ``Memset (Unknown)`` where it
    names the eager one ``Memset (Device)``."""
    if name.startswith(("Memcpy DtoD", "memcpy")):
        return "Memcpy DtoD"
    if name.startswith("Memset"):
        return "Memset"
    return name


def _launched_in(cpu, ops, a, b):
    """The names of the device operations launched by a CUDA call that
    starts in [a, b), by device start."""
    corr = {e[3] for e in cpu
            if e[0].startswith("cu") and e[3] and a <= e[1] < b}
    return [_op_name(k[0]) for k in sorted((k for k in ops if k[3] in corr),
                                           key=lambda k: k[1])]


def _census_against_trace(owner, tracker, frame, parts):
    """``frame()`` (a frame of ``tracker`` that replays the graphs
    ``parts`` of ``owner``, a ``CapturedFrame``) under the profiler: each
    replay's device operations number its census total, and the frame's
    row holds the table. Then each part run eagerly under the profiler:
    the census stages, in the order entered, are its spans of the same
    names in the order opened, and each stage's operations of the replay
    have the names of those the eager span launched, in order."""
    cpu, ops = _profiled(frame)
    row = tracker.metrics[-1]
    replay = {}
    for name in parts:
        table = owner.census[name]
        (a, b), = [(e[1], e[2]) for e in cpu if e[0] == table[0][0]]
        replay[name] = _launched_in(cpu, ops, a, b)
        assert len(replay[name]) == table[0][2] > 0, name
        assert row["graph_stages"][table[0][0]] is table
    for name, part in parts.items():
        table = owner.census[name]
        stages = {s for s, _, _ in table[1:]}
        cpu, ops = _profiled(part)
        spans = sorted(((e[1], -e[2], e[0]) for e in cpu
                        if e[0] in stages))
        assert [s for _, _, s in spans] == [s for s, _, _ in table[1:]]
        for (a, neg_b, _), (stage, first, end) in zip(spans, table[1:]):
            assert (_launched_in(cpu, ops, a, -neg_b)
                    == replay[name][first:end]), (name, stage)


# set in the process that ``_in_a_new_process`` starts
NEW_PROCESS = "CUBEMAP_CENSUS_TEST_PROCESS"


def _in_a_new_process(request) -> bool:
    """Run this test again in a new process, and pass where it passes there;
    True in the new process. In a process that profiled before, the trace
    can lose some of a CUDA graph replay's operations and the host call of
    a hand-written kernel's eager launch (PyTorch's profiler notes that
    CUDA graphs do not work well with CUPTI's teardown between profiles);
    the benchmark profiles once a process, as the new one does."""
    if os.environ.get(NEW_PROCESS) == "1":
        return True
    here = pathlib.Path(__file__).resolve()
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "--noconftest", "-m", "gpu", "-q", f"{here}::{request.node.name}"],
        cwd=here.parents[1], env=dict(os.environ, **{NEW_PROCESS: "1"}),
        capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stdout[-6000:] + p.stderr[-3000:]
    return False


def test_graph_census_localization(cuda, request):
    """Graphs L1 and L3 of a localization-mode frame on the card, in a new
    process (``_in_a_new_process``): the census of each capture against a
    replay and the eager parts under the profiler
    (``_census_against_trace``); L1's front end stages are ``warp``
    (kernel W alone), ``extract`` and its five ``extract.*`` steps, and
    ``pose_lm``, each with operations."""
    from cubemapslam_tpu_torch import serialize
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    if not _in_a_new_process(request):
        return
    cfg, frames, path = request.getfixturevalue("reloc_map")
    slam = CubemapSLAM(cfg, device=cuda)
    serialize.load_map(slam, path)
    assert slam.track_fisheye(frames[6], 20.0) is not None
    slam.activate_localization_mode()
    for k in (7, 8):
        assert slam.track_fisheye(frames[k], 20.0 + k) is not None
    fl = slam.fused_localization
    _census_against_trace(
        fl, slam, lambda: slam.track_fisheye(frames[9], 29.0),
        {"l1": lambda: fl._part_l1(slam), "l3": lambda: fl._part_l3(slam)})
    assert slam.metrics[-1]["kind"] == "localization"
    stages = {s: (a, b) for s, a, b in fl.census["l1"][1:]}
    assert {"warp", "extract", "extract.pyramid", "extract.detect",
            "extract.select", "extract.describe", "extract.rays",
            "pose_lm"} <= set(stages)
    assert stages["warp"][1] - stages["warp"][0] == 1
    assert all(b > a for a, b in stages.values())


def test_graph_census_tracked(cuda, request):
    """Graphs A and B of ``MapTracker``'s tracked frame on the card, in a new
    process (``_in_a_new_process``): the census of each capture against a
    replay and the eager parts under the profiler
    (``_census_against_trace``)."""
    if not _in_a_new_process(request):
        return
    graph_scene = request.getfixturevalue("graph_scene")
    tr = graph_scene["tracker"](False)
    frames = graph_scene["frames"]
    for k in (0, 1):
        assert tr.track_fisheye(frames[k], k / 30.0) is not None
    fs = tr.fused_step
    _census_against_trace(
        fs, tr, lambda: tr.track_fisheye(frames[2], 2 / 30.0),
        {"a": lambda: fs._part_a(tr), "b": lambda: fs._part_b(tr)})
    assert tr.metrics[-1]["kind"] == "tracked"


def test_frame_tracker_graph_bitwise_eager(cuda):
    """``FrameTracker``'s graph F (captured on the first call, replayed on
    every later one) against ``FrameTracker(graphs=False)`` over 4 calls
    from different start poses, the frame on the card or, on the last,
    as a host array: every output bitwise equal; kernels W, D (two
    entries), describe and the pose LM launch once a frame, replays
    included; a landmark set of another shape raises."""
    from cubemapslam_tpu_torch.optim import pose_opt as PO
    cfg = SlamConfig(**SMALL)
    graph, eager = FrameTracker(cfg), FrameTracker(cfg, graphs=False)
    eager.set_warp_map(graph.warp_map)
    img = textured(cfg.fisheye_height, cfg.fisheye_width,
                   seed=4).clip(0, 255).astype(np.uint8)
    dev_img = torch.as_tensor(img, device=cuda)
    kp0 = graph.extract(graph.warp(dev_img))
    v = kp0.valid
    n = int(v.sum())
    gen = torch.Generator(device=cuda).manual_seed(0)
    lms = (kp0.rays[v] * (3 + 5 * torch.rand(n, 1, generator=gen,
                                             device=cuda)),
           kp0.desc[v], kp0.level[v],
           torch.ones(n, dtype=torch.bool, device=cuda))
    kernels = (warp_cuda.WARP_REMAP, TE.ORB_FAST, TE.ORB_SELECT,
               TE.ORB_DESCRIBE, PO.POSE_LM)
    for k, turn in enumerate((0.0, 0.01, -0.015, 0.02)):
        R0 = so3_exp(torch.tensor([turn, 0.5 * turn, 0.0], device=cuda))
        t0 = torch.tensor([0.01, 0.0, -0.01], device=cuda)
        for c in kernels:
            c.launches = 0
        g = graph(img if k == 3 else dev_img, *lms, R0, t0)
        assert [c.launches for c in kernels] == [1, 1, 1, 1, 1]
        e = eager(dev_img, *lms, R0, t0)
        assert all(torch.equal(x, y) for x, y in zip(g[0], e[0]))
        assert all(torch.equal(x, y) for x, y in zip(g[1:], e[1:]))
        cf = graph.step_graph
        assert (cf.frame_captures, cf.frame_replayed) == \
            ((1, []) if k == 0 else (0, ["F"]))
    assert (cf.captures, cf.replays) == (1, 3)
    assert eager.step_graph is None
    with pytest.raises(ValueError, match="lm_pos"):
        graph(dev_img, lms[0][:-1], *lms[1:], R0, t0)


# a pre-initialization sequence of ``slam_frames`` (-1: a blank frame): the
# reference, an attempt without parallax (I1, I2 captured), a blank frame
# that drops the reference, the reference again (I0 replayed), attempts
# until the map is made; then a reset, which keeps the graphs, and the
# bootstrap again, replaying them
INIT_SEQUENCE = (0, 0, -1, 0, 1, 2, 3, 4)
INIT_AFTER_RESET = (0, 0, 1, 2, 3, 4)


def _init_run(cuda, cfg, frames, graphs):
    """``CubemapSLAM`` on the card over INIT_SEQUENCE (until the map is
    made), a reset, then INIT_AFTER_RESET (likewise), through
    ``FusedInit`` or eagerly (``init_graphs`` off): per frame the row
    without its graph counts, the pose, clones of ``init_trace``, the
    sym_eig launches, the whole row and the sequence (0 or 1); the
    system."""
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM, TrackState
    from cubemapslam_tpu_torch.solvers import sym_eig as SE
    slam = CubemapSLAM(cfg, device=cuda)
    slam.init_graphs = graphs
    out = []
    for cycle, seq in enumerate((INIT_SEQUENCE, INIT_AFTER_RESET)):
        for k in seq:
            img = (np.zeros_like(frames[0]) if k < 0 else frames[k])
            n0 = SE.SYM_EIG.launches
            T = slam.track_fisheye(img, len(out) / cfg.fps)
            out.append((chip_smoke.init_record(slam, T),
                        SE.SYM_EIG.launches - n0, dict(slam.metrics[-1]),
                        cycle))
            if slam.state == TrackState.OK:
                break
        slam.reset()
    torch.cuda.synchronize()
    return slam, out


def test_init_graphs_bitwise_eager(cuda, slam_frames):
    """Pre-initialization frames through ``FusedInit``'s graphs I0, I1 and
    I2 against the eager path (``init_graphs`` off) on the card: every row,
    pose and attempt (keypoints, matches, window centres, E21, R21, t21,
    p3d, good) bitwise equal, the same sym_eig launches (3 an attempt that
    reaches the RANSAC); I0, I1 and I2 captured once, on the first frames
    that need them, and replayed after, across the reset that keeps
    them."""
    cfg, frames = slam_frames
    (e_slam, e), (g_slam, g) = (_init_run(cuda, cfg, frames, graphs)
                                for graphs in (False, True))
    assert len(e) == len(g)
    for i, (a, b) in enumerate(zip(e, g)):
        chip_smoke.same_init(f"frame {i}", b[0], a[0])
        assert a[1] == b[1], (i, a[1], b[1])
    assert any(r[0]["T"] is not None for r in g)
    attempts = [r for r in g if "E" in r[0]["trace"]]
    assert len(attempts) >= 3 and all(r[1] == 3 for r in attempts)
    fi = g_slam.fused_init
    assert e_slam.fused_init is None and set(fi.outputs) == {"i0", "i1",
                                                             "i2"}
    assert fi.captures == 3 and fi.replays >= 5
    rows = [r[2] for r in g]
    assert sum(r["graph_init_captures"] for r in rows) == 3
    later = [r[2] for r in g if r[3] == 1]
    assert len(later) >= 2 and all(r["graph_init_captures"] == 0
                                   and r["graph_init_replays"] > 0
                                   for r in later)


def test_init_attempt_waits(cuda, slam_frames, monkeypatch):
    """A replaying attempt on the card waits for the host only for its 2
    reads and the frame's upload, and never in ``torch.linalg.svd`` (patched
    to raise here: the essential solver takes none)."""
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    cfg, frames = slam_frames

    def no_svd(*a, **k):
        raise AssertionError("an init frame called torch.linalg.svd")

    monkeypatch.setattr(torch.linalg, "svd", no_svd)
    slam = CubemapSLAM(cfg, device=cuda)
    for k in (0, 0, 0):                 # capture I0, then I1 and I2
        slam.track_fisheye(frames[k], 0.0)
    prof = chip_smoke.profile_stages(
        lambda: slam.track_fisheye(frames[0], 0.1), ("init",), 1)
    row = slam.metrics[-1]
    assert row["graph_init_captures"] == 0 and row["graph_init_replays"] == 2
    assert row["host_reads"] == 2 and "init_matches" in row
    assert prof["host_waits"] <= row["host_reads"] + 1, prof["wait_sources"]
    assert not any("svd" in src for src, _ in prof["wait_sources"])
