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
and ``sim3_ransac`` waits ``sim3.EIGH_WAITS`` times. The segmented-sum
kernel at the main path's shapes (the global BA's camera and point sums,
the local BA's coupling and point sums, the pose graph's normal matrix, the
landmark normals with their dump row): bitwise equal to its kernel-order
plain version, two launches on one plan bitwise equal, and within
len * 2^-23 * sum|v| of the CPU's ``index_add_`` per segment; strided
rows, one lane and no rows as their plain version. Run twice on the card
from one arena, bitwise equal: ``mapping_step`` with its BA, ``local_ba``,
the loop correction from the CPU's refined Sim3, the global BA, and the
pose graph.
"""

import math
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from cubemapslam_tpu_torch import SlamConfig
from cubemapslam_tpu_torch import warp as TW
from cubemapslam_tpu_torch import warp_cuda
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.features import extractor as TE
from cubemapslam_tpu_torch.runtime import FrameTracker
from cubemapslam_tpu_torch.runtime import synthetic as S
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
    hypothesis starts from a null basis of its own (cuSOLVER's, LAPACK's),
    so both are held to the outcome: success, inlier counts within 5%, the
    truth within 1 deg / 0.05."""
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
    reasons are in ``chip_smoke.py``. On the card the closing call reads 7
    times (detection among them), waits 3 times in eigh and synchronizes
    twice to time its last stages (the global BA, held back here, reads
    once more)."""
    chip_smoke.small_loop_reference_check(card=cuda)
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    closed, _, _, lc = chip_smoke.small_loop_closure(cfg, cuda)
    assert closed == [False, True]
    assert (lc.reads, lc.eigh_waits) == (9, 3)


def test_sim3_ransac_eigh_waits(cuda):
    """One ``sim3_ransac`` on the card waits ``sim3.EIGH_WAITS`` times (its
    Horn eigen-solves: the batch once, the single refit twice), counted as
    ``chip_smoke.py`` counts host waits."""
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
    S3.sim3_ransac(cam, gen, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("sim3"):
            res = S3.sim3_ransac(cam, gen, *args)
        torch.cuda.synchronize()
    ev = prof.events()
    span = [(e.time_range.start, e.time_range.end) for e in ev
            if e.name == "sim3" and e.device_type == DeviceType.CPU]
    waits = [e for e in ev if e.device_type == DeviceType.CPU
             and ("Synchronize" in e.name or e.name == "cudaMemcpy")
             and any(a <= e.time_range.start < b for a, b in span)]
    assert len(waits) == S3.EIGH_WAITS, [e.name for e in waits]
    assert bool(res.success) and abs(float(res.s12) - 1.3) < 1e-3


@pytest.mark.parametrize("name", list(chip_smoke.SEG_SHAPES))
def test_seg_sum_kernel_bitwise(cuda, name):
    """The segmented-sum kernel bitwise equal to its kernel-order plain
    version on the card, two launches on one plan bitwise equal, and within
    len * 2^-23 * sum|v| of the CPU's index_add_ (its own summation
    order)."""
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
    """The tier-1-size constructed-drift closure on the card twice from
    the CPU's refined Sim3 (loop fusion, the pose graph, SearchAndFuse),
    then the global BA twice from the CPU's corrected arena: each pair
    bitwise equal."""
    import types
    from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser
    cfg = SlamConfig(**chip_smoke.LOOP_SMALL)
    _, c, rec, _ = chip_smoke.small_loop_closure(cfg, "cpu")
    corrected = [chip_smoke.small_loop_closure(
        cfg, cuda, refined=rec["refined"])[1] for _ in range(2)]
    assert _arena_equal(*corrected) == []
    solved = []
    for _ in range(2):
        system = types.SimpleNamespace(arena=c.to(cuda))
        LoopCloser(cfg, CubemapCamera.from_config(cfg, cuda))._global_ba(
            system)
        solved.append(system.arena.to("cpu"))
    assert _arena_equal(*solved) == []


def test_pose_graph_twice_bitwise(cuda):
    """``optimize_essential_graph`` on a 64-vertex ring with chain,
    covisibility and loop edges, twice on the card: bitwise equal."""
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
    for x, y in zip(a, b):
        assert torch.equal(x, y)
