"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA card every test skips (decided in a fixture).
This file imports nothing of JAX, so it also runs on a machine without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: kernel W within 1e-3 of the plain resampler (it rounds each
product and sum as the plain version does, so it is bitwise in practice);
kernel D's candidates bitwise, subpixel offsets within
1e-6; kernel G bitwise.
"""

import numpy as np
import pytest
import torch

from cubemapslam_tpu_torch import SlamConfig
from cubemapslam_tpu_torch import warp as TW
from cubemapslam_tpu_torch import warp_cuda
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.features import extractor as TE
from cubemapslam_tpu_torch.runtime import FrameTracker

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


@pytest.mark.parametrize("shape,cell,kind", [
    ((157, 201), 32, "textured"), ((150, 203), 32, "tied"),
    ((96, 130), 16, "textured"), ((1950, 1950), 32, "textured")])
def test_detect_kernel(cuda, shape, cell, kind):
    img = textured(*shape, seed=1) if kind == "textured" else tied(*shape)
    t = torch.as_tensor(img, device=cuda)
    n0 = (TE.ORB_FAST.launches, TE.ORB_SELECT.launches)
    kern = TE.detect_cells(t, cell, 20, 7)
    plain = TE._detect_cells_plain(t, cell, 20, 7)
    torch.cuda.synchronize()
    assert (TE.ORB_FAST.launches, TE.ORB_SELECT.launches) == (n0[0] + 1,
                                                              n0[1] + 1)
    for a, b in zip(kern[:3], plain[:3]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    for a, b in zip(kern[3:], plain[3:]):
        assert float((a - b).abs().max()) <= 1e-6
    assert (kern[0] > 0).sum() > 10


def test_gather_kernel(cuda):
    img = textured(157, 201, seed=2)
    H, W = img.shape
    rng = np.random.default_rng(3)
    ys = np.concatenate([rng.integers(0, H, 300), [-5, 0, H - 1, H + 7]])
    xs = np.concatenate([rng.integers(0, W, 300), [2, -9, W + 3, W - 1]])
    t = torch.as_tensor(img, device=cuda)
    y = torch.as_tensor(ys, device=cuda)
    x = torch.as_tensor(xs, device=cuda)
    out = TE.gather_patches(t, y, x)
    torch.cuda.synchronize()
    assert torch.equal(out, TE._gather_patches_plain(t, y, x))


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
