"""Port parity: the triangulation kernel's order (``triangulate_rays_ordered``)
and the wrapper's CPU path.

On the card ``triangulate_rays`` launches ``csrc/triangulate.cu``, whose
plain version ``triangulate_rays_ordered`` repeats its arithmetic in its
order (the kernel is held to it bitwise by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``). Here that order is held against the JAX package's
``triangulate_rays`` (a float32 SVD) on ``test_torch_solvers.py``'s seeded
scenes, and against the port's CPU path (``triangulate_rays_matmul``: the
same Jacobi by batched products, which the CPU keeps), and the mapping
gates are run with it in place of the CPU path.

Tolerances: within 1e-3 relative of JAX's points where the rays part by at
least 1 degree (``test_torch_solvers.py``'s bound), and within 1e-4 of the
true points on exact rays; within 1e-5 relative of the CPU path on those
rows (both are float64 Jacobi rounded to float32; the sums run in another
order); on degenerate rows (zero baseline, parallel, axis-aligned and NaN
rays) the same finite mask as the CPU path. ``triangulate_with_neighbor``
with the kernel's order held to JAX as
``test_torch_mapping.py::test_triangulate_with_neighbor`` holds the CPU path
(masks, gate counts and matches equal, points within 1e-4 relative + 1e-5),
and to the CPU path with the same masks and gate counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu.solvers import triangulate as JT
from cubemapslam_tpu_torch import _build
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime import mapping as TMAP
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
from cubemapslam_tpu_torch.solvers import triangulate as TT

import test_torch_mapping as TM                              # noqa: E402
from test_torch_solvers import scene                         # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores, where more
    threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def rel(a, b):
    return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)


def wide_rows(s):
    """Rows whose rays part by at least 1 degree."""
    return (s["r1"] * (s["r2"] @ s["R21"])).sum(1) < np.cos(np.deg2rad(1.0))


def degenerate(rng, n=64):
    """Seeded rays with degenerate rows, and (R21, t21): rows 0-7 parallel
    (r2 = R21 r1), rows 8-15 axis-aligned (both rays on the z axis or on
    x), rows 16-19 NaN, the rest a wide-parallax scene."""
    s = scene(rng, n)
    r1, r2 = s["r1"].copy(), s["r2"].copy()
    R21, t21 = s["R21"], s["t21"]
    r2[:8] = r1[:8] @ R21.T
    r1[8:12] = r2[8:12] = np.array([0, 0, 1], np.float32)
    r1[12:16] = r2[12:16] = np.array([1, 0, 0], np.float32)
    r1[16:18, 1] = np.nan
    r2[18:20, 2] = np.nan
    return r1, r2, R21, t21


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_ordered_against_jax(noise):
    """The kernel's order against JAX's float32 SVD on the seeded scenes of
    ``test_torch_solvers.py::test_triangulate_rays``; on exact rays also
    against the true points."""
    rng = np.random.default_rng(0)
    s = scene(rng, 400)
    if noise:
        s = scene(rng, 400, noise=noise)
    args = (s["r1"], s["r2"], s["R21"], s["t21"])
    Xo = TT.triangulate_rays_ordered(*map(t, args)).numpy()
    Xj = np.asarray(JT.triangulate_rays(*map(jnp.asarray, args)))
    wide = wide_rows(s)
    assert wide.sum() > 300
    assert rel(Xo, Xj)[wide].max() < 1e-3
    if not noise:
        assert rel(Xo, s["pts"]).max() < 1e-4


@pytest.mark.parametrize("case", ["exact", "noisy", "baseline_0.05"])
def test_ordered_against_cpu_path(case):
    """The kernel's order against the CPU path within 1e-5 relative on
    every row of a wide-parallax scene, the CPU results being the parent's
    (``triangulate_rays`` on CPU tensors is ``triangulate_rays_matmul``)."""
    rng = np.random.default_rng(7)
    s = scene(rng, 500, noise=0.0 if case == "exact" else 2e-3)
    if case == "baseline_0.05":
        s["t21"] = (s["t21"] * 0.05).astype(np.float32)
    args = list(map(t, (s["r1"], s["r2"], s["R21"], s["t21"])))
    Xo = TT.triangulate_rays_ordered(*args).numpy()
    Xc = TT.triangulate_rays(*args).numpy()
    assert torch.equal(TT.triangulate_rays(*args),
                       TT.triangulate_rays_matmul(*args))
    wide = wide_rows(s)
    assert wide.sum() > 200
    assert rel(Xo, Xc)[wide].max() < 1e-5


@pytest.mark.parametrize("baseline", ["zero", "wide"])
def test_degenerate_rows_finite_mask(baseline):
    """Zero baseline (every row at infinity: w is floored), parallel,
    axis-aligned and NaN rays: the same finite mask as the CPU path; NaN
    rows are not finite; the finite rows of wide parallax agree."""
    r1, r2, R21, t21 = degenerate(np.random.default_rng(3))
    if baseline == "zero":
        t21 = np.zeros(3, np.float32)
    args = list(map(t, (r1, r2, R21, t21)))
    Xo = TT.triangulate_rays_ordered(*args)
    Xc = TT.triangulate_rays(*args)
    fin_o = torch.isfinite(Xo).all(-1)
    fin_c = torch.isfinite(Xc).all(-1)
    assert torch.equal(fin_o, fin_c)
    assert not fin_o[16:20].any()
    if baseline == "wide":
        good = np.zeros(len(r1), bool)
        good[20:] = wide_rows(dict(r1=r1, r2=r2, R21=R21))[20:]
        assert good.sum() > 20 and fin_o[20:].all()
        assert rel(Xo.numpy(), Xc.numpy())[good].max() < 1e-5


def test_axis_aligned_rows_meet_zero_pivots():
    """Axis-aligned rays under an identity rotation and a baseline on x
    give normal matrices with exact zeros off the diagonal, so rotations
    meet M[p][q] == 0 (the identity rotation): the same finite mask as the
    CPU path, and its points where finite."""
    r1, r2, _, _ = degenerate(np.random.default_rng(3))
    args = list(map(t, (r1[8:16], r2[8:16], np.eye(3, dtype=np.float32),
                        np.array([0.5, 0, 0], np.float32))))
    M = TT.normal_matrices(*args)
    off = M[:, [0, 0, 0, 1, 1, 2], [1, 2, 3, 2, 3, 3]]
    assert (off == 0).any(dim=1).all()
    Xo = TT.triangulate_rays_ordered(*args)
    Xc = TT.triangulate_rays(*args)
    fin = torch.isfinite(Xo).all(-1)
    assert torch.equal(fin, torch.isfinite(Xc).all(-1)) and fin.any()
    assert torch.allclose(Xo[fin], Xc[fin], rtol=1e-5, atol=1e-6)


def test_normal_matrices_against_products():
    """The kernel's AᵀA (written out, six row products added left to
    right) against the CPU path's batched products, within float64
    rounding."""
    s = scene(np.random.default_rng(11), 200, noise=1e-3)
    args = list(map(t, (s["r1"], s["r2"], s["R21"], s["t21"])))
    M = TT.normal_matrices(*args)
    r1, r2 = args[0].double(), args[1].double()
    f64 = torch.float64
    P1 = torch.cat([torch.eye(3, dtype=f64), torch.zeros(3, 1, dtype=f64)],
                   1)
    P2 = torch.cat([args[2].double(), args[3].double()[:, None]], 1)
    A = torch.cat([TT.hat(r1) @ P1, TT.hat(r2) @ P2], -2)
    ref = A.transpose(-1, -2) @ A
    assert torch.allclose(M, ref, rtol=1e-14, atol=1e-15)
    assert torch.equal(M, M.transpose(-1, -2))


@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_single(n):
    s = scene(np.random.default_rng(2), 8)
    args = [t(s["r1"][:n]), t(s["r2"][:n]), t(s["R21"]), t(s["t21"])]
    Xo = TT.triangulate_rays_ordered(*args)
    Xc = TT.triangulate_rays(*args)
    assert Xo.shape == Xc.shape == (n, 3)
    assert Xo.dtype == Xc.dtype == torch.float32
    if n:
        assert rel(Xo.numpy(), Xc.numpy()).max() < 1e-5


def test_cpu_call_builds_nothing(monkeypatch):
    """CPU tensors never reach the kernel: no build, no launch."""
    def no_build(source):
        raise AssertionError(f"{source} built for a CPU call")

    monkeypatch.setattr(_build, "load", no_build)
    n0 = TT.TRIANGULATE.launches
    s = scene(np.random.default_rng(4), 16)
    TT.triangulate_rays(*map(t, (s["r1"], s["r2"], s["R21"], s["t21"])))
    assert TT.TRIANGULATE.launches == n0 and TT.TRIANGULATE._fn is None


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel's wrapper, which raises on
    what is not a CUDA tensor rather than taking the plain path."""
    s = scene(np.random.default_rng(4), 16)
    args = list(map(t, (s["r1"], s["r2"], s["R21"], s["t21"])))
    args[3] = args[3].to("meta")
    n0 = TT.TRIANGULATE.launches
    with pytest.raises(ValueError):
        TT.triangulate_rays(*args)
    assert TT.TRIANGULATE.launches == n0


@pytest.fixture(scope="module")
def snap():
    """``test_torch_mapping.py``'s arena: before the last mapping step of a
    9-frame CPU run (the new keyframe in slot 5)."""
    poses = S.forward_trajectory(9)
    world = S.make_world(np.random.default_rng(5), n=600,
                         centers=S.camera_centres(poses), fx=80.0)
    arena, slot, _, _ = S.arena_before_last_mapping(
        CubemapSLAM(TConfig(**TM.E2E), device="cpu"), world, poses)
    arena = TM.interop.arena_to_numpy(arena)
    jcfg = TM.JConfig(**TM.E2E)
    return dict(arena=arena, slot=slot,
                jm=TM.JMK(jcfg, TM.JCam.from_config(jcfg)),
                tm=TMAP.MappingKernels(TConfig(**TM.E2E), device="cpu"))


@pytest.mark.parametrize("back", [1, 2])
def test_triangulate_with_neighbor_in_kernel_order(snap, back, monkeypatch):
    """The mapping gates with the kernel's order in place of the CPU path:
    against JAX with the bounds of ``test_torch_mapping.py``, and against
    the CPU path with the same candidates and gate counts."""
    slot = snap["slot"]
    Xc, okc, idxc, cosc, gc = snap["tm"].triangulate_with_neighbor(
        TM.ta(snap["arena"]), slot, slot - back)
    monkeypatch.setattr(TMAP, "triangulate_rays", TT.triangulate_rays_ordered)
    Xt, okt, idxt, cost, gt = snap["tm"].triangulate_with_neighbor(
        TM.ta(snap["arena"]), slot, slot - back)
    Xj, okj, idxj, cosj, gj = snap["jm"].triangulate_with_neighbor(
        TM.ja(snap["arena"]), jnp.int32(slot), jnp.int32(slot - back))
    okj = np.asarray(okj)
    assert okj.sum() > 20
    np.testing.assert_array_equal(okt.numpy(), okj)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(idxt.numpy()[okj], np.asarray(idxj)[okj])
    np.testing.assert_allclose(Xt.numpy()[okj], np.asarray(Xj)[okj],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cosj), atol=1e-6)
    assert torch.equal(okt, okc) and torch.equal(gt, gc)
    ok = okc.numpy()
    np.testing.assert_allclose(Xt.numpy()[ok], Xc.numpy()[ok], rtol=1e-5,
                               atol=1e-6)
