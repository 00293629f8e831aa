"""Port parity: the triangulation kernel's order (``triangulate_rays_ordered``,
``triangulate_gated_ordered``) and the wrappers' CPU paths.

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

The batched forms: ``triangulate_rays_ordered`` over B pairs is bitwise
the B one-pair calls (B = 1, 4, 6; N = 0, 1, 37 with parallel,
axis-aligned and NaN rows), and ``triangulate_pairs`` on CPU tensors
bitwise the matmul path a pair. ``triangulate_gated_ordered`` (the mapping
step's one launch: the 6 neighbours triangulated and gated together) on
the new keyframe of the ``snap`` arena against its neighbours (back 1, 2,
and all 6 with one that is not a keyframe) is held to JAX's
``triangulate_with_neighbor`` run per neighbour with the bounds above, and
to the port's CPU path with the same masks and gate counts;
``triangulate_gated`` on CPU tensors is its plain version and builds
nothing; a meta or mixed tensor raises with no launch counted.
``reconstruct_e`` on the CPU is bitwise its earlier body (each hypothesis
triangulated inside ``check_rt``).
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

import chip_smoke                                            # noqa: E402
import test_torch_mapping as TM                              # noqa: E402
from cubemapslam_tpu_torch.camera import CubemapCamera      # noqa: E402
from cubemapslam_tpu_torch.solvers import essential as TE    # noqa: E402
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


@pytest.mark.parametrize("B", [1, 4, 6])
@pytest.mark.parametrize("n", [0, 1, 37])
def test_pairs_ordered_is_the_one_pair_calls(B, n):
    """``triangulate_rays_ordered`` over B pairs (and ``triangulate_pairs``
    on CPU tensors, over the matmul path) bitwise the B one-pair calls,
    degenerate rows included (``chip_smoke.tri_problem``: parallel,
    axis-aligned and NaN rays)."""
    args = chip_smoke.tri_problem(n, 3, "cpu", pairs=B)
    r1, r2, R21s, t21s = args
    X = TT.triangulate_rays_ordered(*args)
    assert X.shape == (B, n, 3) and X.dtype == torch.float32
    one = torch.stack([TT.triangulate_rays_ordered(r1, r2, R21s[b], t21s[b])
                       for b in range(B)])
    assert chip_smoke.same_float_bits(X, one)
    one_mm = torch.stack([TT.triangulate_rays(r1, r2, R21s[b], t21s[b])
                          for b in range(B)])
    assert chip_smoke.same_float_bits(TT.triangulate_pairs(*args), one_mm)
    # rays given a pair each broadcast the same way
    Xb = TT.triangulate_rays_ordered(r1.expand(B, n, 3), r2.expand(B, n, 3),
                                     R21s, t21s)
    assert chip_smoke.same_float_bits(Xb, X)
    if n == 37:
        assert not torch.isfinite(X[:, 4::16]).all(-1).any()
        assert torch.isfinite(X[:, 6::16]).all()


def gated_args(snap, nbs):
    """The gated form's arguments for the snap arena's new keyframe against
    ``nbs``, each pair's geometry and epipolar search as ``mapping_step``
    makes them."""
    arena, slot, tm = TM.ta(snap["arena"]), snap["slot"], snap["tm"]
    pairs = [tm._search_pair(arena, slot, nb) for nb in nbs]
    R21s, t21s, idx, match = (torch.stack(x) for x in zip(*(
        (R21, t21, res.idx, res.ok) for _, _, R21, t21, res in pairs)))
    kf = TT.Keyframes(arena.kf_rays, arena.kf_uv, arena.kf_level,
                      arena.kf_R, arena.kf_t)
    return (kf, torch.tensor([slot]), torch.tensor(nbs), idx, match, R21s,
            t21s, tm.gate_consts)


@pytest.mark.parametrize("nbs", ["back1", "back2", "six"])
def test_gated_ordered_against_jax(snap, nbs):
    """``triangulate_gated_ordered`` on the new keyframe against its
    neighbours, against JAX's ``triangulate_with_neighbor`` a neighbour at
    a time (masks, gate counts and matches equal; points within 1e-4
    relative + 1e-5; the parallax cosine within 1e-6) and against the
    port's CPU path (the same masks and gate counts). "six": the 5 other
    keyframes and slot 6, which holds none (the mapping step masks such a
    neighbour with ``nb_ok``)."""
    slot = snap["slot"]
    nbs = {"back1": [slot - 1], "back2": [slot - 2],
           "six": [3, 0, 6, 4, 1, 2]}[nbs]
    assert not snap["arena"]["kf_valid"][6]
    args = gated_args(snap, nbs)
    c = TT.triangulate_gated_ordered(*args)
    assert c.Xw.shape == (len(nbs), TM.E2E["n_features"], 3)
    assert c.gates.dtype == torch.int64
    kept = 0
    for b, nb in enumerate(nbs):
        Xj, okj, idxj, cosj, gj = snap["jm"].triangulate_with_neighbor(
            TM.ja(snap["arena"]), jnp.int32(slot), jnp.int32(nb))
        okj = np.asarray(okj)
        kept += okj.sum()
        np.testing.assert_array_equal(c.ok[b].numpy(), okj)
        np.testing.assert_array_equal(c.gates[b].numpy(), np.asarray(gj))
        np.testing.assert_array_equal(args[3][b].numpy()[okj],
                                      np.asarray(idxj)[okj])
        np.testing.assert_allclose(c.Xw[b].numpy()[okj],
                                   np.asarray(Xj)[okj], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(c.cos_par[b].numpy(), np.asarray(cosj),
                                   atol=1e-6)
        Xc, okc, idxc, _, gc = snap["tm"].triangulate_with_neighbor(
            TM.ta(snap["arena"]), slot, nb)
        assert torch.equal(c.ok[b], okc) and torch.equal(c.gates[b], gc)
        assert torch.equal(args[3][b], idxc)
    assert kept > 20
    if 6 in nbs:
        assert not c.ok[nbs.index(6)].any()


def test_gated_wrapper_on_cpu_is_its_plain_version(monkeypatch):
    """``triangulate_gated`` on CPU tensors is ``triangulate_gated_ordered``
    bitwise, and neither builds nor launches the kernel."""
    def no_build(source):
        raise AssertionError(f"{source} built for a CPU call")

    monkeypatch.setattr(_build, "load", no_build)
    n0 = TT.TRIANGULATE.launches
    args = chip_smoke.tri_gated_problem(6, 37, 2, "cpu")
    c = TT.triangulate_gated(*args)
    ref = TT.triangulate_gated_ordered(*args)
    assert chip_smoke.same_candidates(c, ref)
    assert (c.gates[:, 0] > 0).all() and (c.gates[:, 3] > 0).any()
    TT.triangulate_pairs(*chip_smoke.tri_problem(37, 2, "cpu", pairs=4))
    assert TT.TRIANGULATE.launches == n0 and TT.TRIANGULATE._fn is None


@pytest.mark.parametrize("form", ["pairs", "gated"])
@pytest.mark.parametrize("where", ["meta", "mixed"])
def test_batched_forms_never_fall_back(form, where):
    """A tensor off the CPU sends the batched forms to the kernel's
    wrapper, which raises on what is not a CUDA tensor of one device
    rather than taking the plain path; no launch is counted."""
    if form == "pairs":
        args = list(chip_smoke.tri_problem(16, 4, "cpu", pairs=4))
        fn = TT.triangulate_pairs
    else:
        args = list(chip_smoke.tri_gated_problem(6, 16, 4, "cpu"))
        fn = TT.triangulate_gated
    args[3] = args[3].to("meta")
    if where == "mixed":
        args = chip_smoke.to_device(args, "meta")
        args[0] = chip_smoke.to_device(args[0], "cpu")
    n0 = TT.TRIANGULATE.launches
    with pytest.raises(ValueError):
        fn(*args)
    assert TT.TRIANGULATE.launches == n0


def reconstruct_e_parent(cam, E, rays1, rays2, uv1, uv2, inliers,
                         sigma2=1.0, min_parallax=1.0, min_triangulated=50,
                         good_ratio=0.9):
    """``essential.reconstruct_e`` as it was before the hypotheses were
    triangulated in one call: each inside ``check_rt``."""
    R1, R2, t = TE.decompose_e(E)
    th2 = 4.0 * sigma2
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    outs = [TE.check_rt(cam, Rs[h], ts[h], rays1, rays2, uv1, uv2, inliers,
                        th2) for h in range(4)]
    n_good = torch.stack([o[0] for o in outs])
    p3d = torch.stack([o[1] for o in outs])
    good = torch.stack([o[2] for o in outs])
    parallax = torch.stack([o[3] for o in outs])
    max_good = n_good.max()
    n_inl = inliers.sum()
    n_min_good = torch.clamp((good_ratio * n_inl).to(torch.int64),
                             min=min_triangulated)
    n_similar = (n_good > 0.7 * max_good).sum()
    best = torch.argmax(n_good)
    ok = ((max_good >= n_min_good) & (n_similar == 1)
          & (TE._take(parallax, best) > min_parallax))
    return TE.TwoViewResult(
        success=ok, R21=TE._take(Rs, best), t21=TE._take(ts, best),
        p3d=TE._take(p3d, best), good=TE._take(good, best) & ok,
        n_good=TE._take(n_good, best), inliers=inliers)


@pytest.mark.parametrize("noise", [0.0, 2e-3])
def test_reconstruct_e_unchanged(noise):
    """``reconstruct_e`` on the CPU (its 4 hypotheses through
    ``triangulate_pairs``) bitwise its earlier body, on a scene's true
    essential matrix."""
    s = scene(np.random.default_rng(9), 300, noise=noise)
    R, tr = t(s["R21"]), t(s["t21"])
    E = TT.hat(tr) @ R
    cam = CubemapCamera.from_config(TConfig(), "cpu")
    args = (cam, E, t(s["r1"]), t(s["r2"]), t(s["uv1"]), t(s["uv2"]),
            t(s["valid"]))
    new, old = TE.reconstruct_e(*args), reconstruct_e_parent(*args)
    assert bool(new.success)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
