"""Port parity: the geometric solvers (triangulation, Horn alignment, the
two-view essential initialization and RANSAC sampling).

torch cannot draw ``jax.random``'s samples, so the RANSAC pieces are held to
JAX on the same samples: the minimal sets are drawn by the JAX
``sample_minimal_sets`` with a JAX key and fed to both ``compute_e21``s, and
the same E goes to both ``check_essential``, ``decompose_e`` and
``reconstruct_e``. ``find_essential`` and ``initialize_two_view`` are held to
outcomes, as ``tests/test_solvers.py`` holds the JAX package.

Tolerances: triangulated points within 1e-3 relative of JAX's (its float32
SVD against the port's float64 normal matrix) where the rays part by at
least 1 degree, and within 1e-4 relative of the true points on exact rays;
Horn's (s, R, t) within 1e-5; E / |E| within 1e-3 up to sign; the inlier
masks of check_essential exactly equal, its scores within 1e-5 relative;
the 4 hypotheses of decompose_e as a set within 1e-5; reconstruct_e's pose
within 1e-4, its count of good points within 1 and its good mask equal on
>= 99.5% of the matches.

The port's essential solver takes no SVD (its eigen-solves are
``sym_eig``'s): a run with ``torch.linalg.svd`` patched to raise witnesses
it, and a near-degenerate 8-point set holds the float64 normal matrix's
null vector within 1e-6 of numpy's float64 SVD, where the float32 normal
matrix misses by more than 1e-5. ``find_essential`` and
``initialize_two_view`` take the RANSAC's scores, drawn by
``sampling.draw_scores``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu.solvers import essential as JE
from cubemapslam_tpu.solvers import horn as JH
from cubemapslam_tpu.solvers import sampling as JS
from cubemapslam_tpu.solvers import triangulate as JT
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.solvers import essential as TE
from cubemapslam_tpu_torch.solvers import horn_alignment, sample_minimal_sets
from cubemapslam_tpu_torch.solvers import triangulate_rays
from cubemapslam_tpu_torch.solvers.sampling import draw_scores

CFG = SlamConfig()


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
def cams():
    return JCam.from_config(CFG), TCam.from_config(CFG, "cpu")


def t(x):
    return torch.as_tensor(np.array(x))


def scene(rng, n=300, noise=0.0, n_out=0):
    """Rays and cross uv of n points seen from the identity and from
    (R21, t21), with angular noise and ``n_out`` scrambled matches."""
    pts = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    R21 = np.asarray(JG.so3_exp(jnp.asarray([0.03, -0.08, 0.01])))
    t21 = np.array([0.8, 0.15, -0.1], np.float32)
    jcam = JCam.from_config(CFG)
    out = []
    for P in (pts, pts @ R21.T + t21):
        r = P / np.linalg.norm(P, axis=1, keepdims=True)
        r = r + rng.normal(0, noise, r.shape)
        r = (r / np.linalg.norm(r, axis=1, keepdims=True)).astype(np.float32)
        uv, face = JC.ray_to_cubemap(jcam, jnp.asarray(r))
        out.append((r, np.array(uv), np.asarray(face) >= 0))
    (r1, uv1, v1), (r2, uv2, v2) = out
    valid = v1 & v2
    if n_out:
        idx = rng.choice(np.nonzero(valid)[0], n_out, replace=False)
        perm = rng.permutation(idx)
        r2[idx], uv2[idx] = r2[perm], uv2[perm]
    return dict(pts=pts, R21=R21.astype(np.float32), t21=t21, r1=r1, r2=r2,
                uv1=uv1, uv2=uv2, valid=valid)


def test_triangulate_rays():
    rng = np.random.default_rng(0)
    s = scene(rng, 400)
    X = triangulate_rays(t(s["r1"]), t(s["r2"]), t(s["R21"]),
                         t(s["t21"])).numpy()
    rel = np.linalg.norm(X - s["pts"], axis=1) / np.linalg.norm(s["pts"],
                                                                axis=1)
    assert rel.max() < 1e-4
    s = scene(rng, 400, noise=1e-3)
    args = (s["r1"], s["r2"], s["R21"], s["t21"])
    Xt = triangulate_rays(*map(t, args)).numpy()
    Xj = np.asarray(JT.triangulate_rays(*map(jnp.asarray, args)))
    r2_in1 = s["r2"] @ s["R21"]
    wide = (s["r1"] * r2_in1).sum(1) < np.cos(np.deg2rad(1.0))
    assert wide.sum() > 300
    rel = (np.linalg.norm(Xt - Xj, axis=1)
           / np.linalg.norm(Xj, axis=1))[wide]
    assert rel.max() < 1e-3, rel.max()


def test_horn_alignment():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(50, 3)).astype(np.float32)
    R = np.asarray(JG.so3_exp(jnp.asarray([0.3, -0.2, 0.5])))
    q = (1.7 * p @ R.T + np.array([0.5, -1.0, 2.0])
         + rng.normal(0, 0.01, p.shape)).astype(np.float32)
    w = (rng.uniform(size=50) < 0.9).astype(np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else t(weights)
        sj, Rj, tj = JH.horn_alignment(jnp.asarray(q), jnp.asarray(p), jw)
        st, Rt, tt = horn_alignment(t(q), t(p), tw)
        assert abs(float(st) - float(sj)) < 1e-5
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    _, Rt, _ = horn_alignment(t(q), t(p), fix_scale=True)
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-2)


@pytest.fixture(scope="module")
def ransac_case(cams):
    """A noisy scene with 15% scrambled matches, JAX-drawn minimal sets,
    and the JAX E of each set."""
    rng = np.random.default_rng(2)
    s = scene(rng, 300, noise=5e-4, n_out=45)
    sets = np.asarray(JS.sample_minimal_sets(
        jax.random.PRNGKey(3), jnp.asarray(s["valid"]), 200, 8))
    E = np.asarray(JE.compute_e21(jnp.asarray(s["r1"])[sets],
                                  jnp.asarray(s["r2"])[sets]))
    return s, sets, E


def test_compute_e21(ransac_case):
    s, sets, Ej = ransac_case
    Et = TE.compute_e21(t(s["r1"])[sets], t(s["r2"])[sets]).numpy()
    nj = Ej / np.linalg.norm(Ej, axis=(1, 2), keepdims=True)
    nt = Et / np.linalg.norm(Et, axis=(1, 2), keepdims=True)
    sign = np.sign((nj * nt).sum(axis=(1, 2)))[:, None, None]
    assert np.abs(nj - sign * nt).max() < 1e-3


def test_check_essential(ransac_case, cams):
    s, _, E = ransac_case
    jcam, tcam = cams
    args = ("r1", "r2", "uv1", "uv2", "valid")
    inl_j, sc_j = JE.check_essential(jcam, jnp.asarray(E),
                                     *(jnp.asarray(s[k]) for k in args))
    inl_t, sc_t = TE.check_essential(tcam, t(E), *(t(s[k]) for k in args))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-5,
                               atol=1e-3)
    assert np.asarray(inl_j).sum(axis=1).max() > 200


def test_decompose_e(ransac_case):
    _, _, E = ransac_case
    for e in E[:20]:
        hj = JE.decompose_e(jnp.asarray(e))
        ht = TE.decompose_e(t(e))
        jset = [(np.asarray(hj[i]), sg * np.asarray(hj[2]))
                for i in (0, 1) for sg in (1, -1)]
        tset = [(ht[i].numpy(), sg * ht[2].numpy())
                for i in (0, 1) for sg in (1, -1)]
        for Rt_, tt_ in tset:
            assert any(np.abs(Rt_ - Rj).max() < 1e-5
                       and np.abs(tt_ - tj).max() < 1e-5
                       for Rj, tj in jset)


def test_reconstruct_e(ransac_case, cams):
    s, _, E = ransac_case
    jcam, tcam = cams
    args = ("r1", "r2", "uv1", "uv2", "valid")
    inl_j, sc_j = JE.check_essential(jcam, jnp.asarray(E),
                                     *(jnp.asarray(s[k]) for k in args))
    b = int(np.argmax(np.asarray(sc_j)))
    inl = np.asarray(inl_j)[b]
    rj = JE.reconstruct_e(jcam, jnp.asarray(E[b]),
                          *(jnp.asarray(s[k]) for k in args[:4]),
                          jnp.asarray(inl))
    rt = TE.reconstruct_e(tcam, t(E[b]), *(t(s[k]) for k in args[:4]),
                          t(inl))
    assert bool(rj.success) and bool(rt.success)
    assert abs(int(rt.n_good) - int(rj.n_good)) <= 1
    np.testing.assert_allclose(rt.R21.numpy(), np.asarray(rj.R21),
                               atol=1e-4)
    np.testing.assert_allclose(rt.t21.numpy(), np.asarray(rj.t21),
                               atol=1e-4)
    assert (rt.good.numpy() == np.asarray(rj.good)).mean() >= 0.995
    np.testing.assert_array_equal(rt.inliers.numpy(), inl)


def test_initialize_two_view_recovers_pose(cams):
    """The outcome of the whole RANSAC bootstrap (the JAX package's
    test_two_view_init): rotation within 0.5 deg, translation direction
    within cos 0.999, the good points on the scene up to scale."""
    _, tcam = cams
    rng = np.random.default_rng(42)
    s = scene(rng, 300, n_out=45)
    scores = draw_scores(torch.Generator().manual_seed(0), 200,
                         len(s["valid"]), "cpu")
    res, E = TE.initialize_two_view(tcam, scores, t(s["r1"]), t(s["r2"]),
                                    t(s["uv1"]), t(s["uv2"]), t(s["valid"]))
    assert bool(res.success)
    # the E returned is the one the pose was taken from: the good pairs
    # (exact rays) satisfy its epipolar constraint
    resid = np.einsum("ni,ij,nj->n", s["r2"], E.numpy(), s["r1"])
    assert np.abs(resid[res.good.numpy()]).max() < 1e-3
    dR = res.R21.numpy() @ s["R21"].T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.5
    t_est = res.t21.numpy()
    cos_t = abs(t_est @ s["t21"]) / np.linalg.norm(t_est) \
        / np.linalg.norm(s["t21"])
    assert cos_t > 0.999
    good = res.good.numpy()
    assert good.sum() > 150
    X = res.p3d.numpy()[good] * np.linalg.norm(s["t21"])
    np.testing.assert_allclose(X, s["pts"][good], atol=0.25)


def test_find_essential_outcome(cams):
    """The best hypothesis keeps the true matches and drops most of the
    scrambled ones."""
    _, tcam = cams
    rng = np.random.default_rng(5)
    s = scene(rng, 300, noise=5e-4, n_out=45)
    scores = draw_scores(torch.Generator().manual_seed(1), 200,
                         len(s["valid"]), "cpu")
    E, inl, score = TE.find_essential(tcam, scores, t(s["r1"]), t(s["r2"]),
                                      t(s["uv1"]), t(s["uv2"]),
                                      t(s["valid"]))
    inl = inl.numpy()
    assert E.shape == (3, 3) and float(score) > 0
    assert inl.sum() >= 0.9 * (s["valid"].sum() - 45)


def test_sample_minimal_sets():
    valid = torch.as_tensor(np.random.default_rng(6).uniform(size=40) < 0.5)
    a = sample_minimal_sets(torch.Generator().manual_seed(7), valid, 100, 8)
    b = sample_minimal_sets(torch.Generator().manual_seed(7), valid, 100, 8)
    c = sample_minimal_sets(torch.Generator().manual_seed(8), valid, 100, 8)
    assert a.shape == (100, 8)
    assert valid[a].all()                         # never an invalid index
    assert all(len(set(r.tolist())) == 8 for r in a)   # no repeat in a set
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_check_rt(ransac_case, cams):
    """Each of the 4 hypotheses of the best JAX E, on the same inliers:
    n_good within 1, the good mask on >= 99.5%, the parallax within
    1e-3 degree."""
    s, _, E = ransac_case
    jcam, tcam = cams
    args = ("r1", "r2", "uv1", "uv2", "valid")
    inl_j, sc_j = JE.check_essential(jcam, jnp.asarray(E),
                                     *(jnp.asarray(s[k]) for k in args))
    b = int(np.argmax(np.asarray(sc_j)))
    inl = np.asarray(inl_j)[b]
    R1, R2, tv = (np.asarray(x) for x in JE.decompose_e(jnp.asarray(E[b])))
    for R, tt in ((R1, tv), (R2, tv), (R1, -tv), (R2, -tv)):
        jr = JE.check_rt(jcam, jnp.asarray(R), jnp.asarray(tt),
                         *(jnp.asarray(s[k]) for k in args[:4]),
                         jnp.asarray(inl), 4.0)
        tr = TE.check_rt(tcam, t(R), t(tt), *(t(s[k]) for k in args[:4]),
                         t(inl), 4.0)
        assert abs(int(tr[0]) - int(jr[0])) <= 1
        assert (tr[2].numpy() == np.asarray(jr[2])).mean() >= 0.995
        assert abs(float(tr[3]) - float(jr[3])) < 1e-3


def test_essential_makes_no_svd(cams, monkeypatch):
    """The essential solver takes no SVD (each would wait for the card):
    ``torch.linalg.svd`` patched to raise, the whole bootstrap still runs
    and succeeds."""
    _, tcam = cams

    def no_svd(*a, **k):
        raise AssertionError("essential.py called torch.linalg.svd")

    monkeypatch.setattr(torch.linalg, "svd", no_svd)
    s = scene(np.random.default_rng(42), 300, n_out=45)
    scores = draw_scores(torch.Generator().manual_seed(0), 200,
                         len(s["valid"]), "cpu")
    res, _ = TE.initialize_two_view(tcam, scores, t(s["r1"]), t(s["r2"]),
                                    t(s["uv1"]), t(s["uv2"]), t(s["valid"]))
    assert bool(res.success)


def test_null_vector_near_degenerate():
    """An 8-point set of rays within a 17-degree cone (A's two smallest
    nonzero singular values 1e-3 of its largest apart from the null one):
    the null vector from the float64 normal matrix within 1e-6 of numpy's
    float64 SVD of A (up to sign), and ``compute_e21`` within 1e-6 of the
    float64 double SVD's rank-2 E. Formed in float32, the same normal
    matrix misses it by more than 1e-5: this set tells the two apart."""
    rng = np.random.default_rng(0)
    R = np.asarray(JG.so3_exp(jnp.asarray([0.02, -0.05, 0.01])),
                   np.float64)
    tr = np.array([0.3, 0.05, -0.02])
    P = np.c_[rng.uniform(-0.3, 0.3, (8, 2)), np.ones(8)] \
        * rng.uniform(4.0, 6.0, 8)[:, None]
    P2 = P @ R.T + tr
    r1 = (P / np.linalg.norm(P, axis=1, keepdims=True)).astype(np.float32)
    r2 = (P2 / np.linalg.norm(P2, axis=1, keepdims=True)).astype(np.float32)
    A = np.einsum("ri,rj->rij", r2.astype(np.float64),
                  r1.astype(np.float64)).reshape(8, 9)
    sv = np.linalg.svd(A, compute_uv=False)
    assert sv[7] < 2e-3 * sv[0]
    v = np.linalg.svd(A)[2][8]

    def err(x):
        x = x.double().numpy()
        return min(np.abs(x - v).max(), np.abs(x + v).max())

    N = TE.normal_matrix(t(r1)[None], t(r2)[None])
    assert N.dtype == torch.float64
    assert err(TE.sym_eig(N)[1][0, :, 0]) < 1e-6
    A32 = torch.as_tensor(A.astype(np.float32))
    N32 = (A32[:, :, None] * A32[:, None, :]).sum(dim=0)[None]
    assert err(TE.sym_eig(N32)[1][0, :, 0]) > 1e-5
    U, S, Vt = np.linalg.svd(v.reshape(3, 3))
    E_ref = U @ np.diag([S[0], S[1], 0.0]) @ Vt
    E = TE.compute_e21(t(r1)[None], t(r2)[None])[0].double().numpy()
    assert min(np.abs(E - E_ref).max(), np.abs(E + E_ref).max()) < 1e-6
