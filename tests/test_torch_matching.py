"""Port parity: matching, exact against JAX (the epipolar chi2 within
1e-4 relative).

Hamming distances are exact ({0,1} products), and every selection
reproduces JAX's tie order: argmin takes the first minimum, the one-to-one
auction the lower query index, the rotation histogram the lower bin.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import matching as JM
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu.features.extractor import Keypoints as JKp
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch import matching as TM
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def random_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def test_hamming():
    rng = np.random.default_rng(0)
    a, b = random_desc(rng, 50), random_desc(rng, 70)
    b[:10] = a[:10]                       # zero distances
    ta, tb = interop.desc_from_numpy(a), interop.desc_from_numpy(b)
    eq(TM.unpack_descriptors(ta), JM.unpack_descriptors(jnp.asarray(a)))
    eq(TM.hamming_matrix(TM.unpack_descriptors(ta),
                         TM.unpack_descriptors(tb)),
       JM.hamming_matrix(JM.unpack_descriptors(jnp.asarray(a)),
                         JM.unpack_descriptors(jnp.asarray(b))))
    eq(TM.hamming_pairs(ta, tb[:50]),
       JM.hamming_pairs(jnp.asarray(a), jnp.asarray(b[:50])))


def test_masked_top2_ties():
    rng = np.random.default_rng(1)
    dist = rng.integers(0, 6, (40, 30)).astype(np.float32)   # many ties
    gate = rng.uniform(size=(40, 30)) < 0.6
    gate[3] = False                                          # empty row
    for t, j in zip(TM._masked_top2(torch.as_tensor(dist),
                                    torch.as_tensor(gate)),
                    JM._masked_top2(jnp.asarray(dist), jnp.asarray(gate))):
        eq(t, j)


def test_resolve_one_to_one_duplicates():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 8, 60)                             # duplicates
    dist = rng.integers(0, 4, 60).astype(np.float32)         # tied dists
    ok = rng.uniform(size=60) < 0.8
    eq(TM.resolve_one_to_one(torch.as_tensor(idx), torch.as_tensor(dist),
                             torch.as_tensor(ok), 8),
       JM.resolve_one_to_one(jnp.asarray(idx, jnp.int32), jnp.asarray(dist),
                             jnp.asarray(ok), 8))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_rotation_consistency_tied_bins(seed):
    rng = np.random.default_rng(seed)
    # angles on exact bin centres, with equal counts in several bins
    bins = np.repeat(np.arange(6), 5)
    a1 = rng.uniform(-np.pi, np.pi, 30).astype(np.float32)
    a2 = (a1 - np.deg2rad(12.0 * bins)).astype(np.float32)
    matched = rng.uniform(size=30) < 0.9
    eq(TM.rotation_consistency(torch.as_tensor(a1), torch.as_tensor(a2),
                               torch.as_tensor(matched)),
       JM.rotation_consistency(jnp.asarray(a1), jnp.asarray(a2),
                               jnp.asarray(matched)))


def test_window_cos():
    fx = np.float32(64.0)
    r = np.array([2.5, 4.0, 15.0, 30.0], np.float32)
    np.testing.assert_allclose(
        TM._window_cos(torch.as_tensor(r), torch.tensor(fx)).numpy(),
        np.asarray(JM._window_cos(jnp.asarray(r), jnp.asarray(fx))),
        rtol=0, atol=1e-7)


def projection_case(nn_ratio, extras):
    """A projection search's arguments for JAX and for the port: (JAX
    positional, JAX keywords, port positional, port keywords). extras: a
    target_free mask, per-query radii, and the rotation check on query
    angles."""
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4)
    jcam = JCam.from_config(cfg)
    tcam = TCam.from_config(cfg, "cpu")
    rng = np.random.default_rng(6)
    n_kp, n_q = 200, 300
    rays = rng.normal(size=(n_kp, 3)).astype(np.float32)
    rays[:, 2] = np.abs(rays[:, 2]) + 0.3
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    desc = random_desc(rng, n_kp)
    level = rng.integers(0, 4, n_kp).astype(np.int32)
    kp = dict(uv=np.zeros((n_kp, 2), np.float32),
              response=np.ones(n_kp, np.float32),
              angle=rng.uniform(-3, 3, n_kp).astype(np.float32),
              level=level, face=np.zeros(n_kp, np.int32), desc=desc,
              rays=rays, valid=rng.uniform(size=n_kp) < 0.95)
    # queries: noisy copies of keypoint rays with perturbed descriptors
    src = rng.integers(0, n_kp, n_q)
    q = rays[src] + rng.normal(0, 0.01, (n_q, 3)).astype(np.float32)
    q *= rng.uniform(2, 6, (n_q, 1)).astype(np.float32)
    qdesc = desc[src] ^ (rng.uniform(size=(n_q, 8)) < 0.05).astype(
        np.uint32) * rng.integers(0, 2 ** 32, (n_q, 8), dtype=np.uint32)
    qlevel = np.clip(level[src] + rng.integers(-1, 2, n_q), 0, 3
                     ).astype(np.int32)
    qvalid = rng.uniform(size=n_q) < 0.95
    sf = np.asarray(cfg.scale_factors, np.float32)
    radius = np.float32(15.0)
    opts_j, opts_t = dict(nn_ratio=nn_ratio), dict(nn_ratio=nn_ratio)
    if extras:
        radius = rng.uniform(4, 20, n_q).astype(np.float32)
        free = rng.uniform(size=n_kp) < 0.9
        # most query angles follow their keypoint's, turned by 24 degrees
        qang = (kp["angle"][src] + np.deg2rad(24.0)
                + rng.normal(0, 0.05, n_q)).astype(np.float32)
        odd = rng.uniform(size=n_q) < 0.2
        qang[odd] = rng.uniform(-3, 3, odd.sum()).astype(np.float32)
        opts_j.update(target_free=jnp.asarray(free),
                      query_angles=jnp.asarray(qang), check_orientation=True)
        opts_t.update(target_free=torch.as_tensor(free),
                      query_angles=torch.as_tensor(qang),
                      check_orientation=True)
    jargs = (jnp.asarray(q), jnp.asarray(qdesc), jnp.asarray(qlevel),
             jnp.asarray(qvalid),
             JKp(**{k: jnp.asarray(v) for k, v in kp.items()}), jcam,
             jnp.asarray(sf), jnp.asarray(radius), -1, 1)
    tkp = interop.keypoints_from_numpy(kp)
    tpos, tdesc, tlev, tval = interop.landmarks_from_numpy(q, qdesc, qlevel,
                                                           qvalid)
    targs = (tpos, tdesc, tlev, tval, tkp, tcam, torch.as_tensor(sf),
             torch.as_tensor(radius), -1, 1)
    return jargs, opts_j, targs, opts_t


@pytest.mark.parametrize("nn_ratio,extras", [
    (None, False), (0.8, False), (0.8, True)])
def test_search_by_projection(nn_ratio, extras):
    """extras: a target_free mask, per-query radii, and the rotation
    check on query angles."""
    jargs, opts_j, targs, opts_t = projection_case(nn_ratio, extras)
    jres = JM.search_by_projection(*jargs, **opts_j)
    tres = TM.search_by_projection(*targs, **opts_t)
    assert int(np.asarray(jres.ok).sum()) > 100
    eq(tres.ok, jres.ok)
    eq(tres.idx, jres.idx)
    eq(tres.dist, jres.dist)
    assert int(tres.count) == int(jres.count)


@pytest.mark.parametrize("chunk", [7, 64, 299])
def test_search_by_projection_query_chunk(chunk):
    """``query_chunk`` (blocks of 7, 64 and 299 of the 300 queries) gives
    the unblocked search's result bitwise, with every option on."""
    _, _, targs, opts = projection_case(0.8, True)
    whole = TM.search_by_projection(*targs, **opts)
    blocked = TM.search_by_projection(*targs, **opts, query_chunk=chunk)
    assert int(whole.count) > 100
    for a, b in zip(whole, blocked):
        assert a.dtype == b.dtype and torch.equal(a, b)


def two_view_keypoints(rng, n=220, noise=0.002):
    """Keypoints of n world points seen from two poses (the second turned
    and moved), as the JAX package's numpy fields: rays, cross uv and
    faces from the JAX camera, level 0 for most, descriptors of kp2 noisy
    copies of kp1's. Returns (cfg, jcam, tcam, kp1, kp2, R21, t21)."""
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4)
    jcam = JCam.from_config(cfg)
    tcam = TCam.from_config(cfg, "cpu")
    X = rng.normal(size=(n, 3)).astype(np.float32)
    X[:, 2] = np.abs(X[:, 2]) + 1.0
    X *= rng.uniform(2, 6, (n, 1)).astype(np.float32)
    a = 0.06
    R21 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    t21 = np.array([0.25, 0.02, 0.05], np.float32)
    desc = random_desc(rng, n)
    kps = []
    for P in (X, X @ R21.T + t21):
        r = P / np.linalg.norm(P, axis=1, keepdims=True)
        r = r + rng.normal(0, noise, r.shape).astype(np.float32)
        r = (r / np.linalg.norm(r, axis=1, keepdims=True)).astype(np.float32)
        uv, face = (np.asarray(v) for v in JC.ray_to_cubemap(
            jcam, jnp.asarray(r)))
        flip = (rng.uniform(size=(n, 8)) < 0.04).astype(np.uint32)
        kps.append(dict(
            uv=uv.astype(np.float32), response=np.ones(n, np.float32),
            angle=rng.normal(0.3, 0.02, n).astype(np.float32),
            level=(rng.uniform(size=n) < 0.15).astype(np.int32),
            face=face.astype(np.int32),
            desc=desc ^ (flip * rng.integers(0, 2 ** 32, (n, 8),
                                             dtype=np.uint32)),
            rays=r, valid=(face >= 0) & (rng.uniform(size=n) < 0.95)))
    # kp2 in another order, so matches are not the identity
    perm = rng.permutation(n)
    kps[1] = {k: v[perm] for k, v in kps[1].items()}
    return cfg, jcam, tcam, kps[0], kps[1], R21, t21


def jkp(kp):
    return JKp(**{k: jnp.asarray(v) for k, v in kp.items()})


def eq_result(tres, jres, n_min):
    assert int(np.asarray(jres.ok).sum()) > n_min
    eq(tres.ok, jres.ok)
    ok = np.asarray(jres.ok)
    np.testing.assert_array_equal(tres.idx.numpy()[ok],
                                  np.asarray(jres.idx)[ok])
    eq(tres.dist, jres.dist)


@pytest.mark.parametrize("centers", [False, True])
def test_search_for_initialization(centers):
    """Exactly equal: the match mask, the matched index of every match and
    the distances; ``centers`` moves the windows to jittered rays."""
    rng = np.random.default_rng(7)
    cfg, jcam, tcam, kp1, kp2, _, _ = two_view_keypoints(rng, noise=0.001)
    c = None
    if centers:
        c = (kp1["rays"] + rng.normal(0, 0.01, kp1["rays"].shape)
             ).astype(np.float32)
    jres = JM.search_for_initialization(
        jkp(kp1), jkp(kp2), jcam,
        center_rays=None if c is None else jnp.asarray(c))
    tres = TM.search_for_initialization(
        interop.keypoints_from_numpy(kp1), interop.keypoints_from_numpy(kp2),
        tcam, center_rays=None if c is None else torch.as_tensor(c))
    eq_result(tres, jres, 50)


def test_epipolar_chi2():
    """Within 1e-4 relative (the pairwise sigma sums in its own order)."""
    rng = np.random.default_rng(8)
    cfg, jcam, tcam, kp1, kp2, R21, t21 = two_view_keypoints(rng)
    hat = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]],
                    [-t21[1], t21[0], 0]], np.float32)
    E12 = (hat @ R21).T.astype(np.float32)
    ls2 = np.asarray(cfg.level_sigma2, np.float32)[kp2["level"]]
    j = np.asarray(JM.epipolar_chi2(jcam, jnp.asarray(E12),
                                    jnp.asarray(kp1["rays"]),
                                    jnp.asarray(kp2["rays"]),
                                    jnp.asarray(kp2["uv"]),
                                    jnp.asarray(ls2)))
    t = TM.epipolar_chi2(tcam, torch.as_tensor(E12),
                         torch.as_tensor(kp1["rays"]),
                         torch.as_tensor(kp2["rays"]),
                         torch.as_tensor(kp2["uv"]),
                         torch.as_tensor(ls2)).numpy()
    fin = np.isfinite(j)
    np.testing.assert_array_equal(fin, np.isfinite(t))
    np.testing.assert_allclose(t[fin], j[fin], rtol=1e-4, atol=1e-6)
    assert (j[fin] < 7.68).sum() > 100


@pytest.mark.parametrize("masks", [False, True])
def test_search_for_triangulation(masks):
    """Exactly equal, with the free masks and the epipole guard
    (``masks``) or without."""
    rng = np.random.default_rng(9)
    cfg, jcam, tcam, kp1, kp2, R21, t21 = two_view_keypoints(rng)
    hat = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]],
                    [-t21[1], t21[0], 0]], np.float32)
    E12 = (hat @ R21).T.astype(np.float32)
    ls2 = np.asarray(cfg.level_sigma2, np.float32)[kp2["level"]]
    opts_j, opts_t = {}, {}
    if masks:
        f1 = rng.uniform(size=len(kp1["uv"])) < 0.8
        f2 = rng.uniform(size=len(kp2["uv"])) < 0.8
        e2 = (t21 / np.linalg.norm(t21)).astype(np.float32)
        opts_j = dict(free1=jnp.asarray(f1), free2=jnp.asarray(f2),
                      epipole_ray2=jnp.asarray(e2), epipole_guard_deg=1.0)
        opts_t = dict(free1=torch.as_tensor(f1), free2=torch.as_tensor(f2),
                      epipole_ray2=torch.as_tensor(e2), epipole_guard_deg=1.0)
    jres = JM.search_for_triangulation(jkp(kp1), jkp(kp2), jcam,
                                       jnp.asarray(E12), jnp.asarray(ls2),
                                       **opts_j)
    tres = TM.search_for_triangulation(
        interop.keypoints_from_numpy(kp1), interop.keypoints_from_numpy(kp2),
        tcam, torch.as_tensor(E12), torch.as_tensor(ls2), **opts_t)
    eq_result(tres, jres, 50)
