"""Port parity: matching, exact against JAX.

Hamming distances are exact ({0,1} products), and every selection
reproduces JAX's tie order: argmin takes the first minimum, the one-to-one
auction the lower query index, the rotation histogram the lower bin.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

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


@pytest.mark.parametrize("nn_ratio,extras", [
    (None, False), (0.8, False), (0.8, True)])
def test_search_by_projection(nn_ratio, extras):
    """extras: a target_free mask, per-query radii, and the rotation
    check on query angles."""
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
    jres = JM.search_by_projection(
        jnp.asarray(q), jnp.asarray(qdesc), jnp.asarray(qlevel),
        jnp.asarray(qvalid), JKp(**{k: jnp.asarray(v) for k, v in kp.items()}),
        jcam, jnp.asarray(sf), jnp.asarray(radius), -1, 1, **opts_j)
    tkp = interop.keypoints_from_numpy(kp)
    tpos, tdesc, tlev, tval = interop.landmarks_from_numpy(q, qdesc, qlevel,
                                                           qvalid)
    tres = TM.search_by_projection(tpos, tdesc, tlev, tval, tkp, tcam,
                                   torch.as_tensor(sf),
                                   torch.as_tensor(radius), -1, 1, **opts_t)
    assert int(np.asarray(jres.ok).sum()) > 100
    eq(tres.ok, jres.ok)
    eq(tres.idx, jres.idx)
    eq(tres.dist, jres.dist)
    assert int(tres.count) == int(jres.count)
