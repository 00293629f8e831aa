"""Port parity: the batched symmetric eigen-solve (``cubemapslam_tpu_torch/
solvers/sym_eig.py``).

On the card ``sym_eig`` launches ``csrc/sym_eig.cu``, whose plain version
``sym_eig_ordered`` repeats its float64 round-robin Jacobi in its order (the
kernel is held to it bitwise by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``). Here:

* ``sym_eig_ordered`` against a scalar emulation of the kernel written from
  its source (one matrix at a time, lane by lane, Python floats, which
  round as IEEE float64 like the kernel's and PyTorch's operations):
  bitwise, at n = 3, 4, 9 and 12, on random, diagonal (ties), zero, EPnP
  and essential matrices (the float64 9x9 normal matrices of the 8-point
  sets rounded to float32, EᵀE), and on float64 inputs, read as they are
  (random, and the essential's normal matrices).
* The schedule: n - 1 steps (n rounded up to even) of disjoint pairs, every
  pair once a sweep, the kernel's lane partners its pairs. On the recorded
  PnP and essential solves no matrix runs out of sweeps; against the
  cyclic order the
  kernel had before (``emulate_cyclic``), the most sweeps of a batch at
  most one more, each matrix at most two more (at most 12% of a batch),
  the mean at most 0.75 more.
* ``sym_eig_ordered`` against ``jnp.linalg.eigh`` (float32) at n = 3, 4, 9
  and 12 on seeded symmetric matrices (positive and indefinite) and on the
  matrices of one ``pnp_ransac`` call and of one ``initialize_two_view``
  call (the float64 normal matrices through float32): eigenvalues within 1e-6 of the
  largest |eigenvalue|, V diag(w) Vᵀ within 1e-6 of A and VᵀV within 1e-6
  of I (relative to the largest |eigenvalue|); each eigenvector of a simple
  eigenvalue equal to JAX's up to its sign within 1e-3; the projector onto
  the 4-dimensional null space of a minimal set's MᵀM within 1e-3 of JAX's
  (the basis itself differs between solvers), and that space annihilated
  by MᵀM within 1e-6 of its norm; the normal matrices' smallest
  eigenvector within 1e-4 of the null vector of JAX's float32 SVD of the
  8x9 system, up to its sign.
* The stable order of equal eigenvalues and the sign rule.
* A non-finite matrix gives NaN results without raising, and leaves the
  other matrices of its batch as they are, in ``sym_eig_ordered`` and in
  ``sym_eig`` on the CPU.
* ``sym_eig`` on CPU tensors is ``eigh_nan`` (``torch.linalg.eigh``, the
  bits the CPU had before) in the input's dtype, rounded to float32, and
  builds nothing; ``sym_eig_cuda`` raises on a CPU tensor, a wrong size or
  dtype, before any launch.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.solvers import pnp as JP
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.solvers import essential as TE
from cubemapslam_tpu_torch.solvers import pnp as TP
from cubemapslam_tpu_torch.solvers import sym_eig as SE
from cubemapslam_tpu_torch.solvers.sampling import draw_scores

SIZES = (3, 4, 9, 12)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores, where more
    threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _order_and_sign(d, v, n):
    """The kernel's stable ascending order and sign rule on the diagonal d
    and the rows v of V (Python floats): float32 (w, V)."""
    perm = [0] * n
    for j in range(n):
        rank = sum((d[i] < d[j]) or (d[i] == d[j] and i < j)
                   for i in range(n))
        perm[rank] = j
    w = np.array([d[k] for k in perm], np.float32)
    V = np.zeros((n, n), np.float32)
    for col, k in enumerate(perm):
        big, best = 0, abs(v[0][k])
        for r in range(1, n):
            if abs(v[r][k]) > best:
                big, best = r, abs(v[r][k])
        neg = v[big][k] < 0.0
        for r in range(n):
            V[r, col] = np.float32(-v[r][k] if neg else v[r][k])
    return w, V


def _nan_result(n):
    return (np.full(n, np.nan, np.float32),
            np.full((n, n), np.nan, np.float32))


def _tree(x):
    """The kernel's shuffle tree over 32 lanes (x padded with zeros): each
    lane adds its xor-16, xor-8, xor-4, xor-2, xor-1 neighbour's value;
    lane 0's."""
    x = list(x) + [0.0] * (32 - len(x))
    for m in (16, 8, 4, 2, 1):
        x = [x[i] + x[i ^ m] for i in range(32)]
    return x[0]


def partner(s, r, NP):
    """Lane r's partner at step s, as the kernel computes it (lanes >= NP
    pair with themselves)."""
    m = NP - 1
    if r >= NP:
        return r
    if r == m:
        return s
    if r == s:
        return m
    j = 2 * s - r
    return j + m if j < 0 else (j - m if j >= m else j)


def emulate(A: np.ndarray, counts: bool = False):
    """The kernel's program for one (n, n) float32 matrix, lane by lane, on
    Python floats: lane r < NP holds row r of A (its own diagonal in d[r])
    and row r of V; each step every lane reads its partner's old row and
    diagonal, its pair's angle, and the angles of every pair from the
    pair's lower lane (the shuffles), then writes its new row. Returns
    (eigenvalues (n,), eigenvectors (n, n)) float32, and with ``counts``
    the sweeps begun."""
    n = A.shape[0]
    NP = n + n % 2
    if not np.isfinite(A).all():
        return _nan_result(n) + ((0,) if counts else ())
    a = [[float(A[max(i, j), min(i, j)]) if max(i, j) < n else 0.0
          for j in range(NP)] for i in range(NP)]
    v = [[1.0 if i == j else 0.0 for j in range(NP)] for i in range(NP)]
    d = [a[i][i] for i in range(NP)]
    part = [0.0] * n
    for i in range(n):
        for j in range(n):
            part[i] = part[i] + a[i][j] * a[i][j]
    tol2 = (SE.EPS * SE.EPS) * _tree(part)
    skip2 = tol2 / float(n * (n - 1) // 2)
    sweeps = 0
    for _ in range(SE.MAX_SWEEPS):
        part = [0.0] * n
        for i in range(n):
            for j in range(n):
                if j > i:
                    part[i] = part[i] + a[i][j] * a[i][j]
        if _tree(part) <= tol2:
            break
        sweeps += 1
        for s, pairs in enumerate(SE.schedule(n)):
            pt = [partner(s, r, NP) for r in range(NP)]
            ang = []
            for r in range(NP):                  # each lane's angle
                e, lo = a[r][pt[r]], r < pt[r]
                app, aqq = (d[r], d[pt[r]]) if lo else (d[pt[r]], d[r])
                if e * e <= skip2:
                    ang.append((e, lo, True, 0.0, 1.0, 0.0))
                    continue
                theta = (aqq - app) / (2.0 * e)
                sgn = 1.0 if theta >= 0.0 else -1.0
                t = sgn / (abs(theta) + math.sqrt(theta * theta + 1.0))
                c = 1.0 / math.sqrt(t * t + 1.0)
                ang.append((e, lo, False, t, c, t * c))
            new_a, new_v, new_d = [], [], []
            for r in range(NP):
                e, lo, skip, t, c, sn = ang[r]
                ui, wi = c, (-sn if lo else sn)
                own, b, vr = a[r], a[pt[r]], v[r]
                na, nv = list(own), list(vr)
                for p, q in pairs:
                    ck, sk = ang[p][4], ang[p][5]
                    up, wp, uq, wq = ck, -sk, ck, sk
                    na[p] = (((ui * up) * own[p] + (wi * wp) * b[q])
                             + ((ui * wp) * own[q] + (wi * up) * b[p]))
                    na[q] = (((ui * uq) * own[q] + (wi * wq) * b[p])
                             + ((ui * wq) * own[p] + (wi * uq) * b[q]))
                    nv[p] = ck * vr[p] - sk * vr[q]
                    nv[q] = sk * vr[p] + ck * vr[q]
                na[pt[r]] = e if skip else 0.0
                new_a.append(na)
                new_v.append(nv)
                new_d.append(d[r] - t * e if lo else d[r] + t * e)
            a, v, d = new_a, new_v, new_d
    out = _order_and_sign(d, v, n)
    return out + ((sweeps,) if counts else ())


def emulate_cyclic(A: np.ndarray):
    """The cyclic Jacobi of the kernel before the round-robin order, one
    rotation at a time in row order, on Python floats: (eigenvalues,
    eigenvectors, sweeps begun). The yardstick of the new order's sweeps."""
    n = A.shape[0]
    if not np.isfinite(A).all():
        return _nan_result(n) + (0,)
    a = [[float(A[max(i, j), min(i, j)]) for j in range(n)]
         for i in range(n)]
    v = [[1.0 if i == j else 0.0 for j in range(n)] for i in range(n)]
    nrm = 0.0
    for i in range(n):
        for j in range(n):
            nrm = nrm + a[i][j] * a[i][j]
    tol2 = (SE.EPS * SE.EPS) * nrm
    skip2 = tol2 / float(n * (n - 1) // 2)
    sweeps = 0
    for _ in range(SE.MAX_SWEEPS):
        off = 0.0
        for p in range(n - 1):
            for q in range(p + 1, n):
                off = off + a[p][q] * a[p][q]
        if off <= tol2:
            break
        sweeps += 1
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = a[p][p], a[q][q], a[p][q]
                if apq * apq <= skip2:
                    continue
                theta = (aqq - app) / (2.0 * apq)
                sgn = 1.0 if theta >= 0.0 else -1.0
                t = sgn / (abs(theta) + math.sqrt(theta * theta + 1.0))
                c = 1.0 / math.sqrt(t * t + 1.0)
                s = t * c
                for r in range(n):
                    vp, vq = v[r][p], v[r][q]
                    v[r][p] = c * vp - s * vq
                    v[r][q] = s * vp + c * vq
                    if r in (p, q):
                        continue
                    mp, mq = a[r][p], a[r][q]
                    a[r][p] = a[p][r] = c * mp - s * mq
                    a[r][q] = a[q][r] = s * mp + c * mq
                a[p][p] = app - t * apq
                a[q][q] = aqq + t * apq
                a[p][q] = a[q][p] = 0.0
    return _order_and_sign([a[j][j] for j in range(n)], v, n) + (sweeps,)


def random_sym(rng, b, n, kind):
    X = rng.standard_normal((b, n, n)).astype(np.float32)
    if kind == "psd":
        return X @ X.transpose(0, 2, 1)
    return (X + X.transpose(0, 2, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def pnp_matrices():
    """The six eigen-solves' inputs of one CPU ``pnp_ransac`` (300
    hypotheses on ``test_torch_pnp.py``'s scene with 45 scrambled matches),
    in call order: (300,3,3), (300,12,12), (300,3,4,4), (3,3), (12,12),
    (3,4,4)."""
    from test_torch_pnp import scene
    from cubemapslam_tpu.camera import CubemapCamera as JCam
    from cubemapslam_tpu.config import SlamConfig
    cfg = SlamConfig()
    s = scene(JCam.from_config(cfg), 3, [0.2, -0.3, 0.1], [0.4, -0.2, 0.6],
              45)
    seen = []
    inner = TP._eigh

    def recorded(A):
        seen.append(A.clone())
        return inner(A)

    TP._eigh = recorded
    try:
        names = ("pts", "rays", "uv", "sig2", "valid")
        TP.pnp_ransac(TCam.from_config(TConfig(), "cpu"),
                      torch.Generator().manual_seed(0),
                      *(torch.as_tensor(np.array(s[k])) for k in names))
    finally:
        TP._eigh = inner
    return seen


@pytest.fixture(scope="module")
def essential_case():
    """One CPU ``initialize_two_view`` (200 hypotheses on
    ``test_torch_solvers.py``'s noisy scene with 45 scrambled matches): its
    eigen-solves' inputs in call order, (200,9,9) float64, (200,3,3) and
    (3,3), and the 8-point systems A (200,8,9) of its minimal sets."""
    from test_torch_solvers import scene
    s = scene(np.random.default_rng(2), 300, noise=5e-4, n_out=45)
    r1, r2, uv1, uv2, valid = (torch.as_tensor(np.array(s[k])) for k in
                               ("r1", "r2", "uv1", "uv2", "valid"))
    scores = draw_scores(torch.Generator().manual_seed(0), 200, 300, "cpu")
    seen = []
    inner = TE.sym_eig

    def recorded(A):
        seen.append(A.clone())
        return inner(A)

    TE.sym_eig = recorded
    try:
        res, _ = TE.initialize_two_view(TCam.from_config(TConfig(), "cpu"),
                                        scores, r1, r2, uv1, uv2, valid)
    finally:
        TE.sym_eig = inner
    assert bool(res.success)
    from cubemapslam_tpu_torch.solvers.sampling import select_minimal_sets
    sets = select_minimal_sets(scores, valid, 8)
    A = (r2[sets][..., :, None] * r1[sets][..., None, :]).reshape(-1, 8, 9)
    return seen, A.numpy()


@pytest.fixture(scope="module")
def recorded(pnp_matrices, essential_case):
    """The recorded solves: one PnP's six and one two-view attempt's
    three."""
    return list(pnp_matrices) + list(essential_case[0])


def test_essential_matrices_shapes(essential_case):
    assert [(tuple(A.shape), A.dtype) for A in essential_case[0]] == [
        ((200, 9, 9), torch.float64), ((200, 3, 3), torch.float32),
        ((3, 3), torch.float32)]


def test_pnp_matrices_shapes(pnp_matrices):
    assert [tuple(A.shape) for A in pnp_matrices] == [
        (300, 3, 3), (300, 12, 12), (300, 3, 4, 4), (3, 3), (12, 12),
        (3, 4, 4)]


@pytest.mark.parametrize("n", SIZES)
def test_ordered_against_kernel_emulation(n, pnp_matrices, essential_case):
    rng = np.random.default_rng(n)
    mats = [random_sym(rng, 2, n, "psd"), random_sym(rng, 2, n, "sym"),
            np.diag(np.array([2.0, 1.0, 1.0] + [0.5] * (n - 3),
                             np.float32))[None],
            np.zeros((1, n, n), np.float32)]
    ess = essential_case[0]
    real = {3: torch.cat([pnp_matrices[0][:2], ess[1][:2]]),
            4: pnp_matrices[2][:1].reshape(-1, 4, 4),
            9: ess[0][:3].float(), 12: pnp_matrices[1][:3]}[n]
    mats.append(real.numpy())
    nan = random_sym(rng, 1, n, "psd")
    nan[0, n - 1, 0] = np.nan
    mats.append(nan)
    A = np.concatenate(mats)
    w, V = SE.sym_eig_ordered(torch.as_tensor(A))
    for i, a in enumerate(A):
        we, Ve = emulate(a)
        np.testing.assert_array_equal(w[i].numpy(), we, err_msg=str(i))
        np.testing.assert_array_equal(V[i].numpy(), Ve, err_msg=str(i))


@pytest.mark.parametrize("n", SIZES)
def test_ordered_against_kernel_emulation_float64(n, essential_case):
    """A float64 input is read as it is (no rounding to float32), by the
    ordered version as by the emulation: bitwise, on seeded matrices with
    entries float32 cannot hold, and at n = 9 on the essential's normal
    matrices."""
    rng = np.random.default_rng(40 + n)
    X = rng.standard_normal((3, n, n))
    mats = [X @ X.transpose(0, 2, 1), X + X.transpose(0, 2, 1)]
    if n == 9:
        mats.append(essential_case[0][0][:3].numpy())
    nan = X[:1] @ X[:1].transpose(0, 2, 1)
    nan[0, 0, n - 1] = np.inf
    mats.append(nan)
    A = np.concatenate(mats)
    assert A.dtype == np.float64
    w, V = SE.sym_eig_ordered(torch.as_tensor(A))
    assert w.dtype == V.dtype == torch.float32
    for i, a in enumerate(A):
        we, Ve = emulate(a)
        np.testing.assert_array_equal(w[i].numpy(), we, err_msg=str(i))
        np.testing.assert_array_equal(V[i].numpy(), Ve, err_msg=str(i))
    # not the float32 input's result
    w32 = SE.sym_eig_ordered(torch.as_tensor(A[:6].astype(np.float32)))[0]
    assert not torch.equal(w32, w[:6])


@pytest.mark.parametrize("n", SIZES)
def test_schedule_covers_every_pair_once(n):
    """A sweep is NP - 1 steps of NP / 2 disjoint pairs (NP = n rounded up
    to even), every pair of the NP indices once; the lanes' partners as the
    kernel computes them (``partner``) are the schedule's pairs."""
    NP = n + n % 2
    steps = SE.schedule(n)
    assert len(steps) == NP - 1
    seen = []
    for s, pairs in enumerate(steps):
        assert len(pairs) == NP // 2
        flat = [i for pq in pairs for i in pq]
        assert sorted(flat) == list(range(NP))
        assert all(p < q for p, q in pairs)
        seen += pairs
        for r in range(32):
            want = r if r >= NP else next(
                q if p == r else p for p, q in pairs if r in (p, q))
            assert partner(s, r, NP) == want
    assert sorted(seen) == [(p, q) for p in range(NP)
                            for q in range(p + 1, NP)]


# The round-robin order's sweeps beyond the cyclic order's, at most: the
# mean of a batch, and the share of a batch that takes two more.
MEAN_MORE = 0.75
SHARE_TWO_MORE = 0.12


def _sized(recorded, n):
    """The recorded solves of size n, each as a (B, n, n) batch."""
    return [A.reshape(-1, n, n) for A in recorded if A.shape[-1] == n]


@pytest.mark.parametrize("n", SIZES)
def test_pnp_matrices_within_max_sweeps(n, recorded):
    """No recorded PnP or essential matrix runs out of sweeps, and each
    sweep begun is NP - 1 steps."""
    batches = _sized(recorded, n)
    assert batches
    for A in batches:
        _, _, rot, sw, st = SE.sym_eig_ordered(A, counts=True)
        assert int(sw.max()) < SE.MAX_SWEEPS
        assert torch.equal(st, sw * (n + n % 2 - 1))
        assert (rot <= st * ((n + n % 2) // 2)).all() and (rot > 0).all()


@pytest.mark.parametrize("n", SIZES)
def test_sweeps_against_cyclic(n, recorded):
    """The round-robin order against the cyclic order it replaced
    (``emulate_cyclic``) on the recorded PnP and essential solves of size n
    and on seeded positive and indefinite matrices. In each batch: the most sweeps (its
    slowest matrix, which sets the launch's time) at most one more; every
    matrix at most two more, and at most ``SHARE_TWO_MORE`` of the batch
    two more; the mean at most ``MEAN_MORE`` more. Measured: the recorded
    MᵀM (300,12,12) 0.56 more on average, 27 of its 300 matrices two more
    (clustered near-null eigenvalues); every other batch at most 0.0 on
    average and at most 1 of 300 two more (the essential's normal
    matrices 0.545 fewer)."""
    rng = np.random.default_rng(20 + n)
    batches = _sized(recorded, n) + [
        torch.as_tensor(random_sym(rng, 64, n, kind))
        for kind in ("psd", "sym")]
    for A in batches:
        _, _, _, sw, _ = SE.sym_eig_ordered(A, counts=True)
        cyc = np.array([emulate_cyclic(a)[2] for a in A.numpy()])
        more = sw.numpy() - cyc
        assert int(sw.max()) <= cyc.max() + 1, (int(sw.max()), cyc.max())
        assert more.max() <= 2, more.max()
        assert (more == 2).sum() <= SHARE_TWO_MORE * len(more), \
            ((more == 2).sum(), len(more))
        assert more.mean() <= MEAN_MORE, more.mean()


def check_against_jax(A: np.ndarray, w, V):
    """Eigenvalues, reconstruction and orthonormality of (w, V) against
    ``jnp.linalg.eigh`` of A (b, n, n)."""
    wj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    w, V = w.numpy().astype(np.float64), V.numpy().astype(np.float64)
    scale = np.abs(wj).max(axis=-1)
    assert (np.abs(w - wj).max(axis=-1) <= 1e-6 * scale).all()
    rec = V @ (w[..., :, None] * V.transpose(0, 2, 1))
    assert (np.abs(rec - A).max(axis=(-1, -2)) <= 1e-6 * scale).all()
    eye = np.eye(A.shape[-1])
    assert np.abs(V.transpose(0, 2, 1) @ V - eye).max() <= 1e-6
    return wj, Vj, scale


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["psd", "sym"])
def test_ordered_against_jax(n, kind):
    A = random_sym(np.random.default_rng(10 + n), 16, n, kind)
    w, V = SE.sym_eig_ordered(torch.as_tensor(A))
    wj, Vj, scale = check_against_jax(A, w, V)
    # each eigenvector of a well-separated eigenvalue, up to its sign
    V = V.numpy()
    gap = np.diff(wj, axis=-1)
    for b in range(len(A)):
        for k in range(n):
            lo = gap[b, k - 1] if k else np.inf
            hi = gap[b, k] if k < n - 1 else np.inf
            if min(lo, hi) > 1e-2 * scale[b]:
                d = min(np.abs(V[b, :, k] - Vj[b, :, k]).max(),
                        np.abs(V[b, :, k] + Vj[b, :, k]).max())
                assert d <= 1e-3, (b, k, d)


def test_ordered_against_jax_on_pnp(pnp_matrices):
    for A in pnp_matrices:
        n = A.shape[-1]
        A = A.reshape(-1, n, n).numpy()
        w, V = SE.sym_eig_ordered(torch.as_tensor(A))
        check_against_jax(A, w, V)


def test_ordered_against_jax_on_essential(essential_case):
    """The two-view attempt's solves against ``jnp.linalg.eigh`` (float32:
    the normal matrices rounded), and each normal matrix's smallest
    eigenvector (from float64) against the null vector of JAX's float32 SVD
    of its 8x9 system (``essential.py:42``), up to its sign."""
    seen, A8 = essential_case
    for A in seen:
        n = A.shape[-1]
        A = A.reshape(-1, n, n)
        w, V = SE.sym_eig_ordered(A)
        check_against_jax(A.float().numpy(), w, V)
    e = SE.sym_eig_ordered(seen[0])[1][..., :, 0].numpy()
    vj = np.asarray(jnp.linalg.svd(jnp.asarray(A8))[2])[..., 8, :]
    d = np.minimum(np.abs(e - vj).max(axis=-1), np.abs(e + vj).max(axis=-1))
    assert d.max() <= 1e-4, d.max()


def test_null_space_projector_against_jax():
    """The 4-dimensional null space of MᵀM of minimal sets, built by the JAX
    package's EPnP pieces (``pnp.py:126-133``): the projector onto the 4
    eigenvectors of the smallest eigenvalues, against JAX's; and MᵀM times
    the basis within 1e-6 of MᵀM's norm."""
    from test_torch_pnp import scene
    from cubemapslam_tpu.camera import CubemapCamera as JCam
    from cubemapslam_tpu.config import SlamConfig
    s = scene(JCam.from_config(SlamConfig()), 0, [0.2, -0.3, 0.1],
              [0.4, -0.2, 0.6], 0)
    rng = np.random.default_rng(5)
    pw, rays = jnp.asarray(s["pts"]), jnp.asarray(s["rays"])
    mats = []
    for _ in range(12):
        w = np.zeros(len(s["pts"]), np.float32)
        w[rng.choice(np.nonzero(s["valid"])[0], 4, replace=False)] = 1.0
        w = jnp.asarray(w)
        cw = JP._control_points(pw, w)
        alphas = JP._barycentric(pw, cw)
        M = (alphas[:, None, :, None] * JG.hat(rays)[:, :, None, :])
        M = M.reshape(-1, 12) * jnp.repeat(w, 3)[:, None]
        mats.append(np.asarray(M.T @ M))
    A = np.stack(mats)
    w, V = SE.sym_eig_ordered(torch.as_tensor(A))
    wj, Vj, scale = check_against_jax(A, w, V)
    N, Nj = V.numpy()[..., :4].astype(np.float64), Vj[..., :4]
    P = N @ N.transpose(0, 2, 1)
    Pj = Nj @ Nj.transpose(0, 2, 1)
    assert np.abs(P - Pj).max() <= 1e-3
    res = np.abs(A.astype(np.float64) @ N).max(axis=(-1, -2))
    assert (res <= 1e-6 * scale).all()


def test_stable_order_and_sign():
    """Equal eigenvalues keep their index order; each eigenvector's entry of
    largest magnitude is positive."""
    A = torch.diag(torch.tensor([2.0, 1.0, 1.0, 0.0]))[None]
    w, V = SE.sym_eig_ordered(A)
    assert w[0].tolist() == [0.0, 1.0, 1.0, 2.0]
    assert V[0].tolist() == torch.eye(4)[:, [3, 1, 2, 0]].tolist()
    A = torch.as_tensor(random_sym(np.random.default_rng(3), 8, 12, "sym"))
    _, V = SE.sym_eig_ordered(-A)
    big = torch.take_along_dim(V, V.abs().argmax(dim=-2, keepdim=True), -2)
    assert (big > 0).all()


def test_nonfinite_gives_nan():
    A = torch.as_tensor(random_sym(np.random.default_rng(4), 4, 12, "psd"))
    A[1, 3, 5] = float("inf")
    A[2, 0, 0] = float("nan")
    for fn in (SE.sym_eig_ordered, SE.sym_eig):
        w, V = fn(A)
        assert torch.isnan(w[1:3]).all() and torch.isnan(V[1:3]).all()
        assert torch.isfinite(w[[0, 3]]).all()
        assert torch.isfinite(V[[0, 3]]).all()
        w0, V0 = fn(A[[0, 3]])
        assert torch.equal(w0, w[[0, 3]]) and torch.equal(V0, V[[0, 3]])


def test_cpu_path_is_eigh_and_builds_nothing(monkeypatch):
    """On CPU tensors ``sym_eig`` is ``torch.linalg.eigh`` (with
    ``eigh_nan``'s NaN rows), the CPU's bits before the kernel, in the
    input's dtype with float32 results, and never builds or launches the
    kernel."""
    from cubemapslam_tpu_torch import _build

    def no_build(*a, **k):
        raise AssertionError("a CPU call built a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    n0 = SE.SYM_EIG.launches
    A = torch.as_tensor(random_sym(np.random.default_rng(6), 5, 4, "sym"))
    for shape in ((5, 4, 4), (5, 1, 4, 4), (4, 4)):
        B = A.reshape(shape) if shape != (4, 4) else A[0]
        w, V = SE.sym_eig(B)
        we, Ve = torch.linalg.eigh(B)
        assert torch.equal(w, we) and torch.equal(V, Ve)
        assert w.shape == B.shape[:-1] and V.shape == B.shape
        # a float64 input is solved in float64, its results rounded
        w, V = SE.sym_eig(B.double())
        we, Ve = torch.linalg.eigh(B.double())
        assert w.dtype == V.dtype == torch.float32
        assert torch.equal(w, we.float()) and torch.equal(V, Ve.float())
    assert SE.SYM_EIG.launches == n0 and SE.SYM_EIG._fn is None


@pytest.mark.parametrize("bad", ["cpu", "size", "dtype", "shape"])
def test_cuda_wrapper_raises_before_a_launch(bad):
    A = torch.eye(4)[None].expand(3, 4, 4)
    A = {"cpu": A, "size": torch.eye(5)[None], "dtype": A.half(),
         "shape": torch.zeros(3, 4, 5)}[bad]
    n0 = SE.SYM_EIG.launches
    with pytest.raises(ValueError):
        SE.sym_eig_cuda(A)
    assert SE.SYM_EIG.launches == n0
