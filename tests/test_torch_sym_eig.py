"""Port parity: the batched symmetric eigen-solve (``cubemapslam_tpu_torch/
solvers/sym_eig.py``).

On the card ``sym_eig`` launches ``csrc/sym_eig.cu``, whose plain version
``sym_eig_ordered`` repeats its float64 cyclic Jacobi in its order (the
kernel is held to it bitwise by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``). Here:

* ``sym_eig_ordered`` against a scalar emulation of the kernel written from
  its source (one matrix at a time, Python floats, which round as IEEE
  float64 like the kernel's and PyTorch's operations): bitwise, at n = 3, 4
  and 12, on random, diagonal (ties), zero and EPnP matrices.
* ``sym_eig_ordered`` against ``jnp.linalg.eigh`` (float32) at n = 3, 4 and
  12 on seeded symmetric matrices (positive and indefinite) and on the
  matrices of one ``pnp_ransac`` call: eigenvalues within 1e-6 of the
  largest |eigenvalue|, V diag(w) Vᵀ within 1e-6 of A and VᵀV within 1e-6
  of I (relative to the largest |eigenvalue|); each eigenvector of a simple
  eigenvalue equal to JAX's up to its sign within 1e-3; the projector onto
  the 4-dimensional null space of a minimal set's MᵀM within 1e-3 of JAX's
  (the basis itself differs between solvers), and that space annihilated
  by MᵀM within 1e-6 of its norm.
* The stable order of equal eigenvalues and the sign rule.
* A non-finite matrix gives NaN results without raising, and leaves the
  other matrices of its batch as they are, in ``sym_eig_ordered`` and in
  ``sym_eig`` on the CPU.
* ``sym_eig`` on CPU tensors is ``eigh_nan`` (``torch.linalg.eigh``, the
  bits the CPU had before) and builds nothing; ``sym_eig_cuda`` raises on
  a CPU tensor, a wrong size or dtype, before any launch.
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
from cubemapslam_tpu_torch.solvers import pnp as TP
from cubemapslam_tpu_torch.solvers import sym_eig as SE

SIZES = (3, 4, 12)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores, where more
    threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate(A: np.ndarray):
    """The kernel's program for one (n, n) float32 matrix, lane by lane in
    order, on Python floats: (eigenvalues (n,), eigenvectors (n, n)),
    float32."""
    n = A.shape[0]
    if not np.isfinite(A).all():
        return (np.full(n, np.nan, np.float32),
                np.full((n, n), np.nan, np.float32))
    a = [[float(A[max(i, j), min(i, j)]) for j in range(n)]
         for i in range(n)]
    v = [[1.0 if i == j else 0.0 for j in range(n)] for i in range(n)]
    nrm = 0.0
    for i in range(n):
        for j in range(n):
            nrm = nrm + a[i][j] * a[i][j]
    tol2 = (SE.EPS * SE.EPS) * nrm
    skip2 = tol2 / float(n * (n - 1) // 2)
    for _ in range(SE.MAX_SWEEPS):
        off = 0.0
        for p in range(n - 1):
            for q in range(p + 1, n):
                off = off + a[p][q] * a[p][q]
        if off <= tol2:
            break
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
    d = [a[j][j] for j in range(n)]
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


def test_pnp_matrices_shapes(pnp_matrices):
    assert [tuple(A.shape) for A in pnp_matrices] == [
        (300, 3, 3), (300, 12, 12), (300, 3, 4, 4), (3, 3), (12, 12),
        (3, 4, 4)]


@pytest.mark.parametrize("n", SIZES)
def test_ordered_against_kernel_emulation(n, pnp_matrices):
    rng = np.random.default_rng(n)
    mats = [random_sym(rng, 2, n, "psd"), random_sym(rng, 2, n, "sym"),
            np.diag(np.array([2.0, 1.0, 1.0] + [0.5] * (n - 3),
                             np.float32))[None],
            np.zeros((1, n, n), np.float32)]
    pnp = {3: pnp_matrices[0][:3], 4: pnp_matrices[2][:1].reshape(-1, 4, 4),
           12: pnp_matrices[1][:3]}[n]
    mats.append(pnp.numpy())
    nan = random_sym(rng, 1, n, "psd")
    nan[0, n - 1, 0] = np.nan
    mats.append(nan)
    A = np.concatenate(mats)
    w, V = SE.sym_eig_ordered(torch.as_tensor(A))
    for i, a in enumerate(A):
        we, Ve = emulate(a)
        np.testing.assert_array_equal(w[i].numpy(), we, err_msg=str(i))
        np.testing.assert_array_equal(V[i].numpy(), Ve, err_msg=str(i))


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
    ``eigh_nan``'s NaN rows), the CPU's bits before the kernel, and never
    builds or launches the kernel."""
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
    assert SE.SYM_EIG.launches == n0 and SE.SYM_EIG._fn is None


@pytest.mark.parametrize("bad", ["cpu", "size", "dtype", "shape"])
def test_cuda_wrapper_raises_before_a_launch(bad):
    A = torch.eye(4)[None].expand(3, 4, 4)
    A = {"cpu": A, "size": torch.eye(5)[None], "dtype": A.double(),
         "shape": torch.zeros(3, 4, 5)}[bad]
    n0 = SE.SYM_EIG.launches
    with pytest.raises(ValueError):
        SE.sym_eig_cuda(A)
    assert SE.SYM_EIG.launches == n0
