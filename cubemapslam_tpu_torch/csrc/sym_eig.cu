// Batched symmetric eigen-solve of B small float32 matrices, one warp a
// matrix: the eigenvalues in ascending order and the eigenvectors as
// columns, as torch.linalg.eigh gives them, with no read back to the host.
//
// Replaces no Pallas kernel. The JAX package calls jnp.linalg.eigh inside
// its compiled relocalization program (cubemapslam_tpu/solvers/pnp.py:51
// the control points' PCA, :133 the null space of M^T M; solvers/horn.py:46
// Horn's 4x4). The port's torch.linalg.eigh reads cuSOLVER's error flag
// back to the host, so each pnp_ransac waited 8 times and could not be
// captured in a CUDA graph. This kernel is its counterpart at those call
// sites (solvers/sym_eig.py sym_eig).
//
// The method, in this order for one matrix (repeated by solvers/sym_eig.py
// sym_eig_ordered, which holds this kernel bitwise):
//   - A is the input's lower triangle mirrored (A[i][j] = in[max(i,j)]
//     [min(i,j)]), in float64; V = I. A matrix with any non-finite entry
//     (either triangle) gives NaN eigenvalues and eigenvectors;
//   - nrm = A[0][0]^2 + A[0][1]^2 + ... + A[n-1][n-1]^2 over all n^2
//     entries, row by row, added left to right from 0; tol2 = eps2 * nrm;
//     skip2 = tol2 / (n (n-1) / 2);
//   - at most max_sweeps cyclic sweeps. A sweep first forms off = the sum
//     of A[p][q]^2 over p < q in row order, added left to right from 0, and
//     the matrix is done when off <= tol2. Then each pair (p, q), p < q, in
//     row order: the rotation is skipped where A[p][q]^2 <= skip2; else
//     theta = (A[q][q] - A[p][p]) / (2 A[p][q]); t = sgn / (|theta| +
//     sqrt(theta^2 + 1)) with sgn = +1 where theta >= 0, else -1;
//     c = 1 / sqrt(t^2 + 1), s = t c; for r != p, q the symmetric pair
//     A[r][p] = A[p][r] = c A[r][p] - s A[r][q] and A[r][q] = A[q][r] =
//     s A[r][p] + c A[r][q] (old values on the right); A[p][p] = A[p][p] -
//     t A[p][q], A[q][q] = A[q][q] + t A[p][q], A[p][q] = A[q][p] = 0; and
//     V[r][p] = c V[r][p] - s V[r][q], V[r][q] = s V[r][p] + c V[r][q] for
//     every r;
//   - the order: column j goes to rank #{i : d_i < d_j} + #{i < j : d_i ==
//     d_j} of the diagonal d (a stable ascending sort);
//   - the sign: each eigenvector column is negated where its entry of
//     largest magnitude (the first among equal magnitudes) is negative;
//   - the eigenvalues d and the columns of V rounded to float32.
// Every product and sum rounds on its own (this source is compiled with
// -fmad=false, _build.SOURCE_FLAGS); division and sqrt are IEEE
// round-to-nearest (no --use_fast_math), as PyTorch's elementwise float64
// operations.
//
// Layout: one warp a matrix, kWarps matrices a block; A and V of the warp's
// matrix in shared memory (2 n^2 doubles: 2304 bytes at n = 12). Every lane
// reads the pivot entries and computes the rotation (the same bits in each
// lane, so every branch is uniform across the warp), then lane r < n
// updates row r's pair of entries in A and V; two __syncwarp a rotation.
// The sums that decide convergence are formed by every lane from the same
// shared entries in the same order.
//
// Bound on an H100: neither bytes (8 n^2 + 4 n bytes a matrix) nor
// operations (about 6 (2n - 2) + 18 float64 operations a rotation: 0.0008
// ms for 300 matrices of 12 x 12 at 34 TFLOP/s) but the serial chain of a
// matrix's rotations, each with two float64 square roots and three
// divisions (software sequences on this card), about 66 rotations a sweep
// at n = 12. The batch runs in parallel, a warp a matrix, so the launch
// costs one matrix's chain; a simple kernel, not tuned.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;        // matrices a block

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
sym_eig_kernel(const float* __restrict__ in, float* __restrict__ evals,
               float* __restrict__ evecs, int batch, int max_sweeps,
               double eps2) {
  __shared__ double sA[kWarps][N][N];
  __shared__ double sV[kWarps][N][N];
  __shared__ int sPerm[kWarps][N];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= batch) return;                  // the whole warp
  double (*A)[N] = sA[warp];
  double (*V)[N] = sV[warp];
  const float* src = in + b * N * N;
  float* val = evals + b * N;
  float* vec = evecs + b * N * N;

  bool finite = true;
  if (lane < N) {
    for (int j = 0; j < N; ++j) {
      const float x = src[lane * N + j];
      finite = finite && isfinite(x);
      if (j <= lane) {                      // the lower triangle, mirrored
        A[lane][j] = (double)x;
        A[j][lane] = (double)x;
      }
      V[lane][j] = lane == j ? 1.0 : 0.0;
    }
  }
  if (!__all_sync(0xffffffffu, finite)) {
    if (lane < N) {
      const float nan = __int_as_float(0x7fc00000);
      val[lane] = nan;
      for (int r = 0; r < N; ++r) vec[r * N + lane] = nan;
    }
    return;
  }
  __syncwarp();

  double nrm = 0.0;
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) nrm = nrm + A[i][j] * A[i][j];
  const double tol2 = eps2 * nrm;
  const double skip2 = tol2 / (double)(N * (N - 1) / 2);

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < N - 1; ++p)
      for (int q = p + 1; q < N; ++q) off = off + A[p][q] * A[p][q];
    if (off <= tol2) break;
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const double app = A[p][p], aqq = A[q][q], apq = A[p][q];
        if (apq * apq <= skip2) continue;
        const double theta = (aqq - app) / (2.0 * apq);
        const double sgn = theta >= 0.0 ? 1.0 : -1.0;
        const double t = sgn / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0);
        const double s = t * c;
        __syncwarp();                     // every lane has read the pivots
        if (lane < N) {
          const int r = lane;
          const double vp = V[r][p], vq = V[r][q];
          V[r][p] = c * vp - s * vq;
          V[r][q] = s * vp + c * vq;
          if (r == p) {
            A[p][p] = app - t * apq;
            A[p][q] = 0.0;
            A[q][p] = 0.0;
          } else if (r == q) {
            A[q][q] = aqq + t * apq;
          } else {
            const double mp = A[r][p], mq = A[r][q];
            const double np = c * mp - s * mq;
            const double nq = s * mp + c * mq;
            A[r][p] = np;
            A[p][r] = np;
            A[r][q] = nq;
            A[q][r] = nq;
          }
        }
        __syncwarp();
      }
    }
  }

  if (lane < N) {                          // a stable ascending order
    const double dj = A[lane][lane];
    int rank = 0;
    for (int i = 0; i < N; ++i) {
      const double di = A[i][i];
      rank += (di < dj) || (di == dj && i < lane);
    }
    sPerm[warp][rank] = lane;
  }
  __syncwarp();
  if (lane < N) {
    const int k = sPerm[warp][lane];
    val[lane] = (float)A[k][k];
    int big = 0;
    double best = fabs(V[0][k]);
    for (int r = 1; r < N; ++r) {
      const double a = fabs(V[r][k]);
      if (a > best) {
        best = a;
        big = r;
      }
    }
    const bool neg = V[big][k] < 0.0;
    for (int r = 0; r < N; ++r) {
      const double v = V[r][k];
      vec[r * N + lane] = (float)(neg ? -v : v);
    }
  }
}

}  // namespace

// One launch for B = batch matrices of size n (3, 4 or 12): in (B, n, n),
// evals (B, n) and evecs (B, n, n), float32, contiguous. Returns
// cudaGetLastError() after the launch; an unsupported n launches nothing
// and returns cudaErrorInvalidValue.
extern "C" int sym_eig_launch(const float* in, float* evals, float* evecs,
                              int batch, int n, int max_sweeps, double eps2,
                              cudaStream_t stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  const int threads = kWarps * 32;
  switch (n) {
    case 3:
      sym_eig_kernel<3><<<blocks, threads, 0, stream>>>(
          in, evals, evecs, batch, max_sweeps, eps2);
      break;
    case 4:
      sym_eig_kernel<4><<<blocks, threads, 0, stream>>>(
          in, evals, evecs, batch, max_sweeps, eps2);
      break;
    case 12:
      sym_eig_kernel<12><<<blocks, threads, 0, stream>>>(
          in, evals, evecs, batch, max_sweeps, eps2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
