// Batched symmetric eigen-solve of B small float32 or float64 matrices,
// one warp a matrix: the eigenvalues in ascending order and the
// eigenvectors as columns, as torch.linalg.eigh gives them, in float32,
// with no read back to the host.
//
// Replaces no Pallas kernel. The JAX package calls jnp.linalg.eigh inside
// its compiled relocalization program (cubemapslam_tpu/solvers/pnp.py:51
// the control points' PCA, :133 the null space of M^T M; solvers/horn.py:46
// Horn's 4x4), and jnp.linalg.svd inside its compiled two-view
// initialization (cubemapslam_tpu/solvers/essential.py:42 the 8-point null
// vector, :44 the rank-2 projection, :100 the decomposition). The port's
// torch.linalg.eigh and torch.linalg.svd read cuSOLVER's error flag back
// to the host, so each pnp_ransac waited 8 times, each two-view attempt 6
// times, and neither could be captured in a CUDA graph. This kernel is
// their counterpart at those call sites (solvers/sym_eig.py sym_eig): the
// essential solver takes its null vector from the 9 x 9 normal matrix
// A^T A, formed in float64 (formed in float32 it squares A's condition
// number into float32's precision) and read here as it is, and its SVDs of
// E from E^T E (3 x 3).
//
// The method: Jacobi rotations in a parallel (round-robin) order, in this
// order for one matrix (repeated by solvers/sym_eig.py sym_eig_ordered,
// which holds this kernel bitwise). NP is n rounded up to even; at odd n
// (3, 9) the index n is a dummy with a zero row and column.
//   - A is the input's lower triangle mirrored (A[i][j] = in[max(i,j)]
//     [min(i,j)]), in float64 (a float32 input widened exactly), zero
//     padded to NP x NP; V = I; d = the
//     diagonal. A matrix with any non-finite entry (either triangle) gives
//     NaN eigenvalues and eigenvectors;
//   - the sums of squares are shuffle trees: lane r < n forms its row's
//     partial sum left to right from 0, every other lane holds 0, then each
//     of the 32 lanes adds its xor-16 neighbour's value to its own, then
//     its xor-8, xor-4, xor-2 and xor-1 neighbour's (all lanes end with the
//     same bits). nrm: the partials over all n entries of the row; tol2 =
//     eps2 * nrm; skip2 = tol2 / (n (n-1) / 2);
//   - at most max_sweeps sweeps. A sweep first forms off, the partials
//     over the entries right of the diagonal (j > r), and the matrix is done
//     when off <= tol2. Then NP - 1 steps; step s pairs NP - 1 with s and
//     i with j where i + j = 2 s modulo NP - 1 (NP / 2 disjoint pairs, every
//     pair once a sweep; solvers/sym_eig.py schedule);
//   - a step computes every pair's angle (p < q) from A as the step found
//     it: skipped where A[p][q]^2 <= skip2 (the dummy's pairs always are);
//     else theta = (d[q] - d[p]) / (2 A[p][q]); t = sgn / (|theta| +
//     sqrt(theta^2 + 1)) with sgn = +1 where theta >= 0, else -1;
//     c = 1 / sqrt(t^2 + 1), s = t c. A skipped pair takes t = 0, c = 1,
//     s = 0: the identity, applied by the same formulas. With u = c and
//     w = -s for the lower index of a pair, u = c and w = s for the upper,
//     and i' the index paired with i, the step sets every entry outside the
//     pivot blocks to (J^T A J)[i][j] written as
//       ((u_i u_j) A[i][j] + (w_i w_j) A[i'][j'])
//         + ((u_i w_j) A[i][j'] + (w_i u_j) A[i'][j]),
//     each product and sum rounded on its own. That expression is the same
//     for (i, j) and (j, i) up to the order of one sum's two terms, so A
//     stays exactly symmetric with no entry mirrored and no triangle
//     preferred. The pivot block: A[p][q] = A[q][p] = 0 (kept where
//     skipped), d[p] = d[p] - t A[p][q], d[q] = d[q] + t A[p][q]. And V J:
//     V[r][p] = c V[r][p] - s V[r][q], V[r][q] = s V[r][p] + c V[r][q];
//   - the order: column j goes to rank #{i : d_i < d_j} + #{i < j : d_i ==
//     d_j} of d (a stable ascending sort);
//   - the sign: each eigenvector column is negated where its entry of
//     largest magnitude (the first among equal magnitudes) is negative;
//   - d and the columns of V rounded to float32.
// Every product and sum rounds on its own (this source is compiled with
// -fmad=false, _build.SOURCE_FLAGS); division and sqrt are IEEE
// round-to-nearest (no --use_fast_math), as PyTorch's elementwise float64
// operations.
//
// Layout: one warp a matrix, kWarps matrices a block. During the sweeps
// lane r < NP holds row r of A (its own diagonal entry in d, the slot of
// the diagonal in the row is left stale and never read) and row r of V in
// registers, every index of them fixed at compile time (the schedule is
// unrolled). A step is one pass of shuffles: each lane reads its partner's
// row and diagonal (the lane pair's row exchange) and takes its pivot
// A[r][r'] from its own row; both lanes of a pair compute the same angle;
// every lane reads each pair's c and s from the pair's lower lane; then
// each lane writes its new row of A (both the column and the row rotation
// are local, from its own and its partner's old row) and of V (column
// rotations only). No shared memory and no __syncwarp in the sweeps;
// shared memory holds d and V once, for the final order. Lanes >= NP hold
// zero rows and pair with themselves. n = 3 and 4 run the same program
// with NP = 4 (28 idle lanes), n = 9 with NP = 10, so one program and one
// plain version serve every size. At n = 3 that costs time: a step holds one real pair, so the
// order adds no parallelism, and a step (0.55 us on an H100) is dearer
// than a rotation of the cyclic order this replaced. The slowest of 300
// PCA matrices takes 12 steps, as many links as its (at most) 12 cyclic
// rotations, and the solve takes 0.0085 ms against the cyclic kernel's
// 0.0073 in the same run (scripts/torch_sym_eig_bench.py). It is
// accepted: the n = 3 solves take about 0.015 ms of the 0.16 ms of one
// PnP's six solves, which the 12 x 12 solves dominate. Dropping the dummy
// pair's shuffles (3 of a step's 9, the same bits) saved 2% of a step and
// nothing of the solve, so the program keeps them.
//
// Bound on an H100: neither bytes (8 n^2 + 4 n bytes a float32 matrix,
// 12 n^2 + 4 n a float64 one) nor the float64 operations the solve needs
// (12 n + 6 a rotation applied, the sums, the order and the sign:
// chip_smoke.py eig_bound, which does not count the program's redundant
// work: both lanes of a pair compute its angle, each entry of A is
// computed in both triangles, a skipped pair rotates by the identity) but the serial chain of a matrix's steps: the
// pivot, two float64 square roots and three divisions (software sequences
// on this card), the shuffles of c and s, and the update, NP - 1 steps a
// sweep (66 rotations in the cyclic order this replaced). The batch runs
// in parallel, a warp a matrix, so the launch costs its slowest matrix's
// chain: its serial floor is that matrix's steps times one step's
// latency. The products are 2 x 2 rotations of 12 x 12 rows, far too small
// for the tensor cores (DMMA), which are not used.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;        // matrices a block
constexpr unsigned kFull = 0xffffffffu;

// The two indices of pair k at step s of a sweep over NP indices: pair 0 is
// (s, NP - 1); pair k > 0 is (s - k, s + k) modulo NP - 1.
__host__ __device__ constexpr int pair_a(int np, int s, int k) {
  return k == 0 ? s : (s - k + (np - 1)) % (np - 1);
}
__host__ __device__ constexpr int pair_b(int np, int s, int k) {
  return k == 0 ? np - 1 : (s + k) % (np - 1);
}
__host__ __device__ constexpr int pair_lo(int np, int s, int k) {
  return pair_a(np, s, k) < pair_b(np, s, k) ? pair_a(np, s, k)
                                              : pair_b(np, s, k);
}
__host__ __device__ constexpr int pair_hi(int np, int s, int k) {
  return pair_a(np, s, k) < pair_b(np, s, k) ? pair_b(np, s, k)
                                              : pair_a(np, s, k);
}

// Lane r's partner at step s (lanes >= NP pair with themselves).
template <int NP>
__device__ __forceinline__ int partner(int s, int r) {
  constexpr int m = NP - 1;
  if (r >= NP) return r;
  if (r == m) return s;
  if (r == s) return m;
  const int j = 2 * s - r;
  return j < 0 ? j + m : (j >= m ? j - m : j);
}

// The sum over the warp's lanes in the fixed tree of the header.
__device__ __forceinline__ double tree_sum(double x) {
  x = x + __shfl_xor_sync(kFull, x, 16);
  x = x + __shfl_xor_sync(kFull, x, 8);
  x = x + __shfl_xor_sync(kFull, x, 4);
  x = x + __shfl_xor_sync(kFull, x, 2);
  x = x + __shfl_xor_sync(kFull, x, 1);
  return x;
}

template <int N, typename T>
__global__ void __launch_bounds__(kWarps * 32)
sym_eig_kernel(const T* __restrict__ in, float* __restrict__ evals,
               float* __restrict__ evecs, int batch, int max_sweeps,
               double eps2) {
  constexpr int NP = N + (N & 1);
  __shared__ double sD[kWarps][N];
  __shared__ double sV[kWarps][N][N];
  __shared__ int sPerm[kWarps][N];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= batch) return;                  // the whole warp
  const T* src = in + b * N * N;
  float* val = evals + b * N;
  float* vec = evecs + b * N * N;

  double a[NP];                            // row `lane` of A
  double v[NP];                            // row `lane` of V
  bool finite = true;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    double x = 0.0;
    if (j < N && lane < N) {
      const T f = src[lane * N + j];
      finite = finite && isfinite(f);
      x = (double)(j <= lane ? f : src[j * N + lane]);  // lower, mirrored
    }
    a[j] = x;
    v[j] = j == lane ? 1.0 : 0.0;
  }
  if (!__all_sync(kFull, finite)) {
    if (lane < N) {
      const float nan = __int_as_float(0x7fc00000);
      val[lane] = nan;
      for (int r = 0; r < N; ++r) vec[r * N + lane] = nan;
    }
    return;
  }
  double d = lane < N ? (double)src[lane * N + lane] : 0.0;

  double part = 0.0;
#pragma unroll
  for (int j = 0; j < N; ++j) part = part + a[j] * a[j];
  const double tol2 = eps2 * tree_sum(part);
  const double skip2 = tol2 / (double)(N * (N - 1) / 2);

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j > lane) off = off + a[j] * a[j];
    if (tree_sum(off) <= tol2) break;      // the same in every lane
#pragma unroll
    for (int s = 0; s < NP - 1; ++s) {
      const int pt = partner<NP>(s, lane);
      const bool lo = lane < pt;
      double e = 0.0;                      // the pivot A[lane][pt]
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (j == pt) e = a[j];
      const double dp = __shfl_sync(kFull, d, pt);
      double o[NP];                        // the partner's row, as found
#pragma unroll
      for (int j = 0; j < NP; ++j) o[j] = __shfl_sync(kFull, a[j], pt);
      const bool skip = e * e <= skip2;
      const double app = lo ? d : dp, aqq = lo ? dp : d;
      // a skipped pair's angle is discarded: it is taken from 1 / 1, since
      // a zero or special operand sends every lane of the warp through the
      // slow paths of the float64 division and square root
      const double theta = (skip ? 1.0 : aqq - app) / (skip ? 1.0 : 2.0 * e);
      const double sgn = theta >= 0.0 ? 1.0 : -1.0;
      double t = sgn / (fabs(theta) + sqrt(theta * theta + 1.0));
      double c = 1.0 / sqrt(t * t + 1.0);
      double sn = t * c;
      if (skip) {
        t = 0.0;
        c = 1.0;
        sn = 0.0;
      }
      const double ui = c, wi = lo ? -sn : sn;
#pragma unroll
      for (int k = 0; k < NP / 2; ++k) {
        const int p = pair_lo(NP, s, k), q = pair_hi(NP, s, k);
        const double ck = __shfl_sync(kFull, c, p);
        const double sk = __shfl_sync(kFull, sn, p);
        const double up = ck, wp = -sk, uq = ck, wq = sk;
        const double ap = a[p], aq = a[q], bp = o[p], bq = o[q];
        a[p] = ((ui * up) * ap + (wi * wp) * bq)
             + ((ui * wp) * aq + (wi * up) * bp);
        a[q] = ((ui * uq) * aq + (wi * wq) * bp)
             + ((ui * wq) * ap + (wi * uq) * bq);
        const double vp = v[p], vq = v[q];
        v[p] = ck * vp - sk * vq;
        v[q] = sk * vp + ck * vq;
      }
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (j == pt) a[j] = skip ? e : 0.0;
      d = lo ? d - t * e : d + t * e;
    }
  }

  if (lane < N) {
    sD[warp][lane] = d;
#pragma unroll
    for (int j = 0; j < N; ++j) sV[warp][lane][j] = v[j];
  }
  __syncwarp();
  const double* D = sD[warp];
  double (*V)[N] = sV[warp];
  if (lane < N) {                          // a stable ascending order
    const double dj = D[lane];
    int rank = 0;
    for (int i = 0; i < N; ++i) {
      const double di = D[i];
      rank += (di < dj) || (di == dj && i < lane);
    }
    sPerm[warp][rank] = lane;
  }
  __syncwarp();
  if (lane < N) {
    const int k = sPerm[warp][lane];
    val[lane] = (float)D[k];
    int big = 0;
    double best = fabs(V[0][k]);
    for (int r = 1; r < N; ++r) {
      const double x = fabs(V[r][k]);
      if (x > best) {
        best = x;
        big = r;
      }
    }
    const bool neg = V[big][k] < 0.0;
    for (int r = 0; r < N; ++r) {
      const double x = V[r][k];
      vec[r * N + lane] = (float)(neg ? -x : x);
    }
  }
}

template <int N>
void launch(const void* in, bool in_f64, float* evals, float* evecs,
            int batch, int max_sweeps, double eps2, cudaStream_t stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  const int threads = kWarps * 32;
  if (in_f64)
    sym_eig_kernel<N, double><<<blocks, threads, 0, stream>>>(
        static_cast<const double*>(in), evals, evecs, batch, max_sweeps,
        eps2);
  else
    sym_eig_kernel<N, float><<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(in), evals, evecs, batch, max_sweeps,
        eps2);
}

}  // namespace

// One launch for B = batch matrices of size n (3, 4, 9 or 12): in (B, n, n)
// float32, or float64 where in_f64 is set (read as it is: the method is
// float64 throughout, so a float64 input skips the rounding to float32),
// evals (B, n) and evecs (B, n, n) float32, all contiguous. Returns
// cudaGetLastError() after the launch; an unsupported n launches nothing
// and returns cudaErrorInvalidValue.
extern "C" int sym_eig_launch(const void* in, float* evals, float* evecs,
                              int batch, int n, int in_f64, int max_sweeps,
                              double eps2, cudaStream_t stream) {
  switch (n) {
    case 3:
      launch<3>(in, in_f64, evals, evecs, batch, max_sweeps, eps2, stream);
      break;
    case 4:
      launch<4>(in, in_f64, evals, evecs, batch, max_sweeps, eps2, stream);
      break;
    case 9:
      launch<9>(in, in_f64, evals, evecs, batch, max_sweeps, eps2, stream);
      break;
    case 12:
      launch<12>(in, in_f64, evals, evecs, batch, max_sweeps, eps2, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
