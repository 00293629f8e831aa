// Two-ray linear triangulation of N correspondences, one thread each.
//
// Replaces cubemapslam_tpu/solvers/triangulate.py:18 triangulate_rays, whose
// null vector is a batched XLA SVD of the (N,6,4) system (:33) inside the
// vmapped mapping program (cubemapslam_tpu/runtime/mapping.py:528-535) and the
// two-view initialization; it is not a Pallas kernel. The port's plain path
// (solvers/triangulate.py null_vector4: cyclic Jacobi on the 4x4 normal matrix
// in float64, since torch.linalg.svd / eigh read an error flag to the host)
// runs as about 1,100 small launches a call on the card.
//
// What each thread computes, in float64 registers, in this order (repeated
// by solvers/triangulate.py triangulate_rays_ordered):
//   - A = [hat(r1) P1 ; hat(r2) P2] with P1 = [I | 0] and P2 = [R21 | t21]:
//     rows 0-2 are hat(r1) with a zero fourth column; row 3 + i, column j
//     is h[a] * P2[a][j] + h[b] * P2[b][j] over the two non-zero entries of
//     row i of hat(r2) (a < b): row 0 (-z) P2[1] + y P2[2], row 1
//     z P2[0] + (-x) P2[2], row 2 (-y) P2[0] + x P2[1];
//   - M[j][k] = A[0][j] A[0][k] + A[1][j] A[1][k] + ... + A[5][j] A[5][k],
//     added left to right, for j <= k; M[k][j] = M[j][k];
//   - V = I, then JACOBI_SWEEPS = 6 cyclic sweeps over the pairs (0,1),
//     (0,2), (0,3), (1,2), (1,3), (2,3). A rotation of (p, q), as _rotate:
//     theta = (M[q][q] - M[p][p]) / (2 M[p][q]), the divisor 2 where
//     M[p][q] == 0; t = sgn(theta) / (|theta| + sqrt(theta^2 + 1)) with
//     sgn = +1 where theta >= 0, else -1; t = 0 where M[p][q] == 0;
//     c = 1 / sqrt(t^2 + 1), s = t c. Then J^T M on rows p and q
//     (row p = c M[p] - s M[q], row q = s M[p] + c M[q]), that times J on
//     columns p and q (column p = c M[.][p] - s M[.][q], column q =
//     s M[.][p] + c M[.][q]), and V J on the columns p and q of V. Nothing
//     is set to zero: M[p][q] keeps what the products leave there;
//   - k = the first index of the smallest diagonal entry of M, a NaN
//     counting as the smallest (torch.argmin's rule); X = column k of V;
//   - w = X[3], replaced by 1e-12 where |w| < 1e-12; out = X[0..2] / w,
//     rounded to float32.
// Non-finite rays give non-finite points, as in the plain version.
//
// Bound on an H100: neither bytes (36 bytes a correspondence) nor operations
// (about 3,440 float64 operations a correspondence: 0.20 us at N = 2000 on
// 34 TFLOP/s) but the serial chain of 36 dependent rotations, each with two
// float64 square roots and three divisions (software sequences on this card),
// at low occupancy: N = 2000 is 63 warps for 132 SMs. The design: one launch,
// one thread a correspondence, M and V in registers (their indices are
// compile-time constants), no shared memory, no synchronisation, small blocks
// (the block size is an argument; the port launches 32, TRI_THREADS) so the
// warps spread over the SMs. This source is compiled with -fmad=false
// (_build.SOURCE_FLAGS): every product and sum rounds on its own, in the
// order written, as the plain version's elementwise operations do; no
// --use_fast_math (double division and sqrt are IEEE round-to-nearest).

#include <cuda_runtime.h>

namespace {

constexpr int kSweeps = 6;       // solvers/triangulate.py JACOBI_SWEEPS

template <int p, int q>
__device__ __forceinline__ void rotate(double (&M)[4][4], double (&V)[4][4]) {
  const double app = M[p][p], aqq = M[q][q], apq = M[p][q];
  const bool nz = apq != 0.0;
  const double theta = (aqq - app) / (2.0 * (nz ? apq : 1.0));
  const double sgn = theta >= 0.0 ? 1.0 : -1.0;
  double t = sgn / (fabs(theta) + sqrt(theta * theta + 1.0));
  t = nz ? t : 0.0;
  const double c = 1.0 / sqrt(t * t + 1.0);
  const double s = t * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {            // J^T M: rows p and q
    const double mp = M[p][k], mq = M[q][k];
    M[p][k] = c * mp - s * mq;
    M[q][k] = s * mp + c * mq;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {            // (J^T M) J: columns p and q
    const double mp = M[r][p], mq = M[r][q];
    M[r][p] = c * mp - s * mq;
    M[r][q] = s * mp + c * mq;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {            // V J
    const double vp = V[r][p], vq = V[r][q];
    V[r][p] = c * vp - s * vq;
    V[r][q] = s * vp + c * vq;
  }
}

__global__ void triangulate_kernel(const float* __restrict__ rays1,
                                   const float* __restrict__ rays2,
                                   const float* __restrict__ R21,
                                   const float* __restrict__ t21,
                                   float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double P[3][4];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P[a][j] = (double)__ldg(R21 + 3 * a + j);
    P[a][3] = (double)__ldg(t21 + a);
  }
  const double x1 = (double)__ldg(rays1 + 3 * i);
  const double y1 = (double)__ldg(rays1 + 3 * i + 1);
  const double z1 = (double)__ldg(rays1 + 3 * i + 2);
  const double x2 = (double)__ldg(rays2 + 3 * i);
  const double y2 = (double)__ldg(rays2 + 3 * i + 1);
  const double z2 = (double)__ldg(rays2 + 3 * i + 2);

  double A[6][4];
  // hat(r1) [I | 0]
  A[0][0] = 0.0; A[0][1] = -z1; A[0][2] = y1;  A[0][3] = 0.0;
  A[1][0] = z1;  A[1][1] = 0.0; A[1][2] = -x1; A[1][3] = 0.0;
  A[2][0] = -y1; A[2][1] = x1;  A[2][2] = 0.0; A[2][3] = 0.0;
  // hat(r2) [R21 | t21], the two non-zero terms of each row
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    A[3][j] = (-z2) * P[1][j] + y2 * P[2][j];
    A[4][j] = z2 * P[0][j] + (-x2) * P[2][j];
    A[5][j] = (-y2) * P[0][j] + x2 * P[1][j];
  }
  double M[4][4], V[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = j; k < 4; ++k) {
      double acc = A[0][j] * A[0][k];
#pragma unroll
      for (int r = 1; r < 6; ++r) acc = acc + A[r][j] * A[r][k];
      M[j][k] = acc;
      M[k][j] = acc;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) V[j][k] = j == k ? 1.0 : 0.0;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    rotate<0, 1>(M, V);
    rotate<0, 2>(M, V);
    rotate<0, 3>(M, V);
    rotate<1, 2>(M, V);
    rotate<1, 3>(M, V);
    rotate<2, 3>(M, V);
  }
  // the first smallest diagonal entry; a NaN is the smallest
  double X[4];
  double best = M[0][0];
#pragma unroll
  for (int r = 0; r < 4; ++r) X[r] = V[r][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const double d = M[k][k];
    if (!(best != best) && ((d != d) || d < best)) {
      best = d;
#pragma unroll
      for (int r = 0; r < 4; ++r) X[r] = V[r][k];
    }
  }
  const double w = fabs(X[3]) < 1e-12 ? 1e-12 : X[3];
  out[3 * i] = (float)(X[0] / w);
  out[3 * i + 1] = (float)(X[1] / w);
  out[3 * i + 2] = (float)(X[2] / w);
}

}  // namespace

// rays1, rays2 (n, 3), R21 (3, 3), t21 (3,), out (n, 3): float32, contiguous,
// on the stream's device. n >= 1; block a multiple of 32, at most 1024.
extern "C" int triangulate_launch(const void* rays1, const void* rays2,
                                  const void* R21, const void* t21, void* out,
                                  int n, int block, void* stream) {
  if (n < 1 || block < 32 || block > 1024 || block % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + block - 1) / block;
  triangulate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)rays1, (const float*)rays2, (const float*)R21,
      (const float*)t21, (float*)out, n);
  return (int)cudaGetLastError();
}
