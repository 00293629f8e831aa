// Two-ray linear triangulation of B pose pairs x N correspondences in one
// launch, one thread a row b * N + i; in the mapping step's form, with the
// candidate gates of that row in the same thread.
//
// Replaces no Pallas kernel. The JAX package takes the null vector from a
// batched XLA SVD of the (N,6,4) system (cubemapslam_tpu/solvers/
// triangulate.py:18 triangulate_rays, the SVD at :33), vmapped over the 6
// neighbours of a mapping step together with the gates of
// triangulate_with_neighbor (cubemapslam_tpu/runtime/mapping.py:116-168),
// which XLA fuses into that one program, and over the 4 (R, t) hypotheses
// of the two-view reconstruction (solvers/essential.py check_rt). The port
// ran one launch a pair and the gates as about 250 small PyTorch operations
// a pair (about 1,550 a mapping step).
//
// The null vector of one row, in float64 registers, in this order (repeated
// by solvers/triangulate.py triangulate_rays_ordered), with (R21, t21) the
// row's pair:
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
//   - w = X[3], replaced by 1e-12 where |w| < 1e-12; X1 = X[0..2] / w,
//     rounded to float32.
// Non-finite rays give non-finite points, as in the plain version.
//
// The gated form (the mapping step; repeated by triangulate_gated_ordered):
// the row's rays are gathered here, r1 = kf_rays[k_new][i] and r2 =
// kf_rays[nb[b]][idx[b][i]], with uv and level likewise. Then, in float32,
// each product and sum written out in this order, as the plain version's
// elementwise operations round them:
//   - ok = match[b][i] & X1 finite;
//   - q = R21^T r2 (q[j] = r2x R[0][j] + r2y R[1][j] + r2z R[2][j]),
//     cos_par = r1x q[0] + r1y q[1] + r1z q[2]; ok &= cos_par < 0.9998
//     -> n_par;
//   - d1 = sqrt(x^2 + y^2 + z^2), base = |t21| likewise; ok &= d1 <= 50 base
//     -> n_depth;
//   - ok &= X1z / max(d1, 1e-12) > cos_fov_th; X2[i] = (R[i][0] X1x +
//     R[i][1] X1y + R[i][2] X1z) + t21[i], d2 as d1, ok &= X2z / max(d2,
//     1e-12) > cos_fov_th;
//   - ray_to_cubemap of X1 and X2 (camera.py): the octant tests in the
//     order front, right, left, lower, upper; the face rotation, whose
//     entries are 0 and +-1, as the moves and negations it makes; the
//     pinhole (x fx) / z' + cx with z' = 1e-14 where z == 0; the in-face
//     test; the cross offset off * W added;
//   - e = du^2 + dv^2 against the keypoint's uv; ok &= face >= 0 and
//     e <= 5.991 level_sigma2[clamp(level)], in both frames -> n_chi2;
//   - the scale test: r = d2 / max(d1, 1e-12), o = sf[l1] / sf[l2];
//     ok &= r * ratio > o and r < o * ratio (ratio = 1.5 scale_factor);
//   - Xw[j] = (X1x - t1x) R1[0][j] + (X1y - t1y) R1[1][j] + (X1z - t1z)
//     R1[2][j] with (R1, t1) the new keyframe's pose.
// Outputs Xw, ok and cos_par a row; a pair's counts [raw, n_par, n_depth,
// n_chi2] are warp ballots, one integer atomicAdd a warp and count into a
// buffer the wrapper zeroes: integer sums, the same in every order. No float
// is summed across threads.
//
// Bound on an H100: neither bytes (under 100 bytes a row) nor operations
// (about 3,443 float64 operations a row, and about 150 float32 for the
// gates: 0.0012 ms at B N = 12,000 on 34 TFLOP/s) but the serial chain of
// 36 dependent rotations a row, each with two float64 square roots and
// three divisions (software sequences on this card), about 14 us, at low
// occupancy. The design pays that chain once a launch instead of once a
// pair: one grid of (ceil(N / block), B) blocks over the B N rows, so no
// block straddles two pairs and each thread reads its pair's 12 geometry
// values once (the same address across the warp: one broadcast); small
// blocks (the block size is an argument; the port launches 32, TRI_THREADS)
// so the 378 warps of a mapping step (B = 6, N = 2000) spread over the 132
// SMs; M and V in registers (their indices are compile-time constants); the
// gates on the finished point, in the same thread, while it is still in
// registers; no shared memory and no synchronisation but the ballots. This
// source is compiled with -fmad=false (_build.SOURCE_FLAGS): every product
// and sum rounds on its own, in the order written, as the plain version's
// elementwise operations do; no --use_fast_math (division and sqrt are
// IEEE round-to-nearest).

#include <cuda_runtime.h>

// The mapping gates' inputs and outputs of one launch (wrapper:
// solvers/triangulate.py _GateArgs, the same layout).
struct GateArgs {
  const float* kf_rays;          // (K, N, 3)
  const float* kf_uv;            // (K, N, 2)
  const long long* kf_level;     // (K, N)
  const float* kf_R;             // (K, 3, 3)
  const float* kf_t;             // (K, 3)
  const long long* k_new;        // (1,) the new keyframe's slot
  const long long* nb;           // (B,) each pair's neighbour slot
  const long long* idx;          // (B, N) the matched neighbour feature
  const bool* match;             // (B, N) the epipolar search's ok
  const float* fxycxy;           // (4,)
  const float* face_wh;          // (2,)
  const float* cos_fov;          // ()
  const float* level_sigma2;     // (L,)
  const float* scale_factors;    // (L,)
  bool* ok;                      // (B, N)
  float* cos_par;                // (B, N)
  unsigned long long* gates;     // (B, 4), zeroed by the wrapper
  int n_levels;                  // L
  float ratio;                   // 1.5 * scale_factor
};

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

// The point of rays r1, r2 under P = [R21 | t21], in frame 1.
__device__ __forceinline__ void solve(const float* __restrict__ r1,
                                      const float* __restrict__ r2,
                                      const float (&R)[3][3],
                                      const float (&tr)[3], float (&out)[3]) {
  double P[3][4];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P[a][j] = (double)R[a][j];
    P[a][3] = (double)tr[a];
  }
  const double x1 = (double)__ldg(r1), y1 = (double)__ldg(r1 + 1);
  const double z1 = (double)__ldg(r1 + 2);
  const double x2 = (double)__ldg(r2), y2 = (double)__ldg(r2 + 1);
  const double z2 = (double)__ldg(r2 + 2);

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
  out[0] = (float)(X[0] / w);
  out[1] = (float)(X[1] / w);
  out[2] = (float)(X[2] / w);
}

__device__ __forceinline__ float norm3(const float (&v)[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ __forceinline__ long long clamp_level(long long l, int n_levels) {
  return l < 0 ? 0 : (l > n_levels - 1 ? n_levels - 1 : l);
}

// camera.py ray_to_cubemap of a rig point: false where it has no face or
// projects outside its face (UNKNOWN, uv (-1, -1) there).
__device__ __forceinline__ bool to_cubemap(const float (&X)[3], float fx,
                                           float fy, float cx, float cy,
                                           float W, float H, float& u,
                                           float& v) {
  const float x = X[0], y = X[1], z = X[2];
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  float lx, ly, lz, ox, oy;      // the face frame's point, the cross offset
  if (z > 0.f && ax <= z && ay <= z) {                 // FRONT (x, y, z)
    lx = x; ly = y; lz = z; ox = 1.f; oy = 1.f;
  } else if (x > 0.f && ay <= x && az <= x) {          // RIGHT (-z, y, x)
    lx = -z; ly = y; lz = x; ox = 2.f; oy = 1.f;
  } else if (x < 0.f && ay <= -x && az <= -x) {        // LEFT (z, y, -x)
    lx = z; ly = y; lz = -x; ox = 0.f; oy = 1.f;
  } else if (y > 0.f && ax <= y && az <= y) {          // LOWER (x, -z, y)
    lx = x; ly = -z; lz = y; ox = 1.f; oy = 2.f;
  } else if (y < 0.f && ax <= -y && az <= -y) {        // UPPER (x, z, -y)
    lx = x; ly = z; lz = -y; ox = 1.f; oy = 0.f;
  } else {
    return false;
  }
  const float zs = lz == 0.f ? 1e-14f : lz;
  const float up = lx * fx / zs + cx;
  const float vp = ly * fy / zs + cy;
  if (!(up >= 0.f && up < W && vp >= 0.f && vp < H)) return false;
  u = up + ox * W;
  v = vp + oy * H;
  return true;
}

template <bool kGated>
__global__ void triangulate_kernel(const float* __restrict__ rays1,
                                   const float* __restrict__ rays2,
                                   const float* __restrict__ R21,
                                   const float* __restrict__ t21,
                                   float* __restrict__ out, int n,
                                   GateArgs g) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = (long long)b * n + i;
  const bool live = i < n;
  float R[3][3], tr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[a][j] = __ldg(R21 + 9 * b + 3 * a + j);
    tr[a] = __ldg(t21 + 3 * b + a);
  }
  if constexpr (!kGated) {
    if (!live) return;
    float X[3];
    solve(rays1 + 3 * i, rays2 + 3 * i, R, tr, X);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * row + c] = X[c];
    return;
  }
  // the gated form: every lane of the warp reaches the ballots
  bool raw = false, pass_par = false, pass_depth = false, pass_chi2 = false;
  if (live) {
    const long long k1 = __ldg(g.k_new), k2 = __ldg(g.nb + b);
    const long long j2 = __ldg(g.idx + row);
    const long long f1 = k1 * n + i, f2 = k2 * n + j2;
    const float* r1 = g.kf_rays + 3 * f1;
    const float* r2 = g.kf_rays + 3 * f2;
    float X1[3];
    solve(r1, r2, R, tr, X1);
    raw = g.match[row];
    bool ok = raw && isfinite(X1[0]) && isfinite(X1[1]) && isfinite(X1[2]);
    // parallax between the viewing rays in frame 1
    const float r1x = __ldg(r1), r1y = __ldg(r1 + 1), r1z = __ldg(r1 + 2);
    const float r2x = __ldg(r2), r2y = __ldg(r2 + 1), r2z = __ldg(r2 + 2);
    float q[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      q[j] = r2x * R[0][j] + r2y * R[1][j] + r2z * R[2][j];
    const float cp = r1x * q[0] + r1y * q[1] + r1z * q[2];
    ok = ok && cp < 0.9998f;
    pass_par = ok;
    const float d1 = norm3(X1);
    const float base = norm3(tr);
    ok = ok && d1 <= 50.0f * base;
    pass_depth = ok;
    // FOV cones in both frames
    const float cfov = __ldg(g.cos_fov);
    ok = ok && X1[2] / fmaxf(d1, 1e-12f) > cfov;
    float X2[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      X2[a] = (R[a][0] * X1[0] + R[a][1] * X1[1] + R[a][2] * X1[2]) + tr[a];
    const float d2 = norm3(X2);
    ok = ok && X2[2] / fmaxf(d2, 1e-12f) > cfov;
    // reprojection chi2 in both frames
    const float fx = __ldg(g.fxycxy), fy = __ldg(g.fxycxy + 1);
    const float cx = __ldg(g.fxycxy + 2), cy = __ldg(g.fxycxy + 3);
    const float W = __ldg(g.face_wh), H = __ldg(g.face_wh + 1);
    const long long l1 = clamp_level(__ldg(g.kf_level + f1), g.n_levels);
    const long long l2 = clamp_level(__ldg(g.kf_level + f2), g.n_levels);
    float u, v;
    if (to_cubemap(X1, fx, fy, cx, cy, W, H, u, v)) {
      const float du = u - __ldg(g.kf_uv + 2 * f1);
      const float dv = v - __ldg(g.kf_uv + 2 * f1 + 1);
      ok = ok && du * du + dv * dv <= 5.991f * __ldg(g.level_sigma2 + l1);
    } else {
      ok = false;
    }
    if (to_cubemap(X2, fx, fy, cx, cy, W, H, u, v)) {
      const float du = u - __ldg(g.kf_uv + 2 * f2);
      const float dv = v - __ldg(g.kf_uv + 2 * f2 + 1);
      ok = ok && du * du + dv * dv <= 5.991f * __ldg(g.level_sigma2 + l2);
    } else {
      ok = false;
    }
    pass_chi2 = ok;
    // scale consistency
    const float rd = d2 / fmaxf(d1, 1e-12f);
    const float ro = __ldg(g.scale_factors + l1) / __ldg(g.scale_factors + l2);
    ok = ok && rd * g.ratio > ro && rd < ro * g.ratio;
    // world coordinates
    const float* R1 = g.kf_R + 9 * k1;
    const float* t1 = g.kf_t + 3 * k1;
    const float e0 = X1[0] - __ldg(t1), e1 = X1[1] - __ldg(t1 + 1);
    const float e2 = X1[2] - __ldg(t1 + 2);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * row + j] = e0 * __ldg(R1 + j) + e1 * __ldg(R1 + 3 + j)
                         + e2 * __ldg(R1 + 6 + j);
    g.ok[row] = ok;
    g.cos_par[row] = cp;
  }
  const unsigned m_raw = __ballot_sync(0xffffffffu, raw);
  const unsigned m_par = __ballot_sync(0xffffffffu, pass_par);
  const unsigned m_depth = __ballot_sync(0xffffffffu, pass_depth);
  const unsigned m_chi2 = __ballot_sync(0xffffffffu, pass_chi2);
  if ((threadIdx.x & 31) == 0) {
    unsigned long long* c = g.gates + 4 * b;
    if (m_raw) atomicAdd(c, (unsigned long long)__popc(m_raw));
    if (m_par) atomicAdd(c + 1, (unsigned long long)__popc(m_par));
    if (m_depth) atomicAdd(c + 2, (unsigned long long)__popc(m_depth));
    if (m_chi2) atomicAdd(c + 3, (unsigned long long)__popc(m_chi2));
  }
}

}  // namespace

// R21 (pairs, 3, 3), t21 (pairs, 3), float32, contiguous, on the stream's
// device; n >= 1 rows a pair; block a multiple of 32, at most 1024.
// gates == nullptr: rays1, rays2 (n, 3) float32 shared by the pairs, out
// (pairs, n, 3) their points in frame 1. Else the gated form (GateArgs):
// rays1 and rays2 unused, out (pairs, n, 3) the world points.
extern "C" int triangulate_launch(const void* rays1, const void* rays2,
                                  const void* R21, const void* t21, void* out,
                                  const GateArgs* gates, int n, int pairs,
                                  int block, void* stream) {
  if (n < 1 || pairs < 1 || pairs > 65535 || block < 32 || block > 1024
      || block % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + block - 1) / block, pairs);
  const cudaStream_t s = (cudaStream_t)stream;
  if (gates == nullptr) {
    triangulate_kernel<false><<<grid, block, 0, s>>>(
        (const float*)rays1, (const float*)rays2, (const float*)R21,
        (const float*)t21, (float*)out, n, GateArgs{});
  } else {
    triangulate_kernel<true><<<grid, block, 0, s>>>(
        nullptr, nullptr, (const float*)R21, (const float*)t21, (float*)out,
        n, *gates);
  }
  return (int)cudaGetLastError();
}
