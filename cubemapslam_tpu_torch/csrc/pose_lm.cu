// Pose-only Levenberg-Marquardt (motion-only BA) of one camera pose against
// N fixed landmarks, the whole solve in one launch.
//
// Replaces cubemapslam_tpu/optim/pose_opt.py:36 pose_optimization, which the
// JAX package compiles into one XLA program (a lax.fori_loop over 4 rounds,
// each a lax.while_loop of at most 10 LM iterations that leaves once an
// accepted step is tiny); it is not a Pallas kernel. The port ran it as a
// Python loop of 40 masked iterations, about 11k small kernels a solve.
//
// What it computes, as optim/pose_opt.py does: per round r (robust Huber
// kernel for r < 2, plain chi2 after), per iteration: the residual of each
// edge at the trial pose, its weight, the trial cost and the 21 upper entries
// of J^T W J and the 6 of J^T W e at the trial pose in one block reduction;
// accept if the cost fell; lambda x0.5 or x4 clamped to [1e-8, 1e4]; leave the
// round once an accepted step has |delta|^2 < 1e-12. A round starts from the
// current pose with lambda 1e-3; after a round each edge is an inlier iff it
// is valid and its chi2 is <= 5.991 (the mask of the next round's sums).
//
// Bound on an H100: neither bytes (about 33 bytes an edge, read once) nor
// operations (about 250 float operations an edge and iteration: 0.0003 ms at
// N = 2000 and 40 iterations) but the serial chain of at most 44 dependent
// block reductions, each followed by a 6x6 solve on one thread. The design:
//   - one block of 512 threads, one launch: no host read, no other device
//     operation, so the launch is captured in the tracked frame's graphs;
//   - each thread keeps its first 4 edges (edge tid + k * 512) in registers
//     and reads the rest through the read-only cache; per-edge state at the
//     current pose is not stored: it is evaluated again from the pose, with
//     the same bits;
//   - the trial cost and the normal equations at the trial pose are one
//     reduction (28 lanes), so an iteration takes two __syncthreads: one
//     after the warps' partial sums, one after thread 0 has decided, solved
//     the next step and published the next pose; an accepted trial's normal
//     equations are the next iteration's;
//   - the round leaves its loop on a block-uniform flag, as JAX's while_loop.
//
// Order of additions (repeated by optim/pose_opt.py pose_optimization_ordered):
// each thread sums its edges in index order from +0.0, then a warp adds by
// __shfl_down_sync with offsets 16, 8, 4, 2, 1, then the 16 warps' sums are
// added in warp order. An edge outside the round's mask adds nothing. This
// source is compiled with -fmad=false (_build.SOURCE_FLAGS): every product and
// sum is rounded on its own, in the order written, as the plain version's
// elementwise operations are; no --use_fast_math, so division, sqrtf, sinf
// and cosf are IEEE / CUDA's accurate versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 4;        // edges a thread keeps in registers
constexpr int kLanes = 28;       // cost, 21 entries of H (upper), 6 of J^T W e
constexpr float kChi2 = 5.991f;

struct Edge {
  float X, Y, Z, u, v, is2;
  int face;
  bool valid;
};

struct Shared {
  float cam[5 * 9 + 5];          // face rotations, fx, fy, cx, cy, Huber delta
  float pose[12];                // the pose the threads evaluate: R, t
  float part[kWarps][kLanes];    // the warps' sums
  float tot[kLanes];             // the block's sums
  float H[21], g[6];             // thread 0's normal equations, current pose
  float R[9], t[3];              // thread 0's current pose
  float cost, lam;
  int count[kWarps];
  int stop;
};

__device__ __forceinline__ Edge load_edge(
    const float* __restrict__ Xw, const float* __restrict__ uv,
    const float* __restrict__ is2, const long long* __restrict__ face,
    const unsigned char* __restrict__ valid, long long i) {
  Edge e;
  e.X = __ldg(Xw + 3 * i);
  e.Y = __ldg(Xw + 3 * i + 1);
  e.Z = __ldg(Xw + 3 * i + 2);
  e.u = __ldg(uv + 2 * i);
  e.v = __ldg(uv + 2 * i + 1);
  e.is2 = __ldg(is2 + i);
  long long f = __ldg(face + i);
  e.face = (int)(f < 0 ? 0 : (f > 4 ? 4 : f));
  e.valid = __ldg(valid + i) != 0;
  return e;
}

// Residual, chi2, camera-frame point and face-local point of one edge at the
// pose p (R row-major, then t): residuals.eval_point.
__device__ __forceinline__ float eval_edge(const Edge& e, const float* p,
                                           const float* cam, float* Xc,
                                           float* loc, float& e0, float& e1) {
  Xc[0] = p[0] * e.X + p[1] * e.Y + p[2] * e.Z + p[9];
  Xc[1] = p[3] * e.X + p[4] * e.Y + p[5] * e.Z + p[10];
  Xc[2] = p[6] * e.X + p[7] * e.Y + p[8] * e.Z + p[11];
  const float* F = cam + 9 * e.face;
  loc[0] = F[0] * Xc[0] + F[1] * Xc[1] + F[2] * Xc[2];
  loc[1] = F[3] * Xc[0] + F[4] * Xc[1] + F[5] * Xc[2];
  loc[2] = F[6] * Xc[0] + F[7] * Xc[1] + F[8] * Xc[2];
  const float z = fabsf(loc[2]) < 1e-12f ? 1e-12f : loc[2];
  e0 = e.u - (loc[0] * cam[45] / z + cam[47]);
  e1 = e.v - (loc[1] * cam[46] / z + cam[48]);
  return (e0 * e0 + e1 * e1) * e.is2;
}

// One edge's terms at pose p, added to acc when the edge is in the round's
// mask. With `update`, the mask is first set to valid & chi2 <= 5.991.
__device__ __forceinline__ void edge_terms(const Edge& e, bool& in,
                                           bool update, bool robust,
                                           const float* p, const float* cam,
                                           float* acc) {
  float Xc[3], loc[3], e0, e1;
  const float chi2 = eval_edge(e, p, cam, Xc, loc, e0, e1);
  if (update) in = e.valid && chi2 <= kChi2;
  if (!(in && e.valid)) return;
  const float delta = cam[49];
  float w = e.is2, rho = chi2;
  if (robust) {
    const float r = sqrtf(chi2 < 1e-20f ? 1e-20f : chi2);
    // delta / r as the plain version's scalar division: (1 / r) * delta
    w = e.is2 * (r <= delta ? 1.0f : (1.0f / r) * delta);
    rho = chi2 <= kChi2 ? chi2 : 2.0f * delta * r - kChi2;
  }
  // pose_jac_from_state: (J_proj R_face) rows, then [-A | A hat(Xc)]
  const float fx = cam[45], fy = cam[46];
  const float z = fabsf(loc[2]) < 1e-12f ? 1e-12f : loc[2];
  const float iz = 1.0f / z;
  const float a0 = fx * iz, a2 = -fx * loc[0] * iz * iz;
  const float b1 = fy * iz, b2 = -fy * loc[1] * iz * iz;
  const float* F = cam + 9 * e.face;
  float J[2][6];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float A[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      A[k] = row == 0 ? a0 * F[k] + a2 * F[6 + k]
                      : b1 * F[3 + k] + b2 * F[6 + k];
    J[row][0] = -A[0];
    J[row][1] = -A[1];
    J[row][2] = -A[2];
    J[row][3] = A[1] * Xc[2] - A[2] * Xc[1];
    J[row][4] = -A[0] * Xc[2] + A[2] * Xc[0];
    J[row][5] = A[0] * Xc[1] - A[1] * Xc[0];
  }
  acc[0] = acc[0] + rho;
  int l = 1;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = J[0][i] * w, w1 = J[1][i] * w;
#pragma unroll
    for (int j = i; j < 6; ++j) {
      acc[l] = acc[l] + (w0 * J[0][j] + w1 * J[1][j]);
      ++l;
    }
    acc[22 + i] = acc[22 + i] + (w0 * e0 + w1 * e1);
  }
}

// (H + lam diag(H) + 1e-9 I) delta = -g by LU with partial pivoting (the
// first largest pivot), H from its 21 upper entries; then |delta|^2.
__device__ __forceinline__ float solve6(const float* H, const float* g,
                                        float lam, float* d) {
  float A[6][6], b[6];
  int l = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = A[j][i] = H[l];
      ++l;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = A[i][i] + lam * A[i][i] + 1e-9f;
    b[i] = -g[i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (p == i) {
#pragma unroll
        for (int j = k; j < 6; ++j) {
          const float s = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = s;
        }
        const float s = b[k];
        b[k] = b[i];
        b[i] = s;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float f = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = A[i][j] - f * A[k][j];
      b[i] = b[i] - f * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * d[j];
    d[i] = s / A[i][i];
  }
  return d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3] + d[4] * d[4] +
         d[5] * d[5];
}

// se3_exp(delta) composed on the left of (R, t), into p (R, then t):
// geometry.so3_exp, _so3_left_jacobian, se3_compose.
__device__ __forceinline__ void step_pose(const float* d, const float* R,
                                          const float* t, float* p) {
  const float x = d[3], y = d[4], z = d[5];
  const float theta = sqrtf(x * x + y * y + z * z + 1e-24f);
  const float K[3][3] = {{0.0f, -z, y}, {z, 0.0f, -x}, {-y, x, 0.0f}};
  float K2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
  const float theta2 = theta * theta;
  const bool small = theta < 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float a = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - c) / theta2;
  const float cc = small ? 1.0f / 6.0f - theta2 / 120.0f
                         : (theta - s) / (theta2 * theta);
  float dR[3][3], dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      dR[i][j] = eye + a * K[i][j] + b * K2[i][j];
      V[j] = eye + b * K[i][j] + cc * K2[i][j];
    }
    dt[i] = V[0] * d[0] + V[1] * d[1] + V[2] * d[2];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      p[3 * i + j] = dR[i][0] * R[j] + dR[i][1] * R[3 + j] +
                     dR[i][2] * R[6 + j];
    p[9 + i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] + dt[i];
  }
}

// Each warp's sums of its threads' acc, by a shuffle tree, into
// sh.part[warp] (lane 0 writes them).
__device__ __forceinline__ void warp_sums(float* acc, Shared& sh, int lane,
                                          int warp) {
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh.part[warp][k] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
               const float* __restrict__ Xw, const float* __restrict__ uv,
               const float* __restrict__ is2,
               const long long* __restrict__ face,
               const unsigned char* __restrict__ valid,
               const float* __restrict__ face_R,
               const float* __restrict__ fxycxy, float huber_delta,
               long long n, int n_rounds, int n_iters, float* R_out,
               float* t_out, unsigned char* inl_out, long long* n_inl_out,
               int* iters_out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 45) sh.cam[tid] = face_R[tid];
  if (tid < 4) sh.cam[45 + tid] = fxycxy[tid];
  if (tid == 0) {
    sh.cam[49] = huber_delta;
#pragma unroll
    for (int k = 0; k < 9; ++k) sh.R[k] = sh.pose[k] = R0[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) sh.t[k] = sh.pose[9 + k] = t0[k];
  }
  Edge cache[kCache];
  bool in_c[kCache];
#pragma unroll
  for (int c = 0; c < kCache; ++c) {
    const long long i = tid + (long long)c * kThreads;
    in_c[c] = false;
    if (i < n) {
      cache[c] = load_edge(Xw, uv, is2, face, valid, i);
      in_c[c] = cache[c].valid;
    }
  }
  for (long long i = tid + (long long)kCache * kThreads; i < n; i += kThreads)
    inl_out[i] = valid[i];
  __syncthreads();

  // The terms of every edge of this thread at sh.pose, summed in index
  // order, then the warp's sum into sh.part.
  auto pass = [&](bool update, bool robust) {
    float p[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) p[k] = sh.pose[k];
    float acc[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCache; ++c)
      if (tid + (long long)c * kThreads < n)
        edge_terms(cache[c], in_c[c], update, robust, p, sh.cam, acc);
    for (long long i = tid + (long long)kCache * kThreads; i < n;
         i += kThreads) {
      const Edge e = load_edge(Xw, uv, is2, face, valid, i);
      bool in = inl_out[i] != 0;
      edge_terms(e, in, update, robust, p, sh.cam, acc);
      if (update) inl_out[i] = in;
    }
    warp_sums(acc, sh, lane, warp);
  };
  // Warp 0 adds the warps' sums in warp order into sh.tot.
  auto block_sums = [&]() {
    if (lane < kLanes) {
      float s = sh.part[0][lane];
      for (int w = 1; w < kWarps; ++w) s = s + sh.part[w][lane];
      sh.tot[lane] = s;
    }
    __syncwarp();
  };
  // Thread 0: solve from its normal equations and publish the trial pose.
  auto publish_step = [&]() {
    float d[6], p[12];
    const float dd = solve6(sh.H, sh.g, sh.lam, d);
    step_pose(d, sh.R, sh.t, p);
#pragma unroll
    for (int k = 0; k < 12; ++k) sh.pose[k] = p[k];
    return dd;
  };
  auto publish_current = [&]() {
#pragma unroll
    for (int k = 0; k < 9; ++k) sh.pose[k] = sh.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) sh.pose[9 + k] = sh.t[k];
  };

  float dd = 0.0f;                 // thread 0: |delta|^2 of the trial step
  for (int r = 0; r < n_rounds; ++r) {
    const bool robust = r < 2;
    pass(r > 0, robust);           // the round's mask, cost, H, g
    __syncthreads();
    if (warp == 0) {
      block_sums();
      if (tid == 0) {
        sh.cost = sh.tot[0];
        for (int k = 0; k < 21; ++k) sh.H[k] = sh.tot[1 + k];
        for (int k = 0; k < 6; ++k) sh.g[k] = sh.tot[22 + k];
        sh.lam = 1e-3f;
        dd = publish_step();
      }
    }
    __syncthreads();
    int it = 0;
    while (it < n_iters) {
      pass(false, robust);         // the trial's cost, H, g
      __syncthreads();
      if (warp == 0) {
        block_sums();
        if (tid == 0) {
          const bool improved = sh.tot[0] < sh.cost;
          if (improved) {
            sh.cost = sh.tot[0];
            for (int k = 0; k < 21; ++k) sh.H[k] = sh.tot[1 + k];
            for (int k = 0; k < 6; ++k) sh.g[k] = sh.tot[22 + k];
            for (int k = 0; k < 9; ++k) sh.R[k] = sh.pose[k];
            for (int k = 0; k < 3; ++k) sh.t[k] = sh.pose[9 + k];
          }
          const float lam = improved ? sh.lam * 0.5f : sh.lam * 4.0f;
          sh.lam = fminf(fmaxf(lam, 1e-8f), 1e4f);
          const bool stop = (improved && dd < 1e-12f) || it + 1 == n_iters;
          if (stop) {
            publish_current();
            iters_out[r] = it + 1;
          } else {
            dd = publish_step();
          }
          sh.stop = stop;
        }
      }
      __syncthreads();
      ++it;
      if (sh.stop) break;
    }
  }

  // The final inlier mask at the current pose (sh.pose) and its count.
  float p[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) p[k] = sh.pose[k];
  auto inlier = [&](const Edge& e) {
    float Xc[3], loc[3], e0, e1;
    return e.valid && eval_edge(e, p, sh.cam, Xc, loc, e0, e1) <= kChi2;
  };
  int count = 0;
#pragma unroll
  for (int c = 0; c < kCache; ++c) {
    const long long i = tid + (long long)c * kThreads;
    if (i < n) {
      const bool in = inlier(cache[c]);
      inl_out[i] = in;
      count += in;
    }
  }
  for (long long i = tid + (long long)kCache * kThreads; i < n;
       i += kThreads) {
    const bool in = inlier(load_edge(Xw, uv, is2, face, valid, i));
    inl_out[i] = in;
    count += in;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) sh.count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += sh.count[w];
    *n_inl_out = total;
#pragma unroll
    for (int k = 0; k < 9; ++k) R_out[k] = p[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t_out[k] = p[9 + k];
  }
}

}  // namespace

// The whole solve: one block on the caller's stream. Inputs: R0 (3,3), t0
// (3,), Xw (n,3), uv (n,2), is2 (n,) float32; face (n,) int64 (clamped to
// 0..4); valid (n,) bool; face_R (5,3,3), fxycxy (4,) float32; the Huber
// delta sqrt(5.991) as float32. Outputs: R (3,3), t (3,), inl (n,) bool,
// n_inl (0-d int64), iters (n_rounds,) int32: the LM iterations each round
// ran. Every output is written by the kernel.
extern "C" int pose_lm_launch(const void* R0, const void* t0, const void* Xw,
                              const void* uv, const void* is2,
                              const void* face, const void* valid,
                              const void* face_R, const void* fxycxy,
                              float huber_delta, long long n, int n_rounds,
                              int n_iters, void* R, void* t, void* inl,
                              void* n_inl, void* iters, void* stream) {
  if (n < 0 || n >= (1ll << 31) || n_rounds < 1 || n_iters < 1)
    return (int)cudaErrorInvalidValue;
  pose_lm_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)R0, (const float*)t0, (const float*)Xw, (const float*)uv,
      (const float*)is2, (const long long*)face, (const unsigned char*)valid,
      (const float*)face_R, (const float*)fxycxy, huber_delta, n, n_rounds,
      n_iters, (float*)R, (float*)t, (unsigned char*)inl, (long long*)n_inl,
      (int*)iters);
  return (int)cudaGetLastError();
}
