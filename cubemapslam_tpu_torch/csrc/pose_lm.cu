// Pose-only Levenberg-Marquardt (motion-only BA) of one camera pose against
// N fixed landmarks, the whole solve in one launch of one thread-block
// cluster.
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
// of J^T W J and the 6 of J^T W e at the trial pose in one reduction (a
// "pass"); accept if the cost fell; lambda x0.5 or x4 clamped to [1e-8, 1e4];
// leave the round once an accepted step has |delta|^2 < 1e-12. A round starts
// with one pass at the current pose, lambda 1e-3; after a round each edge is
// an inlier iff it is valid and its chi2 is <= 5.991 (the mask of the next
// round's sums).
//
// Bound on an H100: neither bytes (about 34 bytes an edge, read once) nor
// operations (about 250 float operations an edge and pass: 0.0002 ms at
// N = 2000 and 40 passes) but the serial chain of up to 44 dependent passes,
// each a reduction of 28 sums over all edges, then a 6x6 solve and a pose
// step that the next pass needs. One block of 512 threads took 5.25 us a
// pass at no edge and 6.3 us at N = 2000: 28 shuffle trees a warp, a 16-way
// serial sum and the decision on one thread, two __syncthreads a pass, all
// on one SM. The same structure spread over 8 blocks was no faster: its SM
// clocks a pass (scripts/torch_pose_lm_bench.py --split) went to the edges'
// terms (4 edges a thread, one warp a scheduler: latency), the warp
// reduction (its array in local memory), the cluster barrier and the 6x6
// solve. This design:
//   - one cluster of C blocks (C = 1, 2, 4, 8; the wrapper takes 8),
//     launched by cudaLaunchKernelEx on the caller's stream: no host read, no
//     other device operation, so CUDA graphs capture it;
//   - the 512 threads of the order of sums are virtual: block b holds virtual
//     threads b * 512 / C ... (b + 1) * 512 / C - 1, so warp w lives in block
//     w / (16 / C); each virtual thread's edges are spread over K physical
//     threads (slices; K = 1, 1, 2, 4 for C = 1, 2, 4, 8): in round m slice c
//     computes the terms of the virtual thread's edge K m + c, slices 1..K-1
//     hand theirs to slice 0 through shared memory, and slice 0 adds the K
//     edges in index order;
//   - a transposed warp reduction: the 28 sums (padded to 32) are
//     reduce-scattered over the lane pairs l ^ 16, l ^ 8, ..., l ^ 1, 31
//     shuffles a warp instead of 140; lane k ends with the warp's value k;
//   - one synchronisation a pass across the cluster: each warp's lanes write
//     their sums into every block's shared memory by st.async, which counts
//     the bytes on that block's mbarrier; a block waits on its own mbarrier
//     (2,048 bytes a pass) and reads all 16 warp sums locally (about 750 SM
//     clocks a pass, against about 1,800 for a cluster barrier and reads
//     through distributed shared memory). The buffer is chosen by the pass's
//     parity, so no second barrier is needed: a block's buffer p is written
//     again only for pass p + 2, which nobody starts before every block has
//     sent pass p + 1, which each does only after reading buffer p. A
//     cluster barrier after the mbarriers' set-up, and two at the end, keep
//     every block's shared memory alive for the remote accesses;
//   - every block decides for itself: the LM state (cost, lambda, the normal
//     equations, R, t, |delta|^2) lives in registers of warp 0 of each block,
//     which runs the accept test, lambda, the 6x6 solve and the pose step on
//     the same sums as every other block's warp 0, and so reaches the same
//     trial pose and the same stop flag, NaN included (a NaN comparison is
//     false in every block alike); every block leaves each round on the same
//     pass. One __syncthreads broadcasts warp 0's result to its block (every
//     warp deciding for itself puts two warps a scheduler on the solve at
//     C = 8, which was slower at 37 and 2000 edges);
//   - each thread keeps its first kCache edges in registers (at C = 8,
//     kCache * K * 512 = 8,192 edges, past a frame's 2000 and an init
//     frame's 6000), their inlier flags too; the edges past them are read
//     through the read-only cache every pass, in the same order, their flags
//     kept in inl_out. inl_out is written at the end.
// What bounds it now (C = 8, 2000 edges, SM clocks a pass at 1980 MHz, with
// the split's own cost): the edges' terms 1,420, the hand-over 653, the warp
// reduction and the push 715, the wait 151, the sums read and added 579, the
// accept test and the broadcast 630, the 6x6 solve 1,577, the pose step 882.
// The decision (judge, solve, step) is one thread's serial chain of about
// 1,000 instructions with IEEE divisions, sqrtf and sincosf; it bounds a pass
// from below at about 1.6 us.

// Order of additions (repeated by optim/pose_opt.py pose_optimization_ordered,
// which does not depend on C): virtual thread v sums edges v, v + 512, ... in
// index order from +0.0; then each warp adds over lane bits 4, 3, 2, 1, 0 in
// that order (the association of a __shfl_down_sync tree's result in lane 0:
// the reduce-scatter adds the same pairs, and IEEE addition is commutative);
// then the 16 warp sums are added in warp order. An edge outside the round's
// mask adds nothing (a slice hands over +0.0 for it: a sum from +0.0 is never
// -0.0, so adding +0.0 leaves its bits). This source is compiled with
// -fmad=false (_build.SOURCE_FLAGS): every product and sum is rounded on its
// own, in the order written, as the plain version's elementwise operations
// are; no --use_fast_math, so division and sqrtf are IEEE and sincosf gives
// the bits of CUDA's accurate sinf and cosf.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;    // virtual threads (pose_opt.LM_THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 4;        // edges a thread keeps in registers
constexpr int kLanes = 28;       // cost, 21 entries of H (upper), 6 of J^T W e
constexpr float kChi2 = 5.991f;
constexpr int kPassBytes = kWarps * 32 * 4;   // the sums a block receives

// With -DPOSE_LM_SPLIT (scripts/torch_pose_lm_bench.py --split), thread 0 of
// block 0 adds the SM clocks of each part of every pass into g_split: the
// edges' terms, the slices' hand-over, the warp reduction and its sending,
// the wait for every block's sums, the sums read and added, the accept test
// and lambda, the 6x6 solve, the pose step; then the pass count.
#ifdef POSE_LM_SPLIT
constexpr int kSplitParts = 8;
__device__ unsigned long long g_split[kSplitParts + 1];
#define SPLIT(k)                                         \
  if (split_on) {                                        \
    const long long now = clock64();                     \
    g_split[k] += (unsigned long long)(now - split_t);   \
    split_t = now;                                       \
  }
#else
#define SPLIT(k)
#endif

// The launch shape for a cluster of C blocks.
template <int C>
struct Shape {
  static constexpr int T = kThreads / C;   // virtual threads a block
  static constexpr int K = C >= 8 ? 4 : (C >= 4 ? 2 : 1);
  static constexpr int BT = K * T;         // threads a block
  static constexpr int WPB = kWarps / C;   // virtual warps a block
  static constexpr int BW = BT / 32;       // warps a block
};

struct Args {
  const float* R0;
  const float* t0;
  const float* Xw;
  const float* uv;
  const float* is2;
  const long long* face;
  const unsigned char* valid;
  const float* face_R;
  const float* fxycxy;
  float huber_delta;
  long long n;
  int n_rounds, n_iters;
  float* R_out;
  float* t_out;
  unsigned char* inl_out;
  long long* n_inl_out;
  int* iters_out;
};

struct Edge {
  float X, Y, Z, u, v, is2;
  int face;
  bool valid;
};

template <int C>
struct __align__(16) Shared {
  // slices 1..K-1's terms of the round, for slice 0 (112 bytes a thread:
  // its float4 accesses meet no bank conflict)
  float4 xfer[Shape<C>::K > 1 ? Shape<C>::K - 1 : 1]
             [Shape<C>::K > 1 ? Shape<C>::T : 1][kLanes / 4];
  float part[2][kWarps][32];      // every warp's sums, by pass parity
  float tot[Shape<C>::BW][32];    // each warp's copy of the cluster's sums
  unsigned long long bar[2];      // the bytes of part[b] received
  float cam[5 * 9 + 5];           // face rotations, fx, fy, cx, cy, Huber delta
  float pose[2][12];              // warp 0's trial pose, by publish parity
  int stop[2];                    // and its stop flag
  int count[Shape<C>::BW];
  long long total;                // this block's inliers
};

// The LM's state, the same in every deciding thread of the cluster.
struct Solver {
  float H[21], g[6];             // normal equations at the current pose
  float R[9], t[3];              // the current pose
  float cost, lam, dd;           // dd: |delta|^2 of the trial step
};

__device__ __forceinline__ Edge load_edge(const Args& a, long long i) {
  Edge e;
  e.X = __ldg(a.Xw + 3 * i);
  e.Y = __ldg(a.Xw + 3 * i + 1);
  e.Z = __ldg(a.Xw + 3 * i + 2);
  e.u = __ldg(a.uv + 2 * i);
  e.v = __ldg(a.uv + 2 * i + 1);
  e.is2 = __ldg(a.is2 + i);
  long long f = __ldg(a.face + i);
  e.face = (int)(f < 0 ? 0 : (f > 4 ? 4 : f));
  e.valid = __ldg(a.valid + i) != 0;
  return e;
}

// c ? x : y as a select instruction: written as an array's c ? a[j] : a[k],
// the compiler may index the array by c, which moves it to local memory.
__device__ __forceinline__ float select(bool c, float x, float y) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r) : "f"(x), "f"(y), "r"((int)c));
  return r;
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

// One edge's 28 terms at pose p into t; returns whether the edge is in the
// round's mask (t is written only then). With `update`, the mask is first
// set to valid & chi2 <= 5.991.
__device__ __forceinline__ bool edge_lanes(const Edge& e, bool& in,
                                           bool update, bool robust,
                                           const float* p, const float* cam,
                                           float* t) {
  float Xc[3], loc[3], e0, e1;
  const float chi2 = eval_edge(e, p, cam, Xc, loc, e0, e1);
  if (update) in = e.valid && chi2 <= kChi2;
  if (!(in && e.valid)) return false;
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
  t[0] = rho;
  int l = 1;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = J[0][i] * w, w1 = J[1][i] * w;
#pragma unroll
    for (int j = i; j < 6; ++j) {
      t[l] = w0 * J[0][j] + w1 * J[1][j];
      ++l;
    }
    t[22 + i] = w0 * e0 + w1 * e1;
  }
  return true;
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
      const float v = fabsf(A[i][k]);
      const bool more = v > best;
      best = select(more, v, best);
      p = more ? i : p;
    }
    // rows k and p swapped: selects of every row i > k on p == i
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool sw = p == i;
#pragma unroll
      for (int j = k; j < 6; ++j) {
        const float x = A[k][j], y = A[i][j];
        A[k][j] = select(sw, y, x);
        A[i][j] = select(sw, x, y);
      }
      const float x = b[k], y = b[i];
      b[k] = select(sw, y, x);
      b[i] = select(sw, x, y);
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
  float a, b, cc;                // the small-angle series only when taken
  if (theta < 1e-8f) {
    a = 1.0f - theta2 / 6.0f;
    b = 0.5f - theta2 / 24.0f;
    cc = 1.0f / 6.0f - theta2 / 120.0f;
  } else {
    float s, c;                  // sinf's and cosf's bits, one reduction
    sincosf(theta, &s, &c);
    a = s / theta;
    b = (1.0f - c) / theta2;
    cc = (theta - s) / (theta2 * theta);
  }
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

// One step of the transposed warp reduction at offset O: a lane keeps the O
// values whose bit O matches its own, sends the other O to lane ^ O and adds
// what that lane sends.
template <int O>
__device__ __forceinline__ void reduce_step(float (&a)[32], bool upper) {
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = select(upper, a[j], a[j + O]);
    const float keep = select(upper, a[j + O], a[j]);
    a[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The warp's 32 values (28 sums and 4 zeros) reduce-scattered over the lane
// pairs l ^ 16, l ^ 8, l ^ 4, l ^ 2, l ^ 1. Lane k returns the warp's sum of
// value k.
__device__ __forceinline__ float reduce_scatter(float (&a)[32], int lane) {
  reduce_step<16>(a, (lane & 16) != 0);
  reduce_step<8>(a, (lane & 8) != 0);
  reduce_step<4>(a, (lane & 4) != 0);
  reduce_step<2>(a, (lane & 2) != 0);
  reduce_step<1>(a, (lane & 1) != 0);
  return a[0];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same shared-memory location in block `rank`.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// v into a block's shared memory, its 4 bytes counted on that block's
// mbarrier.
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// This thread's arrival on the mbarrier's current phase, which then waits
// for `bytes` more.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the mbarrier's phase of this parity has completed.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred q;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 q, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, q;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// A round's start from the sums at the current pose: cost, H, g, lambda
// 1e-3.
__device__ __forceinline__ void start_round(Solver& s, const float* tot) {
  s.cost = tot[0];
#pragma unroll
  for (int k = 0; k < 21; ++k) s.H[k] = tot[1 + k];
#pragma unroll
  for (int k = 0; k < 6; ++k) s.g[k] = tot[22 + k];
  s.lam = 1e-3f;
}

// One LM iteration's verdict from the sums at the trial pose p: accept or
// reject, lambda, the stop test; when the round stops p becomes the current
// pose. Returns the stop flag (else the next trial step follows).
__device__ __forceinline__ bool judge(Solver& s, const float* tot, float* p,
                                      bool last) {
  // selects, not branches: the state moves as a whole
  const bool improved = tot[0] < s.cost;
  s.cost = select(improved, tot[0], s.cost);
#pragma unroll
  for (int k = 0; k < 21; ++k) s.H[k] = select(improved, tot[1 + k], s.H[k]);
#pragma unroll
  for (int k = 0; k < 6; ++k) s.g[k] = select(improved, tot[22 + k], s.g[k]);
#pragma unroll
  for (int k = 0; k < 9; ++k) s.R[k] = select(improved, p[k], s.R[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) s.t[k] = select(improved, p[9 + k], s.t[k]);
  const float lam = improved ? s.lam * 0.5f : s.lam * 4.0f;
  s.lam = fminf(fmaxf(lam, 1e-8f), 1e4f);
  const bool stop = (improved && s.dd < 1e-12f) || last;
#pragma unroll
  for (int k = 0; k < 9; ++k) p[k] = select(stop, s.R[k], p[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[9 + k] = select(stop, s.t[k], p[9 + k]);
  return stop;
}

template <int C>
__global__ void __launch_bounds__(Shape<C>::BT, 1) pose_lm_kernel(Args a) {
  using S = Shape<C>;
  constexpr int T = S::T, K = S::K, BT = S::BT, WPB = S::WPB, BW = S::BW;
  constexpr long long kStride = (long long)kThreads * K;  // a thread's edges
  __shared__ Shared<C> sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int slice = tid / T, vl = tid - slice * T, wl = vl >> 5;
  const bool owner = slice == 0;                 // slice 0: warp wl's lanes
  const int rank = (int)cluster.block_rank();
  const long long n = a.n;
  // this thread's q-th edge: vt + 512 (slice + K q), vt the virtual thread
  const long long base = (long long)rank * T + vl + (long long)kThreads * slice;
  const int rounds = (int)(((n + kThreads - 1) / kThreads + K - 1) / K);
  const bool decides = wp == 0;
  for (int k = tid; k < 45; k += BT) sh.cam[k] = a.face_R[k];
  if (tid < 4) sh.cam[45 + tid] = a.fxycxy[tid];
  if (tid == 0) {
    sh.cam[49] = a.huber_delta;
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&sh.bar[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    expect_bytes(smem_addr(&sh.bar[0]), kPassBytes);
    expect_bytes(smem_addr(&sh.bar[1]), kPassBytes);
  }

  Solver s;
  float p[12];                   // the pose the threads evaluate: R, t
#pragma unroll
  for (int k = 0; k < 9; ++k) s.R[k] = p[k] = a.R0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) s.t[k] = p[9 + k] = a.t0[k];

  Edge cache[kCache];
  bool in_c[kCache];
#pragma unroll
  for (int q = 0; q < kCache; ++q) {
    const long long i = base + q * kStride;
    in_c[q] = false;
    if (i < n) {
      cache[q] = load_edge(a, i);
      in_c[q] = cache[q].valid;
    }
  }
  // edges past the register cache: their flags in inl_out
  const long long first_global = base + kCache * kStride;
  for (long long i = first_global; i < n; i += kStride)
    a.inl_out[i] = a.valid[i];
  cluster.sync();                // cam, and every block's mbarriers set up

  // One pass: each virtual thread's edges at p, summed in index order by
  // slice 0; each warp's sums to every block; then the deciding warps add the
  // 16 warp sums in warp order into tot.
  int pass_no = 0;
#ifdef POSE_LM_SPLIT
  const bool split_on = rank == 0 && tid == 0;
  long long split_t = clock64();
#endif
  auto pass = [&](bool update, bool robust, float* tot) {
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    // round q: this thread's edge q (`exists`: below n), then the hand-over
    auto round = [&](bool exists, const Edge& e, bool& in, bool more) {
      float t[kLanes];
      const bool add = exists && edge_lanes(e, in, update, robust, p, sh.cam,
                                             t);
      SPLIT(0)
      if (K == 1) {
        if (add) {
#pragma unroll
          for (int l = 0; l < kLanes; ++l) acc[l] = acc[l] + t[l];
        }
        SPLIT(1)
        return;
      }
      if (!owner) {
#pragma unroll
        for (int l = 0; l < kLanes; l += 4)
          sh.xfer[slice - 1][vl][l / 4] =
              add ? make_float4(t[l], t[l + 1], t[l + 2], t[l + 3])
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();
      if (owner) {
        if (add) {
#pragma unroll
          for (int l = 0; l < kLanes; ++l) acc[l] = acc[l] + t[l];
        }
#pragma unroll
        for (int c = 1; c < K; ++c) {
#pragma unroll
          for (int l = 0; l < kLanes; l += 4) {
            const float4 q = sh.xfer[c - 1][vl][l / 4];
            acc[l] = acc[l] + q.x;
            acc[l + 1] = acc[l + 1] + q.y;
            acc[l + 2] = acc[l + 2] + q.z;
            acc[l + 3] = acc[l + 3] + q.w;
          }
        }
      }
      // the next round's hand-over waits for slice 0's reads; the next
      // pass's waits for the sums, which slice 0 sends after them
      if (more) __syncthreads();
      SPLIT(1)
    };
#pragma unroll
    for (int q = 0; q < kCache; ++q)
      if (q < rounds)
        round(base + q * kStride < n, cache[q], in_c[q], q + 1 < rounds);
    for (int q = kCache; q < rounds; ++q) {
      const long long i = base + q * kStride;
      const bool exists = i < n;
      bool in = exists && a.inl_out[i] != 0;
      Edge e = {};
      if (exists) e = load_edge(a, i);
      round(exists, e, in, q + 1 < rounds);
      if (exists && update) a.inl_out[i] = in;
    }
    SPLIT(0)
#ifdef POSE_LM_SPLIT
    if (split_on) g_split[kSplitParts] += 1;
#endif
    const int b = pass_no & 1;
    if (owner) {
      const float v = reduce_scatter(acc, lane);
      const uint32_t at = smem_addr(&sh.part[b][rank * WPB + wl][lane]);
      const uint32_t bar = smem_addr(&sh.bar[b]);
#pragma unroll
      for (int d = 0; d < C; ++d) push(at_rank(at, d), v, at_rank(bar, d));
    }
    SPLIT(2)
    wait_phase(smem_addr(&sh.bar[b]), (pass_no >> 1) & 1);
    // the next phase of bar[b] (pass pass_no + 2) cannot complete before
    // every thread here is past this wait: its sums need this block's
    if (tid == 0) expect_bytes(smem_addr(&sh.bar[b]), kPassBytes);
    SPLIT(3)
    if (decides) {
      float x[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x[w] = sh.part[b][w][lane];
      float sum = x[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = sum + x[w];
      sh.tot[wp][lane] = sum;
      __syncwarp();
      const float4* t4 = reinterpret_cast<const float4*>(sh.tot[wp]);
#pragma unroll
      for (int k = 0; k < kLanes / 4; ++k) {
        const float4 q = t4[k];
        tot[4 * k] = q.x;
        tot[4 * k + 1] = q.y;
        tot[4 * k + 2] = q.z;
        tot[4 * k + 3] = q.w;
      }
    }
    ++pass_no;
    SPLIT(4)
  };
  // The next trial pose p from the state: the 6x6 solve, then the step.
  auto trial = [&]() {
    float d[6];
    s.dd = solve6(s.H, s.g, s.lam, d);
    SPLIT(6)
    step_pose(d, s.R, s.t, p);
    SPLIT(7)
  };
  // Warp 0's trial pose and stop flag to the block's other warps, in the
  // buffer of the publish's parity: thread 0 writes buffer q again only in
  // the publish after next, past the next publish's __syncthreads, which
  // every thread reaches after reading buffer q.
  int pub_no = 0;
  auto publish = [&](bool stop) {
    const int q = pub_no & 1;
    ++pub_no;
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 12; ++k) sh.pose[q][k] = p[k];
      sh.stop[q] = stop;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 12; ++k) p[k] = sh.pose[q][k];
    return sh.stop[q] != 0;
  };

  float tot[kLanes];
  for (int r = 0; r < a.n_rounds; ++r) {
    const bool robust = r < 2;
    pass(r > 0, robust, tot);    // the round's mask, cost, H, g
    if (decides) {
      start_round(s, tot);
      SPLIT(5)
      trial();
    }
    publish(false);
    SPLIT(5)
    for (int it = 0; it < a.n_iters; ++it) {
      pass(false, robust, tot);  // the trial's cost, H, g
      bool stop = false;
      if (decides) {
        stop = judge(s, tot, p, it + 1 == a.n_iters);
        SPLIT(5)
        if (!stop) trial();
      }
      stop = publish(stop);
      SPLIT(5)
      if (stop) {
        if (rank == 0 && tid == 0) a.iters_out[r] = it + 1;
        break;
      }
    }
  }

  // The final inlier mask at the current pose p and its count.
  auto inlier = [&](const Edge& e) {
    float Xc[3], loc[3], e0, e1;
    return e.valid && eval_edge(e, p, sh.cam, Xc, loc, e0, e1) <= kChi2;
  };
  int count = 0;
#pragma unroll
  for (int q = 0; q < kCache; ++q) {
    const long long i = base + q * kStride;
    if (i < n) {
      const bool in = inlier(cache[q]);
      a.inl_out[i] = in;
      count += in;
    }
  }
  for (long long i = first_global; i < n; i += kStride) {
    const bool in = inlier(load_edge(a, i));
    a.inl_out[i] = in;
    count += in;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) sh.count[wp] = count;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < BW; ++w) total += sh.count[w];
    sh.total = total;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    long long total = 0;
    for (int r = 0; r < C; ++r) total += *cluster.map_shared_rank(&sh.total, r);
    *a.n_inl_out = total;
#pragma unroll
    for (int k = 0; k < 9; ++k) a.R_out[k] = p[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.t_out[k] = p[9 + k];
  }
  cluster.sync();                // every remote access done before any exit
}

// One cluster of C blocks on the stream.
template <int C>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(Shape<C>::BT, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = C;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pose_lm_kernel<C>, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// The whole solve: one cluster of `cluster` blocks (1, 2, 4 or 8) on the
// caller's stream. Inputs: R0 (3,3), t0 (3,), Xw (n,3), uv (n,2), is2 (n,)
// float32; face (n,) int64 (clamped to 0..4); valid (n,) bool; face_R
// (5,3,3), fxycxy (4,) float32; the Huber delta sqrt(5.991) as float32.
// Outputs: R (3,3), t (3,), inl (n,) bool, n_inl (0-d int64), iters
// (n_rounds,) int32: the LM iterations each round ran. Every output is
// written by the kernel. A cluster size outside {1, 2, 4, 8} or a refused
// launch returns the error; nothing falls back.
extern "C" int pose_lm_launch(const void* R0, const void* t0, const void* Xw,
                              const void* uv, const void* is2,
                              const void* face, const void* valid,
                              const void* face_R, const void* fxycxy,
                              float huber_delta, long long n, int n_rounds,
                              int n_iters, int cluster, void* R, void* t,
                              void* inl, void* n_inl, void* iters,
                              void* stream) {
  if (n < 0 || n >= (1ll << 31) || n_rounds < 1 || n_iters < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.R0 = (const float*)R0;
  a.t0 = (const float*)t0;
  a.Xw = (const float*)Xw;
  a.uv = (const float*)uv;
  a.is2 = (const float*)is2;
  a.face = (const long long*)face;
  a.valid = (const unsigned char*)valid;
  a.face_R = (const float*)face_R;
  a.fxycxy = (const float*)fxycxy;
  a.huber_delta = huber_delta;
  a.n = n;
  a.n_rounds = n_rounds;
  a.n_iters = n_iters;
  a.R_out = (float*)R;
  a.t_out = (float*)t;
  a.inl_out = (unsigned char*)inl;
  a.n_inl_out = (long long*)n_inl;
  a.iters_out = (int*)iters;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (cluster) {
    case 1: return (int)launch<1>(a, s);
    case 2: return (int)launch<2>(a, s);
    case 4: return (int)launch<4>(a, s);
    case 8: return (int)launch<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef POSE_LM_SPLIT
// The split's counters into out (host memory), then set to 0.
extern "C" int pose_lm_split_take(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kSplitParts + 1] = {};
  return (int)cudaMemcpyToSymbol(g_split, zero, sizeof(g_split));
}
#endif
