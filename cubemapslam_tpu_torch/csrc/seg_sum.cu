// The segmented sum: out[s, c] = sum of values[perm[k], c] over the sorted
// positions k in [off[s], off[s+1]), in an order fixed by the plan alone.
//
// Replaces the float scatter-adds of the JAX package, which are XLA scatters
// and not Pallas kernels: `.at[idx].add` in cubemapslam_tpu/optim/ba.py (the
// direct BA's point and coupling sums, the CG BA's camera and point sums and
// its Schur matvec), optim/pose_graph.py (the dense normal matrix and its
// right-hand side) and slam_map.py (the landmarks' mean viewing normal). On
// the card PyTorch's index_add_ adds with float atomics, whose order, and so
// whose last bits, change from run to run; this kernel's order does not.
//
// The plan (segment.SegmentPlan) is built once per problem on the device: the
// stable sort of the segment ids gives `perm` (the rows of `values` segment
// by segment, each segment's rows in index order) and `off` (n_seg + 1 start
// positions). One warp sums one segment, all of its C lanes at once:
//   1. the segment's len rows are cut into 32 contiguous chunks of
//      ceil(len / 32) rows; thread t sums chunk t row by row, from 0.0;
//   2. the non-empty chunks' partial sums are added in chunk order, from 0.0,
//      by every thread alike (a broadcast shuffle a chunk), and thread
//      (c mod 32) writes lane c.
// Every sum is rounded one add at a time (__fadd_rn), so the result depends
// on the plan only and segment.segment_sum_ordered reproduces it bitwise. A
// segment of at most 32 rows is summed in index order from 0.0, which is the
// order of the CPU's index_add_. Every output row is written once: an empty
// segment writes zeros, so no zero fill runs before it. The kernel reads no
// host value and allocates nothing.
//
// Bound on an H100: bytes (one add per value read). Each value is read once
// through the gather `perm`, and each output lane written once; the offsets
// and the permutation add 8 bytes a segment and 8 a row. Loads of one thread
// walk one row's C lanes; the camera segments of the CG BA (about 1,440 rows
// each) take ceil(len / 32) steps a thread, the point segments one or two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;

template <int CMAX>
__global__ void seg_sum_kernel(const float* __restrict__ values,
                               long long stride_row, long long stride_lane,
                               const long long* __restrict__ perm,
                               const long long* __restrict__ off,
                               float* __restrict__ out, long long n_seg,
                               int lanes) {
  const long long s =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int t = threadIdx.x % kWarp;
  if (s >= n_seg) return;  // the whole warp leaves together
  const long long begin = __ldg(off + s), end = __ldg(off + s + 1);
  const long long len = end - begin;
  float* row = out + s * lanes;
  if (len == 0) {
    for (int c = t; c < lanes; c += kWarp) row[c] = 0.0f;
    return;
  }
  const long long chunk = (len + kWarp - 1) / kWarp;
  const int n_chunks = (int)((len + chunk - 1) / chunk);

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.0f;
  const long long k0 = begin + t * chunk;
  const long long k1 = min(k0 + chunk, end);
  for (long long k = k0; k < k1; ++k) {
    const float* src = values + __ldg(perm + k) * stride_row;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < lanes) acc[c] = __fadd_rn(acc[c], __ldg(src + c * stride_lane));
    }
  }

#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < lanes) {
      float total = 0.0f;
      for (int j = 0; j < n_chunks; ++j) {
        total = __fadd_rn(total, __shfl_sync(kFullMask, acc[c], j));
      }
      if (t == c % kWarp) row[c] = total;
    }
  }
}

template <int CMAX>
cudaError_t launch(const void* values, long long stride_row,
                   long long stride_lane, const void* perm, const void* off,
                   void* out, long long n_seg, int lanes,
                   cudaStream_t stream) {
  const long long warps_per_block = kThreads / kWarp;
  const long long blocks = (n_seg + warps_per_block - 1) / warps_per_block;
  seg_sum_kernel<CMAX><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)values, stride_row, stride_lane, (const long long*)perm,
      (const long long*)off, (float*)out, n_seg, lanes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int seg_sum_launch(const void* values, long long stride_row,
                              long long stride_lane, const void* perm,
                              const void* off, void* out, long long n_seg,
                              int lanes, void* stream) {
  if (n_seg <= 0) return (int)cudaGetLastError();
  if (lanes < 1 || lanes > 49) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the smallest register budget that holds the lanes: the BA's 3, 6, 9,
  // 18 and 36 lanes, the pose graph's 7 and 49
  if (lanes <= 1) return (int)launch<1>(values, stride_row, stride_lane,
                                        perm, off, out, n_seg, lanes, st);
  if (lanes <= 3) return (int)launch<3>(values, stride_row, stride_lane,
                                        perm, off, out, n_seg, lanes, st);
  if (lanes <= 6) return (int)launch<6>(values, stride_row, stride_lane,
                                        perm, off, out, n_seg, lanes, st);
  if (lanes <= 9) return (int)launch<9>(values, stride_row, stride_lane,
                                        perm, off, out, n_seg, lanes, st);
  if (lanes <= 18) return (int)launch<18>(values, stride_row, stride_lane,
                                          perm, off, out, n_seg, lanes, st);
  if (lanes <= 36) return (int)launch<36>(values, stride_row, stride_lane,
                                          perm, off, out, n_seg, lanes, st);
  return (int)launch<49>(values, stride_row, stride_lane, perm, off, out,
                         n_seg, lanes, st);
}
