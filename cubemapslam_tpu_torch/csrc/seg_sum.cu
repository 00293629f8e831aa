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
// positions); its schedule lists the long segments (more than 32 rows) in
// segment order (`long_seg`, their count `long_count` on the device, at most
// `bound` = min(E / 33, n_seg), known on the host) with a counter each
// (`long_done`, 0 between launches). The order of additions:
//   - a segment of at most 32 rows adds its rows in index order from +0.0;
//   - a longer one is cut into 32 contiguous chunks of ceil(len / 32) rows,
//     each chunk summed row by row from 0.0, and the non-empty chunks' sums
//     added in chunk order from 0.0.
// Every add is rounded on its own (__fadd_rn), so the result depends on the
// plan only, and segment.segment_sum_ordered repeats it bitwise (the order
// of this kernel's earlier one-warp-a-segment form, unchanged). A segment of
// at most 32 rows is summed in the order of the CPU's index_add_.
//
// Bound on an H100: bytes. Each value is read once through `perm`, each
// output lane written once; the offsets add 8 bytes a segment. One launch,
// two block roles:
//   - the long role (the first min(32 bound, 512) blocks; the CG BA's camera
//     sums: 14 of 512 segments, 1,440-2,000 rows of 36 lanes): one block a
//     (long segment, chunk) item, walking count x 32 items, so no host value
//     is read and the work is spread over the card rather than over 14 SMs.
//     It stages the chunk's rows, gathered through `perm`, into shared
//     memory with cp.async in double-buffered tiles (all of a tile's loads in
//     flight together; no thread walks dependent gathered rows), thread c
//     adds lane c in row order and writes the chunk sum to a workspace. The
//     block that finishes a segment's last chunk (an atomic counter) adds the
//     chunk sums in chunk order and writes the row: the bits do not depend on
//     which block that is.
//   - the rows role (a block a tile of about 4,096 floats of out, fewer
//     where the tiles would not fill the card): the tile's offsets are read
//     once into shared memory; a tile without a row is stored as zeros at
//     once (16-byte stores; most of the local BA's coupling, 393,216
//     segments for 61,440 rows, and of the pose graph's normal matrix,
//     262,144 for 1,200); else its short rows are staged (a block prefix sum
//     places them; their ids, then their lanes, each thread gathering 8 at a
//     time) and each thread adds the rows of 4 neighbouring floats from
//     shared memory, writing them as one 16-byte store. It skips the long
//     segments.
// Each output row is written once. Neither role reads a host value or
// allocates. The mostly empty shapes (the local BA's coupling, the pose
// graph) stay above their store bound and above index_add_'s blind fill
// and atomic adds; storing a tile's empty floats before staging its rows
// made every shape slower, so a tile with rows stores its floats once it
// has summed them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;           // rows of a short segment, chunks of a
                                    // long one
constexpr int kThreads = 256;       // a block of either role
constexpr int kMinBlocks = 6;       // resident a SM: 40 registers a thread
constexpr int kLongBlocks = 512;    // at most, walking count x 32 items
constexpr int kTile = 4096;         // floats of a staged chunk tile (16 KB)
constexpr int kOutFloats = 4096;    // floats of out a rows block writes
constexpr int kStageFloats = 4096;  // floats of staged rows a rows block
constexpr int kMaxTileSegs = 4 * kThreads;  // segments a rows block covers
constexpr int kStageRows = 1024;    // short rows a rows block stages
constexpr int kBatch = 8;           // gathers in flight a thread

// Exact unsigned division by a runtime divisor d (1..2^31) for any 32-bit
// numerator: q = (t + ((n - t) >> sh1)) >> sh2 with t = mulhi(m, n)
// (Granlund and Montgomery, "Division by invariant integers using
// multiplication", 1994, figure 4.1).
struct Divisor {
  unsigned m, sh1, sh2;
};

Divisor make_divisor(unsigned d) {
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return Divisor{(unsigned)m, l < 1 ? l : 1u, l > 1 ? l - 1 : 0u};
}

__device__ __forceinline__ unsigned divide(unsigned n, Divisor d) {
  const unsigned t = __umulhi(d.m, n);
  return (t + ((n - t) >> d.sh1)) >> d.sh2;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float* values;
  long long stride_row, stride_lane;
  const long long* perm;
  const long long* off;
  const long long* long_seg;
  const long long* long_count;
  int* long_done;       // a counter a long segment, 0 between launches
  float* partial;       // bound x 32 x lanes chunk sums
  float* out;
  long long n_seg;
  int lanes;
  int tile_segs;        // segments a rows block covers, a multiple of 4
  int long_blocks;      // blocks of the long role, before the rows blocks
  Divisor by_lanes;
};

struct LongSmem {
  float tile[2][kTile];
  int last;
};

struct RowsSmem {
  long long off[kMaxTileSegs + 1];  // the tile's offsets
  int start[kMaxTileSegs + 1];      // where each short segment's rows are
                                    // staged (a prefix sum of their lengths)
  short seg_of[kStageRows];         // the tile segment of a staged row
  int row[kStageRows];              // the row of `values` it is
  float val[kStageFloats];          // the staged rows' lanes
  int warp_sum[kThreads / kWarp];
};

union Smem {
  LongSmem l;
  RowsSmem r;
};

// Stage `rows` rows of `lanes` floats, the rows listed at `pt`, into `dst`
// (row-major) with one cp.async a float, as one commit group.
__device__ __forceinline__ void stage_tile(float* dst,
                                           const long long* __restrict__ pt,
                                           long long rows, const Args& a) {
  const int n = (int)rows * a.lanes;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / a.lanes, c = e - r * a.lanes;
    cp_async4(dst + e, a.values + __ldg(pt + r) * a.stride_row +
                           c * a.stride_lane);
  }
  cp_async_commit();
}

// The long role: block b sums the items w = b, b + long_blocks, ... below
// count x 32, item w being chunk w % 32 of long segment w / 32. The chunk's
// rows are staged into shared memory in double-buffered tiles, thread c
// adds lane c's rows in row order from 0.0 and writes the chunk sum to
// `partial`. The block that finishes a segment's last non-empty chunk adds
// its chunk sums in chunk order from 0.0, writes the segment's output row
// and sets its counter back to 0.
__device__ void long_role(const Args& a, LongSmem& sm) {
  const int tid = threadIdx.x, lanes = a.lanes;
  const long long items = __ldg(a.long_count) * kWarp;
  const int tile_rows = kTile / lanes;
  for (long long w = blockIdx.x; w < items; w += a.long_blocks) {
    const long long i = w / kWarp;
    const int j = (int)(w % kWarp);
    const long long s = __ldg(a.long_seg + i);
    const long long begin = __ldg(a.off + s);
    const long long len = __ldg(a.off + s + 1) - begin;
    const long long chunk = (len + kWarp - 1) / kWarp;
    const int n_chunks = (int)((len + chunk - 1) / chunk);
    const long long r0 = j * chunk, r1 = min(r0 + chunk, len);
    if (r0 >= r1) continue;  // an empty chunk
    const long long rows = r1 - r0;
    const int n_tiles = (int)((rows + tile_rows - 1) / tile_rows);
    const long long* p = a.perm + begin + r0;

    float acc = 0.0f;
    stage_tile(sm.tile[0], p, min((long long)tile_rows, rows), a);
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) {
        const long long r = (long long)(t + 1) * tile_rows;
        stage_tile(sm.tile[(t + 1) & 1], p + r,
                   min((long long)tile_rows, rows - r), a);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (tid < lanes) {
        const int n = (int)min((long long)tile_rows,
                               rows - (long long)t * tile_rows);
        const float* src = sm.tile[t & 1] + tid;
        for (int r = 0; r < n; ++r) acc = __fadd_rn(acc, src[r * lanes]);
      }
      __syncthreads();  // the buffer is staged again two tiles on
    }
    float* part = a.partial + i * kWarp * lanes;
    if (tid < lanes) part[j * lanes + tid] = acc;
    __threadfence();
    __syncthreads();
    if (tid == 0)
      sm.last = atomicAdd(a.long_done + i, 1) == n_chunks - 1;
    __syncthreads();
    if (sm.last) {
      __threadfence();
      if (tid < lanes) {
        float total = 0.0f;
        for (int q = 0; q < n_chunks; ++q)
          total = __fadd_rn(total, __ldcg(part + q * lanes + tid));
        a.out[s * lanes + tid] = total;
      }
      if (tid == 0) a.long_done[i] = 0;
    }
    __syncthreads();  // sm.last is set again by the next item
  }
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// 4 floats of out at tile offset f, as one 16-byte store where all 4 are
// written and lie inside the tile, else one by one.
__device__ __forceinline__ void store4(float* out, int f, int n_out,
                                       const float (&v)[4],
                                       const bool (&skip)[4]) {
  if (f + 4 <= n_out && !(skip[0] || skip[1] || skip[2] || skip[3])) {
    *reinterpret_cast<float4*>(out + f) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (!skip[g] && f + g < n_out) out[f + g] = v[g];
  }
}

// A tile that holds rows, after its offsets: the short segments' staging
// places (a block prefix sum of their lengths, 4 segments a thread); the
// staged rows' ids read from `perm`, then their lanes, kBatch loads of a
// thread in flight together; then 4 neighbouring floats of out a thread at
// a time: zeros at once where their segments hold no row, else each
// float's rows added in index order from +0.0 from shared memory (or,
// beyond the staging room, from device memory), written as one 16-byte
// store. Long segments' floats are left to the long role.
__device__ void rows_tile(const Args& a, RowsSmem& sm, long long s_lo,
                          int n_here) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int lanes = a.lanes;
  int len[4], sum = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * tid + q;
    const int n = i < n_here ? (int)(sm.off[i + 1] - sm.off[i]) : 0;
    len[q] = n <= kWarp ? n : 0;
    sum += len[q];
  }
  const int incl = warp_inclusive_sum(sum);
  if (lane == kWarp - 1) sm.warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kThreads / kWarp ? sm.warp_sum[lane] : 0;
    v = warp_inclusive_sum(v);
    if (lane < kThreads / kWarp) sm.warp_sum[lane] = v;
  }
  __syncthreads();
  const int short_rows = sm.warp_sum[kThreads / kWarp - 1];
  const int staged = min(min(short_rows, kStageRows), kStageFloats / lanes);
  int at = (warp ? sm.warp_sum[warp - 1] : 0) + incl - sum;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * tid + q;
    if (i < n_here) sm.start[i] = at;
    for (int r = 0; r < len[q] && at + r < staged; ++r)
      sm.seg_of[at + r] = (short)i;
    at += len[q];
  }
  __syncthreads();

  for (int q = tid; q < staged; q += kThreads) {
    const int i = sm.seg_of[q];
    sm.row[q] = (int)__ldg(a.perm + sm.off[i] + (q - sm.start[i]));
  }
  __syncthreads();
  const int n_val = staged * lanes;
  for (int f0 = tid; f0 < n_val; f0 += kThreads * kBatch) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int f = f0 + u * kThreads;
      if (f < n_val) {
        const int q = (int)divide((unsigned)f, a.by_lanes);
        x[u] = __ldg(a.values + (long long)sm.row[q] * a.stride_row +
                     (f - q * lanes) * a.stride_lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int f = f0 + u * kThreads;
      if (f < n_val) sm.val[f] = x[u];
    }
  }
  __syncthreads();

  const int n_out = n_here * lanes;
  float* out = a.out + s_lo * lanes;
  for (int f = 4 * tid; f < n_out; f += 4 * kThreads) {
    int i = (int)divide((unsigned)f, a.by_lanes);
    int c = f - i * lanes;
    const int i3 = (int)divide((unsigned)min(f + 3, n_out - 1), a.by_lanes);
    if (sm.off[i] == sm.off[i3 + 1]) {  // no row in the 4 floats' segments
      if (f + 4 <= n_out) {
        *reinterpret_cast<float4*>(out + f) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        for (int g = f; g < n_out; ++g) out[g] = 0.0f;
      }
      continue;
    }
    float acc[4];
    bool skip[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      acc[g] = 0.0f;
      skip[g] = f + g >= n_out;
      if (!skip[g]) {
        const long long b = sm.off[i];
        const int n = (int)(sm.off[i + 1] - b);
        const int st = sm.start[i];
        if (n > kWarp) {
          skip[g] = true;  // the long role writes it
        } else if (st + n <= staged) {
          for (int r = 0; r < n; ++r)
            acc[g] = __fadd_rn(acc[g], sm.val[(st + r) * lanes + c]);
        } else {
          const float* src = a.values + c * a.stride_lane;
          for (int r0 = 0; r0 < n; r0 += kBatch) {
            float x[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              x[u] = r0 + u < n ? __ldg(src + __ldg(a.perm + b + r0 + u) *
                                                  a.stride_row)
                                : 0.0f;
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              if (r0 + u < n) acc[g] = __fadd_rn(acc[g], x[u]);
          }
        }
      }
      if (++c == lanes) {
        c = 0;
        ++i;
      }
    }
    store4(out, f, n_out, acc, skip);
  }
}

// The rows role: rows block r writes the output rows of the tile of
// segments [r * tile_segs, (r + 1) * tile_segs), all but the long ones.
// The tile's offsets are read once; a tile without a row is stored as
// zeros at once.
__device__ void rows_role(const Args& a, RowsSmem& sm, long long tile) {
  const long long s_lo = tile * a.tile_segs;
  const int n_here = (int)min((long long)a.tile_segs, a.n_seg - s_lo);
  for (int i = threadIdx.x; i <= n_here; i += kThreads)
    sm.off[i] = __ldg(a.off + s_lo + i);
  __syncthreads();
  if (sm.off[0] != sm.off[n_here]) {
    rows_tile(a, sm, s_lo, n_here);
    return;
  }
  const int n_out = n_here * a.lanes;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool none[4] = {false, false, false, false};
  for (int f = 4 * threadIdx.x; f < n_out; f += 4 * kThreads)
    store4(a.out + s_lo * a.lanes, f, n_out, zero, none);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    seg_sum_kernel(const Args a) {
  __shared__ Smem sm;
  if ((int)blockIdx.x < a.long_blocks) {
    long_role(a, sm.l);
  } else {
    rows_role(a, sm.r, (long long)blockIdx.x - a.long_blocks);
  }
}

// Segments a rows block covers: a multiple of 4 (so that its floats of out
// start 16-byte aligned), at most kMaxTileSegs and about kOutFloats / lanes;
// fewer where that would give fewer blocks than fill the card (`resident`:
// kMinBlocks a SM), or where the plan's rows (on average) would not fit the
// staging room.
long long tile_segs(long long n_seg, int lanes, long long n_rows,
                    long long resident) {
  long long s = kOutFloats / lanes;
  if (s > kMaxTileSegs) s = kMaxTileSegs;
  long long par = (n_seg + resident - 1) / resident;
  if (par < s) s = par;
  if (n_rows > 0) {
    const long long dense = kStageRows * n_seg / n_rows;
    if (dense < s) s = dense;
    const long long wide = (long long)kStageFloats * n_seg / (n_rows * lanes);
    if (wide < s) s = wide;
  }
  s = (s + 3) / 4 * 4;
  return s < 4 ? 4 : (s > kMaxTileSegs ? kMaxTileSegs : s);
}

}  // namespace

// out: n_seg x lanes floats, 16-byte aligned, n_seg * lanes < 2^31 and
// n_rows < 2^31;
// partial: bound x 32 x lanes floats and long_done: bound ints, all 0
// (unused when bound is 0), where bound is at most n_rows / 33 and at least
// long_count. One launch; a plan's launches are ordered on one stream.
extern "C" int seg_sum_launch(const void* values, long long stride_row,
                              long long stride_lane, const void* perm,
                              const void* off, const void* long_seg,
                              const void* long_count, void* long_done,
                              void* partial, void* out, long long n_seg,
                              int lanes, long long n_rows, long long bound,
                              void* stream) {
  if (n_seg <= 0) return (int)cudaGetLastError();
  if (lanes < 1 || lanes > 49 || n_seg * lanes >= (1ll << 31) ||
      n_rows >= (1ll << 31) || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.values = (const float*)values;
  a.stride_row = stride_row;
  a.stride_lane = stride_lane;
  a.perm = (const long long*)perm;
  a.off = (const long long*)off;
  a.long_seg = (const long long*)long_seg;
  a.long_count = (const long long*)long_count;
  a.long_done = (int*)long_done;
  a.partial = (float*)partial;
  a.out = (float*)out;
  a.n_seg = n_seg;
  a.lanes = lanes;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long segs =
      tile_segs(n_seg, lanes, n_rows, (long long)sms * kMinBlocks);
  a.tile_segs = (int)segs;
  a.long_blocks = (int)min(bound * kWarp, (long long)kLongBlocks);
  a.by_lanes = make_divisor((unsigned)lanes);
  const long long blocks = a.long_blocks + (n_seg + segs - 1) / segs;
  seg_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
