// Kernel D: FAST-9/16 detection with per-cell threshold fallback, 3x3 NMS,
// border keep-out, per-cell top-4 and quadratic subpixel offsets, for every
// level of the pyramid in one launch of each pass.
//
// Replaces cubemapslam_tpu/features/extractor.py::_detect_kernel (one Pallas
// pass per 32-row slab and level, with lane-group scans for the per-cell
// reductions). This kernel computes what the JAX package's CPU path computes,
// exactly:
//   * FAST neighbours wrap around the image (the CPU path rolls the image),
//     and the per-cell fallback looks at the unmasked strong map, so wrapped
//     corners count;
//   * cells are anchored at (0,0); pixels past the image edge are zero;
//   * 3x3 NMS keeps score >= max of its in-image neighbourhood, and the
//     EDGE_BORDER mask comes after NMS;
//   * the per-cell top-4 takes the row-major in-cell order and breaks ties
//     to the lower index (as lax.top_k does);
//   * the subpixel parabola is taken on the pre-NMS merged map, zero outside
//     the image, with IEEE division (no fast math).
//
// Two launches, because the fallback of a neighbouring cell decides the NMS
// at a cell's edge. Each enumerates the (level, cell) pairs of all levels;
// the levels' pointers, shapes and first cells reach it by value (Levels),
// filled by the C entry from host arrays, so a launch needs no copy to the
// device. The cell size is a template parameter (16 or 32), so no index
// needs a runtime division.
//   pass 1, one block per cell: the cell's tile plus a 3-px halo is loaded
//           into shared memory once, by asynchronous copies (cp.async), with
//           the wrap-around applied at load time. An exact test on the four
//           compass points finds the pixels whose strength may exceed the
//           lower threshold; only those, compacted into a list so that whole
//           warps work, run the 16-tap FAST runs from shared memory at
//           compile-time offsets. The others can only merge to 0 and store
//           -inf. The strength goes to a scratch map, and the cell's
//           any-strong flag comes from __syncthreads_or.
//   pass 2, one warp per cell, eight cells a block: the merged map over the
//           cell plus a one-pixel halo in the warp's shared tile (the
//           strengths by asynchronous copies, then merged in place with the
//           thresholds of the 3x3 cells around); each lane keeps a sorted
//           top-4 of a 64-bit key (value bits, then the complement of the
//           in-cell index) over its pixels after NMS and the border mask;
//           four rounds of a warp-shuffle arg-max merge the lanes' lists;
//           lanes 0-3 compute the four subpixel offsets. No __syncthreads.
//
// Bound on an H100: operations for a frame whose every pixel passes the
// compass test (two runs of 57 exact min/max each, against 4 bytes read a
// pixel), bytes for a frame where few do (the cubemap cross's empty
// quadrants and the dark outside of the fisheye never pass). The design
// keeps the arithmetic in registers, reads the taps from shared memory,
// skips the runs where the compass test allows it, and never writes the
// merged map out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kPerCell = 4;
constexpr int kEdgeBorder = 19;
constexpr int kFastThreads = 256;
constexpr int kSelectWarps = 8;

struct Levels {
  const float* img[kMaxLevels];
  long long pix0[kMaxLevels];   // first pixel of the level in the scratch map
  int H[kMaxLevels];
  int W[kMaxLevels];
  int Wc[kMaxLevels];           // cells per row
  int cell0[kMaxLevels + 1];    // first cell of each level; cell0[n] = total
  int n;
};

__device__ __forceinline__ int level_of(const Levels& lv, int g) {
  int l = 0;
  while (l + 1 < lv.n && g >= lv.cell0[l + 1]) ++l;
  return l;
}

// The arcs of FAST-9/16 over the 16 circle pixels p: with kMin, the max
// over the 16 circular 9-runs of the run's minimum; otherwise the min over
// them of the run's maximum. Van Herk blocks of 9 over the circle extended to
// 24 pixels (q[j] = p[j mod 16]): suffix runs of q[0..8] and q[9..17],
// prefix runs of q[9..16] and q[18..23], then run i = block suffix from i
// joined with the next block's prefix up to i+8. 42 + 15 operations, each
// an exact min or max.
template <bool kMin>
__device__ __forceinline__ float in_run(float a, float b) {
  return kMin ? fminf(a, b) : fmaxf(a, b);
}

template <bool kMin>
__device__ __forceinline__ float arc9(const float (&p)[16]) {
  float suf0[9], pre1[8], suf1[9], pre2[6];
  suf0[8] = p[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) suf0[i] = in_run<kMin>(p[i], suf0[i + 1]);
  pre1[0] = p[9];                                   // q[9..16]
#pragma unroll
  for (int j = 10; j <= 16; ++j)
    pre1[j - 9] = in_run<kMin>(pre1[j - 10], p[j & 15]);
  suf1[8] = p[1];                                   // q[9..17]
#pragma unroll
  for (int i = 16; i >= 9; --i)
    suf1[i - 9] = in_run<kMin>(p[i & 15], suf1[i - 8]);
  pre2[0] = p[2];                                   // q[18..23]
#pragma unroll
  for (int j = 19; j <= 23; ++j)
    pre2[j - 18] = in_run<kMin>(pre2[j - 19], p[j - 16]);
  float v = suf0[0];
#pragma unroll
  for (int i = 1; i <= 8; ++i)
    v = in_run<!kMin>(v, in_run<kMin>(suf0[i], pre1[i - 1]));
  v = in_run<!kMin>(v, suf1[0]);
#pragma unroll
  for (int i = 10; i <= 15; ++i)
    v = in_run<!kMin>(v, in_run<kMin>(suf1[i - 9], pre2[i - 10]));
  return v;
}

// FAST strength of the pixel at t (a pointer into a tile of row pitch T):
// the largest threshold at which 9 contiguous circle pixels are all
// brighter or all darker. The plain version takes the runs over the
// differences d = p - c; rounding p - c is monotone in p, so the run of the
// differences is the difference of the run, bit for bit, and two
// subtractions replace sixteen.
template <int T>
__device__ __forceinline__ float fast_strength(const float* t) {
  float p[16];
#define FAST_TAP(i, dx, dy) p[i] = t[(dy) * T + (dx)];
  // radius-3 Bresenham circle in circular order (dx, dy)
  FAST_TAP(0, 0, -3) FAST_TAP(1, 1, -3) FAST_TAP(2, 2, -2) FAST_TAP(3, 3, -1)
  FAST_TAP(4, 3, 0) FAST_TAP(5, 3, 1) FAST_TAP(6, 2, 2) FAST_TAP(7, 1, 3)
  FAST_TAP(8, 0, 3) FAST_TAP(9, -1, 3) FAST_TAP(10, -2, 2)
  FAST_TAP(11, -3, 1) FAST_TAP(12, -3, 0) FAST_TAP(13, -3, -1)
  FAST_TAP(14, -2, -2) FAST_TAP(15, -1, -3)
#undef FAST_TAP
  const float c = t[0];
  return fmaxf(arc9<true>(p) - c, c - arc9<false>(p));
}

// Whether the FAST strength of the pixel at t can exceed th (>= 0). Every
// run of 9 of the 16 circle pixels holds two neighbouring compass points
// (circle positions 0, 4, 8, 12), so without such a pair both brighter than
// c + th or both darker than c - th, the strength is at most th. On the
// 4-cycle of compass points, some neighbouring pair is brighter exactly when
// one of {0, 8} and one of {4, 12} are: min(max(d0, d8), max(d4, d12)) > th;
// likewise darker. The differences are those of the plain version, so the
// test is exact.
template <int T>
__device__ __forceinline__ bool may_exceed(const float* t, float th) {
  const float c = t[0];
  const float d0 = t[-3 * T] - c, d4 = t[3] - c, d8 = t[3 * T] - c,
              d12 = t[-3] - c;
  return fminf(fmaxf(d0, d8), fmaxf(d4, d12)) > th ||
         fmaxf(fminf(d0, d8), fminf(d4, d12)) < -th;
}

// Asynchronous 4-byte copy from device memory to shared memory (cp.async):
// every load of a tile is in flight at once, without holding registers.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

template <int CELL>
__global__ void __launch_bounds__(kFastThreads)
fast_levels_kernel(const __grid_constant__ Levels lv,
                   float* __restrict__ strength, int* __restrict__ flags,
                   float ini_th, float lo_th) {
  static_assert((CELL * CELL) % kFastThreads == 0, "whole warps per cell");
  constexpr int T = CELL + 6;
  __shared__ float tile[T * T];
  __shared__ unsigned short cand[CELL * CELL];
  __shared__ int n_cand;
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int l = level_of(lv, g);
  const int c = g - lv.cell0[l];
  const int H = lv.H[l], W = lv.W[l];
  const int cy = c / lv.Wc[l], cx = c - cy * lv.Wc[l];
  const int y0 = cy * CELL, x0 = cx * CELL;
  const float* __restrict__ img = lv.img[l];
  const float NEG_INF = -__int_as_float(0x7f800000);
  if (threadIdx.x == 0) n_cand = 0;

  // every in-image pixel reads rows/cols in [-3, H+2]: one wrap suffices;
  // the clamp only keeps the unused tail of an edge cell inside the image
  for (int e = threadIdx.x; e < T * T; e += kFastThreads) {
    const int i = e / T, j = e - (e / T) * T;
    int y = y0 - 3 + i, x = x0 - 3 + j;
    y = y < 0 ? y + H : (y >= H ? y - H : y);
    x = x < 0 ? x + W : (x >= W ? x - W : x);
    y = min(max(y, 0), H - 1);
    x = min(max(x, 0), W - 1);
    copy_async(tile + e, img + (size_t)y * W + x);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // pixels whose strength cannot exceed the lower threshold merge to 0
  // whichever threshold their cell takes: they store -inf; the others are
  // compacted into a list, so that the runs are computed by full warps
  float* __restrict__ out = strength + lv.pix0[l];
#pragma unroll
  for (int p0 = 0; p0 < CELL * CELL; p0 += kFastThreads) {
    const int p = p0 + threadIdx.x;
    const int y = y0 + p / CELL, x = x0 + p % CELL;
    bool pass = false;
    if (y < H && x < W) {
      pass = may_exceed<T>(tile + (p / CELL + 3) * T + p % CELL + 3, lo_th);
      if (!pass) out[(size_t)y * W + x] = NEG_INF;
    }
    const unsigned m = __ballot_sync(0xffffffffu, pass);
    if (m != 0u) {
      const int leader = __ffs(m) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&n_cand, __popc(m));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (pass)
        cand[base + __popc(m & ((1u << lane) - 1u))] = (unsigned short)p;
    }
  }
  __syncthreads();

  int strong = 0;
  const int n = n_cand;
  for (int i = threadIdx.x; i < n; i += kFastThreads) {
    const int p = cand[i];
    const int py = p / CELL, px = p % CELL;
    const float s = fast_strength<T>(tile + (py + 3) * T + px + 3);
    out[(size_t)(y0 + py) * W + x0 + px] = s;
    strong |= (s > ini_th);
  }
  strong = __syncthreads_or(strong);
  if (threadIdx.x == 0) flags[g] = strong ? 1 : 0;
}

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

template <int CELL>
__global__ void __launch_bounds__(kSelectWarps * 32)
select_levels_kernel(const __grid_constant__ Levels lv,
                     const float* __restrict__ strength,
                     const int* __restrict__ flags, float ini_th,
                     float min_th, float* __restrict__ out_resp,
                     int* __restrict__ out_y, int* __restrict__ out_x,
                     float* __restrict__ out_dy, float* __restrict__ out_dx) {
  constexpr int T = CELL + 2;           // merged tile with a 1-pixel halo
  __shared__ float tiles[kSelectWarps][T * T];
  __shared__ float ths[kSelectWarps][9];   // thresholds of the 3x3 cells
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kSelectWarps + warp;
  if (g >= lv.cell0[lv.n]) return;      // the whole warp leaves together
  const int l = level_of(lv, g);
  const int c = g - lv.cell0[l];
  const int H = lv.H[l], W = lv.W[l], Wc = lv.Wc[l];
  const int cy = c / Wc, cx = c - cy * Wc;
  const int y0 = cy * CELL, x0 = cx * CELL;
  const float* __restrict__ str = strength + lv.pix0[l];
  const int* __restrict__ fl = flags + lv.cell0[l];
  float* tile = tiles[warp];

  // the strength tile by asynchronous copies, while lanes 0-8 read the
  // thresholds of the 3x3 cells around this one; then the merge in place
  for (int e = lane; e < T * T; e += 32) {
    const int i = e / T, j = e - (e / T) * T;
    const int y = y0 - 1 + i, x = x0 - 1 + j;
    if (y >= 0 && y < H && x >= 0 && x < W)
      copy_async(tile + e, str + (size_t)y * W + x);
    else
      tile[e] = 0.0f;
  }
  if (lane < 9) {
    const int ny = cy - 1 + lane / 3, nx = cx - 1 + lane % 3;
    const bool in = ny >= 0 && nx >= 0 && ny * CELL < H && nx < Wc;
    ths[warp][lane] = in && __ldg(fl + ny * Wc + nx) ? ini_th : min_th;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();
  // outside the image the tile holds 0 where the plain NMS pads with -inf:
  // NMS compares only values > 0 with it, and the subpixel parabola reads
  // the zero-padded map
  for (int e = lane; e < T * T; e += 32) {
    const int i = e / T, j = e - (e / T) * T;
    const float th = ths[warp][(i == 0 ? 0 : (i <= CELL ? 3 : 6)) +
                               (j == 0 ? 0 : (j <= CELL ? 1 : 2))];
    const float s = tile[e];
    tile[e] = s > th ? s : 0.0f;
  }
  __syncwarp();

  // key: value bits (all values >= 0, so the bits order like the floats),
  // then the complement of the index, so ties go to the lower index; 0 is
  // below every real key. k0 > k1 > k2 > k3.
  unsigned long long k0 = 0ull, k1 = 0ull, k2 = 0ull, k3 = 0ull;
#pragma unroll 4
  for (int p = lane; p < CELL * CELL; p += 32) {
    const int py = p / CELL, px = p % CELL;
    const int y = y0 + py, x = x0 + px;
    float v = 0.0f;                   // a merged 0 stays 0 through NMS
    const float* t = tile + (py + 1) * T + px + 1;
    if (y < H && x < W && t[0] > 0.0f) {
      const float cv = t[0];
      float nmax = cv;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) nmax = fmaxf(nmax, t[dy * T + dx]);
      const bool inb = y >= kEdgeBorder && y < H - kEdgeBorder &&
                       x >= kEdgeBorder && x < W - kEdgeBorder;
      v = (cv >= nmax && inb) ? cv : 0.0f;
    }
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(v) << 32) |
        (unsigned long long)(0xffffffffu - (unsigned)p);
    if (key > k3) {
      if (key > k2) {
        k3 = k2;
        if (key > k1) {
          k2 = k1;
          if (key > k0) {
            k1 = k0;
            k0 = key;
          } else {
            k1 = key;
          }
        } else {
          k2 = key;
        }
      } else {
        k3 = key;
      }
    }
  }

  // merge: each round takes the largest head; keys are unique, so exactly
  // one lane pops its list. Lane r keeps the r-th winner.
  unsigned long long mine = 0ull;
#pragma unroll
  for (int r = 0; r < kPerCell; ++r) {
    const unsigned long long best = warp_max_u64(k0);
    if (lane == r) mine = best;
    if (k0 == best) {
      k0 = k1;
      k1 = k2;
      k2 = k3;
      k3 = 0ull;
    }
  }

  if (lane < kPerCell) {
    const int p = (int)(0xffffffffu - (unsigned)(mine & 0xffffffffull));
    const float v = __uint_as_float((unsigned)(mine >> 32));
    const int py = p / CELL, px = p % CELL;
    // pre-NMS merged map around the winner; outside the image reads 0
    const int ci = (py + 1) * T + px + 1;
    const float cv = fmaxf(tile[ci], 0.0f);
    const float xm = fmaxf(tile[ci - 1], 0.0f);
    const float xp = fmaxf(tile[ci + 1], 0.0f);
    const float ym = fmaxf(tile[ci - T], 0.0f);
    const float yp = fmaxf(tile[ci + T], 0.0f);
    const float denx = 2.0f * cv - xm - xp;
    const float deny = 2.0f * cv - ym - yp;
    float sx = fabsf(denx) > 1e-6f ? 0.5f * (xp - xm) / fmaxf(denx, 1e-6f)
                                   : 0.0f;
    float sy = fabsf(deny) > 1e-6f ? 0.5f * (yp - ym) / fmaxf(deny, 1e-6f)
                                   : 0.0f;
    sx = fminf(fmaxf(sx, -0.5f), 0.5f);
    sy = fminf(fmaxf(sy, -0.5f), 0.5f);
    const int o = g * kPerCell + lane;
    out_resp[o] = v;
    out_y[o] = y0 + py;
    out_x[o] = x0 + px;
    out_dy[o] = sy;
    out_dx[o] = sx;
  }
}

// The level table from host arrays; false if the levels do not fit it.
bool fill_levels(Levels* lv, int n, const long long* imgs, const int* H,
                 const int* W, int cell) {
  if (n < 1 || n > kMaxLevels) return false;
  long long pix = 0;
  int cells = 0;
  for (int l = 0; l < n; ++l) {
    if (H[l] < 3 || W[l] < 3) return false;
    lv->img[l] = (const float*)imgs[l];
    lv->H[l] = H[l];
    lv->W[l] = W[l];
    lv->Wc[l] = (W[l] + cell - 1) / cell;
    lv->pix0[l] = pix;
    lv->cell0[l] = cells;
    pix += (long long)H[l] * W[l];
    cells += lv->Wc[l] * ((H[l] + cell - 1) / cell);
  }
  lv->cell0[n] = cells;
  lv->n = n;
  return true;
}

}  // namespace

// One C entry per pass, so that each launch is counted. Each takes the
// levels as host arrays: device pointers, heights and widths.
// Thresholds must be >= 0 (the keys order the merged values by their bits).
extern "C" int orb_fast_launch(int n, const long long* imgs, const int* H,
                               const int* W, int cell, float ini_th,
                               float min_th, void* strength, void* flags,
                               void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n, imgs, H, W, cell) || !(ini_th >= 0.0f) ||
      !(min_th >= 0.0f))
    return (int)cudaErrorInvalidValue;
  const int grid = lv.cell0[n];
  const float lo_th = fminf(ini_th, min_th);
  cudaStream_t s = (cudaStream_t)stream;
  if (cell == 32) {
    fast_levels_kernel<32><<<grid, kFastThreads, 0, s>>>(
        lv, (float*)strength, (int*)flags, ini_th, lo_th);
  } else if (cell == 16) {
    fast_levels_kernel<16><<<grid, kFastThreads, 0, s>>>(
        lv, (float*)strength, (int*)flags, ini_th, lo_th);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int orb_select_launch(int n, const long long* imgs, const int* H,
                                 const int* W, int cell, float ini_th,
                                 float min_th, const void* strength,
                                 const void* flags, void* out_resp,
                                 void* out_y, void* out_x,
                                 void* out_dy, void* out_dx, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n, imgs, H, W, cell) || !(ini_th >= 0.0f) ||
      !(min_th >= 0.0f))
    return (int)cudaErrorInvalidValue;
  const int grid = (lv.cell0[n] + kSelectWarps - 1) / kSelectWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (cell == 32) {
    select_levels_kernel<32><<<grid, kSelectWarps * 32, 0, s>>>(
        lv, (const float*)strength, (const int*)flags, ini_th, min_th,
        (float*)out_resp, (int*)out_y, (int*)out_x, (float*)out_dy,
        (float*)out_dx);
  } else if (cell == 16) {
    select_levels_kernel<16><<<grid, kSelectWarps * 32, 0, s>>>(
        lv, (const float*)strength, (const int*)flags, ini_th, min_th,
        (float*)out_resp, (int*)out_y, (int*)out_x, (float*)out_dy,
        (float*)out_dx);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
