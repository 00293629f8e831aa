// Kernel D: FAST-9/16 detection with per-cell threshold fallback, 3x3 NMS,
// border keep-out, per-cell top-4 and quadratic subpixel offsets.
//
// Replaces cubemapslam_tpu/features/extractor.py::_detect_kernel (one Pallas
// pass per 32-row slab with lane-group scans for the per-cell reductions).
// This kernel computes what the JAX package's CPU path computes, exactly:
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
// at a cell's edge:
//   pass 1, one block per cell: FAST strength of each pixel, written to a
//           scratch map, and the cell's any-strong flag (__syncthreads_or);
//   pass 2, one block per cell: the merged map over the cell plus a one-pixel
//           halo (using the neighbours' flags) in shared memory, NMS and
//           border mask, four rounds of a block-wide arg-max on a 64-bit key
//           (value bits, then the complement of the in-cell index), and the
//           subpixel offsets of the four winners.
//
// Bound on an H100: operations. Each pixel costs 16 differences and two
// doubling chains of min/max (about 175 float operations) against 8 bytes of
// device-memory traffic, far above the card's operations-per-byte balance
// for float32 outside the tensor cores. Neighbour reads hit L1/L2 (the
// 16-tap circle of a warp's 32 pixels spans 7 rows of 38 floats). The
// design keeps the arithmetic in registers and fully unrolled; the per-cell
// selection works in shared memory and never writes the merged map out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerCell = 4;
constexpr int kEdgeBorder = 19;

__constant__ int c_circle_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                    0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_circle_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                    3, 3, 2, 1, 0, -1, -2, -3};

// max over the 16 circular 9-runs of the run's minimum (doubling chain)
__device__ __forceinline__ float run9(const float (&d)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m2[i] = fminf(d[i], d[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i] = fminf(m2[i], m2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m8[i] = fminf(m4[i], m4[(i + 4) & 15]);
  float v = fminf(m8[0], d[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) v = fmaxf(v, fminf(m8[i], d[(i + 8) & 15]));
  return v;
}

__device__ __forceinline__ float fast_strength(const float* __restrict__ img,
                                               int y, int x, int H, int W) {
  const float c = __ldg(img + (size_t)y * W + x);
  float dp[16], dn[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int yy = y + c_circle_dy[i];
    int xx = x + c_circle_dx[i];
    yy = yy < 0 ? yy + H : (yy >= H ? yy - H : yy);
    xx = xx < 0 ? xx + W : (xx >= W ? xx - W : xx);
    const float d = __ldg(img + (size_t)yy * W + xx) - c;
    dp[i] = d;
    dn[i] = -d;
  }
  return fmaxf(run9(dp), run9(dn));
}

__global__ void fast_strength_kernel(const float* __restrict__ img,
                                     float* __restrict__ strength,
                                     int* __restrict__ flags,
                                     int H, int W, int cell, float ini_th) {
  const int cx = blockIdx.x, cy = blockIdx.y;
  const int n = cell * cell;
  int strong = 0;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = cy * cell + p / cell;
    const int x = cx * cell + p % cell;
    if (y < H && x < W) {
      const float s = fast_strength(img, y, x, H, W);
      strength[(size_t)y * W + x] = s;
      strong |= (s > ini_th);
    }
  }
  strong = __syncthreads_or(strong);
  if (threadIdx.x == 0) flags[cy * gridDim.x + cx] = strong ? 1 : 0;
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

__global__ void detect_select_kernel(const float* __restrict__ strength,
                                     const int* __restrict__ flags,
                                     float* __restrict__ out_resp,
                                     int* __restrict__ out_y,
                                     int* __restrict__ out_x,
                                     float* __restrict__ out_dy,
                                     float* __restrict__ out_dx,
                                     int H, int W, int cell,
                                     float ini_th, float min_th) {
  extern __shared__ float smem[];
  const int T = cell + 2;             // merged tile with a 1-pixel halo
  float* tile = smem;                 // T*T; -inf outside the image
  float* vals = smem + T * T;         // cell*cell NMS'd, border-masked scores
  __shared__ unsigned long long warp_best[kThreads / 32];
  __shared__ unsigned long long best;

  const int cx = blockIdx.x, cy = blockIdx.y;
  const int Wc = gridDim.x;
  const int y0 = cy * cell, x0 = cx * cell;
  const float NEG_INF = -__int_as_float(0x7f800000);

  for (int p = threadIdx.x; p < T * T; p += blockDim.x) {
    const int y = y0 - 1 + p / T;
    const int x = x0 - 1 + p % T;
    float m = NEG_INF;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float s = __ldg(strength + (size_t)y * W + x);
      const float th = __ldg(flags + (y / cell) * Wc + (x / cell))
                           ? ini_th : min_th;
      m = s > th ? s : 0.0f;
    }
    tile[p] = m;
  }
  __syncthreads();

  const int n = cell * cell;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int py = p / cell, px = p % cell;
    const int y = y0 + py, x = x0 + px;
    float v = 0.0f;
    if (y < H && x < W) {
      const float c = tile[(py + 1) * T + px + 1];
      float nmax = c;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          nmax = fmaxf(nmax, tile[(py + dy) * T + px + dx]);
      const bool inb = y >= kEdgeBorder && y < H - kEdgeBorder &&
                       x >= kEdgeBorder && x < W - kEdgeBorder;
      v = (c >= nmax && inb) ? c : 0.0f;
    }
    vals[p] = v;
  }
  __syncthreads();

  const int cell_id = cy * Wc + cx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < kPerCell; ++r) {
    // key: value bits (all values >= 0, so the bits order like the floats),
    // then the complement of the index, so ties go to the lower index;
    // values already taken are marked -1 and lose to every other entry
    unsigned long long key = 0ull;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const float v = vals[p];
      if (v >= 0.0f) {
        const unsigned long long k =
            ((unsigned long long)__float_as_uint(v) << 32) |
            (unsigned long long)(0xffffffffu - (unsigned)p);
        key = k > key ? k : key;
      }
    }
    key = warp_max_u64(key);
    if (lane == 0) warp_best[warp] = key;
    __syncthreads();
    if (warp == 0) {
      key = lane < (int)(blockDim.x >> 5) ? warp_best[lane] : 0ull;
      key = warp_max_u64(key);
      if (lane == 0) best = key;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int p = (int)(0xffffffffu - (unsigned)(best & 0xffffffffull));
      const float v = vals[p];
      const int py = p / cell, px = p % cell;
      // pre-NMS merged map around the winner; outside the image reads 0
      const int ci = (py + 1) * T + px + 1;
      const float c = fmaxf(tile[ci], 0.0f);
      const float xm = fmaxf(tile[ci - 1], 0.0f);
      const float xp = fmaxf(tile[ci + 1], 0.0f);
      const float ym = fmaxf(tile[ci - T], 0.0f);
      const float yp = fmaxf(tile[ci + T], 0.0f);
      const float denx = 2.0f * c - xm - xp;
      const float deny = 2.0f * c - ym - yp;
      float sx = fabsf(denx) > 1e-6f ? 0.5f * (xp - xm) / fmaxf(denx, 1e-6f)
                                     : 0.0f;
      float sy = fabsf(deny) > 1e-6f ? 0.5f * (yp - ym) / fmaxf(deny, 1e-6f)
                                     : 0.0f;
      sx = fminf(fmaxf(sx, -0.5f), 0.5f);
      sy = fminf(fmaxf(sy, -0.5f), 0.5f);
      const int o = cell_id * kPerCell + r;
      out_resp[o] = v;
      out_y[o] = y0 + py;
      out_x[o] = x0 + px;
      out_dy[o] = sy;
      out_dx[o] = sx;
      vals[p] = -1.0f;
    }
    __syncthreads();
  }
}

}  // namespace

// One C entry per __global__ kernel, so that each launch is counted.
extern "C" int fast_strength_launch(const void* img, void* strength,
                                    void* flags, int H, int W, int cell,
                                    float ini_th, void* stream) {
  const dim3 grid((W + cell - 1) / cell, (H + cell - 1) / cell);
  fast_strength_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)strength, (int*)flags, H, W, cell, ini_th);
  return (int)cudaGetLastError();
}

extern "C" int detect_select_launch(const void* strength, const void* flags,
                                    void* out_resp, void* out_y, void* out_x,
                                    void* out_dy, void* out_dx, int H, int W,
                                    int cell, float ini_th, float min_th,
                                    void* stream) {
  const dim3 grid((W + cell - 1) / cell, (H + cell - 1) / cell);
  const size_t smem = sizeof(float) *
                      ((size_t)(cell + 2) * (cell + 2) + (size_t)cell * cell);
  detect_select_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)strength, (const int*)flags, (float*)out_resp,
      (int*)out_y, (int*)out_x, (float*)out_dy, (float*)out_dx, H, W, cell,
      ini_th, min_th);
  return (int)cudaGetLastError();
}
