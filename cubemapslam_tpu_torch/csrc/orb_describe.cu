// The describe kernel: per keypoint, the 43x43 window gather, the
// intensity-centroid angle and the 256-bit blur-folded rBRIEF of the chosen
// rotation bin, for the keypoints of every level in one launch.
//
// Replaces cubemapslam_tpu/features/extractor.py::_gather_kernel (16 aligned
// (56,256) DMA windows in flight per program, then two modular rolls to crop,
// because Mosaic DMAs must start on an (8,128) tile; its prototype is
// scripts/proto_gather_kernel.py::kernel) together with what the JAX package
// does after it, _angle_and_desc: one MXU product of the bf16 raw patches with
// the dense (2304, 32*256+2) descriptor+moment operator, which scores all 32
// rotation bins and then keeps one. Per keypoint, one block of 256 threads:
//   1. gather: the window around the integer keypoint, clamped into the image
//      first, with every index clamped into the level (edge replicate), each
//      value rounded to bf16 (nearest even) as the product's operand is, into
//      shared memory;
//   2. moments: m10 and m01 over the radius-15 disc with the operator's
//      integer moment weights, summed in double (each product of a bf16 value
//      and a small integer is exact), rounded once to float; then the angle
//      atan2(m01, m10) and the bin round(angle * 32 / 2pi) mod 32;
//   3. descriptor: thread b sums bit b's comparison score of that bin only,
//      from a sparse table of the operator: for each (bin, bit), its non-zero
//      entries as (bf16 coefficient bits << 16 | offset in the 43x43 window),
//      padded with zero words to the largest count. The coefficients are the
//      operator's bf16-rounded entries themselves (overlapping blur
//      footprints of a pair were summed before the rounding);
//   4. the 8 descriptor words by warp ballot (bit j of word w = bit 32w+j).
// It sums in another order than the dense float32 product, so a score within
// rounding of 0 may flip its bit, and an angle at a bin's rounding edge may
// change its bin.
//
// Bound on an H100: bytes. Per keypoint it reads at most 43*43 floats of its
// level and one bin's table rows (about 100 KB, shared by all keypoints of
// that bin and served from L2), and does about 256 x 98 multiply-adds: about
// 50 MFLOP for 2000 keypoints, against 75 GFLOP for the dense product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;   // one thread per descriptor bit
constexpr int kWin = 43;        // window side: 2 * (18 + 3) + 1
constexpr int kWinR = 21;
constexpr int kOriR = 15;
constexpr int kRot = 32;
constexpr int kBits = 256;
constexpr float kBinScale = (float)(32.0 / (2.0 * 3.14159265358979323846));

struct Levels {
  const float* img[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  int first[kMaxLevels + 1];    // first keypoint of each level; first[n] = K
  int n;
};

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const __grid_constant__ Levels lv,
                    const long long* __restrict__ ys,
                    const long long* __restrict__ xs,
                    const uint32_t* __restrict__ table, int nnz,
                    float* __restrict__ out_ang,
                    long long* __restrict__ out_desc) {
  __shared__ float patch[kWin * kWin];
  __shared__ double red[2][kThreads / 32];
  __shared__ int s_bin;
  const int k = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int l = 0;
  while (l + 1 < lv.n && k >= lv.first[l + 1]) ++l;
  const int H = lv.H[l], W = lv.W[l];
  const float* __restrict__ img = lv.img[l];
  const int yc = (int)min(max(__ldg(ys + k), 0ll), (long long)H - 1);
  const int xc = (int)min(max(__ldg(xs + k), 0ll), (long long)W - 1);

  double mx = 0.0, my = 0.0;
  for (int e = threadIdx.x; e < kWin * kWin; e += kThreads) {
    const int i = e / kWin, j = e - (e / kWin) * kWin;
    const int y = min(max(yc - kWinR + i, 0), H - 1);
    const int x = min(max(xc - kWinR + j, 0), W - 1);
    const float v = __bfloat162float(
        __float2bfloat16_rn(__ldg(img + (size_t)y * W + x)));
    patch[e] = v;
    const int dx = j - kWinR, dy = i - kWinR;
    if (dx * dx + dy * dy <= kOriR * kOriR) {
      mx += (double)dx * (double)v;
      my += (double)dy * (double)v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx += __shfl_xor_sync(0xffffffffu, mx, off);
    my += __shfl_xor_sync(0xffffffffu, my, off);
  }
  if (lane == 0) {
    red[0][warp] = mx;
    red[1][warp] = my;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sx = 0.0, sy = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      sx += red[0][w];
      sy += red[1][w];
    }
    const float ang = atan2f((float)sy, (float)sx);
    const int b = (int)rintf(ang * kBinScale);
    s_bin = ((b % kRot) + kRot) % kRot;
    out_ang[k] = ang;
  }
  __syncthreads();

  const uint32_t* __restrict__ rows =
      table + (size_t)s_bin * nnz * kBits + threadIdx.x;
  float acc = 0.0f;
#pragma unroll 7
  for (int j = 0; j < nnz; ++j) {
    const uint32_t w = __ldg(rows + (size_t)j * kBits);
    acc = fmaf(__uint_as_float(w & 0xffff0000u), patch[w & 0xffffu], acc);
  }
  const unsigned word = __ballot_sync(0xffffffffu, acc > 0.0f);
  if (lane == 0) out_desc[(size_t)k * (kBits / 32) + warp] = (long long)word;
}

}  // namespace

// Levels as host arrays (device pointers, heights, widths, keypoints per
// level); ys/xs (K,) int64 level coordinates, the keypoints of level 0 first;
// table (32, nnz, 256) uint32; outputs (K,) float32 angles and (K, 8) int64
// words.
extern "C" int orb_describe_launch(int n, const long long* imgs, const int* H,
                                   const int* W, const int* counts,
                                   const void* ys, const void* xs,
                                   const void* table, int nnz, void* out_ang,
                                   void* out_desc, void* stream) {
  if (n < 1 || n > kMaxLevels || nnz < 1) return (int)cudaErrorInvalidValue;
  Levels lv;
  int K = 0;
  for (int l = 0; l < n; ++l) {
    if (H[l] < 1 || W[l] < 1 || counts[l] < 0)
      return (int)cudaErrorInvalidValue;
    lv.img[l] = (const float*)imgs[l];
    lv.H[l] = H[l];
    lv.W[l] = W[l];
    lv.first[l] = K;
    K += counts[l];
  }
  lv.first[n] = K;
  lv.n = n;
  if (K > 0) {
    orb_describe_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
        lv, (const long long*)ys, (const long long*)xs, (const uint32_t*)table,
        nnz, (float*)out_ang, (long long*)out_desc);
  }
  return (int)cudaGetLastError();
}
