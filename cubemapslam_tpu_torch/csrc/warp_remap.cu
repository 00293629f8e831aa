// Kernel W: exact bilinear fisheye -> cubemap-cross remap.
//
// Replaces the TPU warp pair in cubemapslam_tpu/warp_tpu.py: _h_kernel (the
// two-pass tile resample, a vertical lerp then a 16-tap base-column selector
// matmul) and _x_kernel (the transposed one-hot pass for foldover tiles),
// together with the cross assembly of runtime/system.py (five
// dynamic_update_slice calls). Those kernels were shaped by the TPU's matrix
// unit and (8,128) tiling and are only approximate (mean error 0.5, p99 3.0
// intensity levels); this kernel computes warp.warp_bilinear exactly.
//
// One thread per cross pixel: it reads the pixel's fisheye source
// coordinates (one 8-byte float2 load; NaN marks a pixel outside the five
// faces or the fisheye image, which comes out 0), derives the top-left
// corner and the four bilinear weights with the formula of
// warp.bilinear_operands (the corner clipped to [0, W-2] x [0, H-2], the
// fractions from the unclipped floor), gathers four u8 texels and writes one
// float. Products and sums are rounded one by one (__fmul_rn/__fadd_rn), in
// the plain version's order, so no multiply-add is contracted and the result
// is bitwise that of the plain version.
//
// Bound on an H100: bytes. Per pixel it moves 8 (coordinates) + 4 (output)
// bytes, what any bilinear resampler with a coordinate map must move; the
// 0.36 MB fisheye image stays in L2, so the gathers cost no device-memory
// traffic beyond the first touch. Loads are coalesced (neighbouring threads
// read neighbouring map entries) and there is no shared memory or
// synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void warp_remap_kernel(const uint8_t* __restrict__ fisheye,
                                  const float2* __restrict__ xy,
                                  float* __restrict__ out, int n_pix,
                                  int src_w, int src_h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const float2 p = __ldg(xy + i);
  if (p.x != p.x) {  // NaN: not a valid source pixel
    out[i] = 0.0f;
    return;
  }
  const float x0 = floorf(p.x), y0 = floorf(p.y);
  const float fx = __fsub_rn(p.x, x0), fy = __fsub_rn(p.y, y0);
  const int x0i = min(max((int)x0, 0), src_w - 2);
  const int y0i = min(max((int)y0, 0), src_h - 2);
  const int base = y0i * src_w + x0i;
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float g00 = (float)__ldg(fisheye + base);
  const float g01 = (float)__ldg(fisheye + base + 1);
  const float g10 = (float)__ldg(fisheye + base + src_w);
  const float g11 = (float)__ldg(fisheye + base + src_w + 1);
  // ((w00 g00 + w01 g01) + w10 g10) + w11 g11, each step rounded
  float acc = __fmul_rn(__fmul_rn(gx, gy), g00);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(fx, gy), g01));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(gx, fy), g10));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(fx, fy), g11));
  out[i] = acc;
}

}  // namespace

extern "C" int warp_remap_launch(const void* fisheye, const void* xy,
                                 void* out, int n_pix, int src_w, int src_h,
                                 void* stream) {
  const int threads = 256;
  const int blocks = (n_pix + threads - 1) / threads;
  if (n_pix > 0) {
    warp_remap_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)fisheye, (const float2*)xy, (float*)out, n_pix, src_w,
        src_h);
  }
  return (int)cudaGetLastError();
}
