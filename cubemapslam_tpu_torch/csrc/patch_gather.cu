// Kernel G: 48x48 raw-patch gather around each keypoint.
//
// Replaces cubemapslam_tpu/features/extractor.py::_gather_kernel (16
// aligned (56,256) DMA windows in flight per program, then two modular rolls
// to crop, because Mosaic DMAs must start on an (8,128) tile) and its
// prototype scripts/proto_gather_kernel.py::kernel. It computes the JAX CPU
// path's vmapped dynamic_slice of the edge-padded level image, bit for bit:
//   patch[k, i, j] = img[clamp(y_k - 21 + i, 0, H-1), clamp(x_k - 21 + j, 0, W-1)]
// with y_k, x_k first clamped into the image.
//
// One block per keypoint; 256 threads write the 2304 floats of its patch,
// neighbouring threads on neighbouring columns, so each patch row is one
// coalesced 192-byte read and write. No alignment constraint exists on the
// card, so no window, roll or scratch is needed.
//
// Bound on an H100: bytes. A patch is 9,216 bytes written and at most as
// many read; the gathers of overlapping patches meet in L2. The level image
// (at most 15 MB at the 1950x1950 level 0) is read once at most.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRaw = 48;
constexpr int kRawR = 21;

__global__ void patch_gather_kernel(const float* __restrict__ img,
                                    const int32_t* __restrict__ ys,
                                    const int32_t* __restrict__ xs,
                                    float* __restrict__ out, int H, int W) {
  const int k = blockIdx.x;
  const int yc = min(max(__ldg(ys + k), 0), H - 1);
  const int xc = min(max(__ldg(xs + k), 0), W - 1);
  float* dst = out + (size_t)k * kRaw * kRaw;
  for (int e = threadIdx.x; e < kRaw * kRaw; e += blockDim.x) {
    const int i = e / kRaw, j = e % kRaw;
    const int y = min(max(yc - kRawR + i, 0), H - 1);
    const int x = min(max(xc - kRawR + j, 0), W - 1);
    dst[e] = __ldg(img + (size_t)y * W + x);
  }
}

}  // namespace

extern "C" int patch_gather_launch(const void* img, const void* ys,
                                   const void* xs, void* out, int K, int H,
                                   int W, void* stream) {
  if (K > 0) {
    patch_gather_kernel<<<K, 256, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const int32_t*)ys, (const int32_t*)xs,
        (float*)out, H, W);
  }
  return (int)cudaGetLastError();
}
