// Zero-border bilinear sampling of coordinate grids from frame channel
// planes of either type the warp takes: bf16 planes (the cascade beyond
// the f32 residency budget, ~720p) and f32 planes (the standalone models
// at large frames).  One launch samples every grid of a call -- every
// face of every frame -- for the whole batch.
//
// Replaces tpu_face/ops/pallas_warp.py::_warp_kernel_strips, the Pallas
// TPU kernel whose planes stay in HBM and whose every block DMAs one
// [3, band, xload] source strip into VMEM.  It computes what that kernel
// computes -- tpu_face/ops/image.py::bilinear_sample (zero border) -- but
// not the way it computes it: the strips and the hat-weight matmuls
// exist because the TPU has no fast gather and little VMEM.  Hopper
// gathers from global memory through L1/L2, so, as in warp_bilinear.cu,
// one thread owns one output pixel of one frame and reads its four taps
// per channel directly; there is no band or x-window, so every ROI is
// sampled exactly whatever its size or rotation.
//
// Plane sharing.  The TPU kernel flattens the cascade's nested [frame]
// [face] vmaps into one group axis and maps group g to plane set
// g // plane_ratio.  Here one frame's K faces are laid out side by side
// in its coordinate row: xs/ys are [batch, K*P] against planes
// [batch, 3, h, w], so the frame index (blockIdx.y) is g // plane_ratio,
// and no frame's planes are ever copied per face.
//
// Bound: bytes.  Per output pixel it reads 8 B of coordinates, writes
// 12 B of samples, and reads 4 taps x 3 channels of 2 B (bf16) that are
// mostly cache hits; the arithmetic is a few dozen flops.  The bf16
// planes halve the tap bytes of the f32 kernel.  This first version keeps
// the simple one-thread-per-pixel shape; making it fast is later work.
//
// Arithmetic: each tap is widened to f32 first, then blended in
// bilinear_sample's order, top*(1-dy) + bot*dy with top = t00*(1-dx) +
// t01*dx; built with -fmad=false it matches the plain PyTorch version
// (which widens each gathered tap the same way) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void warp_bilinear_strips_kernel(const T* __restrict__ planes,
                                            int64_t stride_b,
                                            int64_t stride_c,
                                            int64_t stride_h, int h, int w,
                                            const float* __restrict__ xs,
                                            const float* __restrict__ ys,
                                            int p, float* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;  // output pixel
  if (q >= p) return;
  const int64_t b = blockIdx.y;                          // frame
  const int64_t i = b * p + q;

  const float x = xs[i];
  const float y = ys[i];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float dx = x - x0;
  const float dy = y - y0;
  const float x1 = x0 + 1.0f;
  const float y1 = y0 + 1.0f;

  // Tap validity compared as floats, so coordinates far outside the
  // frame never overflow an int; a NaN coordinate makes every tap
  // invalid and the output NaN, as in the plain version.  Offsets are
  // int64: a 4K batch of 8 holds 199 M plane elements.
  const bool vx0 = x0 >= 0.0f && x0 < static_cast<float>(w);
  const bool vx1 = x1 >= 0.0f && x1 < static_cast<float>(w);
  const bool vy0 = y0 >= 0.0f && y0 < static_cast<float>(h);
  const bool vy1 = y1 >= 0.0f && y1 < static_cast<float>(h);
  const int64_t ox0 = vx0 ? static_cast<int64_t>(x0) : 0;
  const int64_t ox1 = vx1 ? static_cast<int64_t>(x1) : 0;
  const int64_t oy0 = (vy0 ? static_cast<int64_t>(y0) : 0) * stride_h;
  const int64_t oy1 = (vy1 ? static_cast<int64_t>(y1) : 0) * stride_h;

  const T* frame = planes + b * stride_b;
  float* o = out + b * 3 * static_cast<int64_t>(p) + q;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T* plane = frame + c * stride_c;
    const float t00 = (vy0 && vx0) ? widen(plane[oy0 + ox0]) : 0.0f;
    const float t01 = (vy0 && vx1) ? widen(plane[oy0 + ox1]) : 0.0f;
    const float t10 = (vy1 && vx0) ? widen(plane[oy1 + ox0]) : 0.0f;
    const float t11 = (vy1 && vx1) ? widen(plane[oy1 + ox1]) : 0.0f;
    const float top = t00 * (1.0f - dx) + t01 * dx;
    const float bot = t10 * (1.0f - dx) + t11 * dx;
    o[c * static_cast<int64_t>(p)] = top * (1.0f - dy) + bot * dy;
  }
}

template <typename T>
int launch(const T* planes, int64_t stride_b, int64_t stride_c,
           int64_t stride_h, int batch, int h, int w, const float* xs,
           const float* ys, int p, float* out, void* stream) {
  if (batch == 0 || p == 0) return 0;
  const dim3 grid((p + kThreads - 1) / kThreads, batch);
  warp_bilinear_strips_kernel<T><<<grid, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      planes, stride_b, stride_c, stride_h, h, w, xs, ys, p, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: [batch, 3, h, w] with element strides (stride_b, stride_c,
// stride_h, 1); xs, ys: [batch, p] f32 contiguous, one frame's grids (all
// its faces) side by side; out: [batch, 3, p] f32 contiguous
// (channel-major).  batch <= 65535.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int warp_bilinear_strips_bf16(const __nv_bfloat16* planes,
                                         int64_t stride_b, int64_t stride_c,
                                         int64_t stride_h, int batch, int h,
                                         int w, const float* xs,
                                         const float* ys, int p, float* out,
                                         void* stream) {
  return launch(planes, stride_b, stride_c, stride_h, batch, h, w, xs, ys,
                p, out, stream);
}

extern "C" int warp_bilinear_strips_f32(const float* planes,
                                        int64_t stride_b, int64_t stride_c,
                                        int64_t stride_h, int batch, int h,
                                        int w, const float* xs,
                                        const float* ys, int p, float* out,
                                        void* stream) {
  return launch(planes, stride_b, stride_c, stride_h, batch, h, w, xs, ys,
                p, out, stream);
}
