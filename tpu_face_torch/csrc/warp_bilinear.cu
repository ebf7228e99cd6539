// Zero-border bilinear sampling of coordinate grids from a frame's three
// f32 channel planes: one launch samples every grid of a call (the mesh
// grid, or both iris grids) for every frame of the batch.
//
// Replaces tpu_face/ops/pallas_warp.py::_warp_kernel, the resident-plane
// Pallas TPU kernel of the cascade's mesh and iris warps.  It computes
// what that kernel computes -- tpu_face/ops/image.py::bilinear_sample
// (zero border) -- but not the way it computes it: the TPU kernel turns
// the gather into banded hat-weight matmuls over VMEM strips because the
// TPU has no fast gather.  Hopper gathers through L1/L2, so here one
// thread owns one output pixel of one frame and reads its four taps per
// channel directly.  There is no static sampling window, so every ROI
// (any rotation, mirrored, past the frame edge) is sampled exactly.
//
// Bound: bytes.  Per output pixel it reads 8 B of coordinates, writes
// 12 B of samples, and reads 4 taps x 3 channels that are mostly cache
// hits (neighbouring pixels share taps); the arithmetic is a few dozen
// flops.  The output is channel-major, so neighbouring threads read
// neighbouring coordinates and store to neighbouring addresses, and the
// CNN that follows reads it as NCHW without a copy.  This first version
// keeps the simple one-thread-per-pixel shape; making it fast (fewer
// tap loads per pixel, a uint8 output, fusing the [0,1] normalisation)
// is later work.
//
// Arithmetic follows bilinear_sample's order, top*(1-dy) + bot*dy with
// top = t00*(1-dx) + t01*dx; built with -fmad=false it matches the plain
// PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void warp_bilinear_kernel(const float* __restrict__ planes,
                                     int64_t stride_b, int64_t stride_c,
                                     int64_t stride_h, int h, int w,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ ys, int p,
                                     float* __restrict__ out) {
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

  // Tap validity and offsets, shared by the three channels.  Compared
  // as floats so coordinates far outside the frame never overflow an
  // int; a NaN coordinate makes every tap invalid and the output NaN,
  // as in the plain version.
  const bool vx0 = x0 >= 0.0f && x0 < static_cast<float>(w);
  const bool vx1 = x1 >= 0.0f && x1 < static_cast<float>(w);
  const bool vy0 = y0 >= 0.0f && y0 < static_cast<float>(h);
  const bool vy1 = y1 >= 0.0f && y1 < static_cast<float>(h);
  const int64_t ox0 = vx0 ? static_cast<int64_t>(x0) : 0;
  const int64_t ox1 = vx1 ? static_cast<int64_t>(x1) : 0;
  const int64_t oy0 = (vy0 ? static_cast<int64_t>(y0) : 0) * stride_h;
  const int64_t oy1 = (vy1 ? static_cast<int64_t>(y1) : 0) * stride_h;

  const float* frame = planes + b * stride_b;
  float* o = out + b * 3 * static_cast<int64_t>(p) + q;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* plane = frame + c * stride_c;
    const float t00 = (vy0 && vx0) ? __ldg(plane + oy0 + ox0) : 0.0f;
    const float t01 = (vy0 && vx1) ? __ldg(plane + oy0 + ox1) : 0.0f;
    const float t10 = (vy1 && vx0) ? __ldg(plane + oy1 + ox0) : 0.0f;
    const float t11 = (vy1 && vx1) ? __ldg(plane + oy1 + ox1) : 0.0f;
    const float top = t00 * (1.0f - dx) + t01 * dx;
    const float bot = t10 * (1.0f - dx) + t11 * dx;
    o[c * static_cast<int64_t>(p)] = top * (1.0f - dy) + bot * dy;
  }
}

}  // namespace

// planes: [batch, 3, h, w] f32 with element strides (stride_b, stride_c,
// stride_h, 1); xs, ys: [batch, p] f32 contiguous; out: [batch, 3, p] f32
// contiguous (channel-major, so each channel's stores are coalesced).
// batch <= 65535.  Launches on `stream` and returns cudaGetLastError().
extern "C" int warp_bilinear(const float* planes, int64_t stride_b,
                             int64_t stride_c, int64_t stride_h, int batch,
                             int h, int w, const float* xs, const float* ys,
                             int p, float* out, void* stream) {
  if (batch == 0 || p == 0) return 0;
  const dim3 grid((p + kThreads - 1) / kThreads, batch);
  warp_bilinear_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      planes, stride_b, stride_c, stride_h, h, w, xs, ys, p, out);
  return static_cast<int>(cudaGetLastError());
}
