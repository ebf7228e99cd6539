// Zero-border bilinear sampling of coordinate grids from a frame's three
// f32 channel planes: one launch samples every grid of a call (the mesh
// grid, or both iris grids) for every frame of the batch.
//
// Replaces tpu_face/ops/pallas_warp.py::_warp_kernel, the resident-plane
// Pallas TPU kernel of the cascade's mesh and iris warps.  It computes
// what that kernel computes -- tpu_face/ops/image.py::bilinear_sample
// (zero border) -- but not the way it computes it: the TPU kernel turns
// the gather into banded hat-weight matmuls over VMEM strips because the
// TPU has no fast gather.  Hopper gathers through L1/L2, so here each
// thread reads the four taps per channel of its output pixel directly.
// There is no static sampling window, so every ROI (any rotation,
// mirrored, past the frame edge) is sampled exactly.
//
// Bound: bytes.  Per output pixel it must read 8 B of coordinates and
// write 12 B of samples, plus the source pixels the taps touch (each once
// at best); the arithmetic is a few dozen flops.  What the design does
// about it:
//   * Segments.  The grids of a call arrive as a small by-value table of
//     (xs, ys, P, grid width) segments, at most kMaxSegments, so the
//     caller never concatenates the coordinates (a copy of 8 B/px and two
//     launches per call); the samples of segment s land at its offset in
//     the [batch, 3, sum P] channel-major output, which the nets read as
//     NCHW without a copy.
//   * 2-D tiles.  One CTA samples a kTile x kTile tile of one grid of one
//     frame, one pixel per thread (a warp covers 16 x 2 pixels), so the
//     taps of a CTA fall in a compact source patch of a rotated ROI and
//     neighbouring rows' taps hit L1, where the first version ran a
//     256-thread CTA along 1 1/3 rows of a 192-wide grid.  Two or four
//     pixels per thread (with float4 coordinate loads and stores) need
//     more registers, so fewer threads and fewer taps are in flight per
//     SM: on an H100 they were slower at the cascade's 540p shapes, as
//     were 32 x 4 and 32 x 8 tiles.
//   * 32-bit offsets within a frame (the wrapper raises where a frame's
//     planes exceed 2^31 elements); one 64-bit frame offset per CTA.
//
// Arithmetic follows bilinear_sample's order, top*(1-dy) + bot*dy with
// top = t00*(1-dx) + t01*dx, the same as the first version; built with
// -fmad=false it matches the plain PyTorch version bit for bit.  (The
// texture unit's hardware bilinear filter would do the blend in 8-bit
// fixed-point weights and break the 1e-3 contract.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegments = 4;
constexpr int kTile = 16;                 // tile side, pixels
constexpr int kThreads = kTile * kTile;   // one output pixel each

struct Segment {
  const float* xs;      // [batch, p] row-contiguous
  const float* ys;
  int p;                // pixels of the segment per frame
  int width;            // row length of its grid (its tiles are 2-D in it)
  int out_off;          // offset of its samples in an output row
  int tiles_x;          // tiles across one grid row
  int tile_start;       // index of its first tile among the launch's
  int pad;
};

struct SegmentTable {
  Segment seg[kMaxSegments];
  int n;
};

// One output pixel: bilinear_sample of the three planes at (x, y).
__device__ __forceinline__ void sample(const float* __restrict__ frame,
                                       int stride_c, int stride_h, int h,
                                       int w, float x, float y, float v[3]) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float dx = x - x0;
  const float dy = y - y0;
  const float x1 = x0 + 1.0f;
  const float y1 = y0 + 1.0f;
  // Tap validity compared as floats, so coordinates far outside the
  // frame never overflow an int; a NaN coordinate makes every tap
  // invalid and the output NaN, as in the plain version.
  const bool vx0 = x0 >= 0.0f && x0 < static_cast<float>(w);
  const bool vx1 = x1 >= 0.0f && x1 < static_cast<float>(w);
  const bool vy0 = y0 >= 0.0f && y0 < static_cast<float>(h);
  const bool vy1 = y1 >= 0.0f && y1 < static_cast<float>(h);
  const int ox0 = vx0 ? static_cast<int>(x0) : 0;
  const int ox1 = vx1 ? static_cast<int>(x1) : 0;
  const int oy0 = (vy0 ? static_cast<int>(y0) : 0) * stride_h;
  const int oy1 = (vy1 ? static_cast<int>(y1) : 0) * stride_h;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* plane = frame + c * stride_c;
    const float t00 = (vy0 && vx0) ? __ldg(plane + oy0 + ox0) : 0.0f;
    const float t01 = (vy0 && vx1) ? __ldg(plane + oy0 + ox1) : 0.0f;
    const float t10 = (vy1 && vx0) ? __ldg(plane + oy1 + ox0) : 0.0f;
    const float t11 = (vy1 && vx1) ? __ldg(plane + oy1 + ox1) : 0.0f;
    const float top = t00 * (1.0f - dx) + t01 * dx;
    const float bot = t10 * (1.0f - dx) + t11 * dx;
    v[c] = top * (1.0f - dy) + bot * dy;
  }
}

__global__ void __launch_bounds__(kThreads)
    warp_bilinear_kernel(const float* __restrict__ planes, int64_t stride_b,
                         int stride_c, int stride_h, int h, int w,
                         const SegmentTable table, int ptotal,
                         float* __restrict__ out) {
  // this CTA's segment: the last whose first tile is at or before it
  // (constant indices only, so the table stays in parameter space)
  const int t = blockIdx.x;
  Segment sg = table.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i) {
    if (i < table.n && t >= table.seg[i].tile_start) sg = table.seg[i];
  }
  const int local = t - sg.tile_start;
  const int tile_y = local / sg.tiles_x;
  const int tile_x = local - tile_y * sg.tiles_x;
  const int col = tile_x * kTile + static_cast<int>(threadIdx.x) % kTile;
  const int row = tile_y * kTile + static_cast<int>(threadIdx.x) / kTile;
  if (col >= sg.width) return;
  const int q = row * sg.width + col;
  if (q >= sg.p) return;
  const int64_t b = blockIdx.y;
  float v[3];
  sample(planes + b * stride_b, stride_c, stride_h, h, w,
         __ldg(sg.xs + b * sg.p + q), __ldg(sg.ys + b * sg.p + q), v);
  float* o = out + b * 3 * static_cast<int64_t>(ptotal) + sg.out_off + q;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c * static_cast<int64_t>(ptotal)] = v[c];
}

}  // namespace

// planes: [batch, 3, h, w] f32 with element strides (stride_b, stride_c,
// stride_h, 1), 2 stride_c + (h - 1) stride_h + w < 2^31; segs: nseg
// (1..4) rows of four int64 (xs, ys, p, width): xs, ys [batch, p] f32
// row-contiguous device pointers, p their pixels per frame, width the row
// length of their grid; out: [batch, 3, ptotal] f32 contiguous, ptotal
// the sum of the p (segment s at the sum of the p before it).
// batch <= 65535.  Launches on `stream` and returns a cudaError_t (0 on
// success).
extern "C" int warp_bilinear(const float* planes, int64_t stride_b,
                             int64_t stride_c, int64_t stride_h, int batch,
                             int h, int w, const int64_t* segs, int nseg,
                             int ptotal, float* out, void* stream) {
  if (nseg < 1 || nseg > kMaxSegments || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SegmentTable table = {};
  table.n = nseg;
  int64_t tiles = 0;
  int64_t off = 0;
  for (int s = 0; s < nseg; ++s) {
    Segment& sg = table.seg[s];
    sg.xs = reinterpret_cast<const float*>(segs[4 * s]);
    sg.ys = reinterpret_cast<const float*>(segs[4 * s + 1]);
    const int64_t p = segs[4 * s + 2];
    const int64_t width = segs[4 * s + 3];
    if (p < 0 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
    sg.p = static_cast<int>(p);
    sg.width = static_cast<int>(width);
    sg.out_off = static_cast<int>(off);
    sg.tiles_x = static_cast<int>((width + kTile - 1) / kTile);
    const int64_t rows = (p + width - 1) / width;
    sg.tile_start = static_cast<int>(tiles);
    tiles += sg.tiles_x * ((rows + kTile - 1) / kTile);
    off += p;
  }
  if (off != ptotal || tiles >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || tiles == 0) return 0;
  const dim3 grid(static_cast<unsigned>(tiles), batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  warp_bilinear_kernel<<<grid, kThreads, 0, s>>>(
      planes, stride_b, static_cast<int>(stride_c),
      static_cast<int>(stride_h), h, w, table, ptotal, out);
  return static_cast<int>(cudaGetLastError());
}
