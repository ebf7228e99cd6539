// A run of identity-skip residual blocks in one pass over device memory:
// for each of `layers` layers l,
//
//     y = DW3x3(x, wd[l]) + bd[l]        zero SAME padding, stride 1
//     z = PW1x1(y, wp[l]) + bp[l]        C -> C
//     x = relu(z + x)
//
// on NCHW f32 activations [batch, c, h, w].  This is the body of the
// BlazeFace detectors: the BACK graph holds 28 such blocks in four runs of
// seven (128x128x24, 64x64x24, 32x32x48, 16x16x96).  (bf16 activations
// go to fused_dw_pw_block_bf16.cu.)
//
// Replaces docs/experiments/fused_block_prototype.py::kernel (K3), the
// Pallas TPU kernel that runs K fused layers per VMEM residency of a row
// chunk with a K-row halo.  The
// same idea on Hopper: one CTA owns one spatial tile of one frame, stages
// the tile plus a `layers`-pixel halo in shared memory, and runs every
// layer of the launch in that residency; only the run's input is read and
// only its output written.  Each layer's valid region shrinks by one pixel
// on each side, so after `layers` layers the tile itself is exact.  After
// every layer the positions outside the image are set to exactly zero:
// they are the next layer's SAME padding (K4's fix 1; without it K3 v1 let
// relu(bias) values grow in the halo and was off by ~4).
//
// Bound: operations.  One block costs 2 (9c + c^2) + 4c flops per pixel
// against 2 x itemsize x c bytes per pixel for the whole run, so every
// shape the detectors give it is compute-bound on f32 FMAs.  This version
// is plain FMA loops over shared memory (no wgmma, TMA or TF32), arranged
// so that shared-memory loads and latency do not dominate:
//   * the launch's weights are copied into shared memory once, as float4;
//     the 1x1 weights arrive transposed ([c_in][c_out]) and are read as
//     float4 broadcasts, eight output channels per thread;
//   * the staging loads are issued eight at a time per thread;
//   * the depthwise 3x3 slides a register window down a column strip of
//     kRows outputs (3 shared loads per output instead of 9);
//   * the 1x1 computes two pixels per thread, so each weight load feeds
//     two FMAs.
// The halo costs recomputed pixels, which the wrapper trades against
// extra launches when it picks the tile and the layers per launch.
//
// Sums are f32 in explicit fma, so -fmad=false does not split them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kGroup = 8;   // output channels of the 1x1 per thread
constexpr int kRows = 4;    // depthwise outputs per thread, down a column
constexpr int kInFlight = 8;  // staging loads issued together per thread

// Walks (k, ry, rx) over k_count x ny x nx items, `step` items at a time,
// without a division per item.
struct Walk {
  int k, ry, rx;
  int qk, sy, sx, ny, nx;
  __device__ Walk(int start, int step, int ny_, int nx_) : ny(ny_), nx(nx_) {
    const int plane = ny * nx;
    k = start / plane;
    ry = (start % plane) / nx;
    rx = start % nx;
    qk = step / plane;
    sy = (step % plane) / nx;
    sx = step % nx;
  }
  __device__ __forceinline__ void next() {
    rx += sx;
    if (rx >= nx) { rx -= nx; ++ry; }
    ry += sy;
    if (ry >= ny) { ry -= ny; ++k; }
    k += qk;
  }
};

// NaN-propagating relu, as torch.relu
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// n floats (n % 4 == 0, both ends 16-byte aligned) into shared memory
__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll 4
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
    fused_blocks_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float* __restrict__ wd,
                        const float* __restrict__ bd,
                        const float* __restrict__ wpt,
                        const float* __restrict__ bp, int c, int h, int w,
                        int layers, int tile, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  const int e = tile + 2 * layers;  // side of the staged tile
  const int np = e * e;
  float* xs = smem;                    // [c][np] activations
  float* ys = xs + c * np;             // [c][np] depthwise output
  float* wps = ys + c * np;            // [layers][c_in][c_out]
  float* wds = wps + layers * c * c;   // [layers][c][9]
  float* bds = wds + layers * 9 * c;   // [layers][c]
  float* bps = bds + layers * c;       // [layers][c]

  copy4(wps, wpt, layers * c * c);
  copy4(wds, wd, layers * 9 * c);
  copy4(bds, bd, layers * c);
  copy4(bps, bp, layers * c);

  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t frame = static_cast<int64_t>(blockIdx.y) * c * plane;
  const int tile_y = blockIdx.x / tiles_x;
  const int tile_x = blockIdx.x % tiles_x;
  const int oy = tile_y * tile - layers;  // image row of staged row 0
  const int ox = tile_x * tile - layers;

  // stage the tile and its halo, zeros outside the image
  const float* xb = x + frame;
  for (Walk it(threadIdx.x, blockDim.x, e, e); it.k < c;) {
    float v[kInFlight];
    int dst[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      dst[u] = -1;
      v[u] = 0.0f;
      if (it.k < c) {
        const int gy = oy + it.ry;
        const int gx = ox + it.rx;
        dst[u] = it.k * np + it.ry * e + it.rx;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
          v[u] = xb[it.k * plane + static_cast<int64_t>(gy) * w + gx];
        }
        it.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (dst[u] >= 0) xs[dst[u]] = v[u];
    }
  }
  __syncthreads();

  for (int l = 0; l < layers; ++l) {
    const float* wl = wps + l * c * c;
    const float* kl = wds + l * 9 * c;
    const float* bdl = bds + l * c;
    const float* bpl = bps + l * c;
    // this layer's region: staged rows/columns [lo, lo + n)
    const int lo = l + 1;
    const int n = e - 2 * lo;

    // depthwise 3x3 + bias into ys: one channel, one column, kRows rows
    // per item, the 3x3 window sliding down in registers.  Positions
    // outside the image are computed too (their inputs are zeros or
    // valid) and zeroed by the 1x1 below.
    const int strips = (n + kRows - 1) / kRows;
    for (Walk it(threadIdx.x, blockDim.x, strips, n); it.k < c; it.next()) {
      const float* k9 = kl + it.k * 9;
      const float k0 = k9[0], k1 = k9[1], k2 = k9[2], k3 = k9[3],
                  k4 = k9[4], k5 = k9[5], k6 = k9[6], k7 = k9[7],
                  k8 = k9[8];
      const float bias = bdl[it.k];
      const int px = lo + it.rx;
      const int y0 = lo + it.ry * kRows;
      const int y1 = min(y0 + kRows, lo + n);
      const float* src = xs + it.k * np + px - 1;
      float* dst = ys + it.k * np + px;
      float a0 = src[(y0 - 1) * e], a1 = src[(y0 - 1) * e + 1],
            a2 = src[(y0 - 1) * e + 2];
      float b0 = src[y0 * e], b1 = src[y0 * e + 1], b2 = src[y0 * e + 2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int y = y0 + r;
        if (y >= y1) break;
        const float c0 = src[(y + 1) * e], c1 = src[(y + 1) * e + 1],
                    c2 = src[(y + 1) * e + 2];
        float acc = bias;
        acc = __fmaf_rn(k0, a0, acc);
        acc = __fmaf_rn(k1, a1, acc);
        acc = __fmaf_rn(k2, a2, acc);
        acc = __fmaf_rn(k3, b0, acc);
        acc = __fmaf_rn(k4, b1, acc);
        acc = __fmaf_rn(k5, b2, acc);
        acc = __fmaf_rn(k6, c0, acc);
        acc = __fmaf_rn(k7, c1, acc);
        acc = __fmaf_rn(k8, c2, acc);
        dst[y * e] = acc;
        a0 = b0; a1 = b1; a2 = b2;
        b0 = c0; b1 = c1; b2 = c2;
      }
    }
    __syncthreads();

    // 1x1 + bias + residual + relu, in place over xs: each thread owns
    // kGroup output channels of two pixels of one row (columns rx and
    // rx + half) and reads only those pixels
    const int half = (n + 1) / 2;
    for (Walk it(threadIdx.x, blockDim.x, n, half); it.k < c / kGroup;
         it.next()) {
      const int py = lo + it.ry;
      const int pxa = lo + it.rx;
      const bool has_b = it.rx + half < n;
      const int pxb = has_b ? pxa + half : pxa;
      const int gy = oy + py;
      const bool row_in = gy >= 0 && gy < h;
      const bool in_a = row_in && ox + pxa >= 0 && ox + pxa < w;
      const bool in_b = row_in && ox + pxb >= 0 && ox + pxb < w;
      const int pa = py * e + pxa;
      const int pb = py * e + pxb;
      float acc_a[kGroup], acc_b[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        acc_a[j] = acc_b[j] = bpl[it.k * kGroup + j];
      }
      const float* wcol = wl + it.k * kGroup;
#pragma unroll 4
      for (int i = 0; i < c; ++i) {
        const float ya = ys[i * np + pa];
        const float yb = ys[i * np + pb];
        const float4 w0 = *reinterpret_cast<const float4*>(wcol + i * c);
        const float4 w1 = *reinterpret_cast<const float4*>(wcol + i * c + 4);
        const float wv[kGroup] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          acc_a[j] = __fmaf_rn(wv[j], ya, acc_a[j]);
          acc_b[j] = __fmaf_rn(wv[j], yb, acc_b[j]);
        }
      }
      float* xa = xs + it.k * kGroup * np + pa;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        xa[j * np] = in_a ? relu(acc_a[j] + xa[j * np]) : 0.0f;
      }
      if (has_b) {
        float* xb2 = xs + it.k * kGroup * np + pb;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          xb2[j * np] = in_b ? relu(acc_b[j] + xb2[j * np]) : 0.0f;
        }
      }
    }
    __syncthreads();
  }

  // write the tile (the staged centre) back
  float* ob = out + frame;
  for (Walk it(threadIdx.x, blockDim.x, tile, tile); it.k < c; it.next()) {
    const int gy = tile_y * tile + it.ry;
    const int gx = tile_x * tile + it.rx;
    if (gy < h && gx < w) {
      ob[it.k * plane + static_cast<int64_t>(gy) * w + gx] =
          xs[it.k * np + (layers + it.ry) * e + layers + it.rx];
    }
  }
}

int launch(const float* x, float* out, const float* wd, const float* bd,
           const float* wpt, const float* bp, int batch, int c, int h,
           int w, int layers, int tile, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  if (c % kGroup != 0 || layers < 1 || tile < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int e = tile + 2 * layers;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(c) * e * e +
                       static_cast<size_t>(layers) * (c * c + 11 * c));
  int device = 0;
  int limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + tile - 1) / tile;
  const int tiles_y = (h + tile - 1) / tile;
  const dim3 grid(tiles_x * tiles_y, batch);
  fused_blocks_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, out, wd, bd, wpt, bp, c, h, w, layers, tile, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [batch, c, h, w] contiguous, distinct buffers; wd: [layers, c,
// 3, 3], bd: [layers, c], wpt: [layers, c_in, c_out] (the 1x1 weights
// transposed), bp: [layers, c], all f32, contiguous and 16-byte aligned.
// c % 8 == 0, batch <= 65535, and the tile must fit shared
// memory: 4 (2 c (tile + 2 layers)^2 + layers (c^2 + 11 c)) bytes.
// Launches on `stream` and returns a cudaError_t (0 on success).
extern "C" int fused_dw_pw_block_f32(const float* x, float* out,
                                     const float* wd, const float* bd,
                                     const float* wpt, const float* bp,
                                     int batch, int c, int h, int w,
                                     int layers, int tile, void* stream) {
  return launch(x, out, wd, bd, wpt, bp, batch, c, h, w, layers, tile,
                stream);
}
