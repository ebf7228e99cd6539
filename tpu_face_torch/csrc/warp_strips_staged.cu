// Zero-border bilinear sampling of coordinate grids from frame channel
// planes (bf16 or f32), with each output block's source window staged in
// shared memory first: the strip-staged counterpart of the gather kernel in
// warp_bilinear_strips.cu, in two variants that differ only in how the
// window is copied.
//
// Replaces two Pallas TPU kernels that stage a source strip per block:
//   * tpu_face/ops/pallas_warp.py::_warp_kernel_strips copies the strip of
//     all three channels as ONE [3, band, xload] DMA per block: the
//     "fused" entry points, which issue the window as one cp.async group
//     and wait for it once;
//   * tools/tpu_strip_dma_probe.py::_kernel_split (K5), the per-channel
//     A/B baseline of that copy: three [band, xload] DMAs per block, each
//     with its own semaphore wait.  The "split" entry points issue the
//     window as three cp.async groups, one per channel, and wait for each
//     before sampling that channel.
//
// Blocks.  As on the TPU, a CTA owns one row tile (rt output rows) of one
// grid and walks its column blocks (cw columns each) in order; one thread
// owns one output pixel of the rt x cw block.  While it samples block j
// from one shared buffer, block j + 1's window is already being copied
// into the other (double buffering, like the TPU kernels' two slots).
//
// The window is sized for the card, not the TPU.  The TPU's [3, 144, 256]
// bf16 strip is 221 KB, a whole SM's shared memory with no room for a
// second slot.  Here each block's window is the bounding box of its taps
// inside the frame (a reduction over the block's coordinates before the
// copy), clipped to a fixed budget per buffer that the wrapper states
// (ops/warp.py STAGE_BYTES).  Taps outside the staged window -- a block
// whose footprint exceeds the budget -- read global memory, so every ROI
// is sampled exactly, whatever its size or rotation.
//
// Copies.  cp.async moves 4 bytes per instruction (two bf16 or one f32),
// which needs 4-byte-aligned addresses on both sides: a window row starts
// at the aligned element at or before its first column (one extra element
// for bf16 when the row's first element is odd), and each shared row keeps
// room for that shift.
//
// Bound: bytes.  The function is the gather's: each touched tap pixel read
// once, the coordinates read and the samples written once
// (chip_smoke.py's touched_bytes).  Staging reads whole windows, which at
// the cascade's downsampling ratios (a 1080p mesh ROI is ~3x its 192-px
// grid) are several times the pixels the four taps of each output touch:
// it is here as the measured counterpart of the TPU design, not because
// the card needs it (Hopper gathers through L1/L2).
//
// Arithmetic: the same tap order and widening as warp_bilinear_strips.cu
// (each tap widened to f32, top*(1-dy) + bot*dy with top = t00*(1-dx) +
// t01*dx); built with -fmad=false, both variants match the gather kernel
// and the plain PyTorch version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A block's staged source window: rows y0 .. y0+rows-1 and columns
// x0 .. x0+cols-1 of every channel, each channel [rows][pitch] elements.
struct Window {
  int y0, rows, x0, cols, pitch;
};

template <typename T, bool kSplit>
__global__ void warp_strips_staged_kernel(
    const T* __restrict__ planes, int h, int w, int64_t n_elem,
    const float* __restrict__ xs, const float* __restrict__ ys, int groups,
    int gh, int gw, int rt, int cw, int cap, int p, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stage = reinterpret_cast<T*>(smem_raw);  // [2][3][cap]
  __shared__ int red[4][32];                         // per-warp extents
  __shared__ Window win[2];

  constexpr int kUnit = 4 / sizeof(T);  // elements per 4-byte copy
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tiles = (gh + rt - 1) / rt;
  const int g = blockIdx.x / tiles;                  // grid of the frame
  const int row = (blockIdx.x % tiles) * rt + tid / cw;
  const int col_in = tid % cw;
  const int n_blocks = (gw + cw - 1) / cw;           // blocks this CTA walks
  const int64_t b = blockIdx.y;                      // frame
  const int64_t frame_base = b * 3 * static_cast<int64_t>(h) * w;
  const int64_t q_row = static_cast<int64_t>(g) * gh * gw +
                        static_cast<int64_t>(row) * gw;
  const float* xrow = xs + b * p + q_row;
  const float* yrow = ys + b * p + q_row;
  float* orow = out + b * 3 * static_cast<int64_t>(p) + q_row;

  auto row_base = [&](int c, int y) -> int64_t {
    return frame_base + (static_cast<int64_t>(c) * h + y) * w;
  };

  // The coordinates of this thread's pixel in column block j.
  auto load = [&](int j, float& x, float& y) -> bool {
    const int col = j * cw + col_in;
    if (row >= gh || col >= gw) return false;
    x = xrow[col];
    y = yrow[col];
    return true;
  };

  // Window of column block j (its pixels' in-frame taps' bounding box,
  // clipped to the budget) into win[slot].
  auto plan = [&](int slot, bool active, float x, float y) {
    int xl = INT_MAX, xh = INT_MIN, yl = INT_MAX, yh = INT_MIN;
    const float fx = floorf(x);
    const float fy = floorf(y);
    // some tap in the frame (false for NaN coordinates)
    if (active && fx >= -1.0f && fx < static_cast<float>(w) &&
        fy >= -1.0f && fy < static_cast<float>(h)) {
      const int ix = static_cast<int>(fx);
      const int iy = static_cast<int>(fy);
      xl = max(ix, 0);
      xh = min(ix + 1, w - 1);
      yl = max(iy, 0);
      yh = min(iy + 1, h - 1);
    }
    xl = __reduce_min_sync(0xffffffffu, xl);
    xh = __reduce_max_sync(0xffffffffu, xh);
    yl = __reduce_min_sync(0xffffffffu, yl);
    yh = __reduce_max_sync(0xffffffffu, yh);
    if (lane == 0) {
      red[0][warp] = xl;
      red[1][warp] = xh;
      red[2][warp] = yl;
      red[3][warp] = yh;
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 1; k < nwarps; ++k) {
        xl = min(xl, red[0][k]);
        xh = max(xh, red[1][k]);
        yl = min(yl, red[2][k]);
        yh = max(yh, red[3][k]);
      }
      Window v{0, 0, 0, 0, kUnit};
      if (xl <= xh) {
        v.y0 = yl;
        v.rows = yh - yl + 1;
        v.x0 = xl;
        v.cols = xh - xl + 1;
        // room for the alignment shift of each row's first element
        v.pitch = (v.cols + 2 * (kUnit - 1)) / kUnit * kUnit;
        if (v.pitch > cap) {           // wider than the budget: one row
          v.pitch = cap;
          v.cols = cap - (kUnit - 1);
          v.rows = 1;
        } else if (static_cast<int64_t>(v.pitch) * v.rows > cap) {
          v.rows = cap / v.pitch;      // the top rows; the rest read global
        }
      }
      win[slot] = v;
    }
    __syncthreads();
  };

  // Issue the copies of channels [c_first, c_last) of win[slot] into
  // buffer `slot`: one warp per window row, 4 bytes per lane and step.
  auto copy = [&](int slot, int c_first, int c_last) {
    const Window v = win[slot];
    T* const buf = stage + slot * 3 * static_cast<int64_t>(cap);
    const int nrows = (c_last - c_first) * v.rows;
    for (int i = warp; i < nrows; i += nwarps) {
      const int c = c_first + i / v.rows;
      const int r = i % v.rows;
      const int64_t g0 = row_base(c, v.y0 + r) + v.x0;
      const int shift = static_cast<int>(g0 % kUnit);
      const int64_t ga = g0 - shift;
      T* const dst = buf + c * cap + r * v.pitch;
      const int units = (shift + v.cols + kUnit - 1) / kUnit;
      for (int u = lane; u < units; u += 32) {
        const int64_t src = ga + static_cast<int64_t>(u) * kUnit;
        if (src + kUnit <= n_elem) {
          cp_async4(dst + u * kUnit, planes + src);
        } else {  // the planes' last element, alone: no 4-byte copy
          for (int e = 0; src + e < n_elem; ++e) {
            dst[u * kUnit + e] = planes[src + e];
          }
        }
      }
    }
  };

  auto issue = [&](int slot) {
    if (kSplit) {
      for (int c = 0; c < 3; ++c) {
        copy(slot, c, c + 1);
        cp_async_commit();
      }
    } else {
      copy(slot, 0, 3);
      cp_async_commit();
    }
  };

  // Channels [c_first, c_last) of this thread's pixel in column block j
  // from buffer `slot`, taps outside the staged window from global memory.
  auto sample = [&](int slot, int j, bool active, float x, float y,
                    int c_first, int c_last) {
    if (!active) return;
    const Window v = win[slot];
    const T* const buf = stage + slot * 3 * static_cast<int64_t>(cap);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float dx = x - x0;
    const float dy = y - y0;
    const float x1 = x0 + 1.0f;
    const float y1 = y0 + 1.0f;
    const bool vx0 = x0 >= 0.0f && x0 < static_cast<float>(w);
    const bool vx1 = x1 >= 0.0f && x1 < static_cast<float>(w);
    const bool vy0 = y0 >= 0.0f && y0 < static_cast<float>(h);
    const bool vy1 = y1 >= 0.0f && y1 < static_cast<float>(h);
    const int ix0 = vx0 ? static_cast<int>(x0) : 0;
    const int ix1 = vx1 ? static_cast<int>(x1) : 0;
    const int iy0 = vy0 ? static_cast<int>(y0) : 0;
    const int iy1 = vy1 ? static_cast<int>(y1) : 0;

    auto tap = [&](int c, bool valid, int iy, int ix) -> float {
      if (!valid) return 0.0f;
      const int64_t rb = row_base(c, iy);
      const int ry = iy - v.y0;
      const int rx = ix - v.x0;
      if (static_cast<unsigned>(ry) < static_cast<unsigned>(v.rows) &&
          static_cast<unsigned>(rx) < static_cast<unsigned>(v.cols)) {
        const int shift = static_cast<int>((rb + v.x0) % kUnit);
        return widen(buf[c * cap + ry * v.pitch + shift + rx]);
      }
      return widen(planes[rb + ix]);
    };

    const int col = j * cw + col_in;
    for (int c = c_first; c < c_last; ++c) {
      const float t00 = tap(c, vy0 && vx0, iy0, ix0);
      const float t01 = tap(c, vy0 && vx1, iy0, ix1);
      const float t10 = tap(c, vy1 && vx0, iy1, ix0);
      const float t11 = tap(c, vy1 && vx1, iy1, ix1);
      const float top = t00 * (1.0f - dx) + t01 * dx;
      const float bot = t10 * (1.0f - dx) + t11 * dx;
      orow[c * static_cast<int64_t>(p) + col] = top * (1.0f - dy) + bot * dy;
    }
  };

  float x = 0.0f, y = 0.0f, xn = 0.0f, yn = 0.0f;
  bool active = load(0, x, y);
  plan(0, active, x, y);
  issue(0);
  for (int j = 0; j < n_blocks; ++j) {
    const int slot = j & 1;
    const bool more = j + 1 < n_blocks;
    bool active_n = false;
    if (more) {  // block j + 1's copies overlap block j's sampling
      active_n = load(j + 1, xn, yn);
      plan(slot ^ 1, active_n, xn, yn);
      issue(slot ^ 1);
    }
    if (kSplit) {
      // pending groups: block j's three channels, then block j + 1's
      if (more) cp_async_wait<5>(); else cp_async_wait<2>();
      __syncthreads();
      sample(slot, j, active, x, y, 0, 1);
      if (more) cp_async_wait<4>(); else cp_async_wait<1>();
      __syncthreads();
      sample(slot, j, active, x, y, 1, 2);
      if (more) cp_async_wait<3>(); else cp_async_wait<0>();
      __syncthreads();
      sample(slot, j, active, x, y, 2, 3);
    } else {
      if (more) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      sample(slot, j, active, x, y, 0, 3);
    }
    __syncthreads();  // buffer `slot` takes block j + 2's window next
    x = xn;
    y = yn;
    active = active_n;
  }
}

template <typename T, bool kSplit>
int launch(const T* planes, int batch, int h, int w, const float* xs,
           const float* ys, int groups, int gh, int gw, int rt, int cw,
           int cap, float* out, void* stream) {
  if (batch == 0 || groups == 0 || gh == 0 || gw == 0) return 0;
  const int smem = 2 * 3 * cap * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      warp_strips_staged_kernel<T, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (gh + rt - 1) / rt;
  const dim3 grid(groups * tiles, batch);
  const int64_t n_elem = static_cast<int64_t>(batch) * 3 * h * w;
  warp_strips_staged_kernel<T, kSplit>
      <<<grid, rt * cw, smem, static_cast<cudaStream_t>(stream)>>>(
          planes, h, w, n_elem, xs, ys, groups, gh, gw, rt, cw, cap,
          groups * gh * gw, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: [batch, 3, h, w] contiguous, 4-byte aligned; xs, ys: [batch,
// groups, gh, gw] f32 contiguous (one frame's grids, all its faces, side
// by side); out: [batch, 3, groups * gh * gw] f32 contiguous.  Blocks of
// rt x cw output pixels, rt * cw threads a CTA (a multiple of 32, at most
// 1024); cap: elements of one channel's window in each of the two shared
// buffers (even).  batch <= 65535.  Launches on `stream` and returns the
// CUDA error of the attribute call or of the launch.
#define STAGED_ENTRY(name, T, split)                                        \
  extern "C" int name(const T* planes, int batch, int h, int w,             \
                      const float* xs, const float* ys, int groups, int gh, \
                      int gw, int rt, int cw, int cap, float* out,          \
                      void* stream) {                                       \
    return launch<T, split>(planes, batch, h, w, xs, ys, groups, gh, gw,    \
                            rt, cw, cap, out, stream);                      \
  }

STAGED_ENTRY(warp_strips_staged_fused_bf16, __nv_bfloat16, false)
STAGED_ENTRY(warp_strips_staged_fused_f32, float, false)
STAGED_ENTRY(warp_strips_staged_split_bf16, __nv_bfloat16, true)
STAGED_ENTRY(warp_strips_staged_split_f32, float, true)
