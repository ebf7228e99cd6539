// Zero-border bilinear sampling of coordinate grids from frame channel
// planes (bf16 or f32), with each output block's source window staged in
// shared memory first: the strip-staged counterpart of the gather kernel in
// warp_bilinear_strips.cu, in two variants that differ only in how the
// window's copy completes.
//
// Replaces two Pallas TPU kernels that stage a source strip per block:
//   * tpu_face/ops/pallas_warp.py::_warp_kernel_strips copies the strip of
//     all three channels as ONE [3, band, xload] DMA per block, with one
//     semaphore wait: the "fused" entry points, whose copies of a block
//     complete on one mbarrier, waited on once;
//   * tools/tpu_strip_dma_probe.py::_kernel_split (K5), the per-channel
//     A/B baseline of that copy: three [band, xload] DMAs per block, each
//     with its own semaphore wait.  The "split" entry points keep three
//     mbarriers per buffer, one per channel, and wait on each before
//     sampling that channel.
//
// The Hopper counterpart of the TPU's DMA + semaphore is the bulk async
// copy (cp.async.bulk) completing on an mbarrier that expects its bytes:
// the lanes of one warp issue one copy per window row and channel; no
// thread spends registers or instructions on the bytes.  (The tensor form,
// one box copy per block through a tensor map, traps with an illegal
// instruction on the card this was measured on, even in a minimal kernel:
// PERF.md.)
//
// Blocks.  A CTA owns one row tile (rt output rows) of one grid and walks
// its column blocks (cw columns each) in order; one thread owns one output
// pixel of the rt x cw block (ops/warp.py STAGED_BLOCK).  While the CTA
// samples block j from one shared buffer, warp 0 has already planned
// block j + 1's window and its copies are landing in the other (double
// buffering, like the TPU kernels' two slots), so a block costs one CTA
// barrier (the buffer it frees).
//
// The window.  Warp 0 reads the next block's coordinates and reduces the
// bounding box of their in-frame taps with warp reductions (no CTA
// barrier), clipped to a fixed budget per buffer that the wrapper states
// (ops/warp.py STAGE_BYTES).  A bulk copy needs 16-byte aligned addresses
// and lengths: each window row starts at the aligned address at or before
// its first column and each shared row keeps room for that shift.  Taps
// outside the staged window -- a block whose footprint exceeds the budget
// -- read global memory, so every ROI is sampled exactly, whatever its
// size or rotation.
//
// Bound: bytes.  The function is the gather's: each touched tap pixel read
// once, the coordinates read and the samples written once
// (chip_smoke.py's touched_bytes).  Staging copies whole windows, more
// than the pixels the four taps of each output touch at the cascade's
// downsampling: given a `stats` buffer, warp 0 adds to it the bytes each
// block's copies move and the blocks whose window does not hold all their
// taps, which chip_smoke.py prints beside touched_bytes.  The kernel is
// here as the measured counterpart of the TPU design, not because the
// card needs it (Hopper gathers through L1/L2).
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The one arrival of this phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A block's staged source window: rows y0 .. y0+rows-1 and columns
// x0 .. x0+cols-1 of every channel, each channel [rows][pitch] elements.
struct Window {
  int y0, rows, x0, cols, pitch;
};

template <typename T, bool kSplit>
__global__ void warp_strips_staged_kernel(
    const T* __restrict__ planes, int h, int w, const T* planes_end,
    const float* __restrict__ xs, const float* __restrict__ ys, int gh,
    int gw, int rt, int cw, int cap, int p, float* __restrict__ out,
    unsigned long long* stats) {
  constexpr int kBars = kSplit ? 3 : 1;
  constexpr int kUnit = 16 / sizeof(T);  // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stage = reinterpret_cast<T*>(smem_raw);  // [2][3][cap]
  __shared__ __align__(8) uint64_t bars[2][kBars];
  __shared__ Window win[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int threads = rt * cw;
  const int tiles = (gh + rt - 1) / rt;
  const int g = blockIdx.x / tiles;                  // grid of the frame
  const int row0 = (blockIdx.x % tiles) * rt;        // the tile's first row
  const int row = row0 + tid / cw;
  const int col_in = tid % cw;
  const int n_blocks = (gw + cw - 1) / cw;           // blocks this CTA walks
  const int64_t b = blockIdx.y;                      // frame
  const int64_t frame_base = b * 3 * static_cast<int64_t>(h) * w;
  const int64_t q_base = static_cast<int64_t>(g) * gh * gw;
  const float* xg = xs + b * p + q_base;
  const float* yg = ys + b * p + q_base;
  float* orow = out + b * 3 * static_cast<int64_t>(p) + q_base +
                static_cast<int64_t>(row) * gw;

  auto row_ptr = [&](int c, int y) -> const T* {
    return planes + frame_base + (static_cast<int64_t>(c) * h + y) * w;
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      for (int k = 0; k < kBars; ++k) mbar_init(&bars[s][k]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp 0: the window of column block j (the bounding box of its pixels'
  // in-frame taps, clipped to the budget) into win[slot], and its copies
  // into buffer `slot`, each channel's rows completing on that channel's
  // barrier (split) or all on one (fused); with `stats`, the bytes copied
  // into stats[0] and, where the window was cut, one block into stats[1].
  auto plan_and_issue = [&](int slot, int j) {
    int xl = INT_MAX, xh = INT_MIN, yl = INT_MAX, yh = INT_MIN;
    for (int i = lane; i < threads; i += 32) {
      const int r = row0 + i / cw;
      const int col = j * cw + i % cw;
      if (r >= gh || col >= gw) continue;
      const int64_t q = static_cast<int64_t>(r) * gw + col;
      const float fx = floorf(xg[q]);
      const float fy = floorf(yg[q]);
      // some tap in the frame (false for NaN coordinates)
      if (fx >= -1.0f && fx < static_cast<float>(w) && fy >= -1.0f &&
          fy < static_cast<float>(h)) {
        const int ix = static_cast<int>(fx);
        const int iy = static_cast<int>(fy);
        xl = min(xl, max(ix, 0));
        xh = max(xh, min(ix + 1, w - 1));
        yl = min(yl, max(iy, 0));
        yh = max(yh, min(iy + 1, h - 1));
      }
    }
    xl = __reduce_min_sync(0xffffffffu, xl);
    xh = __reduce_max_sync(0xffffffffu, xh);
    yl = __reduce_min_sync(0xffffffffu, yl);
    yh = __reduce_max_sync(0xffffffffu, yh);
    Window v{0, 0, 0, 0, kUnit};
    bool cut = false;   // some of the block's taps read global memory
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
        cut = true;
      } else if (static_cast<int64_t>(v.pitch) * v.rows > cap) {
        v.rows = cap / v.pitch;      // the top rows; the rest read global
        cut = true;
      }
      // a last row whose aligned copy would pass the planes' end reads
      // global memory instead
      const uintptr_t end = reinterpret_cast<uintptr_t>(
          row_ptr(2, v.y0 + v.rows - 1) + v.x0 + v.cols);
      if (((end + 15) & ~uintptr_t{15}) >
          reinterpret_cast<uintptr_t>(planes_end)) {
        --v.rows;
        cut = true;
      }
    }
    if (lane == 0) win[slot] = v;
    // each row's copy: its aligned span from its own start (a row's shift
    // depends on its address), rows spread over the lanes; the bytes each
    // barrier expects summed over the warp first
    T* const buf = stage + slot * 3 * static_cast<int64_t>(cap);
    auto span = [&](int i, const T*& from, uint32_t& bytes) {
      const int c = i / v.rows;
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          row_ptr(c, v.y0 + i - c * v.rows) + v.x0);
      const uintptr_t lo = a & ~uintptr_t{15};
      from = reinterpret_cast<const T*>(lo);
      bytes = static_cast<uint32_t>(
          ((a + v.cols * sizeof(T) + 15) & ~uintptr_t{15}) - lo);
      return c;
    };
    uint32_t expect[3] = {0u, 0u, 0u};
    for (int i = lane; i < 3 * v.rows; i += 32) {
      const T* from;
      uint32_t bytes;
      const int c = span(i, from, bytes);
      expect[c] += bytes;
    }
    for (int c = 0; c < 3; ++c) {
      expect[c] = __reduce_add_sync(0xffffffffu, expect[c]);
    }
    if (lane == 0) {
      if (kSplit) {
        for (int c = 0; c < 3; ++c) mbar_expect(&bars[slot][c], expect[c]);
      } else {
        mbar_expect(&bars[slot][0], expect[0] + expect[1] + expect[2]);
      }
      if (stats != nullptr) {
        atomicAdd(&stats[0], static_cast<unsigned long long>(
                                 expect[0] + expect[1] + expect[2]));
        if (cut) atomicAdd(&stats[1], 1ull);
      }
    }
    __syncwarp();
    for (int i = lane; i < 3 * v.rows; i += 32) {
      const T* from;
      uint32_t bytes;
      const int c = span(i, from, bytes);
      bulk_copy(buf + c * cap + (i - c * v.rows) * v.pitch, from, bytes,
                &bars[slot][kSplit ? c : 0]);
    }
  };

  // Channel c of this thread's pixel at (x, y) from buffer `slot`, taps
  // outside the staged window from global memory.
  auto sample = [&](int slot, float x, float y, int c, int col) {
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

    auto tap = [&](bool valid, int iy, int ix) -> float {
      if (!valid) return 0.0f;
      const T* const rp = row_ptr(c, iy);
      const int ry = iy - v.y0;
      const int rx = ix - v.x0;
      if (static_cast<unsigned>(ry) < static_cast<unsigned>(v.rows) &&
          static_cast<unsigned>(rx) < static_cast<unsigned>(v.cols)) {
        const int shift = static_cast<int>(
            (reinterpret_cast<uintptr_t>(rp + v.x0) & 15) / sizeof(T));
        return widen(buf[c * cap + ry * v.pitch + shift + rx]);
      }
      return widen(rp[ix]);
    };

    const float t00 = tap(vy0 && vx0, iy0, ix0);
    const float t01 = tap(vy0 && vx1, iy0, ix1);
    const float t10 = tap(vy1 && vx0, iy1, ix0);
    const float t11 = tap(vy1 && vx1, iy1, ix1);
    const float top = t00 * (1.0f - dx) + t01 * dx;
    const float bot = t10 * (1.0f - dx) + t11 * dx;
    orow[c * static_cast<int64_t>(p) + col] = top * (1.0f - dy) + bot * dy;
  };

  // this thread's pixel of column block j: whether it is in the grid,
  // and its coordinates
  auto load = [&](int j, float& x, float& y) -> bool {
    const int col = j * cw + col_in;
    if (row >= gh || col >= gw) return false;
    x = xg[static_cast<int64_t>(row) * gw + col];
    y = yg[static_cast<int64_t>(row) * gw + col];
    return true;
  };

  float x = 0.0f, y = 0.0f, xn = 0.0f, yn = 0.0f;
  bool active = load(0, x, y);
  if (tid < 32) plan_and_issue(0, 0);
  for (int j = 0; j < n_blocks; ++j) {
    const int slot = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    const int col = j * cw + col_in;
    // block j + 1's coordinates and copies overlap block j's sampling; its
    // buffer was freed by the barrier that ended block j - 1
    const bool active_n = j + 1 < n_blocks && load(j + 1, xn, yn);
    if (tid < 32 && j + 1 < n_blocks) plan_and_issue(slot ^ 1, j + 1);
    if (kSplit) {
      for (int c = 0; c < 3; ++c) {
        mbar_wait(&bars[slot][c], parity);
        if (active) sample(slot, x, y, c, col);
      }
    } else {
      mbar_wait(&bars[slot][0], parity);
      if (active) {
        for (int c = 0; c < 3; ++c) sample(slot, x, y, c, col);
      }
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
           int cap, float* out, unsigned long long* stats, void* stream) {
  if (batch == 0 || groups == 0 || gh == 0 || gw == 0) return 0;
  const int smem = 2 * 3 * cap * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      warp_strips_staged_kernel<T, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (gh + rt - 1) / rt;
  const dim3 grid(groups * tiles, batch);
  const T* end = planes + static_cast<int64_t>(batch) * 3 * h * w;
  warp_strips_staged_kernel<T, kSplit>
      <<<grid, rt * cw, smem, static_cast<cudaStream_t>(stream)>>>(
          planes, h, w, end, xs, ys, gh, gw, rt, cw, cap, groups * gh * gw,
          out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: [batch, 3, h, w] contiguous, 16-byte aligned; xs, ys: [batch,
// groups, gh, gw] f32 contiguous (one frame's grids, all its faces, side
// by side); out: [batch, 3, groups * gh * gw] f32 contiguous.  Blocks of
// rt x cw output pixels, rt * cw threads a CTA (a multiple of 32, at most
// 1024); cap: elements of one channel's window in each of the two shared
// buffers (a multiple of 16 bytes).  batch <= 65535.  stats: null, or two
// device counters the launch adds to (bytes the windows' copies moved,
// blocks whose window does not hold all their taps).  Launches on `stream`
// and returns the CUDA error of the attribute call or of the launch.
#define STAGED_ENTRY(name, T, split)                                        \
  extern "C" int name(const T* planes, int batch, int h, int w,             \
                      const float* xs, const float* ys, int groups, int gh, \
                      int gw, int rt, int cw, int cap, float* out,          \
                      unsigned long long* stats, void* stream) {            \
    return launch<T, split>(planes, batch, h, w, xs, ys, groups, gh, gw,    \
                            rt, cw, cap, out, stats, stream);               \
  }

STAGED_ENTRY(warp_strips_staged_fused_bf16, __nv_bfloat16, false)
STAGED_ENTRY(warp_strips_staged_fused_f32, float, false)
STAGED_ENTRY(warp_strips_staged_split_bf16, __nv_bfloat16, true)
STAGED_ENTRY(warp_strips_staged_split_f32, float, true)
