// A run of identity-skip residual blocks on bf16 activations in one pass
// over device memory: for each of `layers` layers l,
//
//     y = bf16(bf16(DW3x3(x, wd[l])) + bd[l])    zero SAME padding
//     z = bf16(bf16(PW1x1(y, wp[l])) + bp[l])    C -> C
//     x = relu(bf16(z + x))
//
// on NCHW bf16 activations [batch, c, h, w], every sum in f32 and every
// rounding where the per-op bf16 sequence (fused_block.fused_blocks_plain,
// the lowered bf16 net op by op) rounds.  The BACK detector runs four
// such runs of seven blocks (128x128x24, 64x64x24, 32x32x48, 16x16x96).
//
// Replaces docs/experiments/fused_block_v2.py::kernel (K4), the Pallas TPU
// kernel that runs K fused layers in bf16 per VMEM residency of a row
// chunk with a K-row halo and feeds its MXU a bf16 depthwise output.  The
// same idea on Hopper: one CTA owns one spatial tile of one frame, stages
// the tile plus a `layers`-pixel halo in shared memory and runs every
// layer of the launch there; only the run's input is read and its output
// written.
//
// Bound: at the detector's shapes, bytes (2 x 2 B x c per pixel for the
// whole run against 2 (9c + c^2) + 4c flops per pixel per layer, most of
// them the 1x1's).  What the design does about it:
//   * The 1x1, 69-90% of the operations, runs on the tensor cores:
//     mma.sync.m16n8k16 (and m16n8k8 for a channel tail of 8), bf16 x bf16
//     -> f32.  Not wgmma: its A operand is the depthwise output, which is
//     computed here per thread in the mma fragment's own layout (so it is
//     never stored to shared memory), and wgmma's A-in-registers layout
//     needs 64-row warpgroup tiles of an irregular, shrinking pixel region;
//     at c <= 96 the 1x1 at mma.sync's rate is a small part of the
//     kernel's time next to the depthwise on the CUDA cores.
//   * Activations live in shared memory as bf16, pixel-major with channels
//     contiguous (c/2 + 2 words per pixel, so the eight pixels of a
//     fragment fall in distinct banks), in two buffers: layer l reads one
//     and writes the other, so no warp waits for another between the
//     depthwise and the 1x1, and there is one barrier per layer.
//   * Only the current layer's weights are in shared memory, in the form
//     the kernel reads (the wrapper packs them once); the next layer's
//     arrive by cp.async while this one computes.
//   * The staged box is clipped to the image plus its one-pixel zero
//     border, and each layer computes only in-image pixels: out-of-image
//     positions stay zero (the next layer's SAME padding) without being
//     rewritten, and a tile that covers a small image recomputes nothing.
//   * The depthwise runs on CUDA cores with f32 sums: each lane owns two
//     horizontally adjacent pixels (mma rows g and g + 8) and its
//     fragment's channel pairs, so the 3x3 windows of the two pixels share
//     six of their twelve loads.
// The wrapper (fused_block.plan with 2-byte activations) trades recomputed
// halo against launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 8;  // staging units loaded together per thread

// The packed weights of one layer, as fused_block.pack_bf16 lays them out
// (bytes): wp [c][ws(c)] bf16 (the 1x1 as [c_out][c_in], zero padding
// columns), then wd [9][c] f32, bd [c] f32, bp [c] f32, all with bf16
// values.  The row stride ws keeps the eight rows a B fragment reads in
// distinct banks.
__host__ __device__ constexpr int weight_stride(int c) {
  return c % 16 == 0 ? c + 8 : c;
}
__host__ __device__ constexpr int blob_bytes(int c) {
  return 2 * c * weight_stride(c) + 44 * c;
}
// 32-bit words per staged pixel: c/2 channel pairs and two words of
// padding, so pixels two apart are 4 banks apart (c % 8 == 0)
__host__ __device__ constexpr int pixel_words(int c) { return c / 2 + 2; }

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

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// NaN-propagating relu, as torch.relu
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t* a,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// One layer's packed weights into shared memory, 16 bytes per cp.async;
// one commit group.
__device__ __forceinline__ void fetch_weights(uint8_t* dst,
                                              const uint8_t* src, int bytes) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16 * i),
                 "l"(src + 16 * i));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The depthwise 3x3 + bias of channels (k, k + 1) at two horizontally
// adjacent staged pixels: `p` points at channel pair k of the pixel left
// of the first one, one row up.  Returns the pair at each pixel, rounded
// as the per-op sequence rounds, packed as the mma operand.
template <int C>
__device__ __forceinline__ void depthwise(const uint32_t* p, int row_words,
                                          const float* wd, const float* bd,
                                          int k, uint32_t& out_a,
                                          uint32_t& out_b) {
  constexpr int kPix = pixel_words(C);
  float2 a = make_float2(0.0f, 0.0f);
  float2 b = a;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const uint32_t* r = p + dy * row_words;
    const float2 v0 = unpack(r[0]);
    const float2 v1 = unpack(r[kPix]);
    const float2 v2 = unpack(r[2 * kPix]);
    const float2 v3 = unpack(r[3 * kPix]);
    const float2 w0 = *reinterpret_cast<const float2*>(wd + (3 * dy) * C + k);
    const float2 w1 =
        *reinterpret_cast<const float2*>(wd + (3 * dy + 1) * C + k);
    const float2 w2 =
        *reinterpret_cast<const float2*>(wd + (3 * dy + 2) * C + k);
    a.x = __fmaf_rn(w0.x, v0.x, a.x); a.y = __fmaf_rn(w0.y, v0.y, a.y);
    a.x = __fmaf_rn(w1.x, v1.x, a.x); a.y = __fmaf_rn(w1.y, v1.y, a.y);
    a.x = __fmaf_rn(w2.x, v2.x, a.x); a.y = __fmaf_rn(w2.y, v2.y, a.y);
    b.x = __fmaf_rn(w0.x, v1.x, b.x); b.y = __fmaf_rn(w0.y, v1.y, b.y);
    b.x = __fmaf_rn(w1.x, v2.x, b.x); b.y = __fmaf_rn(w1.y, v2.y, b.y);
    b.x = __fmaf_rn(w2.x, v3.x, b.x); b.y = __fmaf_rn(w2.y, v3.y, b.y);
  }
  const float2 bias = *reinterpret_cast<const float2*>(bd + k);
  out_a = pack(round_bf16(a.x) + bias.x, round_bf16(a.y) + bias.y);
  out_b = pack(round_bf16(b.x) + bias.x, round_bf16(b.y) + bias.y);
}

// Stages a box of the image (rows [by0, by0 + bh), columns [bx0, bx0 +
// bw), which may reach one pixel past the image on each side) into `act`:
// each staged pixel's c/2 channel pairs, zeros outside the image, and the
// same zeros in the second buffer (at `act` + act_words).  kSpan pixels
// per load along x: 2 reads each channel's pixel pairs at even columns
// as 4-byte words (the image width even, so a pair lies wholly inside or
// outside the image), 1 reads single pixels.
template <int C, int kSpan>
__device__ __forceinline__ void stage(const uint16_t* __restrict__ xb,
                                      uint32_t* act, int act_words,
                                      int plane, int h, int w, int by0,
                                      int bx0, int bh, int bw) {
  constexpr int kPix = pixel_words(C);
  const int q0 = kSpan == 2 ? (bx0 + 2) / 2 - 1 : bx0;  // floor(bx0 / 2)
  const int nq = (bx0 + bw + kSpan - 1) / kSpan - q0;
  for (Walk it(threadIdx.x, kThreads, bh, nq); it.k < C / 2;) {
    uint32_t a[kInFlight], b[kInFlight];
    int pair[kInFlight], row[kInFlight], col[kInFlight];
    bool outside[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      pair[u] = -1;
      a[u] = b[u] = 0u;
      row[u] = col[u] = 0;
      outside[u] = true;
      if (it.k < C / 2) {
        const int gy = by0 + it.ry;
        const int gx = (q0 + it.rx) * kSpan;
        pair[u] = it.k;
        row[u] = it.ry;
        col[u] = gx - bx0;
        outside[u] = gy < 0 || gy >= h || gx < 0 || gx >= w;
        if (!outside[u]) {
          const int at = 2 * it.k * plane + gy * w + gx;
          if constexpr (kSpan == 2) {
            a[u] = __ldg(reinterpret_cast<const uint32_t*>(xb + at));
            b[u] = __ldg(reinterpret_cast<const uint32_t*>(xb + at + plane));
          } else {
            a[u] = __ldg(xb + at);
            b[u] = __ldg(xb + at + plane);
          }
        }
        it.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (pair[u] < 0) continue;
#pragma unroll
      for (int i = 0; i < kSpan; ++i) {
        const int c = col[u] + i;
        if (c < 0 || c >= bw) continue;
        // channel 2k in the low half, 2k + 1 in the high half
        const uint32_t v = i == 0 ? (a[u] & 0xffffu) | (b[u] << 16)
                                  : (a[u] >> 16) | (b[u] & 0xffff0000u);
        const int at = (row[u] * bw + c) * kPix + pair[u];
        act[at] = v;
        if (outside[u]) act[act_words + at] = 0u;
      }
    }
  }
}

// Writes the tile at image rows [ty0, ty0 + tile) and columns [tx0, tx0 +
// tile) (within the image) from the staged box `res` back to the NCHW
// output; kSpan 2 stores each channel's pixel pairs as 4-byte words (even
// tile and image widths).
template <int C, int kSpan>
__device__ __forceinline__ void write_back(const uint32_t* res,
                                           uint16_t* __restrict__ ob,
                                           int plane, int h, int w, int ty0,
                                           int tx0, int tile, int by0,
                                           int bx0, int bw) {
  constexpr int kPix = pixel_words(C);
  const int th = min(tile, h - ty0), tw = min(tile, w - tx0);
  for (Walk it(threadIdx.x, kThreads, th, tw / kSpan); it.k < C / 2;
       it.next()) {
    const int gy = ty0 + it.ry;
    const int gx = tx0 + it.rx * kSpan;
    const int from = ((gy - by0) * bw + gx - bx0) * kPix + it.k;
    const int at = 2 * it.k * plane + gy * w + gx;
    if constexpr (kSpan == 2) {
      const uint32_t v0 = res[from], v1 = res[from + kPix];
      *reinterpret_cast<uint32_t*>(ob + at) = (v0 & 0xffffu) | (v1 << 16);
      *reinterpret_cast<uint32_t*>(ob + at + plane) =
          (v0 >> 16) | (v1 & 0xffff0000u);
    } else {
      const uint32_t v = res[from];
      ob[at] = static_cast<uint16_t>(v & 0xffffu);
      ob[at + plane] = static_cast<uint16_t>(v >> 16);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    fused_blocks_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ out,
                             const uint8_t* __restrict__ weights, int h,
                             int w, int layers, int tile, int tiles_x,
                             int box_pixels) {
  constexpr int kPix = pixel_words(C);
  constexpr int kWs = weight_stride(C);
  constexpr int kBlob = blob_bytes(C);
  constexpr int kK16 = C / 16;          // full k16 steps of the 1x1
  constexpr int kTail = (C % 16) / 8;   // a last k8 step
  constexpr int kA = 4 * kK16 + 2 * kTail;   // A fragment words per lane
  constexpr int kN = C / 8;             // n8 tiles of the 1x1
  constexpr int kB = kN * (2 * kK16 + kTail);   // B fragment words
  constexpr bool kBInRegs = kB <= 40;   // c <= 48: held for the layer

  // two activation buffers of box_pixels staged pixels, then two layers'
  // weights (buffer i at base + i * size: no arrays of pointers, which
  // would live in local memory)
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* const act = reinterpret_cast<uint32_t*>(smem);
  const int act_words = box_pixels * kPix;
  uint8_t* const wbuf = smem + 2 * 4 * act_words;

  // issue layer 0's weights first: they arrive while the tile is staged
  fetch_weights(wbuf, weights, kBlob);

  const int plane = h * w;
  const int64_t frame = static_cast<int64_t>(blockIdx.y) * C * plane;
  const int tile_y = blockIdx.x / tiles_x;
  const int tile_x = blockIdx.x - tile_y * tiles_x;
  const int oy = tile_y * tile - layers;  // image row of the unclipped box
  const int ox = tile_x * tile - layers;
  const int e = tile + 2 * layers;
  // the box, clipped to the image and its one-pixel zero border
  const int by0 = max(oy, -1), by1 = min(oy + e, h + 1);
  const int bx0 = max(ox, -1), bx1 = min(ox + e, w + 1);
  const int bh = by1 - by0, bw = bx1 - bx0;

  // stage the box into buffer 0, and zeros at buffer 1's out-of-image
  // pixels, which no layer writes; pixel pairs (4-byte loads) where the
  // rows allow it
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) + frame;
  if (w % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) {
    stage<C, 2>(xb, act, act_words, plane, h, w, by0, bx0, bh, bw);
  } else {
    stage<C, 1>(xb, act, act_words, plane, h, w, by0, bx0, bh, bw);
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;   // mma row group: pixel pair g of an m-tile
  const int t = lane % 4;   // channel pair within each 8 channels

  int cur = 0;
  for (int l = 0; l < layers; ++l) {
    if (l + 1 < layers) {
      fetch_weights(wbuf + ((l + 1) & 1) * kBlob, weights + (l + 1) * kBlob,
                    kBlob);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();   // layer l's weights and input visible to every warp

    const uint8_t* wl = wbuf + (l & 1) * kBlob;
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(wl);
    const float* wd = reinterpret_cast<const float*>(wl + 2 * C * kWs);
    const float* bd = wd + 9 * C;
    const float* bp = bd + C;
    const uint32_t* src = act + cur * act_words;
    uint32_t* dst = act + (cur ^ 1) * act_words;

    // this layer's region: the box shrunk by l + 1 on unclipped sides,
    // within the image (box coordinates)
    const int r0 = max(oy + l + 1, 0) - by0;
    const int r1 = min(oy + e - l - 1, h) - by0;
    const int c0 = max(ox + l + 1, 0) - bx0;
    const int c1 = min(ox + e - l - 1, w) - bx0;
    const int rw = c1 - c0;
    const int pairs_row = (rw + 1) / 2;
    const int pairs = (r1 - r0) * pairs_row;

    // B fragments: b0 = W[n][k0 + 2t..], b1 = W[n][k0 + 8 + 2t..], n the
    // lane's column g of each n8 tile
    uint32_t breg[kBInRegs ? kB : 1];
    if constexpr (kBInRegs) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const uint32_t* row = wp + ((8 * n + g) * kWs) / 2 + t;
#pragma unroll
        for (int s = 0; s < kK16; ++s) {
          breg[n * (2 * kK16 + kTail) + 2 * s] = row[8 * s];
          breg[n * (2 * kK16 + kTail) + 2 * s + 1] = row[8 * s + 4];
        }
        if constexpr (kTail) {
          breg[n * (2 * kK16 + kTail) + 2 * kK16] = row[8 * kK16];
        }
      }
    }

    for (int m = warp; m * 8 < pairs; m += kWarps) {
      const int j = min(m * 8 + g, pairs - 1);
      const bool valid = m * 8 + g < pairs;
      const int pr = j / pairs_row;
      const int pc = 2 * (j - pr * pairs_row);
      const bool valid_b = valid && pc + 1 < rw;
      const int pix = (r0 + pr) * bw + c0 + pc;   // the pair's left pixel

      // A: the depthwise output of the pair's two pixels at the lane's
      // channel pairs (rows g and g + 8 of the fragment)
      uint32_t a[kA];
      const uint32_t* win = src + (pix - bw - 1) * kPix;
#pragma unroll
      for (int s = 0; s < kK16; ++s) {
        depthwise<C>(win + 8 * s + t, bw * kPix, wd, bd, 16 * s + 2 * t,
                     a[4 * s], a[4 * s + 1]);
        depthwise<C>(win + 8 * s + 4 + t, bw * kPix, wd, bd,
                     16 * s + 8 + 2 * t, a[4 * s + 2], a[4 * s + 3]);
      }
      if constexpr (kTail) {
        depthwise<C>(win + 8 * kK16 + t, bw * kPix, wd, bd,
                     16 * kK16 + 2 * t, a[4 * kK16], a[4 * kK16 + 1]);
      }

      // 1x1 per n8 tile, then bias, residual and relu in registers
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < kK16; ++s) {
          uint32_t b0, b1;
          if constexpr (kBInRegs) {
            b0 = breg[n * (2 * kK16 + kTail) + 2 * s];
            b1 = breg[n * (2 * kK16 + kTail) + 2 * s + 1];
          } else {
            const uint32_t* row = wp + ((8 * n + g) * kWs) / 2 + t;
            b0 = row[8 * s];
            b1 = row[8 * s + 4];
          }
          mma_k16(acc, a + 4 * s, b0, b1);
        }
        if constexpr (kTail) {
          uint32_t b0;
          if constexpr (kBInRegs) {
            b0 = breg[n * (2 * kK16 + kTail) + 2 * kK16];
          } else {
            b0 = wp[((8 * n + g) * kWs) / 2 + t + 8 * kK16];
          }
          mma_k8(acc, a + 4 * kK16, b0);
        }
        const int ch = 8 * n + 2 * t;   // the lane's output channel pair
        const float2 bias = *reinterpret_cast<const float2*>(bp + ch);
        const int at = pix * kPix + ch / 2;
        if (valid) {
          const float2 r = unpack(src[at]);
          dst[at] = pack(
              relu(round_bf16(round_bf16(round_bf16(acc[0]) + bias.x) + r.x)),
              relu(round_bf16(round_bf16(round_bf16(acc[1]) + bias.y) + r.y)));
        }
        if (valid_b) {
          const float2 r = unpack(src[at + kPix]);
          dst[at + kPix] = pack(
              relu(round_bf16(round_bf16(round_bf16(acc[2]) + bias.x) + r.x)),
              relu(round_bf16(round_bf16(round_bf16(acc[3]) + bias.y) + r.y)));
        }
      }
    }
    __syncthreads();   // layer l written before layer l + 1 reads it
    cur ^= 1;
  }

  // write the tile (the last layer's region) back
  const uint32_t* res = act + cur * act_words;
  uint16_t* ob = reinterpret_cast<uint16_t*>(out) + frame;
  if (w % 2 == 0 && tile % 2 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 4 == 0) {
    write_back<C, 2>(res, ob, plane, h, w, tile_y * tile, tile_x * tile,
                     tile, by0, bx0, bw);
  } else {
    write_back<C, 1>(res, ob, plane, h, w, tile_y * tile, tile_x * tile,
                     tile, by0, bx0, bw);
  }
}

template <int C>
int launch(const __nv_bfloat16* x, __nv_bfloat16* out,
           const uint8_t* weights, int batch, int h, int w, int layers,
           int tile, void* stream) {
  const int e = tile + 2 * layers;
  const int box_pixels = std::min(e, h + 2) * std::min(e, w + 2);
  const size_t smem = 2 * sizeof(uint32_t) * static_cast<size_t>(box_pixels) *
                          pixel_words(C) +
                      2 * static_cast<size_t>(blob_bytes(C));
  int device = 0;
  int limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_blocks_bf16_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + tile - 1) / tile;
  const int tiles_y = (h + tile - 1) / tile;
  const dim3 grid(tiles_x * tiles_y, batch);
  fused_blocks_bf16_kernel<C><<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      x, out, weights, h, w, layers, tile, tiles_x, box_pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [batch, c, h, w] bf16 contiguous, distinct buffers, c*h*w < 2^31;
// weights: `layers` packed layers (fused_block.pack_bf16), 16-byte
// aligned; c one of 24, 48, 96 (the detectors' runs); batch <= 65535; the tile
// must fit shared memory: 8 box (c/2 + 2) + 2 blob(c) bytes, box =
// min(tile + 2 layers, h + 2) x min(tile + 2 layers, w + 2).  Launches on
// `stream` and returns a cudaError_t (0 on success).
extern "C" int fused_dw_pw_block_bf16(const __nv_bfloat16* x,
                                      __nv_bfloat16* out,
                                      const uint8_t* weights, int batch,
                                      int c, int h, int w, int layers,
                                      int tile, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  if (layers < 1 || tile < 1 || batch > 65535 ||
      static_cast<int64_t>(c) * h * w >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (c) {
    case 24: return launch<24>(x, out, weights, batch, h, w, layers, tile, stream);
    case 48: return launch<48>(x, out, weights, batch, h, w, layers, tile, stream);
    case 96: return launch<96>(x, out, weights, batch, h, w, layers, tile, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
