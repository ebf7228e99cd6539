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
// chunk with a K-row halo.  The same idea on Hopper: one CTA owns one
// spatial tile of one frame, stages the tile plus a `layers`-pixel halo in
// shared memory and runs every layer of the launch there; only the run's
// input is read and its output written.
//
// Bound: operations (2 (9c + c^2) + 4c flops per pixel per layer against
// 2 x 4 B x c per pixel for the whole run), 69-90% of them the 1x1's.
// What the design does about it:
//   * The 1x1 leaves the f32 FMA units: split-TF32 ("3xTF32") on the
//     tensor cores.  Each f32 operand v is split into hi = tf32(v) and
//     lo = tf32(v - hi) (cvt.rna), and mma.sync.m16n8k8.tf32 accumulates
//     lo*hi + hi*lo + hi*hi in f32: close to f32 accuracy (the dropped
//     lo*lo term is ~2^-22 of each product), where one-pass TF32 keeps
//     ~3 decimal digits.  Not wgmma, for the reason fused_dw_pw_block_bf16.cu
//     gives: the A operand, the depthwise output, is computed per lane in
//     the mma fragment's layout and never stored.  The fragment's k index
//     is permuted so that a lane's two k values are one channel pair
//     (float2 loads); the weights' rows follow the same permutation.
//   * Activations live in shared memory pixel-major, padded to c + 2 or
//     c + 4 floats per pixel (pixel_floats), so the pixels of a warp's
//     lanes and their channel pairs fall in distinct banks; two buffers:
//     layer l reads one and writes the other, one barrier per layer.
//   * Only the current layer's weights are in shared memory, in the form
//     the kernel reads (fused_block.pack_f32: the 1x1 as [c_in][c + 4], the
//     taps as [9][c]); the next layer's arrive by cp.async while this one
//     computes.  So more layers per launch fit, with larger tiles.
//   * The staged box is clipped to the image plus its one-pixel zero
//     border, and each layer computes only in-image pixels: out-of-image
//     positions stay zero (the next layer's SAME padding), and a tile that
//     covers a small image recomputes nothing.
//   * The depthwise runs on the CUDA cores: each lane owns four (c <= 48)
//     or two horizontally adjacent pixels (rows g and g + 8 of one or two
//     m16 tiles) and one channel pair, so the 3x3 windows of its pixels
//     share their loads (18 for four pixels, 12 for two) and the taps'
//     weights are loaded once for all of them.  For c = 24 the layer's
//     split 1x1 weights stay in registers.
// The depthwise and every FMA part are explicit __fmaf_rn in a fixed
// order (built with -fmad=false).  The wrapper (fused_block.plan) trades
// recomputed halo against launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Adjacent pixels along x a lane owns in a layer's depthwise and mma
// rows: four (two m16 tiles a warp step) for c <= 48, two for c = 96,
// whose accumulators would not fit four.
__host__ __device__ constexpr int lane_pixels(int c) { return c <= 48 ? 4 : 2; }
// floats per staged pixel: the lanes of a half warp read pixels
// lane_pixels apart at channel pairs 2t, so lane_pixels * stride must be 8
// or 24 words modulo 32 (c % 8 == 0)
__host__ __device__ constexpr int pixel_floats(int c) {
  return lane_pixels(c) == 4 ? c + 2 : c + 4;
}
// the row stride of the packed 1x1
__host__ __device__ constexpr int weight_stride(int c) { return c + 4; }
// floats of one layer's packed weights (fused_block.pack_f32): wp
// [c_in][weight_stride(c)], wd [9][c], bd [c], bp [c]
__host__ __device__ constexpr int blob_floats(int c) {
  return c * weight_stride(c) + 11 * c;
}

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

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v ~ hi + lo, both tf32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One layer's packed weights into shared memory, 16 bytes per cp.async;
// one commit group.
__device__ __forceinline__ void fetch_weights(float* dst, const float* src,
                                              int floats) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < floats / 4; i += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16 * i),
                 "l"(src + 4 * i));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The depthwise 3x3 + bias of channels (k, k + 1) at kP horizontally
// adjacent staged pixels: `p` points at channel k of the pixel left of the
// first one, one row up.  Returns the pair at pixel i in y[i].
template <int C, int kP>
__device__ __forceinline__ void depthwise(const float* p, int row_floats,
                                          const float* wd, const float* bd,
                                          int k, float2 (&y)[kP]) {
  constexpr int kPix = pixel_floats(C);
  const float2 bias = *reinterpret_cast<const float2*>(bd + k);
#pragma unroll
  for (int i = 0; i < kP; ++i) y[i] = bias;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const float* r = p + dy * row_floats;
    float2 v[kP + 2];
#pragma unroll
    for (int i = 0; i < kP + 2; ++i) {
      v[i] = *reinterpret_cast<const float2*>(r + i * kPix);
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float2 wt =
          *reinterpret_cast<const float2*>(wd + (3 * dy + dx) * C + k);
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        y[i].x = __fmaf_rn(wt.x, v[i + dx].x, y[i].x);
        y[i].y = __fmaf_rn(wt.y, v[i + dx].y, y[i].y);
      }
    }
  }
}

// A lane's pixel group in a layer's region [r0, r1) x [c0, c0 + rw) (box
// coordinates): groups of kP adjacent pixels along x, row by row, group
// j = 8 m + g for warp step m and mma row group g.
template <int kP>
struct Group {
  int pix;     // the group's first pixel (box index)
  int count;   // its pixels in the region: 0 past the region's end
  __device__ __forceinline__ Group(int j, int groups, int groups_row, int bw,
                                   int r0, int c0, int rw) {
    const int jj = min(j, groups - 1);
    const int pr = jj / groups_row;
    const int pc = kP * (jj - pr * groups_row);
    pix = (r0 + pr) * bw + c0 + pc;
    count = j < groups ? min(kP, rw - pc) : 0;
  }
};

// Stages a box of the image (rows [by0, by0 + bh), columns [bx0, bx0 +
// bw), which may reach one pixel past the image on each side) into `act`,
// pixel-major, zeros outside the image, and the same zeros in the second
// buffer (at `act` + act_floats).  Every value is a 4-byte cp.async (zero
// filled outside the image), all in flight at once; one commit group.
template <int C>
__device__ __forceinline__ void stage(const float* __restrict__ xb,
                                      float* act, int act_floats, int plane,
                                      int h, int w, int by0, int bx0, int bh,
                                      int bw) {
  constexpr int kPix = pixel_floats(C);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(act));
  for (Walk it(threadIdx.x, kThreads, bh, bw); it.k < C; it.next()) {
    const int gy = by0 + it.ry;
    const int gx = bx0 + it.rx;
    const int at = (it.ry * bw + it.rx) * kPix + it.k;
    const bool outside = gy < 0 || gy >= h || gx < 0 || gx >= w;
    const float* src = outside ? xb : xb + it.k * plane + gy * w + gx;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     base + 4 * at),
                 "l"(src), "r"(outside ? 0 : 4));
    if (outside) act[act_floats + at] = 0.0f;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One layer on the tensor cores: the depthwise of `src`'s region [r0, r1)
// x [c0, c0 + rw) (box coordinates) straight into split-TF32 A fragments,
// the 1x1 as three mma products per k8 x n8 step, then bias, residual
// and relu into `dst`.  A warp step takes 8 lane groups of kP adjacent
// pixels: kP / 2 m16 tiles, tile i's rows g and g + 8 the group's pixels
// 2i and 2i + 1.  For c = 24 the layer's B fragments, split, stay in
// registers; wider layers load and split them once per warp step.
template <int C>
__device__ __forceinline__ void layer_tc(const float* src, float* dst,
                                         const float* wp, const float* wd,
                                         const float* bd, const float* bp,
                                         int bw, int r0, int r1, int c0,
                                         int rw) {
  constexpr int kPix = pixel_floats(C);
  constexpr int kWs = weight_stride(C);
  constexpr int kN = C / 8;   // n8 tiles and k8 steps
  constexpr int kP = lane_pixels(C);
  constexpr int kT = kP / 2;  // m16 tiles a warp step
  constexpr bool kBInRegs = C <= 24;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // mma row group
  const int t = lane % 4;     // channel pair within each 8 channels
  const int groups_row = (rw + kP - 1) / kP;
  const int groups = (r1 - r0) * groups_row;

  // B: b0 = W[k = t][n = g] (input channel 8s + 2t), b1 = W[k = t + 4][g]
  // (input channel 8s + 2t + 1), output channel 8n + g
  uint32_t bhi[kBInRegs ? 2 * kN * kN : 1], blo[kBInRegs ? 2 * kN * kN : 1];
  if constexpr (kBInRegs) {
#pragma unroll
    for (int s = 0; s < kN; ++s) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float* wr = wp + (8 * s + 2 * t) * kWs + 8 * n + g;
        split(wr[0], bhi[2 * (s * kN + n)], blo[2 * (s * kN + n)]);
        split(wr[kWs], bhi[2 * (s * kN + n) + 1], blo[2 * (s * kN + n) + 1]);
      }
    }
  }

  for (int m = threadIdx.x / 32; m * 8 < groups; m += kWarps) {
    const Group<kP> grp(m * 8 + g, groups, groups_row, bw, r0, c0, rw);
    const float* win = src + (grp.pix - bw - 1) * kPix + 2 * t;

    float acc[kT][kN][4];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.0f;
      }
    }
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      float2 y[kP];
      depthwise<C, kP>(win + 8 * s, bw * kPix, wd, bd, 8 * s + 2 * t, y);
      // A of tile i: rows g, g + 8 = pixels 2i, 2i + 1; k = t is channel
      // 8s + 2t, k = t + 4 channel 8s + 2t + 1
      uint32_t ahi[kT][4], alo[kT][4];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        split(y[2 * i].x, ahi[i][0], alo[i][0]);
        split(y[2 * i + 1].x, ahi[i][1], alo[i][1]);
        split(y[2 * i].y, ahi[i][2], alo[i][2]);
        split(y[2 * i + 1].y, ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        uint32_t b0hi, b0lo, b1hi, b1lo;
        if constexpr (kBInRegs) {
          b0hi = bhi[2 * (s * kN + n)];
          b0lo = blo[2 * (s * kN + n)];
          b1hi = bhi[2 * (s * kN + n) + 1];
          b1lo = blo[2 * (s * kN + n) + 1];
        } else {
          const float* wr = wp + (8 * s + 2 * t) * kWs + 8 * n + g;
          split(wr[0], b0hi, b0lo);
          split(wr[kWs], b1hi, b1lo);
        }
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          mma_tf32(acc[i][n], alo[i], b0hi, b1hi);
          mma_tf32(acc[i][n], ahi[i], b0lo, b1lo);
          mma_tf32(acc[i][n], ahi[i], b0hi, b1hi);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int ch = 8 * n + 2 * t;   // the lane's output channel pair
      const float2 bias = *reinterpret_cast<const float2*>(bp + ch);
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        if (q < grp.count) {
          const int at = (grp.pix + q) * kPix + ch;
          const float2 r = *reinterpret_cast<const float2*>(src + at);
          const float* d = acc[q / 2][n] + 2 * (q % 2);
          *reinterpret_cast<float2*>(dst + at) = make_float2(
              relu(d[0] + bias.x + r.x), relu(d[1] + bias.y + r.y));
        }
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    fused_blocks_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float* __restrict__ weights, int h, int w,
                        int layers, int tile, int tiles_x, int box_pixels) {
  constexpr int kPix = pixel_floats(C);
  constexpr int kBlob = blob_floats(C);

  // two activation buffers of box_pixels staged pixels, then two layers'
  // weights
  extern __shared__ __align__(16) float smem[];
  float* const act = smem;
  const int act_floats = box_pixels * kPix;
  float* const wbuf = smem + 2 * act_floats;

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

  stage<C>(x + frame, act, act_floats, plane, h, w, by0, bx0, bh, bw);

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

    const float* wp = wbuf + (l & 1) * kBlob;
    const float* wd = wp + C * weight_stride(C);
    const float* bd = wd + 9 * C;
    const float* bp = bd + C;
    // this layer's region: the box shrunk by l + 1 on unclipped sides,
    // within the image (box coordinates)
    const int r0 = max(oy + l + 1, 0) - by0;
    const int r1 = min(oy + e - l - 1, h) - by0;
    const int c0 = max(ox + l + 1, 0) - bx0;
    const int rw = min(ox + e - l - 1, w) - bx0 - c0;
    layer_tc<C>(act + cur * act_floats, act + (cur ^ 1) * act_floats, wp, wd,
                bd, bp, bw, r0, r1, c0, rw);
    cur ^= 1;
    __syncthreads();   // layer l written before layer l + 1 reads it
  }

  // write the tile (the last layer's region) back
  const float* res = act + cur * act_floats;
  float* ob = out + frame;
  const int ty0 = tile_y * tile, tx0 = tile_x * tile;
  const int th = min(tile, h - ty0), tw = min(tile, w - tx0);
  for (Walk it(threadIdx.x, kThreads, th, tw); it.k < C; it.next()) {
    const int gy = ty0 + it.ry;
    const int gx = tx0 + it.rx;
    ob[it.k * plane + gy * w + gx] =
        res[((gy - by0) * bw + gx - bx0) * kPix + it.k];
  }
}

template <int C>
int launch(const float* x, float* out, const float* weights, int batch,
           int h, int w, int layers, int tile, void* stream) {
  const int e = tile + 2 * layers;
  const int box_pixels = std::min(e, h + 2) * std::min(e, w + 2);
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(box_pixels) * pixel_floats(C) +
                       2 * static_cast<size_t>(blob_floats(C)));
  int device = 0;
  int limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_blocks_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + tile - 1) / tile;
  const int tiles_y = (h + tile - 1) / tile;
  const dim3 grid(tiles_x * tiles_y, batch);
  fused_blocks_kernel<C><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, out, weights, h, w, layers, tile, tiles_x, box_pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [batch, c, h, w] f32 contiguous, distinct buffers, c*h*w < 2^31;
// weights: `layers` packed layers (fused_block.pack_f32, blob_floats(c)
// floats each), 16-byte aligned; c one of 24, 48, 96 (the detectors'
// runs); batch <= 65535; the tile must fit shared memory: 8 box
// pixel_floats(c) + 8 blob_floats(c) bytes, box = min(tile + 2 layers,
// h + 2) x min(tile + 2 layers, w + 2).  Launches on `stream` and returns
// a cudaError_t (0 on success).
extern "C" int fused_dw_pw_block_f32(const float* x, float* out,
                                     const float* weights, int batch, int c,
                                     int h, int w, int layers, int tile,
                                     void* stream) {
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
