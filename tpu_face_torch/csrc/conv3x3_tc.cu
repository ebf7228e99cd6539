// A dense 3x3 convolution of an f32 net on Hopper's tensor cores, in split
// TF32 ("3xTF32"), at f32 accuracy:
//
//   y[b, oy, ox, co] = sum over (ky, kx, ci) of
//       x[b, oy*s + ky - p, ox*s + kx - p, ci] * w[co, ky, kx, ci]
//
// x NHWC (a channels_last [B, Cin, H, W] tensor), w OHWI, y NHWC, all f32;
// stride s 1 or 2, symmetric padding p 0 or 1 (taps outside the image read
// zero); Cin a multiple of 32, Cout of 64.  No bias or activation: the
// lowered net's epilogue kernel (conv_epilogue.cu) follows.  Optionally an
// input affine (a BatchNorm before the conv, which cannot fold into the
// weights of a zero-padded conv: it would change the border taps): each x
// inside the image read as x * scale[ci] + shift[ci], rounded after the
// product and after the sum as ATen's MUL then ADD, and the taps outside
// still zero, so the result equals MUL, ADD, then the conv, bit for bit.
//
// It replaces no Pallas kernel: XLA lowers the JAX package's convolutions
// (tpu_face/compiler/lowering.py) onto the TPU's matrix unit itself.  On
// the card the f32 convolutions of ArcFace's IR-ResNet went to cuDNN,
// which with TF32 off runs them as FFTs and SIMT implicit GEMMs (about 74
// TFLOP/s at R100's shapes).
//
// Bound: operations, at the split-TF32 rate (three TF32 products for each
// f32 one: 495 / 3 = 165 TFLOP/s on an H100 SXM).  R100's convolutions do
// 9 * Cin multiply-adds for each 4-byte output, far above the card's
// ridge.  What the design does about it:
//   * An implicit GEMM: M = B * Ho * Wo output pixels, N = Cout, K = 9 * Cin
//     in (ky, kx, ci) order.  A K step of 32 is one tap and 32 channels, so
//     a row of an A tile is 128 contiguous bytes of x (or zeros at a
//     border), and both operands are K-major, as tf32 wgmma requires.
//   * Accuracy: each f32 v is split into hi = tf32(v) and lo = tf32(v - hi)
//     (round to nearest, ties away), and acc += a_lo*b_hi + a_hi*b_lo +
//     a_hi*b_hi in f32; the dropped a_lo*b_lo is ~2^-22 of each product.
//     The weights are constants: the wrapper splits them once (the net's
//     construction), into hi and lo buffers in this kernel's tile order
//     ([K / 32][Cout][32], each 128-byte row already swizzled), so a stage
//     of B is one bulk copy each.
//   * wgmma.m64nNk8 with A from registers and B from shared memory (128B
//     swizzle).  A tile is 128 x 128 outputs, or 256 x 64 where Cout is no
//     multiple of 128 (ops/conv_tc.py plan): the same work and bytes a
//     stage (its wgmma of N = 64 took about as long as those of N = 128 on
//     the H100, so those layers run at about half the rate: PERF.md).  Two
//     consumer warpgroups own half its rows each, in blocks of 64; they
//     load their A fragments from shared memory with 16-byte
//     loads, split them in registers and run three wgmma per k8 step.
//     The tensor cores' f32 accumulation does not round to nearest and its
//     error grows with the steps summed: each stage's products are summed
//     there from zero and added to the f32 accumulators with FADD, which
//     keeps the kernel's error at f32's (the producer warpgroup gives up
//     registers for these, setmaxnreg).
//     Within a 32-channel stage the K order is permuted (the same way on
//     both operands, the sum does not care) so that a thread's fragments
//     for all four k8 steps are eight consecutive channels of its row.
//   * A producer warpgroup gathers the A tiles on the fly (a thread a row
//     or two, eight 16-byte cp.async a row with zero fill at the borders)
//     and copies the B tiles (cp.async.bulk) into a ring of stages, each
//     completing on an mbarrier; the consumers free a stage on another.
//   * The input affine, where given, is the consumers': each applies it to
//     the eight channels of its two rows it has just loaded, before the
//     split, where the row's tap lies in the image (a 9-bit mask a row,
//     made once a tile; the scale and shift from global memory, L1-held).
//     On the H100 that costs 0-15% of a conv (PERF.md); the producer
//     rewriting each stage in shared memory, one or two stages behind its
//     copies, cost 14-50%; the consumers' two warpgroups issuing their
//     wgmma in turns, making a stage's fragments while the stage before's
//     wgmma ran, or each k8 step's fragments before its own wgmma, made
//     the convs slower still.  A conv without the affine runs an
//     instantiation with none of its code (a template flag).
//   * Persistent CTAs, one per SM, walk the (M tile, N tile) list with the
//     N tiles of one M tile adjacent, so an A tile is fetched from memory
//     once and read again from L2.
//   * The accumulators (f32, registers) are stored straight to y, NHWC.
//
// With `tf32` set (the caller allows TF32 in convolutions, as
// torch.backends.cudnn.allow_tf32 does for cuDNN's) it is one TF32
// product a_hi*b_hi a k step instead of three, at TF32's accuracy.  Only
// the benchmark's TF32 control and the tests take this mode: every entry
// point of the package runs its nets under exact_f32, which clears the
// flag (tests/test_torch_conv_tc.py holds that).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kThreads = 384;             // producer + two consumer WGs
constexpr int kBK = 32;                   // K a stage: 32 channels of a tap
constexpr int kRowBytes = kBK * 4;        // one 128-byte swizzle row
constexpr int kStages = 4;

// A tile of BM = 2 * 64 * kMW output pixels by BN output channels: each
// consumer warpgroup owns kMW blocks of 64 rows, so a tile of either
// width holds 128 x 128 outputs' work, reads as many bytes a stage
// (48 KB) and keeps as many accumulators.
template <int BN>
struct Cfg {
  static constexpr int kMW = 128 / BN;            // 64-row blocks a WG
  static constexpr int kBM = 128 * kMW;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;  // each of hi and lo
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  // the stages, 1024 bytes of room to align them, the barriers
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 16 * kStages;
};

// 16 bytes from global `src`, or zeros where `bytes` is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// `bar` gets one arrival once this thread's cp.async so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// v * s + t with two roundings (no FMA), as ATen's MUL then ADD
__device__ __forceinline__ float affine(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);
}

// Bit ky * 3 + kx set where tap (ky, kx) of output pixel m lies in the
// image (none for m past the last pixel).
__device__ __forceinline__ uint32_t tap_mask(int m, int m_total, int pixels,
                                             int wo, int h, int w,
                                             int stride, int pad) {
  if (m >= m_total) return 0;
  const int b = m / pixels;
  const int rem = m - b * pixels;
  const int oy = rem / wo;
  const int iy = oy * stride - pad;
  const int ix = (rem - oy * wo) * stride - pad;
  uint32_t cols = 0, mask = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cols |= static_cast<uint32_t>(static_cast<unsigned>(ix + k) <
                                  static_cast<unsigned>(w))
            << k;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (static_cast<unsigned>(iy + k) < static_cast<unsigned>(h)) {
      mask |= cols << (3 * k);
    }
  }
  return mask;
}

// The shared memory of a CTA, from the 1024-aligned base: kStages stages
// of [A BM x 32 | B hi BN x 32 | B lo BN x 32] f32, then the full and the
// empty barrier of each stage.  kAffine: x read through the input affine
// (scale, shift: Cin floats each).
template <int BN, bool kSplit, bool kAffine>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_tc_kernel(const float* __restrict__ x,
                      const float* __restrict__ w_hi,
                      const float* __restrict__ w_lo,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, float* __restrict__ y,
                      int h, int w, int cin, int ho, int wo, int cout,
                      int stride, int pad, int m_total, int tiles_n,
                      int tiles) {
  using C = Cfg<BN>;
  constexpr int kMW = C::kMW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + kStages * C::kStageBytes;
  const uint32_t empty0 = full0 + 8 * kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the producer's 128 cp.async arrivals and its bulk copies' one
      mbar_init(full0 + 8 * s, 129);
      mbar_init(empty0 + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int cblocks = cin / kBK;
  const int ktiles = 9 * cblocks;
  const int pixels = ho * wo;

  if (tid < 128) {
    // producer: thread r gathers rows r + 128q of each A tile; thread 0
    // also copies the B tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int r = tid;
    const uint32_t sw = r & 7;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile / tiles_n;
      const int nt = tile - mt * tiles_n;
      // each row's image, first input row and column (-1 << 20: no row)
      const float* xb[kMW];
      int iy0[kMW], ix0[kMW];
#pragma unroll
      for (int q = 0; q < kMW; ++q) {
        const int m = mt * C::kBM + r + 128 * q;
        xb[q] = x;
        iy0[q] = ix0[q] = -(1 << 20);
        if (m < m_total) {
          const int b = m / pixels;
          const int rem = m - b * pixels;
          const int oy = rem / wo;
          xb[q] = x + static_cast<int64_t>(b) * h * w * cin;
          iy0[q] = oy * stride - pad;
          ix0[q] = (rem - oy * wo) * stride - pad;
        }
      }
      const float* bh = w_hi + static_cast<int64_t>(nt) * BN * kBK;
      const float* bl = w_lo + static_cast<int64_t>(nt) * BN * kBK;
      int tap = 0, cb = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int ky = tap / 3;
        const int kx = tap - 3 * ky;
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t sa = base + stage * C::kStageBytes;
        if (r == 0) {
          const int64_t off = static_cast<int64_t>(kt) * cout * kBK;
          mbar_expect(full, (kSplit ? 2 : 1) * C::kBBytes);
          bulk_copy(sa + C::kABytes, bh + off, C::kBBytes, full);
          if (kSplit) {
            bulk_copy(sa + C::kABytes + C::kBBytes, bl + off, C::kBBytes,
                      full);
          }
        }
#pragma unroll
        for (int q = 0; q < kMW; ++q) {
          const int iy = iy0[q] + ky;
          const int ix = ix0[q] + kx;
          const bool ok =
              static_cast<unsigned>(iy) < static_cast<unsigned>(h) &&
              static_cast<unsigned>(ix) < static_cast<unsigned>(w);
          const float* src =
              ok ? xb[q] + (static_cast<int64_t>(iy) * w + ix) * cin + cb * kBK
                 : x;
          const uint32_t bytes = ok ? 16 : 0;
          const uint32_t dst = sa + (r + 128 * q) * kRowBytes;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            cp_async16(dst + ((c ^ sw) << 4), src + 4 * c, bytes);
          }
        }
        cp_async_arrive(full);
        if (++cb == cblocks) {
          cb = 0;
          ++tap;
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: warpgroup g owns rows 64 (kMW g + mb) .. + 63 of the tile
  // for each block mb; in a block's m64k8 fragment a thread holds rows r0
  // and r0 + 8, k columns t and t + 4
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = tid - 128;
  const int lane = c & 31;
  const int t = lane & 3;
  const int r0 = (c >> 7) * 64 * kMW + ((c >> 5) & 3) * 16 + (lane >> 2);
  const uint32_t sw = r0 & 7;
  // its eight channels 8t .. 8t + 7 of each row: two 16-byte chunks
  const uint32_t a00 = r0 * kRowBytes + (((2 * t) ^ sw) << 4);
  const uint32_t a01 = r0 * kRowBytes + (((2 * t + 1) ^ sw) << 4);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / tiles_n;
    const int nt = tile - mt * tiles_n;
    float acc[kMW][BN / 2], part[kMW][BN / 2];
    // kAffine: bit tap of taps[mb] set where row r0 + 64 mb's tap lies in
    // the image, bit 16 + tap where row r0 + 64 mb + 8's does
    uint32_t taps[kMW];
#pragma unroll
    for (int mb = 0; mb < kMW; ++mb) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0.0f;
      if constexpr (kAffine) {
        const int m = mt * C::kBM + mb * 64 + r0;
        taps[mb] = tap_mask(m, m_total, pixels, wo, h, w, stride, pad) |
                   tap_mask(m + 8, m_total, pixels, wo, h, w, stride, pad)
                       << 16;
      }
    }
    int tap = 0, cb = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      // kAffine: the scale and shift of channels 8t .. 8t + 7 of the stage
      float sc[8], sh[8];
      if constexpr (kAffine) {
        const float4* s4 =
            reinterpret_cast<const float4*>(scale + cb * kBK + 8 * t);
        const float4* t4 =
            reinterpret_cast<const float4*>(shift + cb * kBK + 8 * t);
        const float4 s0 = __ldg(s4), s1 = __ldg(s4 + 1);
        const float4 t0 = __ldg(t4), t1 = __ldg(t4 + 1);
        sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
        sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
        sh[0] = t0.x, sh[1] = t0.y, sh[2] = t0.z, sh[3] = t0.w;
        sh[4] = t1.x, sh[5] = t1.y, sh[6] = t1.z, sh[7] = t1.w;
      }
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t sa = base + stage * C::kStageBytes;
      uint32_t hi[kMW][4][4], lo[kMW][4][4];
#pragma unroll
      for (int mb = 0; mb < kMW; ++mb) {
        const uint32_t row = sa + mb * 64 * kRowBytes;
        const float4 p00 = lds128(row + a00);
        const float4 p01 = lds128(row + a01);
        const float4 p10 = lds128(row + a00 + 8 * kRowBytes);
        const float4 p11 = lds128(row + a01 + 8 * kRowBytes);
        // channel 8t + q of rows r0 (v0) and r0 + 8 (v1); k8 step kk
        // takes q = 2kk as its k column t and q = 2kk + 1 as t + 4
        float v0[8] = {p00.x, p00.y, p00.z, p00.w,
                       p01.x, p01.y, p01.z, p01.w};
        float v1[8] = {p10.x, p10.y, p10.z, p10.w,
                       p11.x, p11.y, p11.z, p11.w};
        if constexpr (kAffine) {
          // taps outside the image stay the zeros the copies filled in
          const bool ok0 = (taps[mb] >> tap) & 1;
          const bool ok1 = (taps[mb] >> (16 + tap)) & 1;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            v0[q] = ok0 ? affine(v0[q], sc[q], sh[q]) : v0[q];
            v1[q] = ok1 ? affine(v1[q], sc[q], sh[q]) : v1[q];
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          split(v0[2 * kk], hi[mb][kk][0], lo[mb][kk][0]);
          split(v1[2 * kk], hi[mb][kk][1], lo[mb][kk][1]);
          split(v0[2 * kk + 1], hi[mb][kk][2], lo[mb][kk][2]);
          split(v1[2 * kk + 1], hi[mb][kk][3], lo[mb][kk][3]);
        }
      }
      const uint64_t dh = sw128_desc(sa + C::kABytes);
      const uint64_t dl = sw128_desc(sa + C::kABytes + C::kBBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int mb = 0; mb < kMW; ++mb) {
          // the stage's first product overwrites part
          if (kSplit) {
            wgmma<BN>(part[mb], lo[mb][kk], dh + 2 * kk, kk > 0);
            wgmma<BN>(part[mb], hi[mb][kk], dl + 2 * kk, 1);
            wgmma<BN>(part[mb], hi[mb][kk], dh + 2 * kk, 1);
          } else {
            wgmma<BN>(part[mb], hi[mb][kk], dh + 2 * kk, kk > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (++cb == cblocks) {
        cb = 0;
        ++tap;
      }
      // the tensor cores' f32 sums are not rounded to nearest; summing
      // each stage's part here keeps their error to one stage's length
#pragma unroll
      for (int mb = 0; mb < kMW; ++mb) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mb][i] += part[mb][i];
      }
    }
    // accumulator i of block mb: rows r0 (i % 4 < 2) and r0 + 8 of the
    // block, column 8 (i / 4) + 2t + i % 2 of the N tile
#pragma unroll
    for (int mb = 0; mb < kMW; ++mb) {
      const int m0 = mt * C::kBM + mb * 64 + r0;
      float* y0 = y + static_cast<int64_t>(m0) * cout + nt * BN + 2 * t;
      float* y1 = y0 + 8 * static_cast<int64_t>(cout);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        if (m0 < m_total) {
          *reinterpret_cast<float2*>(y0 + 8 * i) =
              make_float2(acc[mb][4 * i], acc[mb][4 * i + 1]);
        }
        if (m0 + 8 < m_total) {
          *reinterpret_cast<float2*>(y1 + 8 * i) =
              make_float2(acc[mb][4 * i + 2], acc[mb][4 * i + 3]);
        }
      }
    }
  }
}

template <int BN, bool kSplit, bool kAffine>
cudaError_t launch(const float* x, const float* w_hi, const float* w_lo,
                   const float* scale, const float* shift, float* y, int h,
                   int w, int cin, int ho, int wo, int cout, int stride,
                   int pad, int m_total, int grid, cudaStream_t stream) {
  // the shared-memory opt-in, once for each device and instantiation
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready & (1u << dev))) {
    err = cudaFuncSetAttribute(conv3x3_tc_kernel<BN, kSplit, kAffine>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<BN>::kSmem);
    if (err != cudaSuccess) return err;
    ready |= 1u << dev;
  }
  const int tiles_n = cout / BN;
  const int tiles = (m_total + Cfg<BN>::kBM - 1) / Cfg<BN>::kBM * tiles_n;
  conv3x3_tc_kernel<BN, kSplit, kAffine>
      <<<grid < tiles ? grid : tiles, kThreads, Cfg<BN>::kSmem, stream>>>(
          x, w_hi, w_lo, scale, shift, y, h, w, cin, ho, wo, cout, stride,
          pad, m_total, tiles_n, tiles);
  return cudaGetLastError();
}

// the instantiation for N tiles of BN columns, the split (or one TF32
// product) and the affine (or none)
template <int BN>
cudaError_t launch_bn(bool split, const float* x, const float* w_hi,
                      const float* w_lo, const float* scale,
                      const float* shift, float* y, int h, int w, int cin,
                      int ho, int wo, int cout, int stride, int pad,
                      int m_total, int grid, cudaStream_t s) {
  if (scale != nullptr) {
    return split ? launch<BN, true, true>(x, w_hi, w_lo, scale, shift, y, h,
                                          w, cin, ho, wo, cout, stride, pad,
                                          m_total, grid, s)
                 : launch<BN, false, true>(x, w_hi, w_lo, scale, shift, y, h,
                                           w, cin, ho, wo, cout, stride, pad,
                                           m_total, grid, s);
  }
  return split ? launch<BN, true, false>(x, w_hi, w_lo, scale, shift, y, h,
                                         w, cin, ho, wo, cout, stride, pad,
                                         m_total, grid, s)
               : launch<BN, false, false>(x, w_hi, w_lo, scale, shift, y, h,
                                          w, cin, ho, wo, cout, stride, pad,
                                          m_total, grid, s);
}

}  // namespace

// y [batch, ho, wo, cout] = the convolution of x [batch, h, w, cin] by the
// weights split into w_hi and w_lo ([9 cin / 32][cout][32] each, the tile
// order of ops/conv_tc.py kernel_weights), stride 1 or 2, padding 0 or 1;
// with `scale` and `shift` (cin floats each, both or neither) x read as
// x * scale + shift inside the image; N tiles of `bn` (64 or 128) columns,
// `grid` persistent CTAs; `tf32`: one TF32 product (w_lo unread) instead
// of the split's three.  All pointers 16-byte aligned.
extern "C" int conv3x3_tc_f32(const float* x, const float* w_hi,
                              const float* w_lo, const float* scale,
                              const float* shift, float* y, int batch, int h,
                              int w, int cin, int cout, int stride, int pad,
                              int bn, int grid, int tf32, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || cin < 32 || cin % 32 != 0 ||
      cout < 64 || cout % 64 != 0 || (stride != 1 && stride != 2) ||
      (pad != 0 && pad != 1) || (bn != 64 && bn != 128) || cout % bn != 0 ||
      grid < 1 || h + 2 * pad < 3 || w + 2 * pad < 3 ||
      (scale == nullptr) != (shift == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = (h + 2 * pad - 3) / stride + 1;
  const int wo = (w + 2 * pad - 3) / stride + 1;
  const int64_t m = static_cast<int64_t>(batch) * ho * wo;
  if (m >= (int64_t{1} << 31) - 256 ||
      static_cast<int64_t>(batch) * h * w >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m);
  const cudaError_t err =
      bn == 64 ? launch_bn<64>(!tf32, x, w_hi, w_lo, scale, shift, y, h, w,
                               cin, ho, wo, cout, stride, pad, mi, grid, s)
               : launch_bn<128>(!tf32, x, w_hi, w_lo, scale, shift, y, h, w,
                                cin, ho, wo, cout, stride, pad, mi, grid, s);
  return static_cast<int>(err);
}
