// TFLite's FULLY_CONNECTED over token rows of an f32 net on Hopper's
// tensor cores, in split TF32 ("3xTF32"), at f32 accuracy, with its bias
// and fused activation:
//
//   y[m, n] = act(sum over k of x[m, k] * w[n, k] + b[n])
//
// x [M, K] row-major, w [N, K] (TFLite's [out, in]), y [M, N] row-major,
// all f32; b f32 [N] or none; act NONE, RELU or RELU6; K a multiple of 32,
// N of 64.  The bias add and the activation are applied to the f32 sums in
// registers before the one store, rounded as ATen's `add` and `clamp` round
// them on the product, so the result equals the bare product followed by
// those two ops, bit for bit.
//
// It replaces no Pallas kernel: XLA lowers the JAX package's products
// (tpu_face/compiler/lowering.py) onto the TPU's matrix unit itself.  On
// the card the token FCs of insightface's ViT went to cuBLAS, which with
// TF32 off runs them as f32 SIMT GEMMs (about 39 TFLOP/s at ViT-L's
// shapes), followed by two ATen passes for the bias and the activation.
//
// Bound: operations, at the split-TF32 rate (three TF32 products for each
// f32 one: 495 / 3 = 165 TFLOP/s on an H100 SXM).  ViT-L's FCs do K = 768
// or 3,072 multiply-adds for each 4-byte output, far above the card's
// ridge.  The design is conv3x3_tc.cu's, with the gather gone:
//   * A GEMM of M = B * tokens rows, N outputs, K inputs; both operands
//     K-major, as tf32 wgmma requires.  A stage is 32 of K: a row of a
//     tile is 128 contiguous bytes.
//   * Accuracy: each f32 v is split into hi = tf32(v) and lo = tf32(v - hi)
//     (round to nearest, ties away), and acc += a_lo*b_hi + a_hi*b_lo +
//     a_hi*b_hi in f32; the dropped a_lo*b_lo is ~2^-22 of each product.
//     The weights are constants: the wrapper splits them once (the net's
//     construction), into hi and lo buffers in this kernel's tile order
//     ([K / 32][N][32], each 128-byte row already swizzled and permuted
//     within the stage as the consumers read A), so a stage of B is one
//     bulk copy each.
//   * A is contiguous: one thread of the producer warpgroup copies each
//     stage's A tile with the Tensor Memory Accelerator under the 128B
//     swizzle (one 2-D box of BM rows x 32 floats; the rows past M read as
//     zeros), and the B tiles with cp.async.bulk, into a ring of stages,
//     each completing on an mbarrier; the consumers free a stage on
//     another.
//   * wgmma.m64nNk8 with A from registers and B from shared memory (128B
//     swizzle).  A tile is 128 x 128 outputs, or 256 x 64 where N is no
//     multiple of 128 (ops/conv_tc.py plan).  Two consumer warpgroups own
//     half its rows each, in blocks of 64; they load their A fragments
//     from shared memory with 16-byte loads, split them in registers and
//     run three wgmma per k8 step.  Each stage's products are summed on
//     the tensor cores from zero and added to the f32 accumulators with
//     FADD, which keeps the kernel's error at f32's (the producer
//     warpgroup gives up registers for these, setmaxnreg).
//   * Persistent CTAs, one per SM, walk the (M tile, N tile) list with the
//     N tiles of one M tile adjacent, so an A tile is fetched from memory
//     once and read again from L2.
//   * The epilogue adds the bias, applies the activation and stores the
//     accumulators straight to y; rows past M are not stored.
//
// With `tf32` set (the caller allows TF32 in matmuls, as
// torch.backends.cuda.matmul.allow_tf32 does for cuBLAS's) it is one TF32
// product a_hi*b_hi a k step instead of three, at TF32's accuracy.  Only
// the benchmark's TF32 control and the tests take this mode: every entry
// point of the package runs its nets under exact_f32, which clears the
// flag.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kThreads = 384;             // producer + two consumer WGs
constexpr int kBK = 32;                   // K a stage
constexpr int kRowBytes = kBK * 4;        // one 128-byte swizzle row
constexpr int kStages = 4;

// the fused activations (ops/fc_tc.py ACTS): 0 none, 1 relu, 2 relu6
constexpr int kNone = 0, kRelu6 = 2;

// A tile of BM = 2 * 64 * kMW rows by BN output columns: each consumer
// warpgroup owns kMW blocks of 64 rows, so a tile of either width holds
// 128 x 128 outputs' work, reads as many bytes a stage (48 KB) and keeps
// as many accumulators.
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

// The box at (c0 along K, c1 along M) of the tensor `map` describes, into
// shared `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// act(v) as ATen's clamp_min(v, 0) (relu) and clamp(v, 0, 6) round it on
// the card: NaN passes through, else max then min
__device__ __forceinline__ float activate(float v, int act) {
  if (act == kNone || isnan(v)) return v;
  v = fmaxf(v, 0.0f);
  return act == kRelu6 ? fminf(v, 6.0f) : v;
}

// The shared memory of a CTA, from the 1024-aligned base: kStages stages
// of [A BM x 32 | B hi BN x 32 | B lo BN x 32] f32, then the full and the
// empty barrier of each stage.
template <int BN, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    fc_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                 const float* __restrict__ w_hi,
                 const float* __restrict__ w_lo,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int m_total, int k, int n, int act, int tiles_n,
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
      mbar_init(full0 + 8 * s, 1);     // the producer's, with the bytes
      mbar_init(empty0 + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ktiles = k / kBK;

  if (tid < 128) {
    // producer: thread 0 copies every tile of every stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&xmap))
                 : "memory");
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile / tiles_n;
      const int nt = tile - mt * tiles_n;
      const float* bh = w_hi + static_cast<int64_t>(nt) * BN * kBK;
      const float* bl = w_lo + static_cast<int64_t>(nt) * BN * kBK;
      for (int kt = 0; kt < ktiles; ++kt) {
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t sa = base + stage * C::kStageBytes;
        const int64_t off = static_cast<int64_t>(kt) * n * kBK;
        mbar_expect(full, C::kABytes + (kSplit ? 2 : 1) * C::kBBytes);
        tma_load_2d(sa, &xmap, kt * kBK, mt * C::kBM, full);
        bulk_copy(sa + C::kABytes, bh + off, C::kBBytes, full);
        if (kSplit) {
          bulk_copy(sa + C::kABytes + C::kBBytes, bl + off, C::kBBytes,
                    full);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
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
  // its eight columns 8t .. 8t + 7 of each row's 32: two 16-byte chunks,
  // where the TMA's 128B swizzle put them
  const uint32_t a00 = r0 * kRowBytes + (((2 * t) ^ sw) << 4);
  const uint32_t a01 = r0 * kRowBytes + (((2 * t + 1) ^ sw) << 4);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / tiles_n;
    const int nt = tile - mt * tiles_n;
    float acc[kMW][BN / 2], part[kMW][BN / 2];
#pragma unroll
    for (int mb = 0; mb < kMW; ++mb) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0.0f;
    }
    // the bias of the thread's columns 8i + 2t and 8i + 2t + 1 of the N
    // tile, read before the main loop, which hides the reads' latency
    // (read in the epilogue, each waited for in turn: a 768 x 768 FC with
    // its bias took 28% longer than without on the H100, 1% so)
    const int col = nt * BN + 2 * t;
    float2 bv[BN / 8];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      bv[i] = bias == nullptr
                  ? make_float2(0.0f, 0.0f)
                  : __ldg(reinterpret_cast<const float2*>(bias + col +
                                                          8 * i));
    }
    for (int kt = 0; kt < ktiles; ++kt) {
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
        // column 8t + q of rows r0 (v0) and r0 + 8 (v1); k8 step kk
        // takes q = 2kk as its k column t and q = 2kk + 1 as t + 4
        const float v0[8] = {p00.x, p00.y, p00.z, p00.w,
                             p01.x, p01.y, p01.z, p01.w};
        const float v1[8] = {p10.x, p10.y, p10.z, p10.w,
                             p11.x, p11.y, p11.z, p11.w};
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
      float* y0 = y + static_cast<int64_t>(m0) * n + col;
      float* y1 = y0 + 8 * static_cast<int64_t>(n);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        float v[4] = {acc[mb][4 * i], acc[mb][4 * i + 1],
                      acc[mb][4 * i + 2], acc[mb][4 * i + 3]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (bias != nullptr) {
            v[j] = __fadd_rn(v[j], j % 2 ? bv[i].y : bv[i].x);
          }
          v[j] = activate(v[j], act);
        }
        if (m0 < m_total) {
          *reinterpret_cast<float2*>(y0 + 8 * i) = make_float2(v[0], v[1]);
        }
        if (m0 + 8 < m_total) {
          *reinterpret_cast<float2*>(y1 + 8 * i) = make_float2(v[2], v[3]);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the libcuda the process has
// loaded (the runtime does not export it; null where there is none)
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

template <int BN, bool kSplit>
cudaError_t launch(const float* x, const float* w_hi, const float* w_lo,
                   const float* bias, float* y, int m, int k, int n, int act,
                   int grid, cudaStream_t stream) {
  using C = Cfg<BN>;
  // the shared-memory opt-in, once for each device and instantiation
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready & (1u << dev))) {
    err = cudaFuncSetAttribute(fc_tc_kernel<BN, kSplit>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return err;
    ready |= 1u << dev;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  // x as a 2-D tensor of K (innermost) by M, boxes of 32 x BM, 128B swizzle
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 4};
  const cuuint32_t box[2] = {kBK, C::kBM};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const int tiles_n = n / BN;
  const int tiles = (m + C::kBM - 1) / C::kBM * tiles_n;
  fc_tc_kernel<BN, kSplit>
      <<<grid < tiles ? grid : tiles, kThreads, C::kSmem, stream>>>(
          xmap, w_hi, w_lo, bias, y, m, k, n, act, tiles_n, tiles);
  return cudaGetLastError();
}

}  // namespace

// y [m, n] = act(x [m, k] . w^T + bias) with the weights split into w_hi
// and w_lo ([k / 32][n][32] each, the tile order of ops/fc_tc.py
// kernel_weights); `bias` n floats or null; `act` 0 none, 1 relu, 2 relu6;
// N tiles of `bn` (64 or 128) columns, `grid` persistent CTAs; `tf32`: one
// TF32 product (w_lo unread) instead of the split's three.  All pointers
// 16-byte aligned.
extern "C" int fc_tc_f32(const float* x, const float* w_hi,
                         const float* w_lo, const float* bias, float* y,
                         int m, int k, int n, int act, int bn, int grid,
                         int tf32, void* stream) {
  if (m < 0 || m > 2147483647 - 256 || k < kBK || k % kBK != 0 || n < 64 ||
      n % 64 != 0 || (bn != 64 && bn != 128) || n % bn != 0 ||
      act < kNone || act > kRelu6 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bn == 64) {
    err = tf32 ? launch<64, false>(x, w_hi, w_lo, bias, y, m, k, n, act,
                                   grid, s)
               : launch<64, true>(x, w_hi, w_lo, bias, y, m, k, n, act,
                                  grid, s);
  } else {
    err = tf32 ? launch<128, false>(x, w_hi, w_lo, bias, y, m, k, n, act,
                                    grid, s)
               : launch<128, true>(x, w_hi, w_lo, bias, y, m, k, n, act,
                                   grid, s);
  }
  return static_cast<int>(err);
}
