// The epilogue of a dense convolution of the lowered nets, in one pass
// over the convolution's f32 output y [B, C, H, W]:
//
//   v = y + bias[c]                      (when the conv has a bias)
//   v = v + skip[c]                      (a residual ADD; 0 for c >= C_skip,
//                                         the zero channels of an absorbed
//                                         channel PAD)
//   v = max(v, 0) + alpha[c] * min(v, 0) (PRELU; or RELU, or RELU6)
//
// It replaces no TPU kernel: XLA fuses these elementwise ops into the
// producing convolution's epilogue on the TPU (tpu_face/compiler/
// lowering.py's _prelu keeps the max + alpha * min form for that reason),
// while on the card ATen runs them op by op after cuDNN's convolution --
// the bias add_, the ADD, the PReLU's two clamps, its mul and its add,
// each a kernel of its own with about 14 passes over the activation in
// all.  Here it is three: y read, skip read, the result written.
//
// The arithmetic is the op-by-op path's, in the same order and each step
// rounded to f32 (built with -fmad=false, so alpha * min(v, 0) is not
// contracted into the add), so the result is equal bit for bit to ATen's
// sequence on the card, cuDNN's convolution being called without a bias
// in both (ATen's cuDNN route adds the bias afterwards as a separate op).
// max and min keep a NaN, as torch.clamp does.
//
// Bound: bytes (a few operations per 12 bytes moved).  What the design
// does about it:
//   * 16-byte loads and stores: a thread takes four consecutive elements
//     where they share a channel (NCHW: H*W a multiple of 4) or lie in
//     one pixel (channels_last: C and C_skip multiples of 4) and the
//     pointers are 16-byte aligned; otherwise one element.
//   * The layout from the strides: NCHW-contiguous (the iris net, whose
//     input is a channel-major view) or channels_last (the mesh and
//     detector nets).  Where y, skip and out do not share one (cuDNN's
//     1x1 convolution may answer an NCHW input in channels_last), a
//     second kernel moves 32 x 32 (channel, pixel) tiles through shared
//     memory, so each operand is still read, and out written, along its
//     own contiguous axis.
//   * 32-bit indices, channels from multiply-high divisions (Div32): a
//     launch takes as many whole images as hold fewer than 2^31 elements,
//     the next one starting at a 64-bit offset (an image of 2^31 elements
//     or more is refused).  Bias and alpha are read through the read-only
//     cache, once per vector.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;   // the grid strides beyond
constexpr int kTile = 32;                  // the mixed-layout kernel's tile
constexpr int kRows = kThreads / kTile;

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2, kPrelu = 3 };

// n / d for n < 2^31 by a multiply-high (Granlund and Montgomery): with
// s = ceil(log2 d) and m = floor(2^32 (2^s - d) / d) + 1,
// n / d = (umulhi(n, m) + n) >> s.
struct Div32 {
  uint32_t d, m, s;
  Div32() = default;
  explicit Div32(uint32_t divisor) : d(divisor), s(0) {
    while ((uint64_t{1} << s) < d) ++s;
    m = static_cast<uint32_t>(((uint64_t{1} << 32) *
                               ((uint64_t{1} << s) - d)) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

template <int V>
__device__ __forceinline__ void load(float (&r)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    p[0] = r[0];
  }
}

// One element's epilogue, the op-by-op path's order.
__device__ __forceinline__ float apply(float v, const float* bias,
                                       float skip, bool has_skip,
                                       const float* alpha, int ch,
                                       int act) {
  if (bias != nullptr) v = v + __ldg(bias + ch);
  if (has_skip) v = v + skip;
  if (act == kRelu) {
    v = v < 0.f ? 0.f : v;
  } else if (act == kRelu6) {
    v = v < 0.f ? 0.f : (v > 6.f ? 6.f : v);
  } else if (act == kPrelu) {
    const float hi = v < 0.f ? 0.f : v;   // clamp(v, min=0)
    const float lo = v > 0.f ? 0.f : v;   // clamp(v, max=0)
    v = hi + __ldg(alpha + ch) * lo;
  }
  return v;
}

// Element i = v * V of y and out, all NCHW (CL false) or all
// channels_last (CL true); the V elements of a vector share a channel, or
// lie in one pixel.
template <bool CL, int V>
__global__ void __launch_bounds__(kThreads) epilogue_kernel(
    const float* __restrict__ y, const float* __restrict__ bias,
    const float* __restrict__ skip, const float* __restrict__ alpha,
    float* __restrict__ out, uint32_t nvec, uint32_t c, uint32_t cs,
    uint32_t hw, Div32 div_c, Div32 div_hw, int act) {
  const uint32_t step = gridDim.x * kThreads;
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < nvec;
       v += step) {
    const uint32_t i = v * V;
    uint32_t ch, s_at;       // channel of element i; its offset in skip
    if constexpr (CL) {
      const uint32_t pix = div_c.div(i);
      ch = i - pix * c;
      s_at = pix * cs + ch;
    } else {
      const uint32_t plane = div_hw.div(i);
      const uint32_t n = div_c.div(plane);
      ch = plane - n * c;
      s_at = (n * cs + ch) * hw + (i - plane * hw);
    }
    float r[V];
    float s[V];
    load<V>(r, y + i);
    if (skip != nullptr && ch < cs) {
      load<V>(s, skip + s_at);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      r[k] = apply(r[k], bias, s[k], skip != nullptr, alpha,
                   static_cast<int>(CL ? ch + k : ch), act);
    }
    store<V>(out + i, r);
  }
}

// Operand element (channel c0 + a, pixel p0 + b) of image n at
// tile[a][b], for a, b < kTile, 0 past its cn channels or hw pixels; a
// warp reads kTile consecutive elements of the operand's own layout.
__device__ __forceinline__ void load_tile(float (*tile)[kTile + 1],
                                          const float* __restrict__ src,
                                          bool cl, uint32_t n, uint32_t c0,
                                          uint32_t p0, uint32_t cn,
                                          uint32_t hw) {
  const int lane = threadIdx.x % kTile;
  for (int row = threadIdx.x / kTile; row < kTile; row += kRows) {
    const int a = cl ? lane : row;
    const int b = cl ? row : lane;
    const uint32_t ch = c0 + a;
    const uint32_t px = p0 + b;
    float v = 0.f;
    if (ch < cn && px < hw) {
      v = __ldg(src + (cl ? (n * hw + px) * cn + ch
                          : (n * cn + ch) * hw + px));
    }
    tile[a][b] = v;
  }
}

// Mixed layouts: y, skip and out each NCHW or channels_last (``cl`` bits
// 1, 2 and 0).  A block takes kTile channels x kTile pixels of one image
// at a time: y's and skip's tiles go through shared memory, each read
// along its own contiguous axis, and out is written along its own.
__global__ void __launch_bounds__(kThreads) epilogue_kernel_tiled(
    const float* __restrict__ y, const float* __restrict__ bias,
    const float* __restrict__ skip, const float* __restrict__ alpha,
    float* __restrict__ out, uint32_t c, uint32_t cs, uint32_t hw,
    uint32_t tiles_p, uint32_t tiles_c, uint32_t tiles, int cl, int act) {
  __shared__ float ty[kTile][kTile + 1];
  __shared__ float ts[kTile][kTile + 1];
  const bool out_cl = (cl & 1) != 0;
  const int lane = threadIdx.x % kTile;
  for (uint32_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const uint32_t rest = t / tiles_p;
    const uint32_t p0 = (t - rest * tiles_p) * kTile;
    const uint32_t n = rest / tiles_c;
    const uint32_t c0 = (rest - n * tiles_c) * kTile;
    load_tile(ty, y, (cl & 2) != 0, n, c0, p0, c, hw);
    if (skip != nullptr) load_tile(ts, skip, (cl & 4) != 0, n, c0, p0, cs, hw);
    __syncthreads();
    for (int row = threadIdx.x / kTile; row < kTile; row += kRows) {
      const int a = out_cl ? lane : row;
      const int b = out_cl ? row : lane;
      const uint32_t ch = c0 + a;
      const uint32_t px = p0 + b;
      if (ch < c && px < hw) {
        out[out_cl ? (n * hw + px) * c + ch : (n * c + ch) * hw + px] =
            apply(ty[a][b], bias, ts[a][b], skip != nullptr, alpha,
                  static_cast<int>(ch), act);
      }
    }
    __syncthreads();
  }
}

int64_t blocks_for(int64_t work) {
  return std::min<int64_t>(std::max<int64_t>(work, 1), kMaxBlocks);
}

template <bool CL, int V>
cudaError_t run(const float* y, const float* bias, const float* skip,
                const float* alpha, float* out, uint32_t numel, uint32_t c,
                uint32_t cs, uint32_t hw, int act, cudaStream_t stream) {
  const uint32_t nvec = numel / V;
  const auto blocks =
      static_cast<unsigned>(blocks_for((nvec + kThreads - 1) / kThreads));
  epilogue_kernel<CL, V><<<blocks, kThreads, 0, stream>>>(
      y, bias, skip, alpha, out, nvec, c, cs, hw, Div32(c), Div32(hw), act);
  return cudaGetLastError();
}

// One launch over numel < 2^31 elements of y: whole images.
cudaError_t dispatch(int cl, bool vec, const float* y, const float* bias,
                     const float* skip, const float* alpha, float* out,
                     uint32_t numel, uint32_t c, uint32_t cs, uint32_t hw,
                     int act, cudaStream_t stream) {
  if (cl != 0 && cl != 7) {
    const uint32_t tiles_p = (hw + kTile - 1) / kTile;
    const uint32_t tiles_c = (c + kTile - 1) / kTile;
    const uint32_t tiles = numel / (c * hw) * tiles_c * tiles_p;
    const auto blocks = static_cast<unsigned>(blocks_for(tiles));
    epilogue_kernel_tiled<<<blocks, kThreads, 0, stream>>>(
        y, bias, skip, alpha, out, c, cs, hw, tiles_p, tiles_c, tiles, cl,
        act);
    return cudaGetLastError();
  }
  if (cl == 7) {
    return vec ? run<true, 4>(y, bias, skip, alpha, out, numel, c, cs, hw,
                              act, stream)
               : run<true, 1>(y, bias, skip, alpha, out, numel, c, cs, hw,
                              act, stream);
  }
  return vec ? run<false, 4>(y, bias, skip, alpha, out, numel, c, cs, hw,
                             act, stream)
             : run<false, 1>(y, bias, skip, alpha, out, numel, c, cs, hw,
                             act, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// y, out: [batch, c, hw] planes or [batch, hw, c] pixels, as ``layouts``
// says (bit 0: out channels_last, bit 1: y, bit 2: skip), c * hw < 2^31;
// skip: the same with c_skip <= c channels, or null; bias, alpha: [c] or
// null; act: 0 none, 1 relu, 2 relu6, 3 prelu (alpha required).
extern "C" int conv_epilogue_f32(const float* y, const float* bias,
                                 const float* skip, const float* alpha,
                                 float* out, int64_t batch, int c,
                                 int c_skip, int64_t hw, int layouts,
                                 int act, void* stream) {
  if (batch < 0 || c < 1 || hw < 0 || act < kNone || act > kPrelu ||
      layouts < 0 || layouts > 7 || (act == kPrelu && alpha == nullptr) ||
      (skip != nullptr && (c_skip < 1 || c_skip > c))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t image = c * hw;            // elements of one image of y
  if (image >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * image == 0) return 0;
  const int64_t cs = skip != nullptr ? c_skip : c;
  // without a skip, its bit follows out's
  const int cl =
      skip != nullptr ? layouts : (layouts & 3) | ((layouts & 1) << 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the images a launch takes: fewer than 2^31 elements in all
  const int64_t per_launch = ((int64_t{1} << 31) - 1) / image;
  for (int64_t n0 = 0; n0 < batch; n0 += per_launch) {
    const int64_t images = std::min(per_launch, batch - n0);
    const float* yn = y + n0 * image;
    const float* sn = skip != nullptr ? skip + n0 * cs * hw : nullptr;
    float* on = out + n0 * image;
    const bool vec = aligned16(yn) && aligned16(on) &&
                     (sn == nullptr || aligned16(sn)) &&
                     (cl == 7 ? c % 4 == 0 && cs % 4 == 0 : hw % 4 == 0);
    const cudaError_t err = dispatch(
        cl, vec, yn, bias, sn, alpha, on,
        static_cast<uint32_t>(images * image), static_cast<uint32_t>(c),
        static_cast<uint32_t>(cs), static_cast<uint32_t>(hw), act, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
