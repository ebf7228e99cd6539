// A transformer's attention core in one pass over device memory, from the
// head split to the head merge, in f32, for each sequence s and head h:
//
//   x = (q_h . k_h^T) * scale  [+ bias[h]]  [+ mask[s mod nw]]
//   p = softmax(x)            over each row: exp(x - max) / sum
//   o_h = p . v_h
//
// q, k, v and o are [seqs, n, heads * d] row-major f32, head h at columns
// h*d .. h*d + d - 1: the q, k and v FCs' outputs as the graph's head split
// (RESHAPE to [., n, heads, d], TRANSPOSE (0, 2, 1, 3)) reads them, and o as
// the head merge (the inverse TRANSPOSE, RESHAPE) writes it for the output
// projection; the split and the merge are this kernel's addressing.  scale
// is one float or null (no MUL), bias [heads, n, n] or null, mask
// [nw, n, n] or null: the shifted windows' mask, sequence s being window
// s mod nw of its image (the window partition orders the windows of each
// image together).  Each step rounds as ATen's op of the lowered graph
// does: the f32 product, the MUL, each ADD, TFLite's SOFTMAX (beta 1) as
// exp (expf, not __expf) of the difference from the row's max over the
// row's sum (see below), the f32 product.
//
// It replaces no Pallas kernel: XLA fuses the JAX package's attention ops
// (tpu_face/compiler/lowering.py) on the TPU itself.  On the card the
// lowered graph ran them as ~10 ATen passes: copies of the split operands,
// cuBLAS's f32 SIMT batched products, the scale, bias and mask as
// elementwise passes over the score tensor (236 MB a block in Swin-S's
// first stage, at 128 crops), a softmax of five passes and the merge's copy.
//
// Bound: bytes.  q, k and v are read once and o written once (ViT-L: 144
// tokens, 8 heads of 96; Swin-S: windows of 49 tokens, heads of 32); the
// two products are 2 n d multiply-adds for each of the 4 d bytes a row
// moves, below the card's ridge at the split-TF32 rate.  What the design
// does about it:
//   * One CTA per (sequence, head), ceil(n / 16) warps, each owning 16
//     query rows.  The head's q, k and v rows, its bias and its window's
//     mask are staged whole in shared memory by cp.async (q and k first,
//     then the rest, as two commit groups: v, the bias and the mask
//     arrive while the scores are computed), rows of q, k and v padded to
//     d + 4 floats so that the fragments' loads fall in distinct banks;
//     the rows past n are zero.  Nothing else waits on device memory.
//   * Three phases.  (1) The scores q . k^T: a warp's 16 rows by every key
//     (n <= 144: at most 18 m16n8 tiles) in registers, in a loop over the
//     steps of d.  (2) In those registers, the scale, the bias and the
//     mask in the graph's order, then the softmax, each row reduced over
//     the quad of lanes that holds it; no online rescaling: the whole row
//     is there.  p = e * (1 / sum) by IEEE reciprocal, within an ulp of
//     e / sum: the division's slow path, which every denormal e of a
//     masked key (exp(-100)) took, made the masked cores twice as slow.
//     p goes to shared memory over q and k, which are read by then.  (3)
//     p . v in a loop over the steps of the keys, the warp's 16 output
//     rows by d in registers.  The score matrix never reaches device
//     memory.  The loops over d in (1) and over the keys in (3) are not
//     unrolled: one straight-line body of every tile outgrew the
//     instruction cache, and ran several times slower.
//   * Both products on the tensor cores, mma.sync.m16n8k8 in split TF32:
//     each f32 operand v as hi = tf32(v) and lo = tf32(v - hi) (cvt.rna),
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi summed on the tensor cores from
//     zero for each k8 step and added to the f32 accumulators in FADD, so
//     the error stays f32's.  mma.sync, not wgmma: wgmma's 64-row tiles
//     would waste most of a 49-row window.  The second product's k index
//     is permuted (keys 2t and 2t + 1 of each 8 in k slots t and t + 4),
//     so that a lane's A fragment of p is the float2 of each of its rows
//     it wrote in (2); v's rows follow the same permutation.
//   * The tiling follows n and d: the score tiles and the output tiles are
//     sized at compile time for n <= 64 or <= 144 and d <= 32 or <= 96,
//     the loops stopping at the tiles n and d fill.
// With `tf32` set (the caller allows TF32 in matmuls, as
// torch.backends.cuda.matmul.allow_tf32 does for cuBLAS's) each product is
// one TF32 product a_hi*b_hi, at TF32's accuracy: the benchmark's TF32
// control and the tests alone take it.  Built with -fmad=false; the score
// steps are explicit __fmul_rn / __fadd_rn.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPad = 4;      // floats after each staged row of q, k and v
constexpr int kSmemMax = 232448;   // the shared memory a CTA may take

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

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment's four values as tf32 hi and lo parts (lo unused where
// `tf32`)
__device__ __forceinline__ void split_a(const float (&a)[4], bool tf32,
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (tf32) {
      hi[i] = to_tf32(a[i]);
      lo[i] = 0;
    } else {
      split(a[i], hi[i], lo[i]);
    }
  }
}

// acc += a . b over one k8 step, b the lane's two values of the B
// fragment: the split's three products summed from zero on the tensor
// cores (or a_hi*b_hi alone where `tf32`), then added in FADD
__device__ __forceinline__ void step(float (&acc)[4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0,
                                     float b1, bool tf32) {
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t h0, l0, h1, l1;
  if (tf32) {
    h0 = to_tf32(b0);
    h1 = to_tf32(b1);
  } else {
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma_tf32(part, alo, h0, h1);
    mma_tf32(part, ahi, l0, l1);
  }
  mma_tf32(part, ahi, h0, h1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// `rows` rows of d floats from `src` (row stride `ld`) into shared memory
// at `dst` (row stride d + kPad), 16 bytes a cp.async
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int d, int ld) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int chunks = d / 4;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = 4 * (i - r * chunks);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 4 * (r * (d + kPad) + c)),
                 "l"(src + static_cast<size_t>(r) * ld + c));
  }
}

// n * n floats from `src` into shared memory at `dst`, 4 bytes a cp.async
// (a head's bias and a window's mask start anywhere)
__device__ __forceinline__ void stage_square(float* dst, const float* src,
                                             int n) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     base + 4 * i),
                 "l"(src + i));
  }
}

// The shared memory of a CTA, in floats, for a sequence of n tokens and
// heads of d, the CTA's warps owning `qrows` = 16 ceil(n / 16) query rows:
// q (qrows rows) and k (8 ceil(n / 8) rows), each row d + kPad floats, and
// p over them once q and k are read (`p_stride` floats a row); then v;
// then the head's bias and the window's mask (n * n each) where given.
// (p_stride(n) is 8 mod 16, so that a row's float2 at 8j + 2t of rows
// g = 0 .. 3 fall in distinct banks.)
__host__ __device__ inline int p_stride(int n) {
  const int keys = 8 * ((n + 7) / 8);
  return keys % 16 == 8 ? keys : keys + 8;
}
__host__ __device__ inline int v_offset(int n, int d) {
  const int qrows = 16 * ((n + 15) / 16), keys = 8 * ((n + 7) / 8);
  const int qk = (qrows + keys) * (d + kPad), p = qrows * p_stride(n);
  return qk > p ? qk : p;
}
__host__ __device__ inline int smem_floats(int n, int d, int squares) {
  return v_offset(n, d) + 8 * ((n + 7) / 8) * (d + kPad) + squares * n * n;
}

// NT: the score tiles of 8 keys a warp can hold (n <= 8 NT); DT: the
// output tiles of 8 columns (d <= 8 DT)
template <int NT, int DT>
__global__ void __launch_bounds__(32 * ((8 * NT + 15) / 16))
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ mask, float* __restrict__ o,
                 int n, int heads, int d, int nw, int tf32) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (n + 7) / 8, keys = 8 * nt, ds = d / 8, ld = heads * d;
  const int row = d + kPad, qrows = 16 * ((n + 15) / 16), sp = p_stride(n);
  float* qs = smem;
  float* ks = qs + qrows * row;
  float* ps = smem;
  float* vs = smem + v_offset(n, d);
  float* bs = vs + keys * row;
  float* ms = bs + (bias == nullptr ? 0 : n * n);
  const int seq = blockIdx.x / heads, h = blockIdx.x - seq * heads;
  const size_t base = static_cast<size_t>(seq) * n * ld +
                      static_cast<size_t>(h) * d;
  stage(qs, q + base, n, d, ld);
  stage(ks, k + base, n, d, ld);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage(vs, v + base, n, d, ld);
  if (bias != nullptr) {
    stage_square(bs, bias + static_cast<size_t>(h) * n * n, n);
  }
  if (mask != nullptr) {
    stage_square(ms, mask + static_cast<size_t>(seq % nw) * n * n, n);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < (qrows - n) * d; i += blockDim.x) {
    const int r = n + i / d, c = i % d;
    qs[r * row + c] = 0.0f;
    if (r < keys) {
      ks[r * row + c] = 0.0f;
      vs[r * row + c] = 0.0f;
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;
  const bool one = tf32 != 0;

  asm volatile("cp.async.wait_group 1;\n" ::: "memory");    // q and k
  __syncthreads();

  // 1. the scores q . k^T of rows r0 and r0 + 8, keys 8j + 2t and
  // 8j + 2t + 1 of tile j
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
  }
  const float* qa = qs + r0 * row + t;
  const float* kb = ks + g * row + t;
#pragma unroll 1
  for (int kk = 0; kk < ds; ++kk) {
    const float* qk = qa + 8 * kk;
    const float a[4] = {qk[0], qk[8 * row], qk[4], qk[8 * row + 4]};
    uint32_t ahi[4], alo[4];
    split_a(a, one, ahi, alo);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const float* kr = kb + 8 * j * row + 8 * kk;
        step(s[j], ahi, alo, kr[0], kr[4], one);
      }
    }
  }
  // v, the bias and the mask are in; every warp is done with q and k
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. the scale, the bias and the mask in the graph's order, keys past n
  // at -inf, and the softmax of each row over the quad of lanes that hold
  // it; p = e * (1 / sum), within an ulp of e / sum, to p's rows over q
  // and k
  {
    const float sc = scale == nullptr ? 1.0f : *scale;
    float top[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = i / 2, r = r0 + 8 * u, c = 8 * j + 2 * t + (i & 1);
          float x = s[j][i];
          if (c < n) {
            if (scale != nullptr) x = __fmul_rn(x, sc);
            if (r < n && bias != nullptr) x = __fadd_rn(x, bs[r * n + c]);
            if (r < n && mask != nullptr) x = __fadd_rn(x, ms[r * n + c]);
          } else {
            x = -INFINITY;
          }
          s[j][i] = x;
          top[u] = fmaxf(top[u], x);
        }
      }
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      top[u] = fmaxf(top[u], __shfl_xor_sync(0xffffffffu, top[u], 1));
      top[u] = fmaxf(top[u], __shfl_xor_sync(0xffffffffu, top[u], 2));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = expf(__fsub_rn(s[j][i], top[i / 2]));     // 0 past n
          sum[i / 2] = __fadd_rn(sum[i / 2], s[j][i]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      sum[u] = __fadd_rn(sum[u], __shfl_xor_sync(0xffffffffu, sum[u], 1));
      sum[u] = __fadd_rn(sum[u], __shfl_xor_sync(0xffffffffu, sum[u], 2));
      sum[u] = __frcp_rn(sum[u]);
    }
    float* p0 = ps + r0 * sp + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        *reinterpret_cast<float2*>(p0 + 8 * j) = make_float2(
            __fmul_rn(s[j][0], sum[0]), __fmul_rn(s[j][1], sum[0]));
        *reinterpret_cast<float2*>(p0 + 8 * sp + 8 * j) = make_float2(
            __fmul_rn(s[j][2], sum[1]), __fmul_rn(s[j][3], sum[1]));
      }
    }
  }
  __syncwarp();

  // 3. o = p . v: tile j of p is k step j, the lane's values (rows r0,
  // r0 + 8; keys 8j + 2t, 8j + 2t + 1) in the A fragment's k slots t and
  // t + 4
  float acc[DT][4];
#pragma unroll
  for (int dd = 0; dd < DT; ++dd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dd][i] = 0.0f;
  }
  const float* pa = ps + r0 * sp + 2 * t;
  const float* vb = vs + 2 * t * row + g;
#pragma unroll 1
  for (int j = 0; j < nt; ++j) {
    const float2 x0 = *reinterpret_cast<const float2*>(pa + 8 * j);
    const float2 x1 = *reinterpret_cast<const float2*>(pa + 8 * sp + 8 * j);
    const float a[4] = {x0.x, x1.x, x0.y, x1.y};
    uint32_t ahi[4], alo[4];
    split_a(a, one, ahi, alo);
    const float* vr = vb + 8 * j * row;
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) {
      if (dd < ds) {
        step(acc[dd], ahi, alo, vr[8 * dd], vr[8 * dd + row], one);
      }
    }
  }

  // the head merge: columns h*d + 8dd + 2t, 2t + 1 of rows r0 and r0 + 8
  float* o0 = o + base + static_cast<size_t>(r0) * ld + 2 * t;
  float* o1 = o0 + static_cast<size_t>(8) * ld;
#pragma unroll
  for (int dd = 0; dd < DT; ++dd) {
    if (dd < ds) {
      if (r0 < n) {
        *reinterpret_cast<float2*>(o0 + 8 * dd) =
            make_float2(acc[dd][0], acc[dd][1]);
      }
      if (r0 + 8 < n) {
        *reinterpret_cast<float2*>(o1 + 8 * dd) =
            make_float2(acc[dd][2], acc[dd][3]);
      }
    }
  }
}

template <int NT, int DT>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* scale, const float* bias, const float* mask,
                   float* o, int seqs, int n, int heads, int d, int nw,
                   int tf32, cudaStream_t stream) {
  // the shared-memory opt-in, once for each device and instantiation, to
  // all a CTA may take (the launch asks for what it needs)
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready & (1u << dev))) {
    err = cudaFuncSetAttribute(attention_kernel<NT, DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return err;
    ready |= 1u << dev;
  }
  attention_kernel<NT, DT><<<seqs * heads, 32 * ((n + 15) / 16),
                             4 * smem_floats(n, d, (bias != nullptr) +
                                                       (mask != nullptr)),
                             stream>>>(
      q, k, v, scale, bias, mask, o, n, heads, d, nw, tf32);
  return cudaGetLastError();
}

}  // namespace

// o [seqs, n, heads * d] = the attention core of q, k and v (each [seqs, n,
// heads * d]): `scale` one float or null, `bias` [heads, n, n] or null,
// `mask` [nw, n, n] or null (sequence s takes window s mod nw); 1 <= n <=
// 144, d a multiple of 8 up to 96, seqs * heads < 2^31, the shared memory
// (smem_floats) at most kSmemMax; `tf32`: one TF32 product for each of the
// split's three.  q, k, v and o 16-byte aligned.
extern "C" int attention_tc_f32(const float* q, const float* k,
                                const float* v, const float* scale,
                                const float* bias, const float* mask,
                                float* o, int seqs, int n, int heads, int d,
                                int nw, int tf32, void* stream) {
  if (seqs < 0 || n < 1 || n > 144 || heads < 1 || d < 8 || d > 96 ||
      d % 8 != 0 || (mask != nullptr && nw < 1) ||
      static_cast<int64_t>(seqs) * heads > 2147483647 ||
      4 * smem_floats(n, d, (bias != nullptr) + (mask != nullptr)) >
          kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (seqs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= 64) {
    err = d <= 32 ? launch<8, 4>(q, k, v, scale, bias, mask, o, seqs, n,
                                 heads, d, nw, tf32, s)
                  : launch<8, 12>(q, k, v, scale, bias, mask, o, seqs, n,
                                  heads, d, nw, tf32, s);
  } else {
    err = d <= 32 ? launch<18, 4>(q, k, v, scale, bias, mask, o, seqs, n,
                                  heads, d, nw, tf32, s)
                  : launch<18, 12>(q, k, v, scale, bias, mask, o, seqs, n,
                                   heads, d, nw, tf32, s);
  }
  return static_cast<int>(err);
}
