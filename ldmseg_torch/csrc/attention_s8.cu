// K13 and K11 on Hopper: the int8 UNet's self-attention without fused
// norms,
// K13: o = softmax(Q K^T * scale) V with q, k, v quantized to int8, on
//      [B, T, H, D];
// K11: the same attention with the projections around it, x [B, T, C] ->
//      to_out(attention(x Wq, x Wk, x Wv)) on int8 weights
//      (use_padded_attention without use_fused_norms);
// K15: K13 on the packed token layout [B, T, C] with dynamic scales
//      (use_packed_attention with use_int8_attention);
// K10 with v_bf16=False (an op): K11 behind a LayerNorm, with the residual
//      and the to_out bias in its epilogue;
// K17: the absorbed attention on int8 weights quantized per head
//      (use_absorbed_attention with use_int8_attention), x [B, T, C] ->
//      to_out(attention(x Wq, x Wk, x Wv)) with dynamic scales per (image,
//      head);
// K18 (an op): K17 with per-tensor weight scales and the projections'
//      dynamic scales per image.
//
// Replaces the TPU kernel ldmseg_tpu/ops/pallas/attention.py:_attn_kernel_s8
// (pallas_call in _fused_impl_s8, public fused_self_attention_s8), together
// with the wrapper's quantize of q, k and v. Its rounding points:
//   1. q8 = clip(rint(float(q) / qs), +-127), k8 and v8 the same with ks and
//      vs (static scales, or one dynamic amax / 127 per tensor that the
//      wrapper hands in as device scalars);
//   2. s = float(int32 q8 k8^T) * sc0 with sc0 = (qs * ks) * scale;
//   3. e = exp((s - rowmax(s)) + ln 127), so rowmax(e) = 127; denom = sum(e)
//      over the unrounded e in fp32;
//   4. e8 = rint(e) (codes 0..127), o32 = int32 e8 V8;
//   5. o = bf16(float(o32) * ((sc1 * 127) / denom)) with sc1 = vs / 127.
//
// What bounds it on an H100: 2*2*BH*T^2*D int8 operations at 1,979 TOPS
// against the int8 q, k, v in and the bf16 o out (3 + 2 bytes per element of
// one [BH, T, D] tensor) at 3.35 TB/s. At the first level (BH=16, T=2048,
// D=40) that is ~10.7 G int8 operations (~5.4 us) against ~6.6 MB (~2 us):
// operations bound it; at T=128 and T=32 (D=160) bytes and launch latency.
//
// Design. Two kernels on the stream:
//   a. quant_qkv: one block per (64 tokens, image*head, tensor), reading q,
//      k and v through their [B, T, H, D] strides (the caller's head views
//      cost nothing); q8 and k8 into a head-padded [B*T, H, dp] scratch (dp
//      = d rounded up to 32: a tensor map's strides are multiples of 16
//      bytes), v8 transposed into v8t [B, H, d, tp] (tp = T rounded up to
//      16) through shared memory, so that both the reads and the stores
//      stay coalesced, with the keys of every 16 in the order the attention
//      stage's registers need (attention_sm90.cuh) and zeros past T;
//   b. attention: attn_s8pv_kernel_sm90 below, the Hopper skeleton K1 and
//      K3 run on (attention_sm90.cuh) with an int8 score product and an
//      int8 e8 V product (kPV): one block per (image*head, 64 or 128
//      queries), a producer warpgroup issuing TMA loads of Q, then K (pass
//      1) and K and V^T (pass 2) through a ring; pass 1 keeps the int32 row
//      max, pass 2 forms e and e8 in registers, sums the unrounded e, and
//      feeds the codes as the register A operand of an s8 wgmma m64nNk32
//      against V^T. Two passes: e8 needs the row's exact max. The launch
//      plan is ops/attention_s8.py:sm90_s8pv_attention_plan's, checked here.
// The epilogue is a template value: kOutBf16 (K13, K15), kOutS8 with
// ratio[h] (K11, K10), kOutF32 with the (image, head) amax of the result
// (K17, K18). The scales are read per (image, head) from device memory
// (K17, K18), per tensor from device memory (K15, K13's dynamic scales),
// or passed by value (K13's static scale).
//
// K11 replaces ldmseg_tpu/ops/pallas/attention.py:_attn_kernel_abs_padded_s8
// (pallas_call in _abs_padded_s8_impl, public
// absorbed_padded_self_attention_s8), whose wrapper quantizes x once. Its
// rounding points, per image, with as = 0.1 and xs the static scale of x:
//   1. x8 = clip(rint(float(x) / xs), +-127);
//   2. q8 = clip(rint(float(x8 Wq8) * m[col]), +-127) with m = w_scale[h] *
//      (xs / as), int32 product; k8 and v8 the same (all three int8);
//   3. per head: s = float(q8 k8^T) * as^2 * d^-0.5, e = exp((s - rowmax) +
//      ln 127), denom = sum(e) over the fp32 e, e8 = rint(e);
//   4. of8 = clip(rint(float(e8 v8) * (r_h / denom)), +-127) with r_h =
//      wos[h] / max(wos), int32 product;
//   5. out = bf16(float(of8 Wo8) * (as * max(wos))), int32 product.
// The TPU kernel's 128-lane head padding and one-hot-free head slices are
// layout work; their zeros are exact and are not carried over.
//
// K15 replaces ldmseg_tpu/ops/pallas/attention.py:_attn_kernel_btc_s8
// (pallas_call in _packed_s8_impl, public fused_self_attention_packed_s8).
// Its wrapper always takes dynamic scales, max(amax, 1e-6) / 127 per tensor
// (it has no static act_scale), and the kernel picks each head with one-hot
// int8 selection matmuls (exact: a permutation) before K13's rounding
// points 2-5. Here the head view of [B, T, C] is [B, T, H, D] with strides
// (T*C, C, D), which quant_qkv reads directly, so K15 is K13's two kernels
// with the scales in device memory, behind two small kernels that compute
// them: the three amaxes (atomicMax per warp) and max(amax, 1e-6) / 127.
//
// K10 with v_bf16=False replaces _attn_kernel_abs_padded_ln_s8 (pallas_call
// in _abs_padded_ln_s8_impl, absorbed_padded_ln_self_attention_s8(...,
// v_bf16=False)): K11's rounding points 2-4 on x8 = clip(rint(LN(x) / xs))
// (K3's step 1-2), then out = bf16((float(x) + float(of8 Wo8) * (as *
// max(wos))) + b_out).
//
// What bounds K11 and K10: K3's work without the LN, with P V and to_out on
// int8: per image 4 * 2*T*C^2 + 2 * 2*H*T^2*d int8 operations at 1,979
// TOPS against x in, the int8 weights and the bf16 output.
//
// Design of K11 and K10: five kernels on the stream, int8 intermediates
// through device memory. (a) ln_quant (s8_common.cuh), with or without the
// LN: x -> x8; (b) gemm_sm90.cuh's int8 product x8 [Wq; Wk]^T with q8 and
// k8 requantized per column into the head-padded scratch (QkPadEpi); (c)
// the V projection with its operands swapped, Wv8 x8^T -> [C, B*T]: both
// operands stay K-major, and the output's columns are tokens, so the
// epilogue (VtEpi) writes v8t with keys contiguous (a column pair is two
// adjacent keys, adjacent in the permuted order too); (d) the attention
// stage with the of8 epilogue (kOutS8); (e) the product of8 Wo8^T with the
// dequantize of step 5 (DequantEpi) or K10's residual and bias
// (ResidualS8Epi).
//
// K11 on a model axis (parallel/tp.py): a rank's pack holds the rows of
// Wq, Wk, Wv of its heads and the columns of Wo that read them, so (b)-(d)
// run over ci = heads_local * d columns on the replicated x8 and (e) is
// [rows, ci] x [c, ci]^T with Int32Epi: the int32 of8 Wo8^T of the rank's
// heads, unscaled (ldmseg_attention_padded_s8 with partial 1). The caller
// sums the ranks' int32 partials, which is exact, and rounds
// bf16(float(sum) * out_scale) as DequantEpi does; out_scale = as *
// max(wos) and ratio[h] = wos[h] / max(wos) take the maximum over every
// rank's heads, so the mesh equals one rank bit for bit.
//
// K17 replaces ldmseg_tpu/ops/pallas/attention.py:_attn_kernel_absorbed_s8
// (pallas_call in _absorbed_s8_impl, public absorbed_self_attention_s8),
// whose wrapper quantizes x once, x8 = clip(rint(float(x) / xs), +-127).
// Per (image, head h), in fp32:
//   1. y = float(int32 x8 W8[h]) * (xs * ws[h]) for q, k and v;
//   2. ys = max(amax|y| over the [T, D] tile, 1e-6) / 127, y8 = rint(y / ys);
//   3. s = float(int32 q8 k8^T) * ((qs * ks) * scale);
//   4-5. e = exp((s - rowmax) + ln 127), denom = sum(e), e8 = rint(e);
//   6. oh = (float(int32 e8 v8) * vs) / denom;
//   7. os = max(amax|oh| over [T, D], 1e-6) / 127, oh8 = rint(oh / os);
//   8. out += float(int32 oh8 Wo8[h]) * (os * wos[h]), h = 0 first;
//   9. out rounded to bf16.
// K18 replaces _attn_kernel_absorbed_fullc_s8 (pallas_call in
// _absorbed_fullc_s8_impl, public absorbed_fullc_self_attention_s8): the
// same steps with one weight scale per tensor and the amax of step 2 over
// the image's whole [T, C] projection. Its one-hot int8 head picks and its
// to_out weight padded to [H, 128, C] are exact TPU layout work: here the
// heads are column offsets and Wo8's head padding is to 32, not 128.
//
// What bounds them: per image 4 * 2*T*C^2 + 2 * 2*H*T^2*d int8 operations
// at 1,979 TOPS against x in, the int8 weights and the bf16 output.
//
// Design (K17 and K18 differ only in the width of step 2's groups): six
// kernels on the stream, fp32 and int8 intermediates through device memory.
// (a) ln_quant without the LN: x8, and the amax words zeroed; (b)
// gemm_sm90.cuh's int8 product of x8 with the three [C, C] codes as one
// [3C, C] product, step 1 in its epilogue into fp32 y and step 2's amax
// folded per 8-row group and column group into each (image, group) slot
// (AbsorbedProjEpi; K18's per-tensor scales arrive repeated per head); (c)
// group_quant_kernel: the scales and codes of step 2 (q8 and k8
// head-padded, v8 transposed as K13's); (d) the attention stage with the
// fp32 epilogue of step 6, which also folds step 7's amax into the (image,
// head) slots; (e) group_quant_kernel again for oh8, head-padded; (f)
// gemm_sm90.cuh's per-head product (gemm_heads_kernel) of oh8 with Wo8
// repacked [C, H, dp] once by the wrapper's pack: each head's int32 sums
// promoted into fp32 registers as acc + float(c32) * (os * wos[h]), h = 0
// first.

#include "attention_sm90.cuh"
#include "gemm_sm90.cuh"
#include "s8_common.cuh"
#include "sm90.cuh"

namespace {

using namespace s8;  // ln_quant, quant_s8, to_f, warp_max

constexpr int kMaxD = 160;  // largest head dim taken
constexpr int kTok = 64;    // tokens of a quantize block

struct Strides {
  long long b, t, h;  // element strides of the B, T and H axes (D is 1)
};

struct QKV {
  const void* x[3];  // q, k, v
  Strides st[3];
};

// position q of a 16-key group of v8t holds this key of the group
// (attention_sm90.cuh: the score registers' order)
__device__ __forceinline__ int key_of(int q) {
  return 2 * ((q >> 2) & 3) + (q & 1) + 8 * ((q >> 1) & 1);
}

// positions [q4, q4 + 4) of the 64-token tile at t0 of one head column
// whose codes lie in `codes` (by token in the tile): key_of within each
// 16, zero for keys past t
__device__ __forceinline__ uint32_t vt_word(const int8_t* codes, int q4,
                                            int t0, int t) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = q4 + e;
    const int key = (q & ~15) + key_of(q & 15);
    if (t0 + key < t) {
      w |= static_cast<uint32_t>(static_cast<uint8_t>(codes[key])) << (8 * e);
    }
  }
  return w;
}

// eight consecutive elements from p, as fp32: 16-byte loads where p is
// 16-byte aligned (the caller's strides may leave it less aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = p[e];
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(p[e]);
  }
}

// eight codes as one 8-byte store, byte e the e-th
__device__ __forceinline__ uint2 pack_codes(const int8_t (&c8)[8]) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(c8[e]))
                << (8 * (e % 4));
  }
  return make_uint2(w[0], w[1]);
}

// ---- a: quantize q, k and v ------------------------------------------------
// One block per (64 tokens, image * head, tensor): q and k into the
// head-padded [B*T, H, dp], v through shared memory into v8t [B, H, d, tp].
template <typename T>
__global__ void __launch_bounds__(256)
    quant_qkv_kernel(QKV a, int8_t* __restrict__ q8, int8_t* __restrict__ k8,
                     int8_t* __restrict__ v8t, int t, int heads, int d,
                     int dp, int tp, const float* __restrict__ scale_dev,
                     float qs, float ks, float vs) {
  __shared__ int8_t vt[kMaxD][kTok + 4];  // v's codes, [column][token]
  const int which = blockIdx.z;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int t0 = blockIdx.x * kTok;
  const float sc = scale_dev != nullptr
                       ? scale_dev[which]
                       : (which == 0 ? qs : (which == 1 ? ks : vs));
  const Strides s = a.st[which];
  const T* x = static_cast<const T*>(a.x[which]) + b * s.b + h * s.h;
  const int units = d / 8;
  for (int i = threadIdx.x; i < kTok * units; i += 256) {
    const int r = i / units;
    const int u = i - r * units;
    const int tok = t0 + r;
    if (tok >= t) continue;
    float v[8];
    load8(x + tok * s.t + 8 * u, v);
    int8_t c8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) c8[e] = quant_s8(v[e] / sc);
    if (which < 2) {
      *reinterpret_cast<uint2*>(
          (which == 0 ? q8 : k8) +
          (static_cast<long long>(b * t + tok) * heads + h) * dp + 8 * u) =
          pack_codes(c8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[8 * u + e][r] = c8[e];
    }
  }
  if (which < 2) return;
  __syncthreads();
  int8_t* dst = v8t + static_cast<long long>(b * heads + h) * d * tp + t0;
  for (int i = threadIdx.x; i < d * (kTok / 4); i += 256) {
    const int col = i / (kTok / 4);
    const int q4 = (i - col * (kTok / 4)) * 4;
    if (t0 + q4 < tp) {
      *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(col) * tp +
                                   q4) = vt_word(vt[col], q4, t0, t);
    }
  }
}

// ---- K15's dynamic scales: amax of |q|, |k|, |v| ---------------------------
// Each block's max (shuffles, then across its warps), then one atomicMax
// per block on the float's bits into amax[which] (zeroed before):
// non-negative floats order as their bit patterns, and a max is exact in
// any order (one atomic per warp queued 5,120 of them on one word at T =
// 2048). Thread unit u owns 8 elements of row (b * t + token) * heads +
// head.
template <typename T>
__global__ void __launch_bounds__(256)
    amax_qkv_kernel(QKV a, int units, int t, int heads, int d,
                    unsigned* __restrict__ amax) {
  const int which = blockIdx.y;
  const int u = blockIdx.x * 256 + threadIdx.x;
  float m = 0.f;
  if (u < units) {
    const int per_row = d / 8;
    const int row = u / per_row;
    const int j = (u - row * per_row) * 8;
    const int bt = row / heads;
    const int h = row - bt * heads;
    const int b = bt / t;
    const int tok = bt - b * t;
    const Strides s = a.st[which];
    float v[8];
    load8(static_cast<const T*>(a.x[which]) + b * s.b + tok * s.t +
              h * s.h + j,
          v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  __shared__ float red[8];
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = warp_max(threadIdx.x < 8 ? red[threadIdx.x] : 0.f);
    if (threadIdx.x == 0) atomicMax(amax + which, __float_as_uint(m));
  }
}

// 1e-6 rounded to the input's type, as jnp.maximum(amax, 1e-6) rounds it
__device__ __forceinline__ float amax_floor(const float*) { return 1e-6f; }
__device__ __forceinline__ float amax_floor(const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(1e-6f));
}

// scale = max(amax, 1e-6 in the input's type) / 127 in fp32, as the JAX
// wrapper computes it (:221-223)
template <typename T>
__global__ void amax_scales_kernel(const unsigned* __restrict__ amax,
                                   float* __restrict__ scales) {
  const float floor = amax_floor(static_cast<const T*>(nullptr));
  const int i = threadIdx.x;
  if (i < 3) scales[i] = fmaxf(__uint_as_float(amax[i]), floor) / 127.f;
}

// ---- b: attention per (image*head, query tile) ------------------------------
// The launch plan as ops/attention_s8.py:sm90_s8pv_attention_plan lays it
// out
struct AttnPlan {
  int head_class;  // N of e8 V: d rounded up to an .s8 class
  int block_q;     // query rows per block, 64 per consumer warpgroup
  int block_k;     // keys per tile
  int stages;      // depth of the K/V ring
  int qk_chunks;   // 128-column int8 boxes across a head of q8/k8
  int dp;          // the head-padded width of q8 and k8
  int tp;          // the key stride of v8t: T rounded up to 16
  int smem_bytes;  // dynamic shared memory of the launch
  int grid_x;      // query tiles
  int grid_y;      // B * H
};
constexpr int kAttnPlanInts = 10;

bool attn_plan_ok(const AttnPlan& p, int bh, int t, int d) {
  const int hc = attn90::s8_class(d);
  const int qk_chunks = ((hc + 31) / 32 + 3) / 4;
  return p.head_class == hc && p.qk_chunks == qk_chunks &&
         p.dp == (d + 31) / 32 * 32 && p.tp == (t + 15) / 16 * 16 &&
         p.smem_bytes == attn90::smem_bytes_s8pv(p.block_q, p.block_k,
                                                 qk_chunks, hc, p.stages) &&
         attn90::tiles_ok(hc, p.block_q, p.block_k, p.stages, p.smem_bytes,
                          p.grid_x, p.grid_y, bh, t);
}

// the scales of a launch: group_scales, per (tensor, image, group) as
// [3][batch][groups] with head h in group h * groups / heads (K17, K18);
// else scale_dev, three per tensor; else the static qs, ks, vs. ratio
// [heads] for kOutS8; amax [batch][heads] for kOutF32 (or null)
struct Scales {
  const float* group_scales;
  int groups;
  const float* scale_dev;
  float qs, ks, vs, scale;
  const float* ratio;
  unsigned* amax;
};

// attention_sm90.cuh's skeleton on int8 q8, k8 and v8t: K13's rounding
// point, the epilogue kOut
template <int kDN, int kWG, int kOut>
__global__ void __launch_bounds__(attn90::Cfg<true, kDN, kWG, kOut>::kThreads,
                                  1)
    attn_s8pv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          void* __restrict__ o, attn90::Strides so, int heads,
                          int t, int d, int stages, Scales sc) {
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  float qs = sc.qs, ks = sc.ks, vs = sc.vs;
  if (sc.group_scales != nullptr) {
    const int batch = gridDim.y / heads;
    const int g = b * sc.groups + h * sc.groups / heads;
    qs = sc.group_scales[g];
    ks = sc.group_scales[batch * sc.groups + g];
    vs = sc.group_scales[2 * batch * sc.groups + g];
  } else if (sc.scale_dev != nullptr) {
    qs = sc.scale_dev[0];
    ks = sc.scale_dev[1];
    vs = sc.scale_dev[2];
  }
  attn90::PV8 pv;
  pv.sc0 = (qs * ks) * sc.scale;
  pv.out = kOut == attn90::kOutS8    ? sc.ratio[h]
           : kOut == attn90::kOutF32 ? vs
                                     : (vs / 127.f) * 127.f;
  pv.amax = sc.amax != nullptr ? sc.amax + blockIdx.y : nullptr;
  attn90::forward<true, kDN, kWG, kOut>(tq, tk, tv, o, so, heads, t, d,
                                        stages, 0.f, pv);
}

template <int kDN, int kWG, int kOut>
int attn_as(const AttnPlan& p, const CUtensorMap* maps, void* o,
            const attn90::Strides& so, int heads, int t, int d,
            const Scales& sc, cudaStream_t stream) {
  auto kernel = attn_s8pv_kernel_sm90<kDN, kWG, kOut>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(p.grid_x, p.grid_y),
           attn90::Cfg<true, kDN, kWG, kOut>::kThreads, p.smem_bytes,
           stream>>>(maps[0], maps[1], maps[2], o, so, heads, t, d, p.stages,
                     sc);
  return static_cast<int>(cudaGetLastError());
}

template <int kWG, int kOut>
int attn_wg(const AttnPlan& p, const CUtensorMap* maps, void* o,
            const attn90::Strides& so, int heads, int t, int d,
            const Scales& sc, cudaStream_t stream) {
  switch (p.head_class) {
    case 16: return attn_as<16, kWG, kOut>(p, maps, o, so, heads, t, d, sc, stream);
    case 32: return attn_as<32, kWG, kOut>(p, maps, o, so, heads, t, d, sc, stream);
    case 48: return attn_as<48, kWG, kOut>(p, maps, o, so, heads, t, d, sc, stream);
    case 64: return attn_as<64, kWG, kOut>(p, maps, o, so, heads, t, d, sc, stream);
    case 80: return attn_as<80, kWG, kOut>(p, maps, o, so, heads, t, d, sc, stream);
    case 128: return attn_as<128, kWG, kOut>(p, maps, o, so, heads, t, d, sc, stream);
    case 160: return attn_as<160, kWG, kOut>(p, maps, o, so, heads, t, d, sc, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q8, k8 int8 [batch*t, heads, dp] (the padding never read), v8t int8
// [batch, heads, d, tp]; o (kOut's type) through the element strides so;
// scale > 0
template <int kOut>
int launch_attn(const int* plan, const int8_t* q8, const int8_t* k8,
                const int8_t* v8t, void* o, const attn90::Strides& so,
                int batch, int t, int heads, int d, const Scales& sc,
                cudaStream_t stream) {
  const AttnPlan p{plan[0], plan[1], plan[2], plan[3], plan[4],
                   plan[5], plan[6], plan[7], plan[8], plan[9]};
  if (!attn_plan_ok(p, batch * heads, t, d) || !(sc.scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int current = sm90::make_current(q8);
  if (current != 0) return current;
  CUtensorMap maps[3];
  int err = sm90::encode_map_s8(&maps[0], q8, batch, t, heads, d, p.dp, 64);
  if (err != 0) return err;
  err = sm90::encode_map_s8(&maps[1], k8, batch, t, heads, d, p.dp,
                            p.block_k);
  if (err != 0) return err;
  err = sm90::encode_map_s8t(&maps[2], v8t, batch, p.tp, heads, d,
                             p.head_class);
  if (err != 0) return err;
  return p.block_q == 128
             ? attn_wg<2, kOut>(p, maps, o, so, heads, t, d, sc, stream)
             : attn_wg<1, kOut>(p, maps, o, so, heads, t, d, sc, stream);
}

// K13 and K15's attention: quant_qkv, then the stage into bf16 o [B, T, H,
// D] contiguous
template <typename T>
int launch(const void* q, const void* k, const void* v, const long long* st,
           int8_t* q8, int8_t* k8, int8_t* v8t, __nv_bfloat16* o, int batch,
           int t, int heads, int d, const float* scale_dev, float qs,
           float ks, float vs, float scale, const int* plan,
           cudaStream_t stream) {
  QKV a;
  a.x[0] = q;
  a.x[1] = k;
  a.x[2] = v;
  for (int i = 0; i < 3; ++i) a.st[i] = Strides{st[3 * i], st[3 * i + 1],
                                                st[3 * i + 2]};
  const int dp = plan[5];
  const int tp = plan[6];
  quant_qkv_kernel<T><<<dim3((t + kTok - 1) / kTok, batch * heads, 3), 256,
                        0, stream>>>(a, q8, k8, v8t, t, heads, d, dp, tp,
                                     scale_dev, qs, ks, vs);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const Scales sc{nullptr, 0, scale_dev, qs, ks, vs, scale, nullptr, nullptr};
  const attn90::Strides so{static_cast<long long>(t) * heads * d,
                           static_cast<long long>(heads) * d, d};
  return launch_attn<attn90::kOutBf16>(plan, q8, k8, v8t, o, so, batch, t,
                                       heads, d, sc, stream);
}

// K15: the dynamic scales into scratch (amax bits, then the three
// scales), then K13's two kernels reading them from device memory. stage
// 1 runs the amax alone and stage 2 the rest on the amax bits the caller
// left in scratch (a model axis: the group's maximum of the ranks' amaxes
// between the two); stage 0 both
template <typename T>
int launch_packed(const void* q, const void* k, const void* v,
                  const long long* st, int8_t* q8, int8_t* k8, int8_t* v8t,
                  __nv_bfloat16* o, int batch, int t, int heads, int d,
                  unsigned* scratch, float scale, const int* plan, int stage,
                  cudaStream_t stream) {
  QKV a;
  a.x[0] = q;
  a.x[1] = k;
  a.x[2] = v;
  for (int i = 0; i < 3; ++i) a.st[i] = Strides{st[3 * i], st[3 * i + 1],
                                                st[3 * i + 2]};
  int err = 0;
  if (stage != 2) {
    err = static_cast<int>(
        cudaMemsetAsync(scratch, 0, 3 * sizeof(unsigned), stream));
    if (err != 0) return err;
    const int units = batch * t * heads * (d / 8);
    amax_qkv_kernel<T><<<dim3((units + 255) / 256, 3), 256, 0, stream>>>(
        a, units, t, heads, d, scratch);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0 || stage == 1) return err;
  }
  float* scales = reinterpret_cast<float*>(scratch + 3);
  amax_scales_kernel<T><<<1, 32, 0, stream>>>(scratch, scales);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch<T>(q, k, v, st, q8, k8, v8t, o, batch, t, heads, d, scales,
                   0.f, 0.f, 0.f, scale, plan, stream);
}

// ---- K11 and K10's products -------------------------------------------------
// (b) q8 and k8 requantized per column, clip(rint(sum * m[col])), into the
// head-padded [rows, heads, dp]; the product's columns are q | k. Where a
// column goes is worked out once per column and block (its tensor and its
// offset in the row, in the int per-column vector).
struct QkPadEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 1;     // m
  static constexpr int kIntCols = 1;  // the column's code
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  const float* m;
  int8_t* q8;
  int8_t* k8;
  int c, d, dp, heads;
  __device__ float col_value(int, int col) const { return __ldg(m + col); }
  __device__ int col_int(int, int col) const {
    const int which = col / c;
    const int cc = col - which * c;
    const int h = cc / d;
    return which << 28 | (h * dp + (cc - h * d));
  }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int row, int, const float2* cv, const int2* ci,
                             const RowPre&, const Pre&, int s0,
                             int s1) const {
    const int code = ci[0].x;
    *reinterpret_cast<char2*>((code >> 28 ? k8 : q8) +
                              static_cast<long long>(row) * heads * dp +
                              (code & ((1 << 28) - 1))) =
        make_char2(quant_s8(static_cast<float>(s0) * cv[0].x),
                   quant_s8(static_cast<float>(s1) * cv[0].y));
  }
};

// (c) the swapped V projection Wv8 x8^T: rows are head columns (channel
// ch = h d + j), columns tokens of the B*T rows of x8. v8 = clip(rint(sum *
// m[ch])) into v8t [B, C, tp] at the token's permuted position; a column
// pair is two adjacent keys of one image (T is even), adjacent there too.
struct VtEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 0;
  static constexpr int kIntCols = 1;  // the column's offset in v8t
  struct RowPre {
    float m;
    long long at;  // the channel's row of v8t, ch * tp
  };
  using Pre = gemm90::NoPre;
  const float* m;
  int8_t* v8t;
  int t, c, tp;
  __device__ float col_value(int, int) const { return 0.f; }
  __device__ int col_int(int, int col) const {
    const int b = col / t;
    const int tok = col - b * t;
    const int q = tok & 15;
    // the inverse of key_of: key 2a + 8c + e sits at 4a + 2c + e
    const int pos = (tok & ~15) + 4 * ((q >> 1) & 3) + 2 * (q >> 3) + (q & 1);
    return b * c * tp + pos;
  }
  __device__ RowPre row_pre(int row) const {
    return {__ldg(m + row), static_cast<long long>(row) * tp};
  }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int, int, const float2*, const int2* ci,
                             const RowPre& rp, const Pre&, int s0,
                             int s1) const {
    *reinterpret_cast<char2*>(v8t + rp.at + ci[0].x) =
        make_char2(quant_s8(static_cast<float>(s0) * rp.m),
                   quant_s8(static_cast<float>(s1) * rp.m));
  }
};

// (e) K11's to_out: out = bf16(float(sum) * scale), [rows, n]
struct DequantEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 0;
  static constexpr int kIntCols = 0;
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  float scale;
  __nv_bfloat16* out;
  int n;
  __device__ float col_value(int, int) const { return 0.f; }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int row, int col, const float2*, const int2*,
                             const RowPre&, const Pre&, int s0,
                             int s1) const {
    *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * n +
                                 col) =
        sm90::pack_bf16(static_cast<float>(s0) * scale,
                        static_cast<float>(s1) * scale);
  }
};

// (e) K11's to_out on a model axis: the int32 sum of this rank's heads,
// unscaled, [rows, n] (the caller sums the ranks' partials, exact, then
// scales and rounds once as DequantEpi does)
struct Int32Epi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 0;
  static constexpr int kIntCols = 0;
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  int* out;
  int n;
  __device__ float col_value(int, int) const { return 0.f; }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int row, int col, const float2*, const int2*,
                             const RowPre&, const Pre&, int s0,
                             int s1) const {
    *reinterpret_cast<int2*>(out + static_cast<long long>(row) * n + col) =
        make_int2(s0, s1);
  }
};

// (e) K10's to_out: out = bf16((float(x) + float(sum) * scale) + bias[col]),
// x the block's input [rows, n] in its type. __fmul_rn: the product rounds
// before the residual add, as in the TPU kernel (no fused multiply-add).
template <typename T>
struct ResidualS8Epi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 1;  // bias
  static constexpr int kIntCols = 0;
  using RowPre = gemm90::NoPre;
  using Pre = typename gemm90::PairOf<T>::type;  // x
  const T* x;
  float scale;
  const float* bias;
  __nv_bfloat16* out;
  int n;
  __device__ float col_value(int, int col) const { return __ldg(bias + col); }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int row, int col) const {
    return gemm90::ldg_pair(x + static_cast<long long>(row) * n + col);
  }
  __device__ void operator()(int row, int col, const float2* cv,
                             const int2*, const RowPre&, const Pre& xv,
                             int s0, int s1) const {
    const float2 xf = gemm90::to_f2(xv);
    *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * n +
                                 col) =
        sm90::pack_bf16(
            (xf.x + __fmul_rn(static_cast<float>(s0), scale)) + cv[0].x,
            (xf.y + __fmul_rn(static_cast<float>(s1), scale)) + cv[0].y);
  }
};

// K11's and K10's (b)-(d): the two projections of x8 [rows, c] and the e8
// attention with the of8 epilogue, over ci = heads * d inner columns (c
// but on a model axis: this rank's heads, w_qkv [3ci, c], of8 [rows, ci]).
// plans: sm90_gemm_plan's of [rows, 2ci, c] and [ci, rows, c] (int8),
// sm90_s8pv_attention_plan's, in that order.
int launch_qkv_attention(const int8_t* x8, const int8_t* w_qkv,
                         const float* m_qkv, const float* ratio, int8_t* q8,
                         int8_t* k8, int8_t* v8t, int8_t* of8, int batch,
                         int t, int c, int ci, int heads, float score_scale,
                         const int* plans, cudaStream_t stream) {
  const int rows = batch * t;
  const int d = ci / heads;
  const int* attn_plan = plans + 2 * gemm90::kPlanInts;
  const int dp = attn_plan[5];
  const int tp = attn_plan[6];
  int err = gemm90::launch_gemm<true>(
      plans, x8, w_qkv, rows, 2 * ci, c, 0,
      QkPadEpi{m_qkv, q8, k8, ci, d, dp, heads}, stream);
  if (err != 0) return err;
  err = gemm90::launch_gemm<true>(
      plans + gemm90::kPlanInts, w_qkv + 2ll * ci * c, x8, ci, rows, c, 0,
      VtEpi{m_qkv + 2 * ci, v8t, t, ci, tp}, stream);
  if (err != 0) return err;
  // sc0 = (1 * 1) * score_scale: the score scale exactly
  const Scales sc{nullptr, 0, nullptr, 1.f, 1.f, 1.f, score_scale, ratio,
                  nullptr};
  const attn90::Strides so{static_cast<long long>(t) * ci, ci, d};
  return launch_attn<attn90::kOutS8>(attn_plan, q8, k8, v8t, of8, so, batch,
                                     t, heads, d, sc, stream);
}

// plans: launch_qkv_attention's three, then sm90_gemm_plan's of to_out
// ([rows, c, ci], int8). `partial` (int32 [rows, c], a model axis) takes
// the unscaled of8 Wo8^T of the rank's ci columns in place of out.
template <typename T>
int launch_padded(const void* x, __nv_bfloat16* out, int* partial,
                  const int8_t* w_qkv, const float* m_qkv, const int8_t* wo,
                  const float* ratio, int8_t* x8, int8_t* q8, int8_t* k8,
                  int8_t* v8t, int8_t* of8, int batch, int t, int c, int ci,
                  int heads, float xs, float score_scale, float out_scale,
                  const int* plans, cudaStream_t stream) {
  const int rows = batch * t;
  int err = launch_ln_quant<T, false>(x, x8, nullptr, nullptr, rows, c, xs,
                                      0.f, nullptr, 0, stream);
  if (err != 0) return err;
  err = launch_qkv_attention(x8, w_qkv, m_qkv, ratio, q8, k8, v8t, of8, batch,
                             t, c, ci, heads, score_scale, plans, stream);
  if (err != 0) return err;
  const int* out_plan = plans + 2 * gemm90::kPlanInts + kAttnPlanInts;
  if (partial != nullptr) {
    return gemm90::launch_gemm<true>(out_plan, of8, wo, rows, c, ci, 0,
                                     Int32Epi{partial, c}, stream);
  }
  return gemm90::launch_gemm<true>(out_plan, of8, wo, rows, c, ci, 0,
                                   DequantEpi{out_scale, out, c}, stream);
}

template <typename T>
int launch_ln_padded(const void* x, __nv_bfloat16* out, const float* ln_w,
                     const float* ln_b, const float* out_b,
                     const int8_t* w_qkv, const float* m_qkv,
                     const int8_t* wo, const float* ratio, int8_t* x8,
                     int8_t* q8, int8_t* k8, int8_t* v8t, int8_t* of8,
                     int batch, int t, int c, int heads, float xs,
                     float score_scale, float out_scale, float eps,
                     const int* plans, cudaStream_t stream) {
  const int rows = batch * t;
  int err = launch_ln_quant<T>(x, x8, ln_w, ln_b, rows, c, xs, eps, nullptr,
                               0, stream);
  if (err != 0) return err;
  err = launch_qkv_attention(x8, w_qkv, m_qkv, ratio, q8, k8, v8t, of8, batch,
                             t, c, c, heads, score_scale, plans, stream);
  if (err != 0) return err;
  return gemm90::launch_gemm<true>(
      plans + 2 * gemm90::kPlanInts + kAttnPlanInts, of8, wo, rows, c, c, 0,
      ResidualS8Epi<T>{static_cast<const T*>(x), out_scale, out_b, out, c},
      stream);
}

// ---- K17 and K18 ------------------------------------------------------------
// (b) y = float(int32 x8 W^T) * (xs * ws[which][head]) in fp32 into y [rows,
// 3c], the product's columns q | k | v; ws [4][heads] holds the weight
// scales per head (K17) or the per-tensor scale repeated (K18). __fmul_rn:
// the scales' product rounds first, as in the TPU kernel. Returns the
// pair's max|y|, which the product folds per 8-row group and column group
// (part * groups + g, groups of gw columns) into amax[(part * batch + b) *
// groups + g], b = row / t.
struct AbsorbedProjEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 1;     // xs * ws[which][head]
  static constexpr int kIntCols = 1;  // the column's group
  static constexpr bool kGroupMax = true;
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  const float* ws;
  float xs;
  float* y;
  unsigned* amax;
  int c, d, heads, gw, batch, t;
  __device__ float col_value(int, int col) const {
    const int which = col / c;
    const int h = (col - which * c) / d;
    return __fmul_rn(xs, __ldg(ws + which * heads + h));
  }
  __device__ int col_int(int, int col) const {
    const int which = col / c;
    return which * (c / gw) + (col - which * c) / gw;
  }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ float operator()(int row, int col, const float2* cv,
                              const int2*, const RowPre&, const Pre&, int s0,
                              int s1) const {
    const float y0 = __fmul_rn(static_cast<float>(s0), cv[0].x);
    const float y1 = __fmul_rn(static_cast<float>(s1), cv[0].y);
    *reinterpret_cast<float2*>(y + static_cast<long long>(row) * 3 * c +
                               col) = make_float2(y0, y1);
    return fmaxf(fabsf(y0), fabsf(y1));
  }
  __device__ void group_max(int row, int group, float v) const {
    const int groups = c / gw;
    const int part = group / groups;
    atomicMax(amax + (part * batch + row / t) * groups + (group - part *
                                                              groups),
              __float_as_uint(v));
  }
};

// (c) and (e): the dynamic scale of each group of y [batch * t, ld] and its
// codes. The columns [0, parts * c) of y are `parts` parts (q | k | v, or
// oh alone) of c columns; a group is one image's t rows by gw columns of
// one part, indexed (p * batch + b) * (c / gw) + g, its amax bits in amax
// (folded by the product or the attention stage). One block per (64
// tokens, image, part and 64 columns): s = max(amax, 1e-6) / 127 in fp32
// (the group's first thread stores it in scales), y8 = rint(y / s), a true
// division (|y / s| <= 127, so the clip of quant_s8 never bites); parts 0
// and 1 into the head-padded pad[p] [batch * t, heads, dp], part 2
// through shared memory into v8t [batch, heads, d, tp] as quant_qkv's.
__global__ void __launch_bounds__(256)
    group_quant_kernel(const float* __restrict__ y, int ld, int c, int gw,
                       const unsigned* __restrict__ amax,
                       float* __restrict__ scales, int8_t* __restrict__ pad0,
                       int8_t* __restrict__ pad1, int8_t* __restrict__ v8t,
                       int batch, int t, int heads, int dp, int tp,
                       int ctiles) {
  __shared__ int8_t vt[kTok][kTok + 4];  // part 2's codes, [column][token]
  const int p = blockIdx.z / ctiles;
  const int c0 = (blockIdx.z - p * ctiles) * kTok;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTok;
  const int groups = c / gw;
  const int d = c / heads;
  for (int i = threadIdx.x; i < kTok * (kTok / 8); i += 256) {
    const int r = i / (kTok / 8);
    const int j = c0 + 8 * (i - r * (kTok / 8));
    const int tok = t0 + r;
    if (tok >= t || j >= c) continue;
    const int g = j / gw;
    const int gi = (p * batch + b) * groups + g;
    const float s = fmaxf(__uint_as_float(amax[gi]), 1e-6f) / 127.f;
    if (tok == 0 && j == g * gw) scales[gi] = s;
    const float* src = y + static_cast<long long>(b * t + tok) * ld + p * c + j;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int8_t c8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) c8[e] = quant_s8(v[e] / s);
    if (p < 2) {
      const int h = j / d;
      *reinterpret_cast<uint2*>(
          (p == 0 ? pad0 : pad1) +
          (static_cast<long long>(b * t + tok) * heads + h) * dp + (j - h * d)) =
          pack_codes(c8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[j - c0 + e][r] = c8[e];
    }
  }
  if (p < 2) return;
  __syncthreads();
  for (int i = threadIdx.x; i < kTok * (kTok / 4); i += 256) {
    const int col = i / (kTok / 4);
    const int q4 = (i - col * (kTok / 4)) * 4;
    if (c0 + col < c && t0 + q4 < tp) {
      *reinterpret_cast<uint32_t*>(
          v8t + (static_cast<long long>(b) * c + c0 + col) * tp + t0 + q4) =
          vt_word(vt[col], q4, t0, t);
    }
  }
}

int launch_group_quant(const float* y, int ld, int parts, int c, int gw,
                       const unsigned* amax, float* scales, int8_t* pad0,
                       int8_t* pad1, int8_t* v8t, int batch, int t, int heads,
                       int dp, int tp, cudaStream_t stream) {
  const int ctiles = (c + kTok - 1) / kTok;
  group_quant_kernel<<<dim3((t + kTok - 1) / kTok, batch, parts * ctiles),
                       256, 0, stream>>>(y, ld, c, gw, amax, scales, pad0,
                                         pad1, v8t, batch, t, heads, dp, tp,
                                         ctiles);
  return static_cast<int>(cudaGetLastError());
}

// (f) out = bf16(the per-head sum), f[b][h] = os[b][h] * wos[h]
struct HeadOutEpi {
  const float* os;   // [batch][heads]
  const float* wos;  // [heads]
  __nv_bfloat16* out;
  int n, heads;
  __device__ float head_factor(int b, int h) const {
    return __fmul_rn(__ldg(os + b * heads + h), __ldg(wos + h));
  }
  __device__ void operator()(int row, int col, float a0, float a1) const {
    *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * n +
                                 col) = sm90::pack_bf16(a0, a1);
  }
};

// (f) on a model axis: the per-head sum over this rank's heads in fp32, not
// rounded (the caller sums the ranks' partials and rounds once)
struct HeadPartialEpi {
  const float* os;   // [batch][heads]
  const float* wos;  // [heads]
  float* out;
  int n, heads;
  __device__ float head_factor(int b, int h) const {
    return __fmul_rn(__ldg(os + b * heads + h), __ldg(wos + h));
  }
  __device__ void operator()(int row, int col, float a0, float a1) const {
    *reinterpret_cast<float2*>(out + static_cast<long long>(row) * n + col) =
        make_float2(a0, a1);
  }
};

// K17 (gw = d: the projections' scales per (image, head)) and K18 (gw = c:
// per image), six kernels on the stream. x is [rows, c]; ci = heads * d is
// the inner width, c, or this rank's heads on a model axis (K17), where
// `partial` (fp32 [rows, c]) takes the per-head sum in place of out.
// plans: sm90_gemm_plan's of [rows, 3ci, c], sm90_s8pv_attention_plan's,
// sm90_gemm_plan's of [rows, c, heads * dp] (int8), in that order.
template <typename T>
int launch_absorbed_s8(const void* x, __nv_bfloat16* out, float* partial,
                       const int8_t* w_qkv, const int8_t* wo_p,
                       const float* ws, int8_t* x8, float* y, int8_t* q8,
                       int8_t* k8, int8_t* v8t, float* oh, int8_t* oh8,
                       float* scales, int batch, int t, int c, int ci,
                       int heads, int gw, float xs, float scale,
                       const int* plans, cudaStream_t stream) {
  const int rows = batch * t;
  const int d = ci / heads;
  const int groups = ci / gw;
  const int* attn_plan = plans + gemm90::kPlanInts;
  const int dp = attn_plan[5];
  const int tp = attn_plan[6];
  const int n_scales = 3 * batch * groups + batch * heads;
  float* os = scales + 3 * batch * groups;
  auto* amax = reinterpret_cast<unsigned*>(scales + n_scales);
  unsigned* oh_amax = amax + 3 * batch * groups;
  int err = launch_ln_quant<T, false>(x, x8, nullptr, nullptr, rows, c, xs,
                                      0.f, amax, n_scales, stream);
  if (err != 0) return err;
  err = gemm90::launch_gemm<true>(
      plans, x8, w_qkv, rows, 3 * ci, c, 0,
      AbsorbedProjEpi{ws, xs, y, amax, ci, d, heads, gw, batch, t}, stream);
  if (err != 0) return err;
  err = launch_group_quant(y, 3 * ci, 3, ci, gw, amax, scales, q8, k8, v8t,
                           batch, t, heads, dp, tp, stream);
  if (err != 0) return err;
  const Scales sc{scales, groups, nullptr, 0.f, 0.f, 0.f, scale, nullptr,
                  oh_amax};
  const attn90::Strides so{static_cast<long long>(t) * ci, ci, d};
  err = launch_attn<attn90::kOutF32>(attn_plan, q8, k8, v8t, oh, so, batch,
                                     t, heads, d, sc, stream);
  if (err != 0) return err;
  err = launch_group_quant(oh, ci, 1, ci, d, oh_amax, os, oh8, nullptr,
                           nullptr, batch, t, heads, dp, tp, stream);
  if (err != 0) return err;
  const int* out_plan = plans + gemm90::kPlanInts + kAttnPlanInts;
  if (partial != nullptr) {
    return gemm90::launch_gemm_heads(
        out_plan, oh8, wo_p, rows, c, heads, dp / 32, t,
        HeadPartialEpi{os, ws + 3 * heads, partial, c, heads}, stream);
  }
  return gemm90::launch_gemm_heads(
      out_plan, oh8, wo_p, rows, c, heads, dp / 32, t,
      HeadOutEpi{os, ws + 3 * heads, out, c, heads}, stream);
}

// what the attention stage takes (K13, K15), and with the products (K11,
// K10, K17, K18: T % 8 and C % 16, a row of x8 being a tensor map's stride)
bool attn_takes(int batch, int t, int heads, int d) {
  return batch >= 1 && t >= 1 && heads >= 1 && d >= 8 && d % 8 == 0 &&
         d <= kMaxD && batch * heads <= 65535;
}

bool takes(int batch, int t, int c, int heads) {
  return heads >= 1 && c % heads == 0 && attn_takes(batch, t, heads,
                                                    c / heads) &&
         t % 8 == 0 && c % 16 == 0;
}

int absorbed_s8_entry(int dtype, const void* x, void* out, float* partial,
                      const int8_t* w_qkv, const int8_t* wo_p,
                      const float* ws, int8_t* x8, float* y, int8_t* q8,
                      int8_t* k8, int8_t* v8t, float* oh, int8_t* oh8,
                      float* scales, int batch, int t, int c, int ci,
                      int heads, int gw, float xs, float scale,
                      const int* plans, void* stream) {
  if (ci < 1 || ci > c || c % 16 != 0 || heads < 1 || ci % heads != 0 ||
      t % 8 != 0 || !attn_takes(batch, t, heads, ci / heads) ||
      static_cast<long long>(batch) * t * ci * 3 >= (1ll << 31) ||
      static_cast<long long>(batch) * t * c >= (1ll << 31) ||
      static_cast<long long>(batch) * ci * ((t + 15) / 16 * 16) >=
          (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (dtype == 0) {
    return launch_absorbed_s8<float>(x, ob, partial, w_qkv, wo_p, ws, x8, y,
                                     q8, k8, v8t, oh, oh8, scales, batch, t,
                                     c, ci, heads, gw, xs, scale, plans, s);
  }
  if (dtype == 1) {
    return launch_absorbed_s8<__nv_bfloat16>(
        x, ob, partial, w_qkv, wo_p, ws, x8, y, q8, k8, v8t, oh, oh8, scales,
        batch, t, c, ci, heads, gw, xs, scale, plans, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K13: dtype of q, k, v: 0 = float32, 1 = bfloat16; each [batch, t, heads,
// d] with unit stride on d, strides holding their (b, t, h) element strides
// in that order. q8 and k8 (int8 [batch*t, heads, dp]) and v8t (int8
// [batch, heads, d, tp]) are scratch and o (bf16) the output, [batch, t,
// heads, d] contiguous. scale_dev: null for the static scales qs, ks, vs,
// else a device array of the three. plan: sm90_s8pv_attention_plan's.
// Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_s8(
    int dtype, const void* q, const void* k, const void* v,
    const long long* strides, int8_t* q8, int8_t* k8, int8_t* v8t, void* o,
    int batch, int t, int heads, int d, const float* scale_dev, float qs,
    float ks, float vs, float scale, const int* plan, void* stream) {
  if (!attn_takes(batch, t, heads, d) ||
      static_cast<long long>(batch) * ((t + 15) / 16 * 16) * heads * d >=
          (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (dtype == 0) {
    return launch<float>(q, k, v, strides, q8, k8, v8t, ob, batch, t, heads,
                         d, scale_dev, qs, ks, vs, scale, plan, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, strides, q8, k8, v8t, ob, batch, t,
                                 heads, d, scale_dev, qs, ks, vs, scale, plan,
                                 s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11: dtype of x 0 = float32, 1 = bfloat16, x [batch*t, c] contiguous;
// ci = heads * d the inner width (c, or this rank's heads on a model axis);
// w_qkv int8 [3ci, c] (rows: q, k, v output columns), m_qkv fp32 [3ci]
// (requant factors), wo int8 [c, ci] (out, in), ratio fp32 [heads]
// (wos[h] / max(wos), the maximum over all the heads of every rank).
// partial 0: out bf16 [batch*t, c] = bf16(of8 Wo8^T * out_scale); partial
// 1: out int32 [batch*t, c] = of8 Wo8^T of these heads, unscaled. x8 (int8
// [batch*t, c]), of8 (int8 [batch*t, ci]), q8 and k8 (int8 [batch*t, heads,
// dp]) and v8t (int8 [batch, ci, tp], its pad positions zero) are scratch.
// plans: launch_padded's four. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_padded_s8(
    int dtype, const void* x, void* out, const int8_t* w_qkv,
    const float* m_qkv, const int8_t* wo, const float* ratio, int8_t* x8,
    int8_t* q8, int8_t* k8, int8_t* v8t, int8_t* of8, int batch, int t, int c,
    int ci, int heads, float xs, float score_scale, float out_scale,
    int partial, const int* plans, void* stream) {
  if (ci < 1 || ci > c || c % 16 != 0 || !takes(batch, t, ci, heads) ||
      partial < 0 || partial > 1 || (!partial && ci != c) ||
      static_cast<long long>(batch) * ((t + 15) / 16 * 16) * c >=
          (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = partial ? nullptr : static_cast<__nv_bfloat16*>(out);
  int* part = partial ? static_cast<int*>(out) : nullptr;
  if (dtype == 0) {
    return launch_padded<float>(x, ob, part, w_qkv, m_qkv, wo, ratio, x8, q8,
                                k8, v8t, of8, batch, t, c, ci, heads, xs,
                                score_scale, out_scale, plans, s);
  }
  if (dtype == 1) {
    return launch_padded<__nv_bfloat16>(x, ob, part, w_qkv, m_qkv, wo, ratio,
                                        x8, q8, k8, v8t, of8, batch, t, c, ci,
                                        heads, xs, score_scale, out_scale,
                                        plans, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K15: dtype of q, k, v 0 = float32, 1 = bfloat16, each the packed token
// layout [batch, t, c] (c = heads * d) with unit stride on c; strides holds
// the (b, t) element strides of q, k and v in that order. The scales are
// always dynamic: scratch (24 bytes, 4-byte aligned) receives the three
// amax bit patterns and then the three scales (qs, ks, vs). q8, k8 and v8t
// are scratch as in ldmseg_attention_s8 and o (bf16) the output, [batch,
// t, c] contiguous. stage 0 runs the whole of it. On a model axis (q, k and
// v hold this rank's heads, c = heads * d of them) it runs in two: stage 1
// writes the three amax bit patterns into scratch and returns; the caller
// replaces them with the model group's maximum; stage 2 computes the scales
// from them and runs the attention, on the same arguments. Returns a
// cudaError_t (0 on success).
extern "C" int ldmseg_attention_packed_s8(
    int dtype, const void* q, const void* k, const void* v,
    const long long* strides, int8_t* q8, int8_t* k8, int8_t* v8t, void* o,
    int batch, int t, int c, int heads, void* scratch, float scale,
    const int* plan, int stage, void* stream) {
  if (heads < 1 || c % heads != 0 || stage < 0 || stage > 2 ||
      !attn_takes(batch, t, heads, c / heads) ||
      static_cast<long long>(batch) * ((t + 15) / 16 * 16) * c >=
          (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d = c / heads;
  long long st[9];
  for (int i = 0; i < 3; ++i) {
    st[3 * i] = strides[2 * i];
    st[3 * i + 1] = strides[2 * i + 1];
    st[3 * i + 2] = d;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* sc = static_cast<unsigned*>(scratch);
  if (dtype == 0) {
    return launch_packed<float>(q, k, v, st, q8, k8, v8t, ob, batch, t, heads,
                                d, sc, scale, plan, stage, s);
  }
  if (dtype == 1) {
    return launch_packed<__nv_bfloat16>(q, k, v, st, q8, k8, v8t, ob, batch,
                                        t, heads, d, sc, scale, plan, stage,
                                        s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K10 with v_bf16=False: dtype of x 0 = float32, 1 = bfloat16, x [batch*t,
// c] contiguous; out bf16 [batch*t, c]; ln_w, ln_b, out_b fp32 [c]; w_qkv,
// m_qkv, wo, ratio, the scratch and plans as in ldmseg_attention_padded_s8.
// Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_ln_padded_s8(
    int dtype, const void* x, void* out, const float* ln_w,
    const float* ln_b, const float* out_b, const int8_t* w_qkv,
    const float* m_qkv, const int8_t* wo, const float* ratio, int8_t* x8,
    int8_t* q8, int8_t* k8, int8_t* v8t, int8_t* of8, int batch, int t, int c,
    int heads, float xs, float score_scale, float out_scale, float eps,
    const int* plans, void* stream) {
  if (!takes(batch, t, c, heads) ||
      static_cast<long long>(batch) * ((t + 15) / 16 * 16) * c >=
          (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (dtype == 0) {
    return launch_ln_padded<float>(x, ob, ln_w, ln_b, out_b, w_qkv, m_qkv,
                                   wo, ratio, x8, q8, k8, v8t, of8, batch, t,
                                   c, heads, xs, score_scale, out_scale, eps,
                                   plans, s);
  }
  if (dtype == 1) {
    return launch_ln_padded<__nv_bfloat16>(
        x, ob, ln_w, ln_b, out_b, w_qkv, m_qkv, wo, ratio, x8, q8, k8, v8t,
        of8, batch, t, c, heads, xs, score_scale, out_scale, eps, plans, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K17: dtype of x 0 = float32, 1 = bfloat16, x [batch*t, c] contiguous;
// ci = heads * d is the inner width, c, or on a model axis's rank the width
// of its heads; w_qkv int8 [3ci, c] (rows: q, k, v output columns, a rank's
// rows of each), quantized per head; wo_p int8 [c, heads, dp], to_out's
// codes (out, in) of these heads with each head's d inputs padded with
// zeros to dp; ws fp32 [4][heads], the per-head scales of q, k, v and o.
// partial 0: out bf16 [batch*t, c]; 1 (the partial mode): out fp32
// [batch*t, c], to_out's per-head sum over these heads, not rounded (the
// scales are per (image, head), so a rank's heads need nothing of the
// others). x8 (int8 [batch*t, c]), y (fp32 [batch*t, 3ci]), q8 and k8
// (int8 [batch*t, heads, dp]), v8t (int8 [batch, ci, tp]), oh (fp32
// [batch*t, ci]), oh8 (int8 [batch*t, heads, dp]) and scales (4-byte words
// [2 * 4 * batch * heads]: the scales, then as many amax words) are
// scratch. xs: x's static scale. plans: sm90_gemm_plan's of [batch*t, 3ci,
// c], sm90_s8pv_attention_plan's, sm90_gemm_plan's of [batch*t, c, heads *
// dp]. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_absorbed_s8(
    int dtype, const void* x, void* out, const int8_t* w_qkv,
    const int8_t* wo_p, const float* ws, int8_t* x8, float* y, int8_t* q8,
    int8_t* k8, int8_t* v8t, float* oh, int8_t* oh8, float* scales,
    int batch, int t, int c, int ci, int heads, float xs, float scale,
    const int* plans, int partial, void* stream) {
  if (heads < 1 || ci % heads != 0 || partial < 0 || partial > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* part = partial ? static_cast<float*>(out) : nullptr;
  return absorbed_s8_entry(dtype, x, partial ? nullptr : out, part, w_qkv,
                           wo_p, ws, x8, y, q8, k8, v8t, oh, oh8, scales,
                           batch, t, c, ci, heads, ci / heads, xs, scale,
                           plans, stream);
}

// K18: K17's arguments with ci = c and partial 0 (it has no partial mode),
// ws holding each tensor's one scale repeated over the heads, the
// projections' dynamic scales per image over all c columns; scales is [2 *
// (3 * batch + batch * heads)] 4-byte words. Returns a cudaError_t.
extern "C" int ldmseg_attention_absorbed_fullc_s8(
    int dtype, const void* x, void* out, const int8_t* w_qkv,
    const int8_t* wo_p, const float* ws, int8_t* x8, float* y, int8_t* q8,
    int8_t* k8, int8_t* v8t, float* oh, int8_t* oh8, float* scales,
    int batch, int t, int c, int ci, int heads, float xs, float scale,
    const int* plans, int partial, void* stream) {
  if (ci != c || partial != 0) return static_cast<int>(cudaErrorInvalidValue);
  return absorbed_s8_entry(dtype, x, out, nullptr, w_qkv, wo_p, ws, x8, y,
                           q8, k8, v8t, oh, oh8, scales, batch, t, c, c,
                           heads, c, xs, scale, plans, stream);
}
