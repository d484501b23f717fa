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
//   a. quant_qkv: one thread per 8 elements of q, k and v (read through
//      their [B, T, H, D] strides, so the caller's head views cost nothing;
//      32-bit index math: the first design's three 64-bit divisions per
//      element made this pass 1.2 ms of a UNet forward), int8 codes written
//      contiguous [B, T, H, D] into scratch;
//   b. attn_s8: one block of 4 warps per (image*head, 64-query tile); each
//      warp owns 16 query rows. The rounding of e to codes needs the final
//      row max, so the kernel takes two passes over 64-key tiles, as K1 and
//      K3 do: pass 1 the row max of the scaled int32 scores, pass 2 e, its
//      fp32 sum, the codes e8 in shared memory and the int8 product e8 V8
//      into int32 accumulators. An online rescale would round e at another
//      scale. Both products run on int8 wmma m16n16k16; D is zero-padded
//      in shared memory to a multiple of 16 (40 -> 48; zeros are exact);
//      keys past T are masked (T = 120 and 24 take the kernel).
// Shared-memory layouts keep every wmma fragment on a 256-byte boundary:
// Q and K tiles k-blocked ([D/16][64 rows][16], s8_common.cuh), the e8 tile
// k-blocked over keys ([4][64 rows][16]), the V tile as 16x16 blocks
// ([4 key slices][D/16 column tiles][16 keys][16 columns]), the row-major B
// operand with ld 16. A simple kernel that is right comes first.
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
// with the scales in device memory (the last-but-one entry point), behind
// two small kernels that compute them: the three amaxes (atomicMax per
// warp) and max(amax, 1e-6) / 127. A wrapper chain of PyTorch reductions
// cost more host time than the attention itself at the UNet's shapes.
//
// K10 with v_bf16=False replaces _attn_kernel_abs_padded_ln_s8 (pallas_call
// in _abs_padded_ln_s8_impl, absorbed_padded_ln_self_attention_s8(...,
// v_bf16=False)): K11's rounding points 2-4 on x8 = clip(rint(LN(x) / xs))
// (K3's step 1-2), then out = bf16((float(x) + float(of8 Wo8) * (as *
// max(wos))) + b_out). Four kernels: ln_quant with the LN, K11's (b) and
// (c), and the to_out product with the residual epilogue (ResidualS8Epi).
//
// What bounds it: K3's work without the LN, with P V and to_out on int8:
// per image 4 * 2*T*C^2 + 2 * 2*H*T^2*d int8 operations at 1,979 TOPS
// against x in, the int8 weights and the bf16 output.
//
// Design. Four kernels on the stream, int8 intermediates through device
// memory: (a) ln_quant without the LN (s8_common.cuh), x -> x8; (b)
// s8_gemm_kernel with the three projections requantized in its epilogue
// (K3's, with v8 int8); (c) attn_s8 above with sc0 = the score scale and
// the epilogue of step 4 (template value kOutS8); (d) s8_gemm_kernel of of8
// with Wo8 and the dequantize of step 5.
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
// heads are column offsets and the pad rows are not stored.
//
// What bounds them: per image 4 * 2*T*C^2 + 2 * 2*H*T^2*d int8 operations
// at 1,979 TOPS against x in, the int8 weights and the bf16 output.
//
// Design (K17 and K18 differ only in the width of step 2's groups): eight
// kernels on the stream, fp32 and int8 intermediates through device memory.
// (a) ln_quant without the LN: x8; (b) s8_gemm_kernel of x8 with the three
// [C, C] codes as one [3C, C] product, step 1 in its epilogue into fp32 y
// (AbsorbedProjEpi; K18's per-tensor scales arrive repeated per head); (c)
// group_amax_kernel (many blocks per group, an atomicMax each) and
// group_quant_kernel (elementwise): step 2 needs the whole tile's amax
// before the first code; (d) attn_s8_kernel above on the head views of
// y8, reading each block's (image, head) scales from (c), with the fp32
// epilogue of step 6; (e) the same two kernels per (image, head) of oh:
// step 7; (f) head_out_kernel: per 64 x 64 output tile, each head's int32
// product over its d columns (zero-padded to 16 in shared memory), scaled
// by os * wos[h] and added in fp32 registers, h = 0 first.

#include "s8_common.cuh"

namespace {

using namespace s8;

constexpr int kMaxD = 160;                // largest head dim taken
constexpr int kMaxDTiles = kMaxD / 16;    // output column tiles per warp
constexpr float kLn127 = 4.844187086458591f;

struct Strides {
  long long b, t, h;  // element strides of the B, T and H axes (D is 1)
};

struct QKV {
  const void* x[3];   // q, k, v
  Strides st[3];
  int8_t* x8[3];      // their codes, contiguous [B, T, H, D]
};

// the 8 elements of q, k or v (which) that thread unit u owns: unit u is
// row (b * t + token) * heads + head, columns [8 (u % (d / 8)), +8)
template <typename T>
__device__ __forceinline__ const T* qkv_unit(const QKV& a, int which, int u,
                                             int t, int heads, int d) {
  const int per_row = d / 8;
  const int row = u / per_row;
  const int j = (u - row * per_row) * 8;
  const int bt = row / heads;
  const int h = row - bt * heads;
  const int b = bt / t;
  const int tok = bt - b * t;
  const Strides s = a.st[which];
  return static_cast<const T*>(a.x[which]) + b * s.b + tok * s.t + h * s.h +
         j;
}

// ---- a: quantize q, k and v ------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
    quant_qkv_kernel(QKV a, int units, int t, int heads, int d,
                     const float* __restrict__ scale_dev, float qs, float ks,
                     float vs) {
  const int which = blockIdx.y;
  const int u = blockIdx.x * 256 + threadIdx.x;  // 8 elements of one row
  if (u >= units) return;
  const T* x = qkv_unit<T>(a, which, u, t, heads, d);
  const float sc = scale_dev != nullptr
                       ? scale_dev[which]
                       : (which == 0 ? qs : (which == 1 ? ks : vs));
  int8_t* y = a.x8[which] + static_cast<long long>(u) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) y[e] = quant_s8(to_f(x[e]) / sc);
}

// ---- K15's dynamic scales: amax of |q|, |k|, |v| ---------------------------
// Each warp's max by shuffles, then one atomicMax per warp on the float's
// bits into amax[which] (zeroed before): non-negative floats order as their
// bit patterns, and a max is exact in any order.
template <typename T>
__global__ void __launch_bounds__(256)
    amax_qkv_kernel(QKV a, int units, int t, int heads, int d,
                    unsigned* __restrict__ amax) {
  const int which = blockIdx.y;
  const int u = blockIdx.x * 256 + threadIdx.x;
  float m = 0.f;
  if (u < units) {
    const T* x = qkv_unit<T>(a, which, u, t, heads, d);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(to_f(x[e])));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) atomicMax(amax + which, __float_as_uint(m));
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

// rows [row0, row0+64) of one head's int8 [t, d] slice (row stride ld) into
// 16x16 blocks: block (key slice kk, column tile n) at (kk * ntiles + n) *
// 256, row-major inside; zero past t and d
__device__ __forceinline__ void load_head_s8_blocks(
    int8_t* dst, const int8_t* __restrict__ src, int ld, int row0, int t,
    int d, int dp) {
  const int units = dp / 8;
  const int ntiles = dp / 16;
  for (int i = threadIdx.x; i < kTile * units; i += kThreads) {
    const int r = i / units;
    const int u = i - r * units;
    uint2 val = make_uint2(0u, 0u);
    if (row0 + r < t && u * 8 < d) {
      val = *reinterpret_cast<const uint2*>(
          src + static_cast<long long>(row0 + r) * ld + u * 8);
    }
    *reinterpret_cast<uint2*>(dst + ((r >> 4) * ntiles + (u >> 1)) * 256 +
                              (r & 15) * 16 + (u & 1) * 8) = val;
  }
}

// ---- b: attention per (image*head, 64-query tile) ------------------------
// The epilogue on o32 = int32 e8 V8 and denom, into o [B, T, H, D]:
//   kOutBf16 (K13): o = bf16(float(o32) * ((sc1 * 127) / denom));
//   kOutS8 (K11): of8 = clip(rint(float(o32) * (ratio[h] / denom)));
//   kOutF32 (K17, K18): oh = (float(o32) * vs) / denom in fp32.
// q8, k8 and v8 are read with the token row stride ld (heads * d, or 3c
// for K17's and K18's q | k | v rows). The scales: group_scales, per
// (tensor, image, group) as [3][batch][groups] with head h in group h *
// groups / heads (K17, K18); else scale_dev, three per tensor; else the
// static qs, ks, vs.
constexpr int kOutBf16 = 0;
constexpr int kOutS8 = 1;
constexpr int kOutF32 = 2;

template <int kOut>
__global__ void __launch_bounds__(kThreads)
    attn_s8_kernel(const int8_t* __restrict__ q8,
                   const int8_t* __restrict__ k8,
                   const int8_t* __restrict__ v8, void* __restrict__ o,
                   int heads, int t, int d, int ld,
                   const float* __restrict__ scale_dev, float qs, float ks,
                   float vs, float scale, const float* __restrict__ ratio,
                   const float* __restrict__ group_scales, int groups) {
  using namespace nvcuda;
  extern __shared__ __align__(256) unsigned char smem[];
  const int dp = (d + 15) & ~15;
  const int ntiles = dp / 16;
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ks = Qs + kTile * dp;
  int8_t* Vs = Ks + kTile * dp;
  int8_t* Es = Vs + kTile * dp;
  int* S = reinterpret_cast<int*>(Es + kTile * kTile);

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  if (group_scales != nullptr) {
    const int batch = gridDim.y / heads;
    const int g = b * groups + h * groups / heads;
    qs = group_scales[g];
    ks = group_scales[batch * groups + g];
    vs = group_scales[2 * batch * groups + g];
  } else if (scale_dev != nullptr) {
    qs = scale_dev[0];
    ks = scale_dev[1];
    vs = scale_dev[2];
  }
  const float sc0 = (qs * ks) * scale;
  const float sc1 = vs / 127.f;

  const int q0 = blockIdx.x * kTile;
  const long long base = static_cast<long long>(b) * t * ld + h * d;
  const int ldo = heads * d;
  const long long obase = (static_cast<long long>(b) * t * heads + h) * d;
  load_head_s8(Qs, q8 + base, ld, q0, t, d, dp);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int row = warp * 16 + (lane >> 1);  // this lane pair's query row
  const int half = lane & 1;                // columns half, half+2, ...
  float m_run = -INFINITY;

  // pass 1: the row max of the scaled scores
  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();
    load_head_s8(Ks, k8 + base, ld, k0, t, d, dp);
    __syncthreads();
    score_tile(Qs, Ks, S, dp);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int cc = half + 2 * j;
      if (k0 + cc < t) {
        m_run = fmaxf(m_run,
                      __fmul_rn(static_cast<float>(S[row * kStageLd + cc]),
                                sc0));
      }
    }
    __syncwarp();
  }
  m_run = fmaxf(m_run, __shfl_xor_sync(0xffffffffu, m_run, 1));

  // pass 2: e = exp((s - max) + ln 127), denom += e, e8 = rint(e),
  // O += e8 V8 (int32)
  AccFrag acc_o[kMaxDTiles];
#pragma unroll
  for (int n = 0; n < kMaxDTiles; ++n) wmma::fill_fragment(acc_o[n], 0);
  float l_run = 0.f;
  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();
    load_head_s8(Ks, k8 + base, ld, k0, t, d, dp);
    load_head_s8_blocks(Vs, v8 + base, ld, k0, t, d, dp);
    __syncthreads();
    score_tile(Qs, Ks, S, dp);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int cc = half + 2 * j;
      int8_t e8 = 0;
      if (k0 + cc < t) {
        // __fmul_rn: s rounds before the subtraction, as in the TPU kernel
        // (no fused multiply-add)
        const float s =
            __fmul_rn(static_cast<float>(S[row * kStageLd + cc]), sc0);
        const float e = expf((s - m_run) + kLn127);
        l_run += e;
        e8 = static_cast<int8_t>(rintf(e));
      }
      Es[(cc >> 4) * kSlab + row * 16 + (cc & 15)] = e8;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          a;
      wmma::load_matrix_sync(a, Es + kk * kSlab + warp * 16 * 16, 16);
#pragma unroll
      for (int n = 0; n < kMaxDTiles; ++n) {
        if (n < ntiles) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::row_major>
              bv;
          wmma::load_matrix_sync(bv, Vs + (kk * ntiles + n) * 256, 16);
          wmma::mma_sync(acc_o[n], a, bv, acc_o[n]);
        }
      }
    }
  }
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  const float f = kOut == kOutS8 ? ratio[h] / l_run : (sc1 * 127.f) / l_run;

  // o = bf16(o32 * f) (or of8) for query rows < t and columns < d, staged
  // per warp through this warp's rows of S
  int* stage = S + warp * 16 * kStageLd;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kMaxDTiles; ++n) {
    if (n < ntiles) {
      wmma::store_matrix_sync(stage, acc_o[n], kStageLd, wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1;
      const int grow = q0 + warp * 16 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = n * 16 + (lane & 1) * 8 + j;
        if (grow < t && cc < d) {
          const long long at = obase + static_cast<long long>(grow) * ldo + cc;
          const float acc =
              static_cast<float>(stage[r * kStageLd + (lane & 1) * 8 + j]);
          if constexpr (kOut == kOutF32) {
            static_cast<float*>(o)[at] = (acc * vs) / l_run;
          } else if constexpr (kOut == kOutS8) {
            static_cast<int8_t*>(o)[at] = quant_s8(acc * f);
          } else {
            static_cast<__nv_bfloat16*>(o)[at] = __float2bfloat16_rn(acc * f);
          }
        }
      }
      __syncwarp();
    }
  }
}

size_t attn_smem(int d) {
  const int dp = (d + 15) & ~15;
  return 3 * kTile * dp + kTile * kTile + kTile * kStageLd * sizeof(int);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const long long* st,
           int8_t* q8, int8_t* k8, int8_t* v8, __nv_bfloat16* o, int batch,
           int t, int heads, int d, const float* scale_dev, float qs,
           float ks, float vs, float scale, cudaStream_t stream) {
  QKV a;
  a.x[0] = q;
  a.x[1] = k;
  a.x[2] = v;
  a.x8[0] = q8;
  a.x8[1] = k8;
  a.x8[2] = v8;
  for (int i = 0; i < 3; ++i) a.st[i] = Strides{st[3 * i], st[3 * i + 1],
                                                st[3 * i + 2]};
  const int units = batch * t * heads * (d / 8);
  const dim3 grid_q((units + 255) / 256, 3);
  quant_qkv_kernel<T><<<grid_q, 256, 0, stream>>>(a, units, t, heads, d,
                                                  scale_dev, qs, ks, vs);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t smem = attn_smem(d);
  err = static_cast<int>(cudaFuncSetAttribute(
      attn_s8_kernel<kOutBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  const dim3 grid((t + kTile - 1) / kTile, batch * heads);
  attn_s8_kernel<kOutBf16><<<grid, kThreads, smem, stream>>>(
      q8, k8, v8, o, heads, t, d, heads * d, scale_dev, qs, ks, vs, scale,
      nullptr, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// K15: the dynamic scales into scratch (amax bits, then the three
// scales), then K13's two kernels reading them from device memory
template <typename T>
int launch_packed(const void* q, const void* k, const void* v,
                  const long long* st, int8_t* q8, int8_t* k8, int8_t* v8,
                  __nv_bfloat16* o, int batch, int t, int heads, int d,
                  unsigned* scratch, float scale, cudaStream_t stream) {
  QKV a;
  a.x[0] = q;
  a.x[1] = k;
  a.x[2] = v;
  for (int i = 0; i < 3; ++i) a.st[i] = Strides{st[3 * i], st[3 * i + 1],
                                                st[3 * i + 2]};
  int err = static_cast<int>(
      cudaMemsetAsync(scratch, 0, 3 * sizeof(unsigned), stream));
  if (err != 0) return err;
  const int units = batch * t * heads * (d / 8);
  amax_qkv_kernel<T><<<dim3((units + 255) / 256, 3), 256, 0, stream>>>(
      a, units, t, heads, d, scratch);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  float* scales = reinterpret_cast<float*>(scratch + 3);
  amax_scales_kernel<T><<<1, 32, 0, stream>>>(scratch, scales);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch<T>(q, k, v, st, q8, k8, v8, o, batch, t, heads, d, scales,
                   0.f, 0.f, 0.f, scale, stream);
}

// K11's to_out: out = bf16(float(sum) * scale), [rows, n]
struct DequantBf16Epi {
  static constexpr bool kColMajor = false;
  float scale;
  __nv_bfloat16* out;
  int n;
  __device__ void operator()(int row, int col, int sum) const {
    out[static_cast<long long>(row) * n + col] =
        __float2bfloat16_rn(static_cast<float>(sum) * scale);
  }
};

// (b) and (c) of K11 and K10: the three projections of x8 requantized
// per column, and the e8 attention with the of8 epilogue
int launch_qkv_attention(const int8_t* x8, const int8_t* w_qkv,
                         const float* m_qkv, const float* ratio, int8_t* q8,
                         int8_t* k8, int8_t* v8, int8_t* of8, int batch,
                         int t, int c, int heads, float score_scale,
                         cudaStream_t stream) {
  const int rows = batch * t;
  const int d = c / heads;
  int err = launch_s8_gemm(x8, w_qkv, rows, 3 * c, c,
                           QkvEpi{m_qkv, q8, k8, v8, c}, stream);
  if (err != 0) return err;
  const size_t smem = attn_smem(d);
  err = static_cast<int>(cudaFuncSetAttribute(
      attn_s8_kernel<kOutS8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  // sc0 = (1 * 1) * score_scale: the score scale exactly
  const dim3 grid((t + kTile - 1) / kTile, batch * heads);
  attn_s8_kernel<kOutS8><<<grid, kThreads, smem, stream>>>(
      q8, k8, v8, of8, heads, t, d, c, nullptr, 1.f, 1.f, 1.f, score_scale,
      ratio, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_padded(const void* x, __nv_bfloat16* out, const int8_t* w_qkv,
                  const float* m_qkv, const int8_t* wo, const float* ratio,
                  int8_t* x8, int8_t* q8, int8_t* k8, int8_t* v8,
                  int8_t* of8, int batch, int t, int c, int heads, float xs,
                  float score_scale, float out_scale, cudaStream_t stream) {
  const int rows = batch * t;
  int err = launch_ln_quant<T, false>(x, x8, nullptr, nullptr, rows, c, xs,
                                      0.f, nullptr, 0, stream);
  if (err != 0) return err;
  err = launch_qkv_attention(x8, w_qkv, m_qkv, ratio, q8, k8, v8, of8, batch,
                             t, c, heads, score_scale, stream);
  if (err != 0) return err;
  return launch_s8_gemm(of8, wo, rows, c, c,
                        DequantBf16Epi{out_scale, out, c}, stream);
}

// K10's to_out: out = bf16((float(x) + float(sum) * scale) + bias[col]),
// x the block's input [rows, n] in its type. __fmul_rn: the product rounds
// before the residual add, as in the TPU kernel (no fused multiply-add).
template <typename T>
struct ResidualS8Epi {
  static constexpr bool kColMajor = false;
  const T* x;
  float scale;
  const float* bias;
  __nv_bfloat16* out;
  int n;
  __device__ void operator()(int row, int col, int sum) const {
    const long long at = static_cast<long long>(row) * n + col;
    out[at] = __float2bfloat16_rn(
        (to_f(x[at]) + __fmul_rn(static_cast<float>(sum), scale)) +
        bias[col]);
  }
};

template <typename T>
int launch_ln_padded(const void* x, __nv_bfloat16* out, const float* ln_w,
                     const float* ln_b, const float* out_b,
                     const int8_t* w_qkv, const float* m_qkv,
                     const int8_t* wo, const float* ratio, int8_t* x8,
                     int8_t* q8, int8_t* k8, int8_t* v8, int8_t* of8,
                     int batch, int t, int c, int heads, float xs,
                     float score_scale, float out_scale, float eps,
                     cudaStream_t stream) {
  const int rows = batch * t;
  int err = launch_ln_quant<T>(x, x8, ln_w, ln_b, rows, c, xs, eps, nullptr,
                               0, stream);
  if (err != 0) return err;
  err = launch_qkv_attention(x8, w_qkv, m_qkv, ratio, q8, k8, v8, of8, batch,
                             t, c, heads, score_scale, stream);
  if (err != 0) return err;
  return launch_s8_gemm(
      of8, wo, rows, c, c,
      ResidualS8Epi<T>{static_cast<const T*>(x), out_scale, out_b, out, c},
      stream);
}

// ---- K17 and K18 ------------------------------------------------------------
// the three projections y = float(int32 x8 W^T) * (xs * ws[which][head]) in
// fp32 into y [rows, 3c], the product's columns q | k | v; ws [4][heads]
// holds the weight scales per head (K17) or the per-tensor scale repeated
// (K18). __fmul_rn: the scales' product rounds first, as in the TPU kernel.
struct AbsorbedProjEpi {
  static constexpr bool kColMajor = false;
  const float* ws;
  float xs;
  float* y;
  int c, d, heads;
  __device__ void operator()(int row, int col, int sum) const {
    const int which = col / c;
    const int h = (col - which * c) / d;
    y[static_cast<long long>(row) * 3 * c + col] = __fmul_rn(
        static_cast<float>(sum), __fmul_rn(xs, ws[which * heads + h]));
  }
};

// Steps 2 and 7 of K17 and K18: the dynamic scale of each group of y
// [batch * t, ld] and its codes. The columns [0, parts * part_cols) of y
// are `parts` parts (q | k | v, or oh alone) of part_cols = groups * gw
// columns; a group is one image's t rows by gw columns of one part (gw = d:
// a head; K18's projections gw = c), indexed (p * batch + b) * groups + g.
// Two kernels, so that every group is read by many blocks at once (the
// first design gave each group one block: 2.1 ms per K17 forward, latency
// bound, and K18's projections only 3 * batch blocks):
// group_amax_kernel: one block per (image, 32-row chunk; group; part): the
// chunk's max of |y|, then one atomicMax on the float's bits into
// amax[group] (zeroed before; non-negative floats order as their bits, and
// a max is exact in any order).
constexpr int kAmaxRows = 32;

__global__ void __launch_bounds__(256)
    group_amax_kernel(const float* __restrict__ y, unsigned* __restrict__ amax,
                      int t, int ld, int part_cols, int gw) {
  __shared__ float red[8];
  const int chunks = (t + kAmaxRows - 1) / kAmaxRows;
  const int b = blockIdx.x / chunks;
  const int r0 = (blockIdx.x - b * chunks) * kAmaxRows;
  const int g = blockIdx.y;
  const int p = blockIdx.z;
  const int n = min(kAmaxRows, t - r0) * gw;
  const long long base = (static_cast<long long>(b) * t + r0) * ld +
                         p * part_cols + g * gw;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += 256) {
    const int r = i / gw;
    m = fmaxf(m, fabsf(y[base + static_cast<long long>(r) * ld +
                         (i - r * gw)]));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = warp_max(threadIdx.x < 8 ? red[threadIdx.x] : 0.f);
    if (threadIdx.x == 0) {
      const int batch = gridDim.x / chunks;
      atomicMax(amax + (p * batch + b) * gridDim.y + g, __float_as_uint(m));
    }
  }
}

// group_quant_kernel: one thread per 8 consecutive elements of a row: s =
// max(amax, 1e-6) / 127 in fp32 (the group's first thread stores it in
// scales), then y8 = rint(y / s), a true division (|y / s| <= 127, so the
// clip of quant_s8 never bites).
__global__ void __launch_bounds__(256)
    group_quant_kernel(const float* __restrict__ y, int8_t* __restrict__ y8,
                       const unsigned* __restrict__ amax,
                       float* __restrict__ scales, int batch, int t, int ld,
                       int part_cols, int gw, int units_per_row) {
  const int u = blockIdx.x * 256 + threadIdx.x;
  if (u >= batch * t * units_per_row) return;
  const int row = u / units_per_row;
  const int j = (u - row * units_per_row) * 8;
  const int p = j / part_cols;
  const int g = (j - p * part_cols) / gw;
  const int b = row / t;
  const int gi = (p * batch + b) * (part_cols / gw) + g;
  const float s = fmaxf(__uint_as_float(amax[gi]), 1e-6f) / 127.f;
  if (row == b * t && j == p * part_cols + g * gw) scales[gi] = s;
  const long long at = static_cast<long long>(row) * ld + j;
  const float4 lo = *reinterpret_cast<const float4*>(y + at);
  const float4 hi = *reinterpret_cast<const float4*>(y + at + 4);
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  char4 c0, c1;
  c0.x = quant_s8(v[0] / s);
  c0.y = quant_s8(v[1] / s);
  c0.z = quant_s8(v[2] / s);
  c0.w = quant_s8(v[3] / s);
  c1.x = quant_s8(v[4] / s);
  c1.y = quant_s8(v[5] / s);
  c1.z = quant_s8(v[6] / s);
  c1.w = quant_s8(v[7] / s);
  *reinterpret_cast<char4*>(y8 + at) = c0;
  *reinterpret_cast<char4*>(y8 + at + 4) = c1;
}

// steps 2 or 7 on `parts` parts of y: the amax bits (scratch, zeroed
// here), then the scales and the codes
int quant_groups(const float* y, int8_t* y8, float* scales, unsigned* amax,
                 int batch, int t, int ld, int parts, int part_cols, int gw,
                 cudaStream_t stream) {
  const int groups = part_cols / gw;
  int err = static_cast<int>(cudaMemsetAsync(
      amax, 0, sizeof(unsigned) * parts * batch * groups, stream));
  if (err != 0) return err;
  const int chunks = (t + kAmaxRows - 1) / kAmaxRows;
  group_amax_kernel<<<dim3(batch * chunks, groups, parts), 256, 0, stream>>>(
      y, amax, t, ld, part_cols, gw);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int per_row = parts * part_cols / 8;
  const int units = batch * t * per_row;
  group_quant_kernel<<<(units + 255) / 256, 256, 0, stream>>>(
      y, y8, amax, scales, batch, t, ld, part_cols, gw, per_row);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxDp = (kMaxD + 15) & ~15;  // a head's depth, padded

// to_out per head: out[row, col] = bf16(sum over h, h = 0 first, of
// float(int32 oh8[row, head h] . wo8[col, head h]) * (os[b][h] * wos[h]))
// with b = row / t. Each head's depth d is zero-padded to a multiple of 16
// in shared memory (zeros are exact); the 64 x 64 output tile's fp32 sums
// stay in registers across the heads. __fmul_rn/__fadd_rn: no fused
// multiply-add, so the sum rounds where the TPU kernel's does.
__global__ void __launch_bounds__(kThreads)
    head_out_kernel(const int8_t* __restrict__ oh8,
                    const int8_t* __restrict__ wo8,
                    const float* __restrict__ os,
                    const float* __restrict__ wos,
                    __nv_bfloat16* __restrict__ out, int rows, int t, int c,
                    int heads) {
  __shared__ __align__(256) int8_t As[kTile * kMaxDp];
  __shared__ __align__(256) int8_t Bs[kTile * kMaxDp];
  __shared__ __align__(256) int S[kTile * kStageLd];
  constexpr int kPer = kTile * kTile / kThreads;
  const int d = c / heads;
  const int dp = (d + 15) & ~15;
  const int r0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  for (int h = 0; h < heads; ++h) {
    __syncthreads();
    load_head_s8(As, oh8 + h * d, c, r0, rows, d, dp);
    load_head_s8(Bs, wo8 + h * d, c, n0, c, d, dp);
    __syncthreads();
    score_tile(As, Bs, S, dp);
    __syncthreads();
    const float wsh = wos[h];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kTile;
      const int cc = i - r * kTile;
      if (r0 + r < rows && n0 + cc < c) {
        const float f = __fmul_rn(os[((r0 + r) / t) * heads + h], wsh);
        acc[j] = __fadd_rn(
            acc[j], __fmul_rn(static_cast<float>(S[r * kStageLd + cc]), f));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kTile;
    const int cc = i - r * kTile;
    if (r0 + r < rows && n0 + cc < c) {
      out[static_cast<long long>(r0 + r) * c + n0 + cc] =
          __float2bfloat16_rn(acc[j]);
    }
  }
}

// K17 (gw = d: the projections' scales per (image, head)) and K18 (gw = c:
// per image), eight kernels on the stream: the static-scale quantize of x,
// the three projections, their dynamic quantize (amax, codes), the
// attention with the fp32 oh epilogue, its quantize per (image, head)
// (amax, codes), to_out per head.
template <typename T>
int launch_absorbed_s8(const void* x, __nv_bfloat16* out,
                       const int8_t* w_qkv, const int8_t* wo,
                       const float* ws, int8_t* x8, float* y, int8_t* y8,
                       float* oh, int8_t* oh8, float* scales, int batch,
                       int t, int c, int heads, int gw, float xs,
                       float scale, cudaStream_t stream) {
  const int rows = batch * t;
  const int d = c / heads;
  const int groups = c / gw;
  const int n_scales = 3 * batch * groups + batch * heads;
  float* os = scales + 3 * batch * groups;
  auto* amax = reinterpret_cast<unsigned*>(scales + n_scales);
  int err = launch_ln_quant<T, false>(x, x8, nullptr, nullptr, rows, c, xs,
                                      0.f, nullptr, 0, stream);
  if (err != 0) return err;
  err = launch_s8_gemm(x8, w_qkv, rows, 3 * c, c,
                       AbsorbedProjEpi{ws, xs, y, c, d, heads}, stream);
  if (err != 0) return err;
  err = quant_groups(y, y8, scales, amax, batch, t, 3 * c, 3, c, gw, stream);
  if (err != 0) return err;
  const size_t smem = attn_smem(d);
  err = static_cast<int>(cudaFuncSetAttribute(
      attn_s8_kernel<kOutF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  const dim3 grid((t + kTile - 1) / kTile, batch * heads);
  attn_s8_kernel<kOutF32><<<grid, kThreads, smem, stream>>>(
      y8, y8 + c, y8 + 2 * c, oh, heads, t, d, 3 * c, nullptr, 0.f, 0.f, 0.f,
      scale, nullptr, scales, groups);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = quant_groups(oh, oh8, os, amax, batch, t, c, 1, c, d, stream);
  if (err != 0) return err;
  head_out_kernel<<<dim3((rows + kTile - 1) / kTile, (c + kTile - 1) / kTile),
                    kThreads, 0, stream>>>(oh8, wo, os, ws + 3 * heads, out,
                                           rows, t, c, heads);
  return static_cast<int>(cudaGetLastError());
}

int absorbed_s8_entry(int dtype, const void* x, void* out,
                      const int8_t* w_qkv, const int8_t* wo, const float* ws,
                      int8_t* x8, float* y, int8_t* y8, float* oh,
                      int8_t* oh8, float* scales, int batch, int t, int c,
                      int heads, int gw, float xs, float scale,
                      void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || c % heads != 0 || c % 8 != 0 ||
      (c / heads) % 8 != 0 || c / heads > kMaxD || batch * heads > 65535 ||
      static_cast<long long>(batch) * t * c * 3 >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (dtype == 0) {
    return launch_absorbed_s8<float>(x, ob, w_qkv, wo, ws, x8, y, y8, oh,
                                     oh8, scales, batch, t, c, heads, gw, xs,
                                     scale, s);
  }
  if (dtype == 1) {
    return launch_absorbed_s8<__nv_bfloat16>(x, ob, w_qkv, wo, ws, x8, y, y8,
                                             oh, oh8, scales, batch, t, c,
                                             heads, gw, xs, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype of q, k, v: 0 = float32, 1 = bfloat16; each [batch, t, heads, d]
// with unit stride on d, strides holding their (b, t, h) element strides in
// that order. q8, k8, v8 (int8) are scratch and o (bf16) the output, each
// [batch, t, heads, d] contiguous. scale_dev: null for the static scales
// qs, ks, vs, else a device array of the three. Returns a cudaError_t (0 on
// success).
extern "C" int ldmseg_attention_s8(
    int dtype, const void* q, const void* k, const void* v,
    const long long* strides, int8_t* q8, int8_t* k8, int8_t* v8, void* o,
    int batch, int t, int heads, int d, const float* scale_dev, float qs,
    float ks, float vs, float scale, void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || d < 8 || d % 8 != 0 || d > kMaxD ||
      batch * heads > 65535 ||
      static_cast<long long>(batch) * t * heads * d >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (dtype == 0) {
    return launch<float>(q, k, v, strides, q8, k8, v8, ob, batch, t, heads, d,
                         scale_dev, qs, ks, vs, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, strides, q8, k8, v8, ob, batch, t,
                                 heads, d, scale_dev, qs, ks, vs, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11: dtype of x 0 = float32, 1 = bfloat16, x [batch*t, c] contiguous;
// out bf16 [batch*t, c]; w_qkv int8 [3c, c] (rows: q, k, v output columns),
// m_qkv fp32 [3c] (requant factors), wo int8 [c, c] (out, in), ratio fp32
// [heads] (wos[h] / max(wos)). x8, q8, k8, v8 and of8 (int8, each [batch*t,
// c]) are scratch. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_padded_s8(
    int dtype, const void* x, void* out, const int8_t* w_qkv,
    const float* m_qkv, const int8_t* wo, const float* ratio, int8_t* x8,
    int8_t* q8, int8_t* k8, int8_t* v8, int8_t* of8, int batch, int t, int c,
    int heads, float xs, float score_scale, float out_scale, void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || c % heads != 0 || c % 8 != 0 ||
      (c / heads) % 8 != 0 || c / heads > kMaxD || batch * heads > 65535 ||
      static_cast<long long>(batch) * t * c >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (dtype == 0) {
    return launch_padded<float>(x, ob, w_qkv, m_qkv, wo, ratio, x8, q8, k8,
                                v8, of8, batch, t, c, heads, xs, score_scale,
                                out_scale, s);
  }
  if (dtype == 1) {
    return launch_padded<__nv_bfloat16>(x, ob, w_qkv, m_qkv, wo, ratio, x8,
                                        q8, k8, v8, of8, batch, t, c, heads,
                                        xs, score_scale, out_scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K15: dtype of q, k, v 0 = float32, 1 = bfloat16, each the packed token
// layout [batch, t, c] (c = heads * d) with unit stride on c; strides holds
// the (b, t) element strides of q, k and v in that order. The scales are
// always dynamic: scratch (24 bytes, 4-byte aligned) receives the three
// amax bit patterns and then the three scales (qs, ks, vs). q8, k8, v8
// (int8) are scratch and o (bf16) the output, each [batch, t, c]
// contiguous. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_packed_s8(
    int dtype, const void* q, const void* k, const void* v,
    const long long* strides, int8_t* q8, int8_t* k8, int8_t* v8, void* o,
    int batch, int t, int c, int heads, void* scratch, float scale,
    void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || c % heads != 0 ||
      (c / heads) % 8 != 0 || c / heads > kMaxD || batch * heads > 65535 ||
      static_cast<long long>(batch) * t * c >= (1ll << 31)) {
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
    return launch_packed<float>(q, k, v, st, q8, k8, v8, ob, batch, t, heads,
                                d, sc, scale, s);
  }
  if (dtype == 1) {
    return launch_packed<__nv_bfloat16>(q, k, v, st, q8, k8, v8, ob, batch,
                                        t, heads, d, sc, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K10 with v_bf16=False: dtype of x 0 = float32, 1 = bfloat16, x [batch*t,
// c] contiguous; out bf16 [batch*t, c]; ln_w, ln_b, out_b fp32 [c]; w_qkv,
// m_qkv, wo and ratio as in ldmseg_attention_padded_s8 (v requantized like
// q and k); x8, q8, k8, v8 and of8 (int8, each [batch*t, c]) are scratch.
// Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_ln_padded_s8(
    int dtype, const void* x, void* out, const float* ln_w,
    const float* ln_b, const float* out_b, const int8_t* w_qkv,
    const float* m_qkv, const int8_t* wo, const float* ratio, int8_t* x8,
    int8_t* q8, int8_t* k8, int8_t* v8, int8_t* of8, int batch, int t, int c,
    int heads, float xs, float score_scale, float out_scale, float eps,
    void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || c % heads != 0 || c % 8 != 0 ||
      (c / heads) % 8 != 0 || c / heads > kMaxD || batch * heads > 65535 ||
      static_cast<long long>(batch) * t * c >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (dtype == 0) {
    return launch_ln_padded<float>(x, ob, ln_w, ln_b, out_b, w_qkv, m_qkv,
                                   wo, ratio, x8, q8, k8, v8, of8, batch, t,
                                   c, heads, xs, score_scale, out_scale, eps,
                                   s);
  }
  if (dtype == 1) {
    return launch_ln_padded<__nv_bfloat16>(
        x, ob, ln_w, ln_b, out_b, w_qkv, m_qkv, wo, ratio, x8, q8, k8, v8,
        of8, batch, t, c, heads, xs, score_scale, out_scale, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K17: dtype of x 0 = float32, 1 = bfloat16, x [batch*t, c] contiguous; out
// bf16 [batch*t, c]; w_qkv int8 [3c, c] (rows: q, k, v output columns) and
// wo int8 [c, c] (out, in), quantized per head; ws fp32 [4][heads], the
// per-head scales of q, k, v and o. x8 and oh8 (int8 [batch*t, c]), y
// (fp32 [batch*t, 3c]), y8 (int8 [batch*t, 3c]), oh (fp32 [batch*t, c]) and
// scales (4-byte words [2 * 4 * batch * heads]: the scales, then as many
// amax words) are scratch. xs: x's static scale.
// Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_absorbed_s8(
    int dtype, const void* x, void* out, const int8_t* w_qkv,
    const int8_t* wo, const float* ws, int8_t* x8, float* y, int8_t* y8,
    float* oh, int8_t* oh8, float* scales, int batch, int t, int c,
    int heads, float xs, float scale, void* stream) {
  if (heads < 1 || c % heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return absorbed_s8_entry(dtype, x, out, w_qkv, wo, ws, x8, y, y8, oh, oh8,
                           scales, batch, t, c, heads, c / heads, xs, scale,
                           stream);
}

// K18: K17's arguments with ws holding each tensor's one scale repeated over
// the heads, the projections' dynamic scales per image over all c columns;
// scales is [2 * (3 * batch + batch * heads)] 4-byte words. Returns a
// cudaError_t.
extern "C" int ldmseg_attention_absorbed_fullc_s8(
    int dtype, const void* x, void* out, const int8_t* w_qkv,
    const int8_t* wo, const float* ws, int8_t* x8, float* y, int8_t* y8,
    float* oh, int8_t* oh8, float* scales, int batch, int t, int c,
    int heads, float xs, float scale, void* stream) {
  return absorbed_s8_entry(dtype, x, out, w_qkv, wo, ws, x8, y, y8, oh, oh8,
                           scales, batch, t, c, heads, c, xs, scale, stream);
}
