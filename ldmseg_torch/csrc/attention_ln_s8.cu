// K3 on Hopper: the int8 UNet's fused self-attention block,
// out = x + to_out(attention(LN(x))) + b_out, on the token layout [B, T, C].
//
// Replaces the TPU kernel ldmseg_tpu/ops/pallas/attention.py:
// _attn_kernel_abs_padded_ln_s8_vt / _abs_padded_ln_s8_vt_body (pallas_call
// in _abs_padded_ln_s8_vt_impl, public absorbed_padded_ln_self_attention_s8
// with v_bf16=True, v_transposed=True). Its rounding points, per image:
//   1. LayerNorm of float(x) in fp32, eps inside the root;
//   2. x8 = clip(rint(hn / xs), +-127) with the static scale xs;
//   3. q8 = clip(rint((x8 Wq8) * mq[col]), +-127) from an int32 product, k8
//      the same with mk; mq = w_scale_q[h] * xs / as with as = 0.1;
//   4. v = bf16((x8 Wv8) * w_scale_v[h] * xs), int32 product;
//   5. per head: s = float(q8 k8^T) * as^2 * d^-0.5; p = bf16(exp(s - max));
//      o = bf16((p v) / sum(p)), both sums over the bf16-rounded p in fp32;
//   6. out = bf16(float(x) + o Wo + b_out), Wo pre-dequantized to bf16.
// The one deliberate difference: the TPU kernel subtracts a static offset
// (0) and clamps at +80 instead of the row max (:939-941), so at extreme
// scores every exp underflows and it returns NaN. Here the row max is
// subtracted; in the normal range the two agree to bf16 rounding.
//
// What bounds it on an H100: per image 3 int8 projections of 2*T*C^2
// operations, the int8 Q K^T and the bf16 P V of 2*H*T^2*d each, the bf16
// to_out of 2*T*C^2; each at its own peak (1,979 TOPS int8, 989 TFLOP/s
// bf16), against the bytes of x, the weights and the output. At the first
// level (B=2, T=2048, C=320, d=40) that is ~6.2 G int8 + ~3.8 GFLOP bf16
// (~7 us) against ~5.7 MB (~1.7 us): operations bound it. At T=128 and
// T=32 (C=1280) the weights' 6.6 MB bound it.
//
// Design. The TPU kernel keeps one whole image's [T, C] in VMEM (grid =
// (B,)); at T=2048, C=320 that is more than a Hopper block's 227 KB of
// shared memory, so the image is not carried over block by block. Four
// kernels on the stream, each tiled for shared memory, hand int8 and bf16
// intermediates through device memory (L2 holds them at these sizes):
//   a. ln_quant: one warp per token row, LN + quantize -> x8 [B*T, C];
//   b. qkv: 64x64 output tiles of x8 [Wq; Wk; Wv]^T (int8 wmma, int32), the
//      epilogue requantizing q8 and k8 per column and dequantizing v to
//      bf16;
//   c. attention: one block per (image*head, 64-query tile); int8 Q K^T
//      with d zero-padded in shared memory to a multiple of 16 (40 -> 48;
//      zeros are exact), two passes over 64-key tiles as K1 (row max, then
//      bf16 P, its fp32 sum and P V on bf16 wmma), o in bf16;
//   d. out: 64x64 tiles of o Wo^T on bf16 wmma with fp32 sums, the
//      residual and bias epilogue.
// Every product of the TPU kernel's body runs in these kernels. A simple
// kernel that is right comes first; speed is later work.

#include "s8_common.cuh"

namespace {

using namespace s8;

constexpr int kMaxD = 160;                // largest head dim taken
constexpr int kMaxDTiles = kMaxD / 16;    // output column tiles per warp
constexpr int kPld = kTile + 8;           // P row stride (bf16)

// ---- b: the three projections ------------------------------------------
__global__ void __launch_bounds__(kThreads)
    qkv_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ w,
               const float* __restrict__ m, int8_t* __restrict__ q8,
               int8_t* __restrict__ k8, __nv_bfloat16* __restrict__ v,
               int rows, int c) {
  __shared__ __align__(256) int8_t As[kTile * kDepth];
  __shared__ __align__(256) int8_t Bs[kTile * kDepth];
  __shared__ __align__(256) int S[kTile * kStageLd];
  const int r0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int n_all = 3 * c;
  AccFrag acc[4];
  zero_acc(acc);
  for (int k0 = 0; k0 < c; k0 += kDepth) {
    __syncthreads();
    load_s8_tile(As, x8, c, r0, rows, k0, c);
    load_s8_tile(Bs, w, c, n0, n_all, k0, c);
    __syncthreads();
    mma_s8_stage(acc, As, Bs);
  }
  stage_acc(S, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile;
    const int cc = i - r * kTile;
    const int row = r0 + r;
    const int n = n0 + cc;
    if (row >= rows || n >= n_all) continue;
    const float f = static_cast<float>(S[r * kStageLd + cc]) * m[n];
    const int which = n / c;
    const long long at = static_cast<long long>(row) * c + (n - which * c);
    if (which == 0) {
      q8[at] = quant_s8(f);
    } else if (which == 1) {
      k8[at] = quant_s8(f);
    } else {
      v[at] = __float2bfloat16_rn(f);
    }
  }
}

// the same for one head's bf16 columns into a row-major [64][ld] tile
__device__ __forceinline__ void load_head_bf16(
    __nv_bfloat16* dst, int ld, const __nv_bfloat16* __restrict__ src, int c,
    int row0, int t, int d, int dp) {
  const int units = dp / 8;
  for (int i = threadIdx.x; i < kTile * units; i += kThreads) {
    const int r = i / units;
    const int u = i - r * units;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t && u * 8 < d) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * c + u * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + u * 8) = val;
  }
}

// ---- c: attention per (image*head, 64-query tile) ------------------------
__global__ void __launch_bounds__(kThreads)
    attn_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int heads, int t, int c, int d,
                float score_scale) {
  using namespace nvcuda;
  extern __shared__ __align__(256) unsigned char smem[];
  const int dp = (d + 15) & ~15;
  const int vld = dp + 8;
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ks = Qs + kTile * dp;
  int* S = reinterpret_cast<int*>(Ks + kTile * dp);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(S + kTile * kStageLd);
  __nv_bfloat16* Ps = Vs + kTile * vld;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kTile;
  const long long base = static_cast<long long>(b) * t * c + h * d;
  const int8_t* qb = q8 + base;
  const int8_t* kb = k8 + base;
  const __nv_bfloat16* vb = v + base;

  load_head_s8(Qs, qb, c, q0, t, d, dp);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int row = warp * 16 + (lane >> 1);  // this lane pair's query row
  const int half = lane & 1;                // columns half, half+2, ...
  float m_run = -INFINITY;

  // pass 1: the row max of the scaled scores
  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();
    load_head_s8(Ks, kb, c, k0, t, d, dp);
    __syncthreads();
    score_tile(Qs, Ks, S, dp);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int cc = half + 2 * j;
      if (k0 + cc < t) {
        m_run = fmaxf(m_run,
                      static_cast<float>(S[row * kStageLd + cc]) * score_scale);
      }
    }
    __syncwarp();
  }
  m_run = fmaxf(m_run, __shfl_xor_sync(0xffffffffu, m_run, 1));

  // pass 2: p = bf16(exp(s - max)), l += p, O += P V (bf16, fp32 sums)
  const int ntiles = dp / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[kMaxDTiles];
#pragma unroll
  for (int n = 0; n < kMaxDTiles; ++n) wmma::fill_fragment(acc_o[n], 0.f);
  float l_run = 0.f;
  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();
    load_head_s8(Ks, kb, c, k0, t, d, dp);
    load_head_bf16(Vs, vld, vb, c, k0, t, d, dp);
    __syncthreads();
    score_tile(Qs, Ks, S, dp);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int cc = half + 2 * j;
      __nv_bfloat16 p = __float2bfloat16_rn(0.f);
      if (k0 + cc < t) {
        const float s =
            static_cast<float>(S[row * kStageLd + cc]) * score_scale;
        p = __float2bfloat16_rn(expf(s - m_run));
      }
      l_run += __bfloat162float(p);
      Ps[row * kPld + cc] = p;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(a, Ps + warp * 16 * kPld + kk * 16, kPld);
#pragma unroll
      for (int n = 0; n < kMaxDTiles; ++n) {
        if (n < ntiles) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bv;
          wmma::load_matrix_sync(bv, Vs + kk * 16 * vld + n * 16, vld);
          wmma::mma_sync(acc_o[n], a, bv, acc_o[n]);
        }
      }
    }
  }
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);

  // o = bf16(acc / l) for query rows < t and columns < d, staged per warp
  // through this warp's rows of S
  float* stage = reinterpret_cast<float*>(S) + warp * 16 * kStageLd;
  __nv_bfloat16* ob = o + base;
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
          ob[static_cast<long long>(grow) * c + cc] =
              __float2bfloat16_rn(stage[r * kStageLd + (lane & 1) * 8 + j] /
                                  l_run);
        }
      }
      __syncwarp();
    }
  }
}

// ---- d: to_out, residual and bias ----------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    out_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ wo,
               const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int rows, int c) {
  using namespace nvcuda;
  constexpr int kLd = kDepth + 8;
  __shared__ __align__(256) __nv_bfloat16 As[kTile * kLd];
  __shared__ __align__(256) __nv_bfloat16 Bs[kTile * kLd];
  __shared__ __align__(256) float S[kTile * kStageLd];
  const int r0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int k0 = 0; k0 < c; k0 += kDepth) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * (kDepth / 8); i += kThreads) {
      const int r = i >> 3;
      const int k = k0 + (i & 7) * 8;
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      uint4 bw = make_uint4(0u, 0u, 0u, 0u);
      if (k < c) {
        if (r0 + r < rows) {
          a = *reinterpret_cast<const uint4*>(
              o + static_cast<long long>(r0 + r) * c + k);
        }
        if (n0 + r < c) {
          bw = *reinterpret_cast<const uint4*>(
              wo + static_cast<long long>(n0 + r) * c + k);
        }
      }
      *reinterpret_cast<uint4*>(As + r * kLd + (i & 7) * 8) = a;
      *reinterpret_cast<uint4*>(Bs + r * kLd + (i & 7) * 8) = bw;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(a, As + warp * 16 * kLd + kk * 16, kLd);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            bf;
        wmma::load_matrix_sync(bf, Bs + n * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(acc[n], a, bf, acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::store_matrix_sync(S + warp * 16 * kStageLd + n * 16, acc[n],
                            kStageLd, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile;
    const int cc = i - r * kTile;
    const int row = r0 + r;
    const int n = n0 + cc;
    if (row >= rows || n >= c) continue;
    const long long at = static_cast<long long>(row) * c + n;
    out[at] = __float2bfloat16_rn((to_f(x[at]) + S[r * kStageLd + cc]) +
                                  bias[n]);
  }
}

size_t attn_smem(int d) {
  const int dp = (d + 15) & ~15;
  return 2 * kTile * dp + kTile * kStageLd * sizeof(int) +
         (kTile * (dp + 8) + kTile * kPld) * sizeof(__nv_bfloat16);
}

template <typename T>
int launch(const void* x, void* out, const float* ln_w, const float* ln_b,
           const float* out_b, const int8_t* w_qkv, const float* m_qkv,
           const __nv_bfloat16* wo, int8_t* x8, int8_t* q8, int8_t* k8,
           __nv_bfloat16* v, __nv_bfloat16* o, int batch, int t, int c,
           int heads, float xs, float score_scale, float eps,
           cudaStream_t stream) {
  const int rows = batch * t;
  const int d = c / heads;
  int err = launch_ln_quant<T>(x, x8, ln_w, ln_b, rows, c, xs, eps, nullptr,
                               0, stream);
  if (err != 0) return err;
  const dim3 grid_qkv((rows + kTile - 1) / kTile, (3 * c + kTile - 1) / kTile);
  qkv_kernel<<<grid_qkv, kThreads, 0, stream>>>(x8, w_qkv, m_qkv, q8, k8, v,
                                                 rows, c);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t smem = attn_smem(d);
  err = static_cast<int>(cudaFuncSetAttribute(
      attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  const dim3 grid_attn((t + kTile - 1) / kTile, batch * heads);
  attn_kernel<<<grid_attn, kThreads, smem, stream>>>(q8, k8, v, o, heads, t,
                                                      c, d, score_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid_out((rows + kTile - 1) / kTile, (c + kTile - 1) / kTile);
  out_kernel<T><<<grid_out, kThreads, 0, stream>>>(
      static_cast<const T*>(x), o, wo, out_b,
      static_cast<__nv_bfloat16*>(out), rows, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16; out is bf16. x, out [batch*t, c]
// contiguous; w_qkv int8 [3c, c] (rows: q, k, v output columns), m_qkv fp32
// [3c] (q/k requant factors, v dequant factors), wo bf16 [c, c] (out, in).
// x8, q8, k8 int8 and v, o bf16, each [batch*t, c], are scratch. Returns a
// cudaError_t (0 on success).
extern "C" int ldmseg_attention_ln_s8(
    int dtype, const void* x, void* out, const float* ln_w,
    const float* ln_b, const float* out_b, const int8_t* w_qkv,
    const float* m_qkv, const void* wo, int8_t* x8, int8_t* q8, int8_t* k8,
    void* v, void* o, int batch, int t, int c, int heads, float xs,
    float score_scale, float eps, void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || c % heads != 0 || c % 8 != 0 ||
      (c / heads) % 8 != 0 || c / heads > kMaxD || batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wob = static_cast<const __nv_bfloat16*>(wo);
  auto* vb = static_cast<__nv_bfloat16*>(v);
  auto* obf = static_cast<__nv_bfloat16*>(o);
  if (dtype == 0) {
    return launch<float>(x, out, ln_w, ln_b, out_b, w_qkv, m_qkv, wob, x8, q8,
                         k8, vb, obf, batch, t, c, heads, xs, score_scale,
                         eps, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, out, ln_w, ln_b, out_b, w_qkv, m_qkv, wob,
                                 x8, q8, k8, vb, obf, batch, t, c, heads, xs,
                                 score_scale, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
