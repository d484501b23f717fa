// K3 and K8 on Hopper: the int8 UNet's fused self-attention block,
// K3: out = x + to_out(attention(LN(x))) + b_out, on the token layout
//     [B, T, C];
// K8: the same block on the residual stream xf = x Wpi + b_pi that a bf16
//     prologue builds from the GroupNorm output x (Transformer2D's 1x1
//     proj_in conv, use_fused_projs);
// K10 with v_bf16=True (an op): K3's row-major TPU twin, the last entry
//     point of this file.
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
//   b. qkv (s8_gemm_kernel, s8_common.cuh): 64x64 output tiles of
//      x8 [Wq; Wk; Wv]^T (int8 wmma, int32), the epilogue requantizing q8
//      and k8 per column and dequantizing v to bf16;
//   c. attention: one block per (image*head, 64-query tile); int8 Q K^T
//      with d zero-padded in shared memory to a multiple of 16 (40 -> 48;
//      zeros are exact), two passes over 64-key tiles as K1 (row max, then
//      bf16 P, its fp32 sum and P V on bf16 wmma), o in bf16;
//   d. out (bf16_gemm_kernel, s8_common.cuh): 64x64 tiles of o Wo^T on
//      bf16 wmma with fp32 sums, the residual and bias epilogue.
// Every product of the TPU kernel's body runs in these kernels. A simple
// kernel that is right comes first; speed is later work.
//
// K8 replaces _attn_kernel_abs_padded_ln_s8_vt_pin (pallas_call in
// _abs_padded_ln_s8_vt_pin_impl, absorbed_padded_ln_self_attention_s8 with
// proj_in), which runs the same body after the prologue
//   0. xf = float(x Wpi) + b_pi: bf16 operands, fp32 sums, an fp32 result
//      that is never rounded to bf16: the LN reads it and so does the
//      residual of step 6.
// So K8 is K3's four kernels on an fp32 residual stream (launch<float>)
// behind a fifth, the prologue: 64x64 tiles of x Wpi^T on bf16 wmma with
// the bias epilogue, into an fp32 scratch [B*T, C]. It reads x either as
// tokens [B, T, C] or channel-major [B, C, T], the GroupNorm's NCHW output
// as it lies, which saves the caller a permute copy. Its 2*T*C^2 bf16
// operations per image add ~1/3 to K3's bf16 work at every level.

#include "s8_common.cuh"

namespace {

using namespace s8;

constexpr int kMaxD = 160;                // largest head dim taken
constexpr int kMaxDTiles = kMaxD / 16;    // output column tiles per warp
constexpr int kPld = kTile + 8;           // P row stride (bf16)

// load_head_s8 (s8_common.cuh) for one head's bf16 columns, into a
// row-major [64][ld] tile
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

// the prologue's epilogue: xf = sum + bias[col] in fp32, [rows, n]
struct BiasF32Epi {
  static constexpr bool kColMajor = false;
  const float* bias;
  float* xf;
  int n;
  __device__ void operator()(int row, int col, float sum) const {
    xf[static_cast<long long>(row) * n + col] = sum + bias[col];
  }
};

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
  err = launch_s8_gemm(x8, w_qkv, rows, 3 * c, c,
                       QkvEpi<false>{m_qkv, q8, k8, v, c}, stream);
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
  return launch_bf16_gemm<false>(
      o, wo, rows, c, c, t,
      ResidualEpi<T>{static_cast<const T*>(x), out_b,
                     static_cast<__nv_bfloat16*>(out), c},
      stream);
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

// K8: x bf16, channel-major [batch, c, t] when channels_major, else
// [batch*t, c]; wpi bf16 [c, c] (out, in), bpi fp32 [c]; xf fp32 [batch*t,
// c] is scratch (the residual stream); the other arguments as in
// ldmseg_attention_ln_s8. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_ln_s8_pin(
    int channels_major, const void* x, const void* wpi, const float* bpi,
    float* xf, void* out, const float* ln_w, const float* ln_b,
    const float* out_b, const int8_t* w_qkv, const float* m_qkv,
    const void* wo, int8_t* x8, int8_t* q8, int8_t* k8, void* v, void* o,
    int batch, int t, int c, int heads, float xs, float score_scale,
    float eps, void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || c % heads != 0 || c % 8 != 0 ||
      (c / heads) % 8 != 0 || c / heads > kMaxD || batch * heads > 65535 ||
      (channels_major && t % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wpib = static_cast<const __nv_bfloat16*>(wpi);
  const int rows = batch * t;
  const BiasF32Epi epi{bpi, xf, c};
  const int err =
      channels_major
          ? launch_bf16_gemm<true>(xb, wpib, rows, c, c, t, epi, s)
          : launch_bf16_gemm<false>(xb, wpib, rows, c, c, t, epi, s);
  if (err != 0) return err;
  return launch<float>(xf, out, ln_w, ln_b, out_b, w_qkv, m_qkv,
                       static_cast<const __nv_bfloat16*>(wo), x8, q8, k8,
                       static_cast<__nv_bfloat16*>(v),
                       static_cast<__nv_bfloat16*>(o), batch, t, c, heads,
                       xs, score_scale, eps, s);
}

// K10 with v_bf16=True: replaces ldmseg_tpu/ops/pallas/attention.py:
// _attn_kernel_abs_padded_ln_s8 (pallas_call in _abs_padded_ln_s8_impl,
// reached by absorbed_padded_ln_self_attention_s8(..., v_transposed=False)).
// That kernel is the row-major form of K3's: V, P and to_out in bf16,
// e = bf16(exp(s - rowmax)) with the row max subtracted (K3's TPU kernel
// drops it, K10's keeps it; this port's K3 keeps it too), denom the fp32
// sum of the bf16 e, o = bf16((e V) / denom), out = bf16(x + o Wo + b_out).
// The TPU's K-major value path of K3 and the row-major one here are two
// layouts of one function, so K10 runs K3's four kernels on the same
// operands (pack_ln_attention); its arguments are ldmseg_attention_ln_s8's.
// Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_ln_s8_rowmajor(
    int dtype, const void* x, void* out, const float* ln_w,
    const float* ln_b, const float* out_b, const int8_t* w_qkv,
    const float* m_qkv, const void* wo, int8_t* x8, int8_t* q8, int8_t* k8,
    void* v, void* o, int batch, int t, int c, int heads, float xs,
    float score_scale, float eps, void* stream) {
  return ldmseg_attention_ln_s8(dtype, x, out, ln_w, ln_b, out_b, w_qkv,
                                m_qkv, wo, x8, q8, k8, v, o, batch, t, c,
                                heads, xs, score_scale, eps, stream);
}
