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
//   a. ln_quant (s8_common.cuh): one warp per token row, LN + quantize ->
//      x8 [B*T, C];
//   b. qkv: gemm_sm90.cuh's int8 product x8 [Wq; Wk; Wv]^T (TMA ring,
//      wgmma, int32 sums), QkvPadEpi requantizing q8 and k8 per column from
//      the registers into a head-padded scratch [B*T, H, dp] (dp = d
//      rounded up to 32: a tensor map's strides are multiples of 16 bytes,
//      and a head at h*d bytes of a [B*T, C] row is not; TMA writes zeros
//      past d whatever the padding holds) and dequantizing v to bf16
//      [B*T, C];
//   c. attention (attn_s8_kernel_sm90 below): the Hopper skeleton K1 runs
//      on (attention_sm90.cuh) with an int8 score product: one block per
//      (image*head, 64 or 128 queries), a producer warpgroup issuing TMA
//      loads of Q, then K (pass 1) and K and V (pass 2) through a ring;
//      S = q8 k8^T on s8 wgmma into int32 registers; pass 1 keeps only the
//      row max, in int32 (the scale as^2 d^-0.5 is positive, so the max of
//      float(s) * scale is float(max s) * scale); pass 2 forms p =
//      bf16(2^(float(s) c - m c)), c = scale * log2(e), adds the *rounded*
//      p to l, and accumulates P V on bf16 wgmma with P from registers;
//      o = bf16(acc / l). This is not K1's epilogue: K1 divides p by l
//      before rounding it (its P is normalised), K3 rounds the unnormalised
//      p and divides the fp32 sum P V by the sum of the rounded p, as
//      _abs_padded_ln_s8_vt_body does (step 5). Two passes keep the row max
//      exact; a one-pass online softmax would round p against a running max;
//   d. out: gemm_sm90.cuh's bf16 product o Wo^T with fp32 sums and the
//      residual and bias epilogue.
// The plans of b., c. and d. (tiles, ring depth, shared memory, grid) come
// from ops/gemm.py:sm90_gemm_plan and ops/attention_s8.py:
// sm90_s8_attention_plan, and are checked here.
//
// K8 replaces _attn_kernel_abs_padded_ln_s8_vt_pin (pallas_call in
// _abs_padded_ln_s8_vt_pin_impl, absorbed_padded_ln_self_attention_s8 with
// proj_in), which runs the same body after the prologue
//   0. xf = float(x Wpi) + b_pi: bf16 operands, fp32 sums, an fp32 result
//      that is never rounded to bf16: the LN reads it and so does the
//      residual of step 6.
// So K8 is K3's four kernels on an fp32 residual stream (launch<float>)
// behind a fifth, the prologue: gemm_sm90.cuh's bf16 product x Wpi^T with
// BiasF32Epi (the bias staged per block before the main loop, fp32 pairs
// sum + b_pi stored from the accumulator registers) into an fp32 scratch
// xf [B*T, C], row-major, which ln_quant then reads by rows. It reads x
// either as tokens [B*T, C] (A K-major, a 2-D map) or channel-major [B, C,
// T], the GroupNorm's NCHW output as it lies, which saves the caller a
// permute copy: A MN-major through a 3-D map over (T, C, B) in boxes of 64
// tokens x 64 channels, the row tiles laid out per image (T = 32 and 120
// leave a last tile partly empty: TMA fills zeros, the epilogue skips those
// rows), the products wgmma's with A's transpose bit. Its 2*T*C^2 bf16
// operations per image add ~1/3 to K3's bf16 work at every level; at T =
// 128 and 32 Wpi's bytes bound it.

#include "attention_sm90.cuh"
#include "gemm_sm90.cuh"
#include "s8_common.cuh"
#include "sm90.cuh"

namespace {

using namespace s8;  // ln_quant, quant_s8

constexpr int kMaxD = 160;  // largest head dim taken

// ---- b: the projection's epilogue -----------------------------------------
// q8 and k8 requantized per column, clip(rint(sum * m[col])), into the
// head-padded [rows, heads, dp]; v dequantized to bf16 [rows, c]; the
// product's columns are q | k | v (attention_s8.cu's QkPadEpi requantizes
// K11's q8 and k8 the same way). Where a column goes is worked out once per
// column and block (a code in the int per-column vector: its section and
// its offset in the row), so the pairs' stores take no division. A column
// pair never straddles a head or a section: c and d are multiples of 8 and
// a pair starts on an even column.
struct QkvPadEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 1;     // m
  static constexpr int kIntCols = 1;  // the column's code
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  const float* m;
  int8_t* q8;
  int8_t* k8;
  __nv_bfloat16* v;
  int c, d, dp, heads;
  __device__ float col_value(int, int col) const { return __ldg(m + col); }
  __device__ int col_int(int, int col) const {
    const int which = col / c;
    const int cc = col - which * c;
    const int h = cc / d;
    return which << 28 | (which == 2 ? cc : h * dp + (cc - h * d));
  }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int row, int col, const float2* cv,
                             const int2* ci, const RowPre&, const Pre&,
                             int s0, int s1) const {
    const float f0 = static_cast<float>(s0) * cv[0].x;
    const float f1 = static_cast<float>(s1) * cv[0].y;
    const int code = ci[0].x;
    const int which = code >> 28;
    const int off = code & ((1 << 28) - 1);
    if (which == 2) {
      *reinterpret_cast<uint32_t*>(v + static_cast<long long>(row) * c +
                                   off) = sm90::pack_bf16(f0, f1);
      return;
    }
    *reinterpret_cast<char2*>((which == 0 ? q8 : k8) +
                              static_cast<long long>(row) * heads * dp +
                              off) = make_char2(quant_s8(f0), quant_s8(f1));
  }
};

// ---- c: attention per (image*head, query tile) -----------------------------
// The launch plan as ops/attention_s8.py:sm90_s8_attention_plan lays it out
struct AttnPlan {
  int head_class;  // N of P V: d rounded up to a compiled class
  int block_q;     // query rows per block, 64 per consumer warpgroup
  int block_k;     // keys per tile
  int stages;      // depth of the K/V ring
  int qk_chunks;   // 128-column int8 boxes across a head of q8/k8
  int v_chunks;    // 64-column bf16 boxes across a head of v
  int dp;          // the head-padded width of q8 and k8
  int smem_bytes;  // dynamic shared memory of the launch
  int grid_x;      // query tiles
  int grid_y;      // B * H
};
constexpr int kAttnPlanInts = 10;

bool attn_plan_ok(const AttnPlan& p, int bh, int t, int d) {
  const int hc = attn90::head_class(d);
  const int qk_chunks = ((hc + 31) / 32 + 3) / 4;
  const int v_chunks = (hc + 63) / 64;
  return p.head_class == hc && p.qk_chunks == qk_chunks &&
         p.v_chunks == v_chunks && p.dp == (d + 31) / 32 * 32 &&
         p.smem_bytes == attn90::smem_bytes(p.block_q, p.block_k, qk_chunks,
                                            v_chunks, p.stages) &&
         attn90::tiles_ok(hc, p.block_q, p.block_k, p.stages, p.smem_bytes,
                          p.grid_x, p.grid_y, bh, t);
}

// attention_sm90.cuh's skeleton on int8 q8 and k8: K3's rounding point
template <int kDN, int kWG>
__global__ void __launch_bounds__(attn90::Cfg<true, kDN, kWG>::kThreads, 1)
    attn_s8_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o, attn90::Strides so,
                        int heads, int t, int d, int stages, float c) {
  attn90::forward<true, kDN, kWG>(tq, tk, tv, o, so, heads, t, d, stages, c);
}

struct K3Kernel {
  static constexpr bool kS8 = true;
  template <int kDN, int kWG>
  static auto kernel() {
    return attn_s8_kernel_sm90<kDN, kWG>;
  }
};

// q8, k8 int8 [batch*t, heads, dp] (the padding never read), v bf16
// [batch*t, c], o bf16 [batch*t, c]; score_scale > 0
int launch_attn(const int* plan, const int8_t* q8, const int8_t* k8,
                const __nv_bfloat16* v, __nv_bfloat16* o, int batch, int t,
                int c, int heads, float score_scale, cudaStream_t stream) {
  const AttnPlan p{plan[0], plan[1], plan[2], plan[3], plan[4],
                   plan[5], plan[6], plan[7], plan[8], plan[9]};
  const int d = c / heads;
  if (!attn_plan_ok(p, batch * heads, t, d) || !(score_scale > 0.f)) {
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
  const long long st[3] = {static_cast<long long>(t) * c, c, d};
  err = sm90::encode_map(&maps[2], v, batch, t, heads, d, st, p.block_k);
  if (err != 0) return err;
  const attn90::Launch a{p.head_class, p.block_q, p.smem_bytes, p.grid_x,
                         p.grid_y, p.stages, maps, o,
                         attn90::Strides{st[0], st[1], st[2]}, heads, t, d,
                         score_scale * attn90::kLog2e};
  return attn90::launch<K3Kernel>(a, stream);
}

// the prologue's epilogue: xf = sum + bias[col] in fp32, [rows, n]
// row-major, stored as pairs (the bias one of the per-column vectors)
struct BiasF32Epi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 1;  // bias
  static constexpr int kIntCols = 0;
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  const float* bias;
  float* xf;
  int n;
  __device__ float col_value(int, int col) const { return __ldg(bias + col); }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int row, int col, const float2* cv,
                             const int2*, const RowPre&, const Pre&,
                             float s0, float s1) const {
    *reinterpret_cast<float2*>(xf + static_cast<long long>(row) * n + col) =
        make_float2(s0 + cv[0].x, s1 + cv[0].y);
  }
};

// K8's prologue: xf = x Wpi^T + bpi in fp32 from bf16 x, as tokens [batch
// * t, c] or channel-major [batch, c, t] (the A operand MN-major, row
// tiles per image); plan is sm90_gemm_plan's of [batch * t, c] x [c, c]^T
// (bf16; channel-major with images = batch), checked
int launch_proj_in(int channels_major, const void* x, const void* wpi,
                   const float* bpi, float* xf, int batch, int t, int c,
                   const int* plan, cudaStream_t stream) {
  const int current = sm90::make_current(x);
  if (current != 0) return current;
  const BiasF32Epi epi{bpi, xf, c};
  if (channels_major) {
    return gemm90::launch_gemm_in_context<false, 1, true>(
        plan, x, &wpi, batch * t, c, c, 0, t, epi, stream);
  }
  return gemm90::launch_gemm_in_context<false, 1, false>(
      plan, x, &wpi, batch * t, c, c, 0, 1, epi, stream);
}

// plans: ops/gemm.py:sm90_gemm_plan's of the projection ([rows, c] x [3c,
// c]^T, int8), ops/attention_s8.py:sm90_s8_attention_plan's, and
// sm90_gemm_plan's of to_out ([rows, c] x [c, c]^T, bf16), in that order
// (9 + 10 + 9 ints)
template <typename T>
int launch(const void* x, void* out, const float* ln_w, const float* ln_b,
           const float* out_b, const int8_t* w_qkv, const float* m_qkv,
           const __nv_bfloat16* wo, int8_t* x8, int8_t* q8, int8_t* k8,
           __nv_bfloat16* v, __nv_bfloat16* o, int batch, int t, int c,
           int heads, float xs, float score_scale, float eps,
           const int* plans, cudaStream_t stream) {
  const int rows = batch * t;
  const int d = c / heads;
  int err = launch_ln_quant<T>(x, x8, ln_w, ln_b, rows, c, xs, eps, nullptr,
                               0, stream);
  if (err != 0) return err;
  err = gemm90::launch_gemm<true>(
      plans, x8, w_qkv, rows, 3 * c, c, 0,
      QkvPadEpi{m_qkv, q8, k8, v, c, d, (d + 31) / 32 * 32, heads}, stream);
  if (err != 0) return err;
  err = launch_attn(plans + gemm90::kPlanInts, q8, k8, v, o, batch, t, c,
                    heads, score_scale, stream);
  if (err != 0) return err;
  return gemm90::launch_gemm<false>(
      plans + gemm90::kPlanInts + kAttnPlanInts, o, wo, rows, c, c, 0,
      gemm90::ResidualEpi<T>{static_cast<const T*>(x), out_b,
                             static_cast<__nv_bfloat16*>(out), c},
      stream);
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16; out is bf16. x, out [batch*t, c]
// contiguous; w_qkv int8 [3c, c] (rows: q, k, v output columns), m_qkv fp32
// [3c] (q/k requant factors, v dequant factors), wo bf16 [c, c] (out, in).
// x8 int8 [batch*t, c], q8 and k8 int8 [batch*t, heads, dp] (dp = d rounded
// up to 32), v and o bf16 [batch*t, c] are scratch. score_scale > 0. plans:
// the three plans of launch() above. Returns a cudaError_t (0 on
// success).
extern "C" int ldmseg_attention_ln_s8(
    int dtype, const void* x, void* out, const float* ln_w,
    const float* ln_b, const float* out_b, const int8_t* w_qkv,
    const float* m_qkv, const void* wo, int8_t* x8, int8_t* q8, int8_t* k8,
    void* v, void* o, int batch, int t, int c, int heads, float xs,
    float score_scale, float eps, const int* plans, void* stream) {
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
                         eps, plans, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, out, ln_w, ln_b, out_b, w_qkv, m_qkv, wob,
                                 x8, q8, k8, vb, obf, batch, t, c, heads, xs,
                                 score_scale, eps, plans, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8: x bf16, channel-major [batch, c, t] when channels_major, else
// [batch*t, c]; wpi bf16 [c, c] (out, in), bpi fp32 [c]; xf fp32 [batch*t,
// c] is scratch (the residual stream); plans: the prologue's (9 ints, as
// launch_proj_in takes it), then K3's three as ldmseg_attention_ln_s8
// takes them; the other arguments as there. Returns a cudaError_t (0 on
// success).
extern "C" int ldmseg_attention_ln_s8_pin(
    int channels_major, const void* x, const void* wpi, const float* bpi,
    float* xf, void* out, const float* ln_w, const float* ln_b,
    const float* out_b, const int8_t* w_qkv, const float* m_qkv,
    const void* wo, int8_t* x8, int8_t* q8, int8_t* k8, void* v, void* o,
    int batch, int t, int c, int heads, float xs, float score_scale,
    float eps, const int* plans, void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || c % heads != 0 || c % 8 != 0 ||
      (c / heads) % 8 != 0 || c / heads > kMaxD || batch * heads > 65535 ||
      (channels_major && t % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_proj_in(channels_major, x, wpi, bpi, xf, batch, t,
                                 c, plans, s);
  if (err != 0) return err;
  return launch<float>(xf, out, ln_w, ln_b, out_b, w_qkv, m_qkv,
                       static_cast<const __nv_bfloat16*>(wo), x8, q8, k8,
                       static_cast<__nv_bfloat16*>(v),
                       static_cast<__nv_bfloat16*>(o), batch, t, c, heads,
                       xs, score_scale, eps, plans + gemm90::kPlanInts, s);
}

// K8's prologue alone (launch_proj_in: xf = x Wpi^T + bpi in fp32; its
// arguments). No model path calls it: the card tests and chip_smoke.py
// hold it against torch.matmul in fp32 (ops/attention_s8.py:proj_in_f32).
// Returns a cudaError_t (0 on success).
extern "C" int ldmseg_proj_in_f32(int channels_major, const void* x,
                                  const void* wpi, const float* bpi,
                                  float* xf, int batch, int t, int c,
                                  const int* plan, void* stream) {
  if (batch < 1 || t < 1 || c < 8 || (channels_major && t % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_proj_in(channels_major, x, wpi, bpi, xf, batch, t, c, plan,
                        static_cast<cudaStream_t>(stream));
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
    float score_scale, float eps, const int* plans, void* stream) {
  return ldmseg_attention_ln_s8(dtype, x, out, ln_w, ln_b, out_b, w_qkv,
                                m_qkv, wo, x8, q8, k8, v, o, batch, t, c,
                                heads, xs, score_scale, eps, plans, stream);
}

// The LN + quantize stage alone (s8_common.cuh:ln_quant_kernel with its LN,
// which K3, K4, K8, K9 and K10 run first): x [rows, c] contiguous (dtype 0
// = float32, 1 = bfloat16) -> x8 int8 [rows, c]; ln_w, ln_b fp32 [c];
// stats fp32 [rows, 3], each row's (mu, var, r), or null. No model path
// calls it: the tests and chip_smoke.py hold its codes against the plain
// version's (ops/attention_s8.py:ln_quant_s8). Returns a cudaError_t.
extern "C" int ldmseg_ln_quant_s8(int dtype, const void* x, int8_t* x8,
                                  const float* ln_w, const float* ln_b,
                                  float* stats, int rows, int c, float xs,
                                  float eps, void* stream) {
  if (rows < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_ln_quant<float>(x, x8, ln_w, ln_b, rows, c, xs, eps,
                                  nullptr, 0, s, stats);
  }
  if (dtype == 1) {
    return launch_ln_quant<__nv_bfloat16>(x, x8, ln_w, ln_b, rows, c, xs,
                                          eps, nullptr, 0, s, stats);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
