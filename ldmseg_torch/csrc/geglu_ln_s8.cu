// K4, K9 and K12 on Hopper: the int8 UNet's fused feed-forward,
// K4:  out = x + W2 q(h * gelu_tanh(gate)) s2 + b2 with [h, gate] = W1 q(LN(x)),
// K9:  out = bf16(K4(x)) Wpo + b_po, Transformer2D's 1x1 proj_out conv as a
//      bf16 epilogue (use_fused_projs),
// K12: out = W2 q(h * gelu_tanh(gate)) s2 with [h, gate] = W1 q(x),
// on the token layout [B, T, C] with interior width M = 4C.
//
// K4 replaces the TPU kernel ldmseg_tpu/ops/pallas/geglu.py:_geglu_ln_kernel
// with _ff_interior (nc = 1) (pallas_call in _geglu_ln_impl, public
// fused_geglu_ln_s8); K12 replaces _geglu_kernel (pallas_call in _geglu_impl,
// public fused_geglu_s8), the same interior without the LayerNorm prologue
// and the residual + b2 epilogue (the caller adds b2, the block the
// residual). Their rounding points, per (image, block of block_t =
// min(512, T) tokens), the Pallas grid:
//   1. K4: LayerNorm of float(x) in fp32; x8 = clip(rint(h / xs), +-127);
//      K12: x8 = clip(rint(float(x) / xs), +-127);
//   2. u = float(x8 W1q) * (xs * s1) + b1 from an int32 product, [rows, 2M];
//   3. g = u[:, :M] * gelu_tanh(u[:, M:]), gelu_tanh(z) = z / (1 + exp(-2 *
//      0.7978845608028654 * (z + 0.044715 z^3)));
//   4. the interior scale: static gs (a calibrated site), g8 =
//      clip(rint(g / gs), +-127); or dynamic, gs = max(amax |g| over the
//      whole [block_t, M] block, 1e-6) / 127 and g8 = rint(g / gs);
//   5. K4: out = bf16(float(x) + float(g8 W2q) * gs * s2 + b2), int32
//      product; K12: out = bf16(float(g8 W2q) * gs * s2).
//
// What bounds it on an H100: 2*T*C*2M + 2*T*M*C int8 operations per image
// at 1,979 TOPS, against the bytes of x, W1, W2 and the output at 3.35 TB/s.
// At the first level (B=2, T=2048, C=320, M=1280) that is ~10 G int8
// operations (~5 us) against ~3.8 MB (~1.1 us); at T=32 and T=128 (C=1280)
// the 19.7 MB of W1 and W2 bound it.
//
// Design. The dynamic scale is one amax per (image, 512-token block), so no
// Hopper block can quantize its own interior: the amax comes from blocks
// that run in no order. Three or four kernels on the stream:
//   a. ln_quant (s8_common.cuh): one warp per token row -> x8 [B*T, C] (K12
//      compiles the LayerNorm out); it also zeroes the amax slots;
//   b. up: gemm_sm90.cuh's product of x8 with W1, two W tiles per stage
//      (the h rows n0.. and the gate rows M + n0..) into two int32
//      accumulator sets; GateEpi dequantizes, adds b1 and gates from the
//      registers. Dynamic: g goes in fp32 to a scratch [B*T, M] and each
//      warp's amax of every 8-row group goes to the group's (image, block)
//      slot by an integer atomicMax on the float's bits (the values are
//      non-negative, so the bits order as the floats); an 8-row group lies
//      in one slot because T and block_t are multiples of 8 (the tiles run
//      over B*T rows and may hold rows of several images at T = 32, 120 or
//      128, so the slot is looked up per group, not per tile). Static (a
//      calibrated site): g8 = clip(rint(g / gs)) is written at once, the
//      same expression as c.'s, and c. is skipped;
//   c. quant (dynamic only): one block per token row over g, g8 = rint(g /
//      gs) (clipped) with gs = max(slot, 1e-6) / 127, into an int8
//      [B*T, M];
//   d. down: the product of g8 with W2; DownEpi reads gs from the row's
//      slot and adds the residual and b2 (K12: kBlock false, neither).
// Each product's plan (tiles, ring, grid) comes from
// ops/gemm.py:sm90_gemm_plan. The TPU kernel's per-(image, block) grid is
// gone: only the scale slots remember it.
//
// K9 replaces _geglu_ln_pout_kernel (pallas_call in _geglu_ln_pout_impl,
// fused_geglu_ln_s8 with proj_out): K4's steps 1-5 with the block's output
// rounded, r = bf16(float(x) + y * gs * s2 + b2) over the whole row, then
//   6. out = bf16(float(r Wpo) + b_po): bf16 operands, fp32 sums.
// r crosses tiles of the product, so K4's kernels write it to a bf16
// scratch [B*T, C] and one more, bf16_gemm_kernel (s8_common.cuh), runs the
// product with the bias epilogue, writing out channel-major [B, C, T]: the
// NCHW layout of Transformer2D's residual add, so the caller adds without a
// permute. Its 2*T*C^2 bf16 operations per image are ~1/6 of K4's int8
// operations counted at the bf16 rate.

#include <type_traits>

#include "gemm_sm90.cuh"
#include "s8_common.cuh"

namespace {

using namespace s8;

// ---- c: quantize the interior (dynamic scale) -----------------------------
// one block per token row: gs = max(slot, 1e-6) / 127 once, then g8 =
// clip(rint(g / gs)) over the row's m values, four at a time (m % 8 == 0)
__global__ void __launch_bounds__(256)
    quant_kernel(const float* __restrict__ g, int8_t* __restrict__ g8,
                 const unsigned* __restrict__ amax, int t, int m,
                 int block_t) {
  const int row = blockIdx.x;
  const int img = row / t;
  const float gs = fmaxf(__uint_as_float(amax[img * (t / block_t) +
                                              (row - img * t) / block_t]),
                         1e-6f) / 127.f;
  const float4* src =
      reinterpret_cast<const float4*>(g + static_cast<long long>(row) * m);
  char4* dst = reinterpret_cast<char4*>(g8 + static_cast<long long>(row) * m);
  for (int i = threadIdx.x; i < m / 4; i += 256) {
    const float4 v = src[i];
    dst[i] = make_char4(quant_s8(v.x / gs), quant_s8(v.y / gs),
                        quant_s8(v.z / gs), quant_s8(v.w / gs));
  }
}

// the (image, block_t-token block) slot of token row `row` of B*T
__device__ __forceinline__ int slot_of(int row, int t, int block_t) {
  const int img = row / t;
  return img * (t / block_t) + (row - img * t) / block_t;
}

// ---- b: W1's epilogue: gating, then g (dynamic) or g8 (static) ------------
struct GateEpi {
  static constexpr int kOps = 2;      // the h and the gate columns
  static constexpr int kCols = 4;     // xs s1 and b1 of h, then of the gate
  static constexpr int kIntCols = 0;
  static constexpr bool kRowMax = true;
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  const float* s1;
  const float* b1;
  float* g;              // [rows, m] fp32, dynamic
  int8_t* g8;            // [rows, m] int8, static
  unsigned* amax;        // the slots, dynamic
  int m, t, block_t;
  float xs, gs_static;
  int dynamic;
  // xss = xs * s1[n], staged once per column: the same fp32 product
  __device__ static float gate(int sh, int sg, float xss_h, float b1h,
                               float xss_g, float b1g) {
    const float uh = static_cast<float>(sh) * xss_h + b1h;
    const float ug = static_cast<float>(sg) * xss_g + b1g;
    const float z = 0.7978845608028654f * (ug + 0.044715f * ug * ug * ug);
    return uh * (ug / (1.f + expf(-2.f * z)));
  }
  __device__ float col_value(int v, int col) const {
    const int at = (v < 2 ? 0 : m) + col;
    return v % 2 == 0 ? xs * __ldg(s1 + at) : __ldg(b1 + at);
  }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ float operator()(int row, int col, const float2* cv,
                              const int2*, int h0, int h1, int g0,
                              int g1) const {
    const float v0 = gate(h0, g0, cv[0].x, cv[1].x, cv[2].x, cv[3].x);
    const float v1 = gate(h1, g1, cv[0].y, cv[1].y, cv[2].y, cv[3].y);
    const long long at = static_cast<long long>(row) * m + col;
    if (dynamic) {
      *reinterpret_cast<float2*>(g + at) = make_float2(v0, v1);
    } else {
      const char2 q = make_char2(quant_s8(v0 / gs_static),
                                 quant_s8(v1 / gs_static));
      *reinterpret_cast<char2*>(g8 + at) = q;
    }
    return fmaxf(fabsf(v0), fabsf(v1));
  }
  // the amax of rows [row, row + 8), one slot
  __device__ void row_max(int row, float v) const {
    if (dynamic) atomicMax(amax + slot_of(row, t, block_t), __float_as_uint(v));
  }
};

// ---- d: W2's epilogue: the interior scale, residual and bias (kBlock) ------
template <typename T, bool kBlock>
struct DownEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = kBlock ? 2 : 1;  // s2, b2
  static constexpr int kIntCols = 0;
  using RowPre = float;                         // the row's interior scale
  using Pre = typename std::conditional<kBlock, typename gemm90::PairOf<T>::type,
                                        gemm90::NoPre>::type;  // x
  const T* x;
  const unsigned* amax;
  const float* s2;
  const float* b2;
  __nv_bfloat16* out;
  int c, t, block_t;
  float gs_static;
  int dynamic;
  __device__ float col_value(int v, int col) const {
    return __ldg((v == 0 ? s2 : b2) + col);
  }
  __device__ RowPre row_pre(int row) const {
    if (!dynamic) return gs_static;
    return fmaxf(__uint_as_float(__ldg(amax + slot_of(row, t, block_t))),
                 1e-6f) / 127.f;
  }
  __device__ Pre pre(int row, int col) const {
    if constexpr (kBlock) {
      return gemm90::ldg_pair(x + static_cast<long long>(row) * c + col);
    } else {
      return {};
    }
  }
  __device__ void operator()(int row, int col, const float2* cv,
                             const int2*, const RowPre& gs, const Pre& xv,
                             int a0, int a1) const {
    const float y0 = static_cast<float>(a0) * gs;
    const float y1 = static_cast<float>(a1) * gs;
    uint32_t pair;
    if constexpr (kBlock) {
      const float2 xf = gemm90::to_f2(xv);
      pair = sm90::pack_bf16((xf.x + y0 * cv[0].x) + cv[1].x,
                               (xf.y + y1 * cv[0].y) + cv[1].y);
    } else {
      pair = sm90::pack_bf16(y0 * cv[0].x, y1 * cv[0].y);
    }
    *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * c +
                                 col) = pair;
  }
};

// kBlock: K4 (LayerNorm, residual and b2); else K12 (ln_w, ln_b, b2 and eps
// unused). plans: sm90_gemm_plan's of up, then down.
template <typename T, bool kBlock>
int launch(const void* x, void* out, const float* ln_w, const float* ln_b,
           const int8_t* w1, const float* s1, const float* b1,
           const int8_t* w2, const float* s2, const float* b2, int8_t* x8,
           float* g, int8_t* g8, unsigned* amax, int batch, int t, int c,
           int m, int block_t, float xs, float gs, int dynamic, float eps,
           const int* plans, cudaStream_t stream) {
  const int rows = batch * t;
  const int slots = batch * (t / block_t);
  int err = launch_ln_quant<T, kBlock>(x, x8, ln_w, ln_b, rows, c, xs, eps,
                                       dynamic ? amax : nullptr, slots,
                                       stream);
  if (err != 0) return err;
  err = gemm90::launch_gemm<true>(
      plans, x8, w1, rows, m, c, m,
      GateEpi{s1, b1, g, g8, amax, m, t, block_t, xs, gs, dynamic}, stream);
  if (err != 0) return err;
  if (dynamic) {
    quant_kernel<<<rows, 256, 0, stream>>>(g, g8, amax, t, m, block_t);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return gemm90::launch_gemm<true>(
      plans + gemm90::kPlanInts, g8, w2, rows, c, m, 0,
      DownEpi<T, kBlock>{static_cast<const T*>(x), amax, s2, b2,
                         static_cast<__nv_bfloat16*>(out), c, t, block_t, gs,
                         dynamic},
      stream);
}

// K9's epilogue: out = bf16(sum + bias[col]) channel-major, [rows / t][n][t]
struct ChannelMajorBiasEpi {
  static constexpr bool kColMajor = true;
  const float* bias;
  __nv_bfloat16* out;
  int n;
  int t;
  __device__ void operator()(int row, int col, float sum) const {
    const int img = row / t;
    out[(static_cast<long long>(img) * n + col) * t + (row - img * t)] =
        __float2bfloat16_rn(sum + bias[col]);
  }
};

// the shapes the kernels take: T and block_t multiples of 8 (an 8-row group
// of the products' epilogues lies in one scale slot), T a multiple of
// block_t; the products' own rules are in their plans' checks
bool shape_ok(int batch, int t, int c, int m, int block_t, float gs,
              int dynamic) {
  return batch >= 1 && t >= 8 && t % 8 == 0 && c % 8 == 0 && m % 8 == 0 &&
         block_t >= 8 && block_t % 8 == 0 && t % block_t == 0 &&
         (dynamic || gs > 0.f);
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16; out is bf16. x, out [batch*t, c]
// contiguous; w1 int8 [2m, c] (rows: h columns, then gate columns), s1, b1
// fp32 [2m]; w2 int8 [c, m], s2, b2 fp32 [c]. x8 int8 [batch*t, c], g fp32
// [batch*t, m], g8 int8 [batch*t, m] and amax (batch * t / block_t words)
// are scratch (g is not written with the static scale). dynamic = 0 takes
// the static interior scale gs. plans: ops/gemm.py:sm90_gemm_plan's of the
// up product ([batch*t, c] x [m, c]^T, two operands) and the down product
// ([batch*t, m] x [c, m]^T), in that order. Returns a cudaError_t (0 on
// success).
extern "C" int ldmseg_geglu_ln_s8(
    int dtype, const void* x, void* out, const float* ln_w,
    const float* ln_b, const int8_t* w1, const float* s1, const float* b1,
    const int8_t* w2, const float* s2, const float* b2, int8_t* x8, float* g,
    int8_t* g8, unsigned* amax, int batch, int t, int c, int m, int block_t,
    float xs, float gs, int dynamic, float eps, const int* plans,
    void* stream) {
  if (!shape_ok(batch, t, c, m, block_t, gs, dynamic)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, true>(x, out, ln_w, ln_b, w1, s1, b1, w2, s2, b2, x8,
                               g, g8, amax, batch, t, c, m, block_t, xs, gs,
                               dynamic, eps, plans, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, true>(x, out, ln_w, ln_b, w1, s1, b1, w2, s2,
                                       b2, x8, g, g8, amax, batch, t, c, m,
                                       block_t, xs, gs, dynamic, eps, plans,
                                       s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12: the arguments of ldmseg_geglu_ln_s8 without the LayerNorm, b2 and
// eps; out = bf16(W2 q(h * gelu_tanh(gate)) s2), no residual.
extern "C" int ldmseg_geglu_s8(
    int dtype, const void* x, void* out, const int8_t* w1, const float* s1,
    const float* b1, const int8_t* w2, const float* s2, int8_t* x8, float* g,
    int8_t* g8, unsigned* amax, int batch, int t, int c, int m, int block_t,
    float xs, float gs, int dynamic, const int* plans, void* stream) {
  if (!shape_ok(batch, t, c, m, block_t, gs, dynamic)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, false>(x, out, nullptr, nullptr, w1, s1, b1, w2, s2,
                                nullptr, x8, g, g8, amax, batch, t, c, m,
                                block_t, xs, gs, dynamic, 0.f, plans, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, false>(x, out, nullptr, nullptr, w1, s1, b1,
                                        w2, s2, nullptr, x8, g, g8, amax,
                                        batch, t, c, m, block_t, xs, gs,
                                        dynamic, 0.f, plans, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9: the arguments of ldmseg_geglu_ln_s8, with out bf16 channel-major
// [batch, c, t], wpo bf16 [c, c] (out, in), bpo fp32 [c] and r bf16
// [batch*t, c] scratch (the block's output, the product's A operand).
extern "C" int ldmseg_geglu_ln_s8_pout(
    int dtype, const void* x, void* out, const float* ln_w,
    const float* ln_b, const int8_t* w1, const float* s1, const float* b1,
    const int8_t* w2, const float* s2, const float* b2, const void* wpo,
    const float* bpo, void* r, int8_t* x8, float* g, int8_t* g8,
    unsigned* amax, int batch, int t, int c, int m, int block_t, float xs,
    float gs, int dynamic, float eps, const int* plans, void* stream) {
  const int err = ldmseg_geglu_ln_s8(dtype, x, r, ln_w, ln_b, w1, s1, b1, w2,
                                     s2, b2, x8, g, g8, amax, batch, t, c, m,
                                     block_t, xs, gs, dynamic, eps, plans,
                                     stream);
  if (err != 0) return err;
  return launch_bf16_gemm(
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(wpo), batch * t, c, c,
      ChannelMajorBiasEpi{bpo, static_cast<__nv_bfloat16*>(out), c, t},
      static_cast<cudaStream_t>(stream));
}
