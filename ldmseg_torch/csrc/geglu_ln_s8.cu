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
// Design. The dynamic scale is one amax per (image, 512-token block), so a
// Hopper block of 64 tokens cannot quantize its own interior: the amax
// comes from blocks that run in no order. Four kernels on the stream:
//   a. ln_quant (s8_common.cuh): one warp per token row -> x8 [B*T, C] (K12
//      compiles the LayerNorm out); it also zeroes the amax slots;
//   b. up: one block per (64-token tile of one image, 64 interior
//      columns); the int8 products of the h and the gate columns (int8
//      wmma, int32 sums), the dequantize, bias and gating epilogue, g
//      written in fp32 to a scratch [B*T, M], and, when dynamic, the tile's
//      amax folded into its (image, block) slot by an integer atomicMax on
//      the float's bits (the values are non-negative, so the bits order as
//      the floats);
//   c. quant: one pass over g, g8 = rint(g / gs) (clipped) with gs the
//      static scale or max(slot, 1e-6) / 127, into an int8 [B*T, M];
//   d. down: one block per (64-token tile, 64 output columns); the int8
//      product of g8 with W2 and the residual + bias epilogue (K12 compiles
//      it out). K4 and K12 are one template, flag kBlock.
// A 64-token tile never straddles a block: block_t is T when T <= 512,
// else 512, and the wrapper sends only T % block_t == 0 here. W1 and W2
// stream through shared memory 64 deep at a time.
//
// K9 replaces _geglu_ln_pout_kernel (pallas_call in _geglu_ln_pout_impl,
// fused_geglu_ln_s8 with proj_out): K4's steps 1-5 with the block's output
// rounded, r = bf16(float(x) + y * gs * s2 + b2) over the whole row, then
//   6. out = bf16(float(r Wpo) + b_po): bf16 operands, fp32 sums.
// r crosses tiles of the product, so K4's four kernels write it to a bf16
// scratch [B*T, C] and a fifth, bf16_gemm_kernel (s8_common.cuh), runs the
// product with the bias epilogue, writing out channel-major [B, C, T]: the
// NCHW layout of Transformer2D's residual add, so the caller adds without a
// permute. Its 2*T*C^2 bf16 operations per image are ~1/6 of K4's int8
// operations counted at the bf16 rate.

#include "s8_common.cuh"

namespace {

using namespace s8;

// ---- b: W1, gating, amax --------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    up_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ w1,
              const float* __restrict__ s1, const float* __restrict__ b1,
              float* __restrict__ g, unsigned* __restrict__ amax, int t,
              int c, int m, int block_t, float xs, int dynamic) {
  __shared__ __align__(256) int8_t As[kTile * kDepth];
  __shared__ __align__(256) int8_t Bh[kTile * kDepth];
  __shared__ __align__(256) int8_t Bg[kTile * kDepth];
  __shared__ __align__(256) int Sh[kTile * kStageLd];
  __shared__ __align__(256) int Sg[kTile * kStageLd];
  __shared__ float warp_amax[kThreads / 32];
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int8_t* xb = x8 + static_cast<long long>(b) * t * c;
  AccFrag acc_h[4], acc_g[4];
  zero_acc(acc_h);
  zero_acc(acc_g);
  for (int k0 = 0; k0 < c; k0 += kDepth) {
    __syncthreads();
    load_s8_tile(As, xb, c, t0, t, k0, c);
    load_s8_tile(Bh, w1, c, n0, m, k0, c);
    load_s8_tile(Bg, w1 + static_cast<long long>(m) * c, c, n0, m, k0, c);
    __syncthreads();
    mma_s8_stage(acc_h, As, Bh);
    mma_s8_stage(acc_g, As, Bg);
  }
  stage_acc(Sh, acc_h);
  stage_acc(Sg, acc_g);
  __syncthreads();
  float local = 0.f;
  float* gb = g + static_cast<long long>(b) * t * m;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile;
    const int cc = i - r * kTile;
    const int row = t0 + r;
    const int n = n0 + cc;
    if (row >= t || n >= m) continue;
    const float uh =
        static_cast<float>(Sh[r * kStageLd + cc]) * (xs * s1[n]) + b1[n];
    const float ug = static_cast<float>(Sg[r * kStageLd + cc]) *
                         (xs * s1[m + n]) +
                     b1[m + n];
    const float z = 0.7978845608028654f * (ug + 0.044715f * ug * ug * ug);
    const float gv = uh * (ug / (1.f + expf(-2.f * z)));
    gb[static_cast<long long>(row) * m + n] = gv;
    local = fmaxf(local, fabsf(gv));
  }
  if (!dynamic) return;
  local = warp_max(local);
  if ((threadIdx.x & 31) == 0) warp_amax[threadIdx.x / 32] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = warp_amax[0];
    for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, warp_amax[w]);
    const int slots = t / block_t;
    atomicMax(amax + b * slots + t0 / block_t, __float_as_uint(mx));
  }
}

// ---- c: quantize the interior -------------------------------------------
__global__ void __launch_bounds__(256)
    quant_kernel(const float* __restrict__ g, int8_t* __restrict__ g8,
                 const unsigned* __restrict__ amax, long long total, int t,
                 int m, int block_t, float gs_static, int dynamic) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= total) return;
  float gs = gs_static;
  if (dynamic) {
    const long long row = i / m;           // b * t + token
    const int b = static_cast<int>(row / t);
    const int tok = static_cast<int>(row - static_cast<long long>(b) * t);
    gs = fmaxf(__uint_as_float(amax[b * (t / block_t) + tok / block_t]),
               1e-6f) / 127.f;
  }
  g8[i] = quant_s8(g[i] / gs);
}

// ---- d: W2, residual and bias (kBlock) -----------------------------------
template <typename T, bool kBlock>
__global__ void __launch_bounds__(kThreads)
    down_kernel(const T* __restrict__ x, const int8_t* __restrict__ g8,
                const unsigned* __restrict__ amax,
                const int8_t* __restrict__ w2, const float* __restrict__ s2,
                const float* __restrict__ b2,
                __nv_bfloat16* __restrict__ out, int t, int c, int m,
                int block_t, float gs_static, int dynamic) {
  __shared__ __align__(256) int8_t As[kTile * kDepth];
  __shared__ __align__(256) int8_t Bs[kTile * kDepth];
  __shared__ __align__(256) int S[kTile * kStageLd];
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  float gs = gs_static;
  if (dynamic) {
    const int slots = t / block_t;
    gs = fmaxf(__uint_as_float(amax[b * slots + t0 / block_t]), 1e-6f) /
         127.f;
  }
  const int8_t* gb = g8 + static_cast<long long>(b) * t * m;
  AccFrag acc[4];
  zero_acc(acc);
  for (int k0 = 0; k0 < m; k0 += kDepth) {
    __syncthreads();
    load_s8_tile(As, gb, m, t0, t, k0, m);
    load_s8_tile(Bs, w2, m, n0, c, k0, m);
    __syncthreads();
    mma_s8_stage(acc, As, Bs);
  }
  stage_acc(S, acc);
  __syncthreads();
  const long long rbase = static_cast<long long>(b) * t;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile;
    const int cc = i - r * kTile;
    const int row = t0 + r;
    const int n = n0 + cc;
    if (row >= t || n >= c) continue;
    const long long at = (rbase + row) * c + n;
    const float y = static_cast<float>(S[r * kStageLd + cc]) * gs;
    if constexpr (kBlock) {
      out[at] = __float2bfloat16_rn((to_f(x[at]) + y * s2[n]) + b2[n]);
    } else {
      out[at] = __float2bfloat16_rn(y * s2[n]);
    }
  }
}

// kBlock: K4 (LayerNorm, residual and b2); else K12 (ln_w, ln_b, b2 and eps
// unused)
template <typename T, bool kBlock>
int launch(const void* x, void* out, const float* ln_w, const float* ln_b,
           const int8_t* w1, const float* s1, const float* b1,
           const int8_t* w2, const float* s2, const float* b2, int8_t* x8,
           float* g, int8_t* g8, unsigned* amax, int batch, int t, int c,
           int m,
           int block_t, float xs, float gs, int dynamic, float eps,
           cudaStream_t stream) {
  const int slots = batch * (t / block_t);
  int err = launch_ln_quant<T, kBlock>(x, x8, ln_w, ln_b, batch * t, c, xs, eps,
                               dynamic ? amax : nullptr, slots, stream);
  if (err != 0) return err;
  const dim3 grid_up((t + kTile - 1) / kTile, (m + kTile - 1) / kTile, batch);
  up_kernel<<<grid_up, kThreads, 0, stream>>>(x8, w1, s1, b1, g, amax, t, c,
                                               m, block_t, xs, dynamic);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long total = static_cast<long long>(batch) * t * m;
  quant_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                 stream>>>(g, g8, amax, total, t, m, block_t, gs, dynamic);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid_down((t + kTile - 1) / kTile, (c + kTile - 1) / kTile,
                       batch);
  down_kernel<T, kBlock><<<grid_down, kThreads, 0, stream>>>(
      static_cast<const T*>(x), g8, amax, w2, s2, b2,
      static_cast<__nv_bfloat16*>(out), t, c, m, block_t, gs, dynamic);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16; out is bf16. x, out [batch*t, c]
// contiguous; w1 int8 [2m, c] (rows: h columns, then gate columns), s1, b1
// fp32 [2m]; w2 int8 [c, m], s2, b2 fp32 [c]. x8 int8 [batch*t, c], g fp32
// [batch*t, m], g8 int8 [batch*t, m] and amax (batch * t / block_t words)
// are scratch. dynamic = 0
// takes the static interior scale gs. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_geglu_ln_s8(
    int dtype, const void* x, void* out, const float* ln_w,
    const float* ln_b, const int8_t* w1, const float* s1, const float* b1,
    const int8_t* w2, const float* s2, const float* b2, int8_t* x8, float* g,
    int8_t* g8, unsigned* amax, int batch, int t, int c, int m, int block_t,
    float xs,
    float gs, int dynamic, float eps, void* stream) {
  if (batch < 1 || t < 1 || c % 8 != 0 || m % 8 != 0 || block_t < 1 ||
      t % block_t != 0 || (t > block_t && block_t % kTile != 0) ||
      batch > 65535 || (!dynamic && !(gs > 0.f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, true>(x, out, ln_w, ln_b, w1, s1, b1, w2, s2, b2, x8,
                               g, g8, amax, batch, t, c, m, block_t, xs, gs,
                               dynamic, eps, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, true>(x, out, ln_w, ln_b, w1, s1, b1, w2, s2,
                                       b2, x8, g, g8, amax, batch, t, c, m,
                                       block_t, xs, gs, dynamic, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12: the arguments of ldmseg_geglu_ln_s8 without the LayerNorm, b2 and
// eps; out = bf16(W2 q(h * gelu_tanh(gate)) s2), no residual.
extern "C" int ldmseg_geglu_s8(
    int dtype, const void* x, void* out, const int8_t* w1, const float* s1,
    const float* b1, const int8_t* w2, const float* s2, int8_t* x8, float* g,
    int8_t* g8, unsigned* amax, int batch, int t, int c, int m, int block_t,
    float xs, float gs, int dynamic, void* stream) {
  if (batch < 1 || t < 1 || c % 8 != 0 || m % 8 != 0 || block_t < 1 ||
      t % block_t != 0 || (t > block_t && block_t % kTile != 0) ||
      batch > 65535 || (!dynamic && !(gs > 0.f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, false>(x, out, nullptr, nullptr, w1, s1, b1, w2, s2,
                                nullptr, x8, g, g8, amax, batch, t, c, m,
                                block_t, xs, gs, dynamic, 0.f, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, false>(x, out, nullptr, nullptr, w1, s1, b1,
                                        w2, s2, nullptr, x8, g, g8, amax,
                                        batch, t, c, m, block_t, xs, gs,
                                        dynamic, 0.f, s);
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
    float gs, int dynamic, float eps, void* stream) {
  const int err = ldmseg_geglu_ln_s8(dtype, x, r, ln_w, ln_b, w1, s1, b1, w2,
                                     s2, b2, x8, g, g8, amax, batch, t, c, m,
                                     block_t, xs, gs, dynamic, eps, stream);
  if (err != 0) return err;
  return launch_bf16_gemm<false>(
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(wpo), batch * t, c, c, t,
      ChannelMajorBiasEpi{bpo, static_cast<__nv_bfloat16*>(out), c, t},
      static_cast<cudaStream_t>(stream));
}
