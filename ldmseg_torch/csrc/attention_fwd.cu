// K1 on Hopper: the UNet self-attention forward, O = softmax(Q K^T * scale) V.
// K14, its packed [B, T, C] entry point, and K16, the attention with its
// four projections absorbed, are at the end of this file.
//
// Replaces the TPU kernels ldmseg_tpu/ops/pallas/attention.py:_attn_kernel
// (:28, pallas_call :1273 in _fused_impl, public fused_self_attention) and,
// through K14's entry point, _attn_kernel_btc (:1427, pallas_call :1476 in
// _packed_impl). Same arithmetic as _attn_body (:35): S = Q K^T accumulated
// in fp32 and scaled, softmax in fp32 with the row max subtracted, P
// normalised by the row's final sum and only then rounded to the input
// dtype, O = P V accumulated in fp32 and stored in the input dtype.
//
// What bounds it on an H100 (bf16): the tensor cores, and at small head
// dims the exponentials. At the slice's largest shape (B*H = 16, T = 2048,
// D = 40) the products are ~18 GFLOP with D padded to 48 for Q K^T (~19 us
// at 989 TFLOP/s), against ~10.5 MB in and out (~3 us at 3.35 TB/s); the
// two passes take 2 * B*H * T^2 = 134 M exponentials on the SFU (16 per
// clock per SM on 132 SMs: ~32 us at 1.98 GHz), so at D = 40 the
// exponentials set the floor. The design overlaps them with the products
// (products issued a step ahead, two consumer warpgroups taking turns) and
// keeps the other work per score to a few FMA-pipe instructions. Besides,
// every 128-query tile streams K twice and V once from L2;
// tools/ablate_attention_fwd.py times the kernel with its loads, products,
// exponentials or softmax taken out.
//
// Why two passes: the rounding point. P is normalised by the row's *final*
// sum before it rounds to bf16. A one-pass online softmax rounds exp(s -
// running max) before the sum is known, and a bf16 rounding does not
// commute with the later rescale; so pass 1 computes Q K^T and the row
// statistics only, and pass 2 recomputes S, forms p = exp(s - m) / l and
// rounds it there, then accumulates P V. Three products where two are owed.
//
// bf16 design (attention_fwd_kernel_sm90): the skeleton of
// attention_sm90.cuh on bf16 Q and K, which K3's int8 attention stage
// (attention_ln_s8.cu) shares. One block per (b*h, 128 or 64 query rows),
// a producer warpgroup issuing TMA loads through 4-D tensor maps built from
// the caller's element strides (so K1's [B, T, H, D], K14's head view of
// [B, T, C] and K16's q, k, v buffers are read in place; a box is 64
// columns, one 128-byte swizzle row), wgmma m64nNk16 for S = Q K^T and P V
// with P from registers; the scale folded with log2(e) into c, pass 1 the
// running max and sum, pass 2 p = 2^(s c - m) * (1 / l), one reciprocal per
// row. The launch plan is ops/attention.py:sm90_launch_plan's, checked here.
//
// fp32 (on no serving or training path) keeps a plain SIMT kernel
// (attention_fwd_kernel_f32): 64-row query tiles through shared memory, the
// same two passes with FMA loops.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_sm90.cuh"
#include "gemm_sm90.cuh"  // K16's projections
#include "sm90.cuh"

namespace {

constexpr int kMaxD = 160;  // largest head dim taken

using Strides = attn90::Strides;  // element strides of B, T and H

// ---------------------------------------------------------------------------
// fp32: plain SIMT
// ---------------------------------------------------------------------------
constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;      // 4 warps; a lane pair per query row
constexpr int kSld = kBlockK + 4;  // score row stride (bank skew)
constexpr int kPld = kBlockK + 8;  // P row stride

// Rows [row0, row0 + 64) of one (b, h) slice into shared memory [64][ld],
// columns [0, d). Rows at or past t are zero-filled. 16-byte vectors: the
// wrapper checks that d and the strides are multiples of 8 elements and
// that the base pointers are 16-byte aligned.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long st, int row0, int t,
                                          int d) {
  const int vecs = d / 4;
  for (int i = threadIdx.x; i < kBlockQ * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t) {
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * st + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// S = Q K^T for the 64 x 64 tile into Ss (unscaled)
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks,
                                           float* Ss, int ldq, int d) {
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  float acc[kBlockK / 2];
#pragma unroll
  for (int j = 0; j < kBlockK / 2; ++j) acc[j] = 0.f;
  for (int c = 0; c < d; ++c) {
    const float qv = Qs[row * ldq + c];
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      acc[j] = fmaf(qv, Ks[(half + 2 * j) * ldq + c], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kBlockK / 2; ++j) Ss[row * kSld + half + 2 * j] = acc[j];
}

__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel_f32(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, int heads, int t, int d,
                             Strides sq, Strides sk, Strides sv, Strides so,
                             float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = d + 4;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBlockQ * ldq;
  float* Vs = Ks + kBlockK * ldq;
  float* Ss = Vs + kBlockK * ldq;
  float* Ps = Ss + kBlockQ * kSld;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kBlockQ;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  load_tile(Qs, ldq, qb, sq.t, q0, t, d);

  const int row = threadIdx.x >> 1;  // this lane pair's query row
  const int half = threadIdx.x & 1;  // columns half, half + 2, ...
  float m_run = -INFINITY;
  float l_run = 0.f;

  // pass 1: row max and row sum of exp(s - max)
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load_tile(Ks, ldq, kb, sk.t, k0, t, d);
    __syncthreads();
    score_tile(Qs, Ks, Ss, ldq, d);
    __syncwarp();
    float s[kBlockK / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int c = half + 2 * j;
      s[j] = (k0 + c < t) ? Ss[row * kSld + c] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) sum += expf(s[j] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
    __syncwarp();
  }

  // pass 2: P = exp(s - m) / l, O += P V
  float acc[kMaxD / 2];
#pragma unroll
  for (int i = 0; i < kMaxD / 2; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load_tile(Ks, ldq, kb, sk.t, k0, t, d);
    load_tile(Vs, ldq, vb, sv.t, k0, t, d);
    __syncthreads();
    score_tile(Qs, Ks, Ss, ldq, d);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int c = half + 2 * j;
      float p = 0.f;
      if (k0 + c < t) p = expf(Ss[row * kSld + c] * scale - m_run) / l_run;
      Ps[row * kPld + c] = p;
    }
    __syncwarp();
    for (int c = 0; c < kBlockK; ++c) {
      const float p = Ps[row * kPld + c];
#pragma unroll
      for (int i = 0; i < kMaxD / 2; ++i) {
        if (half + 2 * i < d) acc[i] = fmaf(p, Vs[c * ldq + half + 2 * i], acc[i]);
      }
    }
  }

  float* ob = o + b * so.b + h * so.h;
  if (q0 + row < t) {
#pragma unroll
    for (int i = 0; i < kMaxD / 2; ++i) {
      const int c = half + 2 * i;
      if (c < d) ob[(q0 + row) * so.t + c] = acc[i];
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int batch,
               int t, int heads, int d, const long long* st, float scale,
               cudaStream_t stream) {
  const int ldq = d + 4;
  const size_t smem =
      (3 * kBlockQ * ldq + kBlockQ * kSld + kBlockQ * kPld) * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (3 * kBlockQ * (kMaxD + 4) + kBlockQ * kSld + kBlockQ * kPld) *
          static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t + kBlockQ - 1) / kBlockQ, batch * heads);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  attention_fwd_kernel_f32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, t, d, sq,
      sk, sv, so, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kBox = 64;  // bf16 columns of a TMA box: one swizzled row

// The launch plan as ops/attention.py:sm90_launch_plan lays it out
struct Plan {
  int head_class;  // N of P V: D rounded up to a compiled class
  int block_q;     // query rows per block, 64 per consumer warpgroup
  int block_k;     // keys per tile
  int stages;      // depth of the K/V ring
  int box_d;       // columns of a TMA box
  int chunks;      // boxes across D
  int smem_bytes;  // dynamic shared memory of the launch
  int grid_x;      // query tiles
  int grid_y;      // B * H
};

bool plan_ok(const Plan& p, int bh, int t, int d) {
  const int chunks = (p.head_class + kBox - 1) / kBox;
  return p.head_class == attn90::head_class(d) && p.box_d == kBox &&
         p.chunks == chunks &&
         p.smem_bytes == attn90::smem_bytes(p.block_q, p.block_k, chunks,
                                            chunks, p.stages) &&
         attn90::tiles_ok(p.head_class, p.block_q, p.block_k, p.stages,
                          p.smem_bytes, p.grid_x, p.grid_y, bh, t);
}

// attention_sm90.cuh's skeleton on bf16 Q and K: K1's rounding point
template <int kDN, int kWG>
__global__ void __launch_bounds__(attn90::Cfg<false, kDN, kWG>::kThreads, 1)
    attention_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ o, Strides so,
                              int heads, int t, int d, int stages, float c) {
  attn90::forward<false, kDN, kWG>(tq, tk, tv, o, so, heads, t, d, stages,
                                   c);
}

struct K1Kernel {
  static constexpr bool kS8 = false;
  template <int kDN, int kWG>
  static auto kernel() {
    return attention_fwd_kernel_sm90<kDN, kWG>;
  }
};

// in_context: the caller has made the tensors' device current (K16)
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int batch, int t, int heads, int d, const long long* st,
                float scale, const int* plan, cudaStream_t stream,
                bool in_context = false) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[5], plan[6], plan[7], plan[8]};
  if (!plan_ok(p, batch * heads, t, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!in_context) {
    const int current = sm90::make_current(q);
    if (current != 0) return current;
  }
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = sm90::encode_map(&maps[i], src[i], batch, t, heads,
                                     d, st + 3 * i, i == 0 ? 64 : p.block_k);
    if (err != 0) return err;
  }
  const attn90::Launch a{p.head_class, p.block_q, p.smem_bytes, p.grid_x,
                         p.grid_y, p.stages, maps,
                         static_cast<__nv_bfloat16*>(o),
                         Strides{st[9], st[10], st[11]}, heads, t, d,
                         scale * attn90::kLog2e};
  return attn90::launch<K1Kernel>(a, stream);
}

int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int batch, int t, int heads, int d, const long long* st,
           float scale, const int* plan, cudaStream_t stream) {
  if (dtype == 0) return launch_f32(q, k, v, o, batch, t, heads, d, st, scale, stream);
  if (dtype == 1) return launch_bf16(q, k, v, o, batch, t, heads, d, st, scale, plan, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are [batch, t, heads, d]
// with unit stride on d; strides holds the (b, t, h) element strides of q,
// k, v and o in that order. plan is ops/attention.py:sm90_launch_plan's for
// (batch * heads, t, d), read by the bf16 kernel (checked; fp32 ignores it).
// Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int batch, int t,
                                    int heads, int d,
                                    const long long* strides, float scale,
                                    const int* plan, void* stream) {
  if (t < 1 || d < 8 || d > kMaxD || d % 8 != 0 || batch * heads < 1 ||
      batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(dtype, q, k, v, o, batch, t, heads, d, strides, scale, plan,
                static_cast<cudaStream_t>(stream));
}

// K14: the same attention on the packed token layout [batch, t, c] with
// c = heads * d (UNetConfig.use_packed_attention). Replaces
// ldmseg_tpu/ops/pallas/attention.py:_attn_kernel_btc (pallas_call in
// _packed_impl, public fused_self_attention_packed). The TPU kernel picks
// each head's d columns with one-hot selection matmuls, an exact
// permutation that works around the TPU's lane tiling; its per-head
// rounding points are K1's. Here the head h of token i is the d columns
// starting at i * c + h * d, so K1's kernel runs unchanged on the head view
// [batch, t, heads, d] with element strides (t * c, c, d): no copy, no
// selection product. strides holds the (b, t) element strides of q, k, v
// and o in that order (the head stride is d); plan is K1's for (batch *
// heads, t, d). Returns a cudaError_t.
extern "C" int ldmseg_attention_fwd_packed(int dtype, const void* q,
                                           const void* k, const void* v,
                                           void* o, int batch, int t, int c,
                                           int heads,
                                           const long long* strides,
                                           float scale, const int* plan,
                                           void* stream) {
  if (heads < 1 || c % heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d = c / heads;
  long long st[12];
  for (int i = 0; i < 4; ++i) {
    st[3 * i] = strides[2 * i];
    st[3 * i + 1] = strides[2 * i + 1];
    st[3 * i + 2] = d;
  }
  return ldmseg_attention_fwd(dtype, q, k, v, o, batch, t, heads, d, st,
                              scale, plan, stream);
}

// K16: self-attention with the projections absorbed (UNetConfig.
// use_absorbed_attention), out = to_out(attention(x Wq, x Wk, x Wv)) without
// the to_out bias, on the token layout x [batch, t, c]. Replaces
// ldmseg_tpu/ops/pallas/attention.py:_attn_kernel_absorbed (pallas_call in
// _absorbed_impl, public absorbed_self_attention). Its grid is (image, head);
// per step it computes, for head h:
//   1. q = T(x Wq[h]), k = T(x Wk[h]), v = T(x Wv[h]), each summed in fp32
//      and rounded to the input dtype T;
//   2-5. K1's rounding points on q, k, v (scores and softmax in fp32, P
//      rounded to T, P V summed in fp32, oh rounded to T);
//   6. oh Wo[h] summed in fp32 and added across heads, h = 0 first;
//   7. the fp32 sum rounded to T once.
// The head slices of the weights and of q, k, v are TPU layout work: on the
// card the head view [batch, t, heads, d] of a [batch, t, c] tensor is a
// stride, so the three projections run as whole products x W^T (every
// column's sum is its head's), K1's kernel reads their head views, and
// to_out is one product over the whole depth heads * d with fp32 sums,
// rounded once: K16's per-head accumulation up to the fp32 summation order.
//
// What bounds it on an H100: per image 4 * 2 * t * c^2 (the projections)
// plus 2 * 2 * t^2 * c (the attention) operations at the bf16 peak against
// x in, the four [c, c] weights and the output: at the serving shapes the
// tensor cores, except at t = 128 and 32, where the weights' bytes do.
//
// bf16 design: three launches on the stream, with q, k, v and oh through
// device memory (the caller's buffers, so that a backward can read them:
// the port runs K2 on their head views):
//   a. Q, K and V in one launch of gemm_sm90.cuh's bf16 product (TMA ring,
//      wgmma m64nNk16, fp32 sums in registers) over three W tensor maps, wq,
//      wk and wv where the caller has them: each column tile takes its map
//      and its destination from its column block, and StoreBf16Epi rounds
//      each pair to bf16 into q, k or v. One launch gives the card three
//      times the blocks of one projection (80 at t = 128: 132 SMs);
//   b. K1's kernel on the head views of q, k and v;
//   c. to_out, oh Wo^T, the same product with one map.
// The plans (K1's and the two products') come from ops/attention.py:
// absorbed_plans and are checked here; the wrapper makes the device
// current once for the three launches. fp32 (no serving or training path)
// takes a plain-FMA product (f32_gemm_kernel) and K1's fp32 variant.

namespace {

// out[i] = bf16(sum), each [rows, c]: columns [i c, i c + c) of the product
// go to out[i] (K16's q, k and v from one launch; to_out's one output).
// Where a column goes is worked out once per column and block (a code in
// the int per-column vector: its output and its offset in the row); a
// column tile lies in one output (the plan's tiles of c columns each).
struct StoreBf16Epi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 0;
  static constexpr int kIntCols = 1;  // the column's code
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  __nv_bfloat16* out0;
  __nv_bfloat16* out1;
  __nv_bfloat16* out2;
  int c;
  __device__ float col_value(int, int) const { return 0.f; }
  __device__ int col_int(int, int col) const {
    const int which = col / c;
    return which << 28 | (col - which * c);
  }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int row, int col, const float2*,
                             const int2* ci, const RowPre&, const Pre&,
                             float s0, float s1) const {
    const int which = ci[0].x >> 28;
    __nv_bfloat16* out = which == 0 ? out0 : which == 1 ? out1 : out2;
    *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * c +
                                 (ci[0].x & ((1 << 28) - 1))) =
        sm90::pack_bf16(s0, s1);
  }
};

constexpr int kGemmTile = 64;   // rows and columns of an fp32 output tile
constexpr int kGemmDepth = 16;  // depth of one shared-memory stage

// out = a w^T in fp32 with plain FMA: a [rows, k], w [n, k] row-major, out
// [rows, n]. 256 threads as 16 x 16, each owning a 4 x 4 block of outputs
// strided by 16 in both directions.
__global__ void __launch_bounds__(256)
    f32_gemm_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    float* __restrict__ out, int rows, int n, int k) {
  __shared__ float As[kGemmDepth][kGemmTile + 4];  // [depth][row]
  __shared__ float Ws[kGemmDepth][kGemmTile + 4];  // [depth][column]
  const int r0 = blockIdx.x * kGemmTile;
  const int n0 = blockIdx.y * kGemmTile;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < k; k0 += kGemmDepth) {
    __syncthreads();
    for (int i = threadIdx.x; i < kGemmTile * kGemmDepth; i += 256) {
      const int r = i / kGemmDepth;
      const int kk = i - r * kGemmDepth;
      const bool in_k = k0 + kk < k;
      As[kk][r] = (in_k && r0 + r < rows)
                      ? a[static_cast<long long>(r0 + r) * k + k0 + kk]
                      : 0.f;
      Ws[kk][r] = (in_k && n0 + r < n)
                      ? w[static_cast<long long>(n0 + r) * k + k0 + kk]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmDepth; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][tr + 16 * i];
        wv[i] = Ws[kk][tc + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + tr + 16 * i;
      const int col = n0 + tc + 16 * j;
      if (row < rows && col < n) {
        out[static_cast<long long>(row) * n + col] = acc[i][j];
      }
    }
  }
}

int f32_gemm(const void* a, const void* w, void* out, int rows, int n, int k,
             cudaStream_t stream) {
  const dim3 grid((rows + kGemmTile - 1) / kGemmTile,
                  (n + kGemmTile - 1) / kGemmTile);
  f32_gemm_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<float*>(out), rows, n, k);
  return static_cast<int>(cudaGetLastError());
}

int launch_absorbed_f32(const void* x, const void* const* w,
                        void* const* qkvo, void* out, int batch, int t,
                        int c, int heads, float scale, cudaStream_t stream) {
  const int rows = batch * t;
  for (int i = 0; i < 3; ++i) {
    const int err = f32_gemm(x, w[i], qkvo[i], rows, c, c, stream);
    if (err != 0) return err;
  }
  long long st[12];
  for (int i = 0; i < 4; ++i) {
    st[3 * i] = static_cast<long long>(t) * c;
    st[3 * i + 1] = c;
    st[3 * i + 2] = c / heads;
  }
  const int err = launch_f32(qkvo[0], qkvo[1], qkvo[2], qkvo[3], batch, t,
                             heads, c / heads, st, scale, stream);
  if (err != 0) return err;
  return f32_gemm(qkvo[3], w[3], out, rows, c, c, stream);
}

// plans: K1's (9 ints), then ops/gemm.py:sm90_gemm_plan's of the Q/K/V
// product ([rows, c] x [3c, c]^T over three maps) and of to_out ([rows, c]
// x [c, c]^T), bf16; the device is current
int launch_absorbed_bf16(const void* x, const void* const* w,
                         void* const* qkvo, void* out, int batch, int t,
                         int c, int heads, float scale, const int* plans,
                         cudaStream_t stream) {
  const int rows = batch * t;
  auto* q = static_cast<__nv_bfloat16*>(qkvo[0]);
  auto* k = static_cast<__nv_bfloat16*>(qkvo[1]);
  auto* v = static_cast<__nv_bfloat16*>(qkvo[2]);
  auto* oh = static_cast<__nv_bfloat16*>(qkvo[3]);
  // one launch for the three projections: three launches of one map each
  // took 16% more of K16's device time per UNet forward on an H100, 65%
  // more at t = 32 (tools/ablate_attention_fwd.py --k16)
  int err = gemm90::launch_gemm_in_context<false, 3, false>(
      plans + gemm90::kPlanInts, x, w, rows, 3 * c, c, 0, 1,
      StoreBf16Epi{q, k, v, c}, stream);
  if (err != 0) return err;
  // the head views [batch, t, heads, d] of q, k, v and oh
  long long st[12];
  for (int i = 0; i < 4; ++i) {
    st[3 * i] = static_cast<long long>(t) * c;
    st[3 * i + 1] = c;
    st[3 * i + 2] = c / heads;
  }
  err = launch_bf16(q, k, v, oh, batch, t, heads, c / heads, st, scale,
                    plans, stream, true);
  if (err != 0) return err;
  auto* o = static_cast<__nv_bfloat16*>(out);
  return gemm90::launch_gemm_in_context<false, 1, false>(
      plans + 2 * gemm90::kPlanInts, oh, &w[3], rows, c, c, 0, 1,
      StoreBf16Epi{o, o, o, c}, stream);
}

}  // namespace

// K16: dtype 0 = float32, 1 = bfloat16 for every tensor, all on CUDA
// device `device`, which this makes current (the wrapper has made it the
// thread's device). x [batch * t, c] contiguous; wq, wk, wv, wo [c, c]
// contiguous in the (out, in) layout of a torch Linear weight. q, k, v and
// oh ([batch * t, c] each, contiguous) and out ([batch * t, c]) are
// written: the three projections, the attention output before to_out, and
// to_out of it without the bias. c = heads * d with d a multiple of 8 up to
// 160; plans: K1's for (batch * heads, t, d), then sm90_gemm_plan's of the
// Q/K/V product (bf16, [batch * t, c] x [3c, c]^T, three maps) and of
// to_out, 27 ints (fp32 reads none of them). Returns a cudaError_t (0 on
// success).
extern "C" int ldmseg_attention_absorbed(int dtype, int device,
                                         const void* x, const void* wq,
                                         const void* wk, const void* wv,
                                         const void* wo, void* q, void* k,
                                         void* v, void* oh, void* out,
                                         int batch, int t, int c, int heads,
                                         float scale, const int* plans,
                                         void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || c % heads != 0 ||
      (c / heads) % 8 != 0 || c / heads > kMaxD || batch * heads > 65535 ||
      static_cast<long long>(batch) * t * c >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* w[4] = {wq, wk, wv, wo};
  void* qkvo[4] = {q, k, v, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_absorbed_f32(x, w, qkvo, out, batch, t, c, heads, scale,
                               s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // binds the device's context to this thread (the tensor maps' encoder
  // needs one) without the pointer query of sm90::make_current
  const cudaError_t dev = cudaSetDevice(device);
  if (dev != cudaSuccess) return static_cast<int>(dev);
  return launch_absorbed_bf16(x, w, qkvo, out, batch, t, c, heads, scale,
                              plans, s);
}
