// K1 on Hopper: the UNet self-attention forward, O = softmax(Q K^T * scale) V.
// K14, its packed [B, T, C] entry point, and K16, the attention with its
// four projections absorbed, are at the end of this file.
//
// Replaces the TPU kernel ldmseg_tpu/ops/pallas/attention.py:_attn_kernel /
// _attn_body (pallas_call in _fused_impl, public fused_self_attention).
// Same arithmetic: S = Q K^T accumulated in fp32 and scaled, softmax in fp32
// with the row max subtracted, P rounded to the input dtype, O = P V
// accumulated in fp32 and stored in the input dtype.
//
// What bounds it on an H100: 4*BH*T^2*D operations against 4*BH*T*D*bytes
// of input and output. At the slice's largest shape (BH=16, T=2048, D=40,
// bf16) that is ~10.7 GFLOP (~11 us at 989 TFLOP/s) against ~10.5 MB
// (~3 us at 3.35 TB/s): the tensor cores bound it, not memory. The smaller
// shapes (T=512/128/32) are bound by launch latency and grid fill.
//
// Design (simple first, fast later):
//   * one block of 4 warps per (batch*head, 64-row query tile); each warp
//     owns 16 query rows. Q/K/V are read through their [B, T, H, D] strides,
//     so the caller needs no transposes (the TPU kernel needed them for a
//     Mosaic tiling rule).
//   * the head dim is zero-padded in shared memory to a multiple of 16 (40 ->
//     48, 80, 160), so QK^T and PV run as nvcuda::wmma 16x16x16 bf16 tiles
//     with fp32 accumulators; the fp32 variant uses plain FMA.
//   * two passes over 64-key tiles. Pass 1 computes each row's max and sum
//     in fp32. Pass 2 recomputes S, forms p = exp(s - m) / l, rounds p to
//     the input dtype exactly where _attn_body does, and accumulates P V in
//     fp32 registers. The two-pass form keeps K1's rounding point; a
//     single-pass online softmax is a later redesign.
//   * no sequence-length budget: the score row never leaves shared memory,
//     so every T >= 1 is taken, the ragged last tile masked. D = 160 needs
//     more than the 48 KB static limit, so shared memory is dynamic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "s8_common.cuh"  // bf16_gemm_kernel (K16's projections)

namespace {

constexpr int kBlockQ = 64;             // query rows per block
constexpr int kBlockK = 64;             // keys per shared-memory tile
constexpr int kThreads = 128;           // 4 warps x 16 query rows
constexpr int kMaxD = 160;              // largest head dim taken
constexpr int kMaxTiles = kMaxD / 16;   // output column tiles per warp
constexpr int kSld = kBlockK + 4;       // fp32 score row stride (bank skew)
constexpr int kPld = kBlockK + 8;       // P row stride in elements

struct Strides {
  long long b, t, h;  // element strides of the B, T and H axes (D is 1)
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows [row0, row0 + 64) of one (b, h) slice into shared memory [64][ld],
// columns [0, d). Rows at or past t are zero-filled. 16-byte vectors:
// the wrapper checks that d and the strides are multiples of 8 elements
// and that the base pointers are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long st, int row0, int t,
                                          int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = d / kVec;
  for (int i = threadIdx.x; i < kBlockQ * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * st + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S = Q K^T for the 64 x 64 tile into Ss (unscaled fp32). Row ownership is
// the same in both variants: warp w computes rows [16w, 16w + 16), so the
// row statistics that follow need only __syncwarp.
template <typename T>
__device__ __forceinline__ void score_tile(const T* Qs, const T* Ks,
                                           float* Ss, int ldq, int d,
                                           int dp) {
  const int warp = threadIdx.x / 32;
  if constexpr (std::is_same<T, float>::value) {
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
    for (int j = 0; j < kBlockK / 2; ++j) {
      Ss[row * kSld + half + 2 * j] = acc[j];
    }
  } else {
    using namespace nvcuda;
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dp / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + warp * 16 * ldq + kk * 16, ldq);
        wmma::load_matrix_sync(b, Ks + n * 16 * ldq + kk * 16, ldq);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * kSld + n * 16, acc, kSld,
                              wmma::mem_row_major);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         int heads, int t, int d, Strides sq, Strides sk,
                         Strides sv, Strides so, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = (d + 15) & ~15;
  const int ldq = dp + 8;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBlockQ * ldq;
  T* Vs = Ks + kBlockK * ldq;
  float* Ss = reinterpret_cast<float*>(Vs + kBlockK * ldq);
  T* Ps = reinterpret_cast<T*>(Ss + kBlockQ * kSld);

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kBlockQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // zero the padded head-dim columns once: tile loads never write them
  const int pad = dp - d;
  for (int i = threadIdx.x; i < kBlockQ * pad; i += kThreads) {
    const int r = i / pad;
    const int c = d + (i - r * pad);
    Qs[r * ldq + c] = from_float<T>(0.f);
    Ks[r * ldq + c] = from_float<T>(0.f);
    Vs[r * ldq + c] = from_float<T>(0.f);
  }
  load_tile(Qs, ldq, qb, sq.t, q0, t, d);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int row = warp * 16 + (lane >> 1);  // this lane pair's query row
  const int half = lane & 1;                // columns half, half+2, ...
  float m_run = -INFINITY;
  float l_run = 0.f;

  // pass 1: row max and row sum of exp(s - max)
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load_tile(Ks, ldq, kb, sk.t, k0, t, d);
    __syncthreads();
    score_tile(Qs, Ks, Ss, ldq, d, dp);
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

  // pass 2: P = exp(s - m) / l rounded to T, O += P V in fp32
  using namespace nvcuda;
  constexpr bool kFp32 = std::is_same<T, float>::value;
  const int ntiles = dp / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[kFp32 ? 1 : kMaxTiles];
  float o_f32[kFp32 ? kMaxD / 2 : 1];
  if constexpr (kFp32) {
#pragma unroll
    for (int i = 0; i < kMaxD / 2; ++i) o_f32[i] = 0.f;
  } else {
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) wmma::fill_fragment(acc_o[n], 0.f);
  }

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load_tile(Ks, ldq, kb, sk.t, k0, t, d);
    load_tile(Vs, ldq, vb, sv.t, k0, t, d);
    __syncthreads();
    score_tile(Qs, Ks, Ss, ldq, d, dp);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int c = half + 2 * j;
      float p = 0.f;
      if (k0 + c < t) p = expf(Ss[row * kSld + c] * scale - m_run) / l_run;
      Ps[row * kPld + c] = from_float<T>(p);
    }
    __syncwarp();
    if constexpr (kFp32) {
      for (int c = 0; c < kBlockK; ++c) {
        const float p = to_float(Ps[row * kPld + c]);
#pragma unroll
        for (int i = 0; i < kMaxD / 2; ++i) {
          if (half + 2 * i < d) {
            o_f32[i] = fmaf(p, to_float(Vs[c * ldq + half + 2 * i]), o_f32[i]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + warp * 16 * kPld + kk * 16, kPld);
#pragma unroll
        for (int n = 0; n < kMaxTiles; ++n) {
          if (n < ntiles) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
            wmma::load_matrix_sync(bv, Vs + kk * 16 * ldq + n * 16, ldq);
            wmma::mma_sync(acc_o[n], a, bv, acc_o[n]);
          }
        }
      }
    }
  }

  // store O rows < t, columns < d, in the input dtype
  T* ob = o + b * so.b + h * so.h;
  if constexpr (kFp32) {
    if (q0 + row < t) {
#pragma unroll
      for (int i = 0; i < kMaxD / 2; ++i) {
        const int c = half + 2 * i;
        if (c < d) ob[(q0 + row) * so.t + c] = o_f32[i];
      }
    }
  } else {
    // stage each 16x16 accumulator through this warp's score rows
    float* stage = Ss + warp * 16 * kSld;
    __syncwarp();
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) {
      if (n < ntiles) {
        wmma::store_matrix_sync(stage, acc_o[n], kSld, wmma::mem_row_major);
        __syncwarp();
        const int r = lane >> 1;
        const int grow = q0 + warp * 16 + r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n * 16 + (lane & 1) * 8 + j;
          if (grow < t && c < d) {
            ob[grow * so.t + c] = from_float<T>(stage[r * kSld + (lane & 1) * 8 + j]);
          }
        }
        __syncwarp();
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int t, int heads, int d, const long long* st, float scale,
           cudaStream_t stream) {
  const int dp = (d + 15) & ~15;
  const int ldq = dp + 8;
  const size_t smem = (3 * kBlockQ * ldq + kBlockQ * kPld) * sizeof(T) +
                      kBlockQ * kSld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBlockQ - 1) / kBlockQ, batch * heads);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, t, d, sq, sk, sv,
      so, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are [batch, t, heads, d]
// with unit stride on d; strides holds the (b, t, h) element strides of q,
// k, v and o in that order. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int batch, int t,
                                    int heads, int d,
                                    const long long* strides, float scale,
                                    void* stream) {
  if (t < 1 || d < 8 || d > kMaxD || d % 8 != 0 || batch * heads < 1 ||
      batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, batch, t, heads, d, strides, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, batch, t, heads, d, strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
// and o in that order (the head stride is d). Returns a cudaError_t.
extern "C" int ldmseg_attention_fwd_packed(int dtype, const void* q,
                                           const void* k, const void* v,
                                           void* o, int batch, int t, int c,
                                           int heads,
                                           const long long* strides,
                                           float scale, void* stream) {
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
                              scale, stream);
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
// tensor cores. The design is five launches on the stream, with q, k, v and
// oh through device memory: three bf16_gemm_kernel products (s8_common.cuh)
// with an epilogue that rounds to bf16, K1's kernel on the head views, and
// one more product for to_out. fp32 takes a plain-FMA product (f32_gemm
// below) and K1's fp32 variant. q, k, v and oh are the caller's buffers, so
// a backward can read them (the port runs K2 on their head views).

namespace {

// out = bf16(sum), [rows, n]
struct StoreBf16Epi {
  static constexpr bool kColMajor = false;
  __nv_bfloat16* out;
  int n;
  __device__ void operator()(int row, int col, float sum) const {
    out[static_cast<long long>(row) * n + col] = __float2bfloat16_rn(sum);
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

// out = T(a w^T) with fp32 sums, [rows, n]
template <typename T>
int gemm(const void* a, const void* w, void* out, int rows, int n, int k,
         cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((rows + kGemmTile - 1) / kGemmTile,
                    (n + kGemmTile - 1) / kGemmTile);
    f32_gemm_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(w),
        static_cast<float*>(out), rows, n, k);
    return static_cast<int>(cudaGetLastError());
  } else {
    return s8::launch_bf16_gemm<false>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(w), rows, n, k, 1,
        StoreBf16Epi{static_cast<__nv_bfloat16*>(out), n}, stream);
  }
}

template <typename T>
int launch_absorbed(const void* x, const void* const* w, void* const* qkvo,
                    void* out, int batch, int t, int c, int heads,
                    float scale, cudaStream_t stream) {
  const int rows = batch * t;
  const int d = c / heads;
  for (int i = 0; i < 3; ++i) {
    const int err = gemm<T>(x, w[i], qkvo[i], rows, c, c, stream);
    if (err != 0) return err;
  }
  // the head views [batch, t, heads, d] of q, k, v and oh
  long long st[12];
  for (int i = 0; i < 4; ++i) {
    st[3 * i] = static_cast<long long>(t) * c;
    st[3 * i + 1] = c;
    st[3 * i + 2] = d;
  }
  const int err = launch<T>(qkvo[0], qkvo[1], qkvo[2], qkvo[3], batch, t,
                            heads, d, st, scale, stream);
  if (err != 0) return err;
  return gemm<T>(qkvo[3], w[3], out, rows, c, c, stream);
}

}  // namespace

// K16: dtype 0 = float32, 1 = bfloat16 for every tensor. x [batch * t, c]
// contiguous; wq, wk, wv, wo [c, c] contiguous in the (out, in) layout of a
// torch Linear weight. q, k, v and oh ([batch * t, c] each, contiguous) and
// out ([batch * t, c]) are written: the three projections, the attention
// output before to_out, and to_out of it without the bias. c = heads * d
// with d a multiple of 8 up to 160. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_absorbed(int dtype, const void* x,
                                         const void* wq, const void* wk,
                                         const void* wv, const void* wo,
                                         void* q, void* k, void* v, void* oh,
                                         void* out, int batch, int t, int c,
                                         int heads, float scale,
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
    return launch_absorbed<float>(x, w, qkvo, out, batch, t, c, heads, scale,
                                  s);
  }
  if (dtype == 1) {
    return launch_absorbed<__nv_bfloat16>(x, w, qkvo, out, batch, t, c, heads,
                                          scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
