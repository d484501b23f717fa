// Pieces shared by K3 and K8 (attention_ln_s8.cu), K4, K9 and K12
// (geglu_ln_s8.cu) and K13, K11, K15, K10, K17 and K18 (attention_s8.cu):
// the (LayerNorm +) static-scale int8 quantize of token rows (every one of
// them), and the one Ampere-era product that is left, bf16 x bf16 with fp32
// sums on 64x64 output tiles (nvcuda::wmma 16x16x16) with the caller's
// epilogue: K8's proj_in prologue, K9's proj_out epilogue and K16's
// products. Every int8 product runs on gemm_sm90.cuh, every int8 attention
// on attention_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

namespace s8 {

constexpr int kTile = 64;           // rows and columns of an output tile
constexpr int kThreads = 128;       // 4 warps; warp w owns rows [16w, 16w+16)
constexpr int kDepth = 64;          // depth of one shared-memory stage
constexpr int kStageLd = kTile + 4; // row stride of the int32/fp32 staging

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// round half to even, then clip to the symmetric int8 range
__device__ __forceinline__ int8_t quant_s8(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

// One warp per token row: LayerNorm in fp32 at the rounding points of the
// plain versions' ops/attention_s8.py:_layer_norm, then x8 = clip(rint(hn /
// xs)) with a true division; without kLN (K12 and the LN-less quantizes)
// x8 = clip(rint(x / xs)). The LN, each step a separately rounded intrinsic
// so that nvcc contracts nothing into an FMA:
//   mu = sum(x) / c, var = sum((x - mu)^2) / c (the centred squares),
//   r = rsqrtf(var + eps): the instruction torch.rsqrt runs on a CUDA
//       tensor, so the same var gives the same r,
//   hn = ((x - mu) * r) * w + b.
// What is left is the order of the two sums: lane l adds columns l, l + 32,
// ... in turn, then a butterfly over the lanes (every lane ends with the
// same bits), where PyTorch reduces in its own order. Where that moves the
// last bit of mu or var and hn / xs lies within a few ulps of a .5, a code
// differs from the plain version's by one (tests/test_torch_port_gn_sm90*).
// Block 0 also zeroes `zero_words` words of `zero` (K4's and K12's amax
// slots), which the next kernel on the stream accumulates into. When
// `stats` is not null, the row's (mu, var, r) go to stats[3 * row + 0..2]
// (ops/attention_s8.py:ln_quant_s8, for the tests).
template <typename T, bool kLN>
__global__ void __launch_bounds__(kThreads)
    ln_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                    const float* __restrict__ w, const float* __restrict__ b,
                    int rows, int c, float xs, float eps,
                    unsigned* __restrict__ zero, int zero_words,
                    float* __restrict__ stats) {
  if (zero != nullptr && blockIdx.x == 0) {
    for (int i = threadIdx.x; i < zero_words; i += blockDim.x) zero[i] = 0u;
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<long long>(row) * c;
  int8_t* out = x8 + static_cast<long long>(row) * c;
  if constexpr (!kLN) {
    for (int i = lane; i < c; i += 32) {
      out[i] = quant_s8(__fdiv_rn(to_f(xr[i]), xs));
    }
    return;
  }
  const float n = static_cast<float>(c);
  float s = 0.f;
  for (int i = lane; i < c; i += 32) s = __fadd_rn(s, to_f(xr[i]));
  const float mu = __fdiv_rn(warp_sum(s), n);
  float v = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d = __fsub_rn(to_f(xr[i]), mu);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(warp_sum(v), n);
  const float r = rsqrtf(__fadd_rn(var, eps));
  if (stats != nullptr && lane == 0) {
    stats[3ll * row] = mu;
    stats[3ll * row + 1] = var;
    stats[3ll * row + 2] = r;
  }
  for (int i = lane; i < c; i += 32) {
    const float hn = __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(to_f(xr[i]), mu), r), w[i]), b[i]);
    out[i] = quant_s8(__fdiv_rn(hn, xs));
  }
}

template <typename T, bool kLN = true>
int launch_ln_quant(const void* x, int8_t* x8, const float* w,
                    const float* b, int rows, int c, float xs, float eps,
                    unsigned* zero, int zero_words, cudaStream_t stream,
                    float* stats = nullptr) {
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  ln_quant_kernel<T, kLN><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), x8, w, b, rows, c, xs, eps, zero,
      zero_words, stats);
  return static_cast<int>(cudaGetLastError());
}

// ---- a whole product: C = A W^T on 64x64 output tiles ---------------------
// A [rows, k] and W [n, k] row-major (k a multiple of 8), each element of
// the product handed to epi(row, col, sum) for row < rows, col < n. The
// epilogue is the caller's rounding point: a functor with a
// __device__ operator() and a static constexpr bool kColMajor, which makes
// the tile's elements go to threads down its columns (consecutive rows to
// consecutive threads), so that a store to a channel-major [images][n][t]
// output is coalesced.

// bf16 A and W, fp32 sums. kAColMajor: A is held channel-major,
// [rows / t][k][t] (a GroupNorm's NCHW output read as tokens; t a multiple
// of 8, so 8 consecutive rows never straddle two images), staged [depth][64
// rows] in shared memory and read by col_major fragments.
template <bool kAColMajor, class Epi>
__global__ void __launch_bounds__(kThreads)
    bf16_gemm_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ w, int rows, int n,
                     int k, int t, Epi epi) {
  using namespace nvcuda;
  constexpr int kLd = kDepth + 8;   // [64 rows][depth] tiles
  constexpr int kLdT = kTile + 8;   // [depth][64 rows] tile of A
  static_assert(kTile * kLd == kDepth * kLdT, "one buffer, both layouts");
  __shared__ __align__(256) __nv_bfloat16 As[kTile * kLd];
  __shared__ __align__(256) __nv_bfloat16 Bs[kTile * kLd];
  __shared__ __align__(256) float S[kTile * kStageLd];
  const int r0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < k; k0 += kDepth) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * (kDepth / 8); i += kThreads) {
      const int r = i >> 3;
      const int u = i & 7;
      const int kk = k0 + u * 8;
      uint4 bw = make_uint4(0u, 0u, 0u, 0u);
      if (kk < k && n0 + r < n) {
        bw = *reinterpret_cast<const uint4*>(
            w + static_cast<long long>(n0 + r) * k + kk);
      }
      *reinterpret_cast<uint4*>(Bs + r * kLd + u * 8) = bw;
      uint4 av = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kAColMajor) {
        // r runs over the depth here (kDepth == kTile): depth row r of the
        // tile takes 8 consecutive tokens of input channel kd
        const int kd = k0 + r;
        const int row = r0 + u * 8;
        if (kd < k && row < rows) {
          const int img = row / t;
          const long long at =
              (static_cast<long long>(img) * k + kd) * t + (row - img * t);
          av = *reinterpret_cast<const uint4*>(a + at);
        }
        *reinterpret_cast<uint4*>(As + r * kLdT + u * 8) = av;
      } else {
        if (kk < k && r0 + r < rows) {
          av = *reinterpret_cast<const uint4*>(
              a + static_cast<long long>(r0 + r) * k + kk);
        }
        *reinterpret_cast<uint4*>(As + r * kLd + u * 8) = av;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      if constexpr (kAColMajor) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            af;
        wmma::load_matrix_sync(af, As + kk * 16 * kLdT + warp * 16, kLdT);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              bf;
          wmma::load_matrix_sync(bf, Bs + j * 16 * kLd + kk * 16, kLd);
          wmma::mma_sync(acc[j], af, bf, acc[j]);
        }
      } else {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::load_matrix_sync(af, As + warp * 16 * kLd + kk * 16, kLd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              bf;
          wmma::load_matrix_sync(bf, Bs + j * 16 * kLd + kk * 16, kLd);
          wmma::mma_sync(acc[j], af, bf, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(S + warp * 16 * kStageLd + j * 16, acc[j],
                            kStageLd, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int major = i / kTile;
    const int minor = i - major * kTile;
    const int r = Epi::kColMajor ? minor : major;
    const int cc = Epi::kColMajor ? major : minor;
    if (r0 + r < rows && n0 + cc < n) {
      epi(r0 + r, n0 + cc, S[r * kStageLd + cc]);
    }
  }
}

template <bool kAColMajor, class Epi>
int launch_bf16_gemm(const __nv_bfloat16* a, const __nv_bfloat16* w,
                     int rows, int n, int k, int t, Epi epi,
                     cudaStream_t stream) {
  const dim3 grid((rows + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  bf16_gemm_kernel<kAColMajor, Epi><<<grid, kThreads, 0, stream>>>(
      a, w, rows, n, k, t, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace s8
