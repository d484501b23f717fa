// Pieces shared by K3 (attention_ln_s8.cu), K4 and K12 (geglu_ln_s8.cu) and
// K13 (attention_s8.cu): the (LayerNorm +) static-scale int8 quantize of
// token rows, the int8 tile loaders, the 64x64 int8 product step and the
// int8 Q K^T score tile on tensor cores (nvcuda::wmma s8 16x16x16 with
// int32 accumulators).
//
// Layout of an int8 tile in shared memory: "k-blocked", [depth / 16][64
// rows][16]. Every 16-deep slice of a row then starts on a 16-byte boundary
// and every wmma fragment (16 rows x 16 deep, ld = 16) on a 256-byte one, as
// load_matrix_sync asks; a plain row-major tile would put the second slice
// of a row only 16 bytes in.

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
constexpr int kSlab = kTile * 16;   // bytes of one 16-deep slice of a tile
constexpr int kStageLd = kTile + 4; // row stride of the int32/fp32 staging

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16,
                                       16, int>;

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

// One warp per token row: LayerNorm in fp32 (mean, then the mean of the
// centred squares, eps inside the root), then x8 = clip(rint(hn / xs));
// without kLN (K12) x8 = clip(rint(x / xs)). Block 0 also zeroes
// `zero_words` words of `zero` (K4's and K12's amax slots), which the next
// kernel on the stream accumulates into.
template <typename T, bool kLN>
__global__ void __launch_bounds__(kThreads)
    ln_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                    const float* __restrict__ w, const float* __restrict__ b,
                    int rows, int c, float xs, float eps,
                    unsigned* __restrict__ zero, int zero_words) {
  if (zero != nullptr && blockIdx.x == 0) {
    for (int i = threadIdx.x; i < zero_words; i += blockDim.x) zero[i] = 0u;
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<long long>(row) * c;
  if constexpr (!kLN) {
    int8_t* out = x8 + static_cast<long long>(row) * c;
    for (int i = lane; i < c; i += 32) out[i] = quant_s8(to_f(xr[i]) / xs);
    return;
  }
  float s = 0.f;
  for (int i = lane; i < c; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) / c;
  float v = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d = to_f(xr[i]) - mu;
    v += d * d;
  }
  const float var = warp_sum(v) / c;
  const float r = 1.f / sqrtf(var + eps);
  int8_t* out = x8 + static_cast<long long>(row) * c;
  for (int i = lane; i < c; i += 32) {
    const float hn = (to_f(xr[i]) - mu) * r * w[i] + b[i];
    out[i] = quant_s8(hn / xs);
  }
}

template <typename T, bool kLN = true>
int launch_ln_quant(const void* x, int8_t* x8, const float* w,
                    const float* b, int rows, int c, float xs, float eps,
                    unsigned* zero, int zero_words, cudaStream_t stream) {
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  ln_quant_kernel<T, kLN><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), x8, w, b, rows, c, xs, eps, zero,
      zero_words);
  return static_cast<int>(cudaGetLastError());
}

// Rows [r0, r0+64) x depth [k0, k0+64) of a row-major int8 matrix (row
// stride ld) into a k-blocked tile; rows >= nrows and depth >= kdim read as
// zero. 8-byte loads: ld and kdim are multiples of 8 and src is 8-byte
// aligned (the wrappers check).
__device__ __forceinline__ void load_s8_tile(int8_t* dst,
                                             const int8_t* __restrict__ src,
                                             long long ld, int r0, int nrows,
                                             int k0, int kdim) {
  for (int i = threadIdx.x; i < kTile * (kDepth / 8); i += kThreads) {
    const int r = i >> 3;
    const int u = i & 7;
    const int k = k0 + u * 8;
    uint2 val = make_uint2(0u, 0u);
    if (r0 + r < nrows && k < kdim) {
      val = *reinterpret_cast<const uint2*>(src + (r0 + r) * ld + k);
    }
    *reinterpret_cast<uint2*>(dst + (u >> 1) * kSlab + r * 16 +
                              (u & 1) * 8) = val;
  }
}

// acc (this warp's 16 rows x 64 columns) += A[64 x 64] * B[64 x 64]^T for
// one stage: A holds rows, B holds output columns, both k-blocked.
__device__ __forceinline__ void mma_s8_stage(AccFrag (&acc)[4],
                                             const int8_t* As,
                                             const int8_t* Bs) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int kb = 0; kb < kDepth / 16; ++kb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
        a;
    wmma::load_matrix_sync(a, As + kb * kSlab + warp * 16 * 16, 16);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major>
          bf;
      wmma::load_matrix_sync(bf, Bs + kb * kSlab + n * 16 * 16, 16);
      wmma::mma_sync(acc[n], a, bf, acc[n]);
    }
  }
}

// this warp's accumulators into rows [16w, 16w+16) of a [64][kStageLd]
// int32 staging tile
__device__ __forceinline__ void stage_acc(int* S, const AccFrag (&acc)[4]) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    nvcuda::wmma::store_matrix_sync(S + warp * 16 * kStageLd + n * 16, acc[n],
                                    kStageLd, nvcuda::wmma::mem_row_major);
  }
}

__device__ __forceinline__ void zero_acc(AccFrag (&acc)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) nvcuda::wmma::fill_fragment(acc[n], 0);
}

// rows [row0, row0+64) of one head's int8 columns [0, d) (row stride ld,
// the head's first column at src) into a k-blocked tile of depth dp, zero
// past t and d
__device__ __forceinline__ void load_head_s8(int8_t* dst,
                                             const int8_t* __restrict__ src,
                                             int ld, int row0, int t, int d,
                                             int dp) {
  const int units = dp / 8;
  for (int i = threadIdx.x; i < kTile * units; i += kThreads) {
    const int r = i / units;
    const int u = i - r * units;
    uint2 val = make_uint2(0u, 0u);
    if (row0 + r < t && u * 8 < d) {
      val = *reinterpret_cast<const uint2*>(
          src + static_cast<long long>(row0 + r) * ld + u * 8);
    }
    *reinterpret_cast<uint2*>(dst + (u >> 1) * kSlab + r * 16 +
                              (u & 1) * 8) = val;
  }
}

// S = Q K^T (int32) for a 64 x 64 tile into rows [16w, 16w+16) of S
__device__ __forceinline__ void score_tile(const int8_t* Qs, const int8_t* Ks,
                                           int* S, int dp) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  AccFrag acc[4];
  zero_acc(acc);
  for (int kb = 0; kb < dp / 16; ++kb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
        a;
    wmma::load_matrix_sync(a, Qs + kb * kSlab + warp * 16 * 16, 16);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major>
          bf;
      wmma::load_matrix_sync(bf, Ks + kb * kSlab + n * 16 * 16, 16);
      wmma::mma_sync(acc[n], a, bf, acc[n]);
    }
  }
  stage_acc(S, acc);
}

}  // namespace s8
