// What K3 and K8 (attention_ln_s8.cu), K4, K9 and K12 (geglu_ln_s8.cu)
// and K13, K11, K15, K10, K17 and K18 (attention_s8.cu) share besides the
// Hopper product: the (LayerNorm +) static-scale int8 quantize of token
// rows. Every product runs on gemm_sm90.cuh, every int8 attention on
// attention_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace s8 {

constexpr int kThreads = 128;  // 4 warps, one token row each

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

}  // namespace s8
