// Pieces shared by K5, K6 (groupnorm_silu.cu) and K7 (gn_silu_conv.cu): the
// GroupNorm + SiLU numerics of the TPU kernels' single definition
// (ldmseg_tpu/ops/pallas/groupnorm_silu.py:gn_silu_rows) on NCHW tensors.
//
// In NCHW the elements of one (image, group) are one contiguous span of
// span = C/G * H * W values; span b * G + g starts at (b * G + g) * span.
// Its statistics, in fp32 (span_stats):
//   mean = sum(x) / n,  var = sum(x^2) / n - mean^2,  inv = 1 / sqrt(var +
//   eps),  n = span;
// then y = ((x - mean) * inv) * scale[c] + bias[c] and silu(y) = y * (1 /
// (1 + exp(-y))). Every step is a separately rounded intrinsic (__fmul_rn,
// __fadd_rn, ...): nvcc may not contract them into an FMA, so two kernels
// that recompute y from x get the same bits (K6's two launches do), and the
// plain PyTorch version, one rounding per operation, gets them too up to
// expf.
//
// K5 and K6 (groupnorm_silu.cu) and K7's activation pass (gn_silu_conv.cu)
// take the sums of a span in one thread-block cluster, folded in a fixed
// order: each thread in load order, the warps in order, the CTAs in rank
// order through distributed shared memory (cluster_arrive, cluster_wait).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace gn {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// kVec consecutive values, loaded and stored as one 16-byte (or narrower)
// access when kVec > 1
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

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

// The sum (kMax false) or max (kMax true) of v over a block of kThreads;
// every thread gets it. `red` holds kThreads / 32 floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    r = kMax ? fmaxf(r, red[w]) : r + red[w];
  }
  return r;
}

// silu(((x - mean) * inv) * scale + bias), one rounding per operation
__device__ __forceinline__ float gn_silu(float x, float mean, float inv,
                                         float scale, float bias) {
  float y = __fmul_rn(__fsub_rn(x, mean), inv);
  y = __fadd_rn(__fmul_rn(y, scale), bias);
  return __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
}

// mean and 1 / sqrt(var + eps) of a span of n values from its sums s1 =
// sum x and s2 = sum x^2
__device__ __forceinline__ void span_stats(float s1, float s2, float n,
                                           float eps, float& mean,
                                           float& inv) {
  mean = __fdiv_rn(s1, n);
  const float var = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace gn
