// K5 and K6 on Hopper: GroupNorm + SiLU of an NCHW tensor, per image,
// K5: out = silu(gn(x) * scale + bias) in x's dtype,
// K6: the same y quantized to int8 with one scale per image,
//     s[b] = max(max |y| over image b, 1e-6) / 127, q = rint(y / s[b]).
//
// K5 replaces the TPU kernel ldmseg_tpu/ops/pallas/groupnorm_silu.py:
// _gn_silu_kernel (pallas_call in _forward, public fused_group_norm_silu /
// group_norm_silu), K6 _gn_silu_quant_kernel (pallas_call in
// group_norm_silu_quant). Both compute y as gn_silu_rows does: the
// variance as E[x^2] - mean^2 in fp32 (gn_common.cuh).
//
// What bounds them on an H100: bytes. K5 reads x and writes the output,
// 2 x 2 bytes per element in bf16; K6 reads x and writes one int8 code, 3
// bytes per element. At the 44 resnet norms of one UNet forward at batch 2
// on a 32x64 latent (~32 M elements) that is ~0.04 ms (K5) and ~0.03 ms
// (K6) at 3.35 TB/s; the operations (an exp per element) are far below.
//
// Design. The TPU kernel holds one image's whole (H, W, C) tile in VMEM and
// takes the group sums with a [C, G] one-hot matmul, since Mosaic cannot
// reshape across lanes. Neither carries over: in NCHW one (image, group) is
// one contiguous span (20,480 to 61,440 elements on the 32x64 latent), and
// B * G blocks (64 at batch 2) would leave most of the 132 SMs idle. So
// every pass cuts each span into chunks of 4,096 elements, one block each:
//   1. stats (gn_common.cuh): partial (sum x, sum x^2) per chunk;
//   2. K5: apply: each block folds its span's partials in a fixed order,
//      then normalizes, scales, shifts and applies the SiLU to its chunk,
//      16-byte loads and stores (8 bf16 or 4 fp32 values a thread);
//   2. K6: ymax: the same y, and the block's max |y| folded into the
//      image's word by an integer atomicMax on the float's bits (|y| >= 0,
//      so the bits order as the floats); pass 1 zeroed the words;
//   3. K6: quant: the same y again (one device function, no FMA
//      contraction: the same bits as in pass 2) and q = rint(y / s) with a
//      true division; the first block of each image writes s.
// The sums run in another order than on the TPU; nothing else differs.

#include "gn_common.cuh"

namespace {

using namespace gn;

// y of one element of span s (image b, group g) from its chunk's values;
// scale and bias in their own dtype W (the UNet's bf16 or fp32 weights, read
// as they are: no cast launched per call)
template <typename T, typename W, int kVec, typename Fn>
__device__ __forceinline__ void for_each_y(const T* __restrict__ x,
                                           const W* __restrict__ scale,
                                           const W* __restrict__ bias,
                                           const float2* __restrict__ part,
                                           int span, int chunks, int hw,
                                           int cg, int groups, float eps,
                                           Fn fn) {
  const int s = blockIdx.y;
  float mean, inv;
  group_stats(part, s, chunks, static_cast<float>(span), eps, mean, inv);
  const int c0 = (s % groups) * cg;
  const long long base = static_cast<long long>(s) * span;
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, span);
  for (int i = start + threadIdx.x * kVec; i < end; i += kThreads * kVec) {
    const Pack<T, kVec> p =
        *reinterpret_cast<const Pack<T, kVec>*>(x + base + i);
    int cl = i / hw;  // channel in the group, then the pixel
    int r = i - cl * hw;
    float y[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      y[k] = gn_silu(to_f(p.v[k]), mean, inv, to_f(scale[c0 + cl]),
                     to_f(bias[c0 + cl]));
      if (++r == hw) {
        r = 0;
        ++cl;
      }
    }
    fn(base + i, y);
  }
}

// ---- K5 pass 2: normalize, affine, SiLU ------------------------------------
template <typename T, typename W, int kVec>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const W* __restrict__ scale,
                    const W* __restrict__ bias,
                    const float2* __restrict__ part, int span, int chunks,
                    int hw, int cg, int groups, float eps) {
  auto store = [&](long long at, const float* y) {
    Pack<T, kVec> o;
#pragma unroll
    for (int k = 0; k < kVec; ++k) o.v[k] = from_f<T>(y[k]);
    *reinterpret_cast<Pack<T, kVec>*>(out + at) = o;
  };
  for_each_y<T, W, kVec>(x, scale, bias, part, span, chunks, hw, cg, groups,
                         eps, store);
}

// ---- K6 pass 2: the per-image max |y| --------------------------------------
template <typename T, typename W, int kVec>
__global__ void __launch_bounds__(kThreads)
    gn_ymax_kernel(const T* __restrict__ x, const W* __restrict__ scale,
                   const W* __restrict__ bias,
                   const float2* __restrict__ part,
                   unsigned* __restrict__ amax, int span, int chunks, int hw,
                   int cg, int groups, float eps) {
  __shared__ float red[kThreads / 32];
  float local = 0.f;
  auto fold = [&](long long, const float* y) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) local = fmaxf(local, fabsf(y[k]));
  };
  for_each_y<T, W, kVec>(x, scale, bias, part, span, chunks, hw, cg, groups,
                         eps, fold);
  local = block_reduce<true>(local, red);
  if (threadIdx.x == 0) {
    atomicMax(amax + blockIdx.y / groups, __float_as_uint(local));
  }
}

// ---- K6 pass 3: quantize with the image's scale ----------------------------
template <typename T, typename W, int kVec>
__global__ void __launch_bounds__(kThreads)
    gn_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ s_out, const W* __restrict__ scale,
                    const W* __restrict__ bias,
                    const float2* __restrict__ part,
                    const unsigned* __restrict__ amax, int span, int chunks,
                    int hw, int cg, int groups, float eps) {
  const int b = blockIdx.y / groups;
  const float s = __fdiv_rn(fmaxf(__uint_as_float(amax[b]), 1e-6f), 127.f);
  if (blockIdx.x == 0 && blockIdx.y % groups == 0 && threadIdx.x == 0) {
    s_out[b] = s;
  }
  auto quantize = [&](long long at, const float* y) {
    Pack<int8_t, kVec> o;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      o.v[k] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(y[k], s)));
    }
    *reinterpret_cast<Pack<int8_t, kVec>*>(q + at) = o;
  };
  for_each_y<T, W, kVec>(x, scale, bias, part, span, chunks, hw, cg, groups,
                         eps, quantize);
}

template <typename T, typename W, int kVec>
int launch(const T* x, void* out, float* s_out, const W* scale,
           const W* bias, float2* part, unsigned* amax, int batch, int c,
           int hw, int groups, float eps, bool quantize, cudaStream_t stream) {
  const int cg = c / groups;
  const int span = cg * hw;
  const int spans = batch * groups;
  const int chunks = num_chunks(span);
  int err = launch_stats<T>(x, part, spans, span, quantize ? amax : nullptr,
                            batch, kVec > 1, stream);
  if (err != 0) return err;
  const dim3 grid(chunks, spans);
  if (!quantize) {
    gn_apply_kernel<T, W, kVec><<<grid, kThreads, 0, stream>>>(
        x, static_cast<T*>(out), scale, bias, part, span, chunks, hw, cg,
        groups, eps);
    return static_cast<int>(cudaGetLastError());
  }
  gn_ymax_kernel<T, W, kVec><<<grid, kThreads, 0, stream>>>(
      x, scale, bias, part, amax, span, chunks, hw, cg, groups, eps);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  gn_quant_kernel<T, W, kVec><<<grid, kThreads, 0, stream>>>(
      x, static_cast<int8_t*>(out), s_out, scale, bias, part, amax, span,
      chunks, hw, cg, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int dispatch(const void* x, void* out, float* s_out, const void* scale,
             const void* bias, float2* part, unsigned* amax, int batch,
             int c, int hw, int groups, float eps, int vec, bool quantize,
             cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const W* sc = static_cast<const W*>(scale);
  const W* bi = static_cast<const W*>(bias);
  if (vec) {
    return launch<T, W, 16 / sizeof(T)>(xt, out, s_out, sc, bi, part, amax,
                                        batch, c, hw, groups, eps, quantize,
                                        stream);
  }
  return launch<T, W, 1>(xt, out, s_out, sc, bi, part, amax, batch, c, hw,
                         groups, eps, quantize, stream);
}

int run(int dtype, int wdtype, const void* x, void* out, float* s_out,
        const void* scale, const void* bias, float2* part, unsigned* amax,
        int batch, int c, int hw, int groups, float eps, int vec,
        bool quantize, void* stream) {
  if (batch < 1 || c < 1 || hw < 1 || groups < 1 || c % groups != 0 ||
      batch * groups > 65535 ||
      static_cast<long long>(c / groups) * hw > (1ll << 30) || dtype < 0 ||
      dtype > 1 || wdtype < 0 || wdtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  auto go = [&](auto t, auto w) {
    return dispatch<decltype(t), decltype(w)>(x, out, s_out, scale, bias,
                                              part, amax, batch, c, hw,
                                              groups, eps, vec, quantize, s);
  };
  if (dtype == 0) {
    return wdtype == 0 ? go(float{}, float{}) : go(float{}, bf16{});
  }
  return wdtype == 0 ? go(bf16{}, float{}) : go(bf16{}, bf16{});
}

}  // namespace

// dtype of x and wdtype of scale and bias: 0 = float32, 1 = bfloat16. x and
// out [batch, c, hw] contiguous, out in x's dtype; scale, bias [c]; part
// fp32 scratch of 2 * batch * groups * chunks words (chunks = ceil(c /
// groups * hw / 4096)). vec = 1 takes 16-byte accesses: it needs c / groups
// * hw to be a multiple of 16 / sizeof(x) and 16-byte aligned x and out.
// Returns a cudaError_t.
extern "C" int ldmseg_group_norm_silu(int dtype, int wdtype, const void* x,
                                      void* out, const void* scale,
                                      const void* bias, float* part,
                                      int batch, int c, int hw, int groups,
                                      float eps, int vec, void* stream) {
  return run(dtype, wdtype, x, out, nullptr, scale, bias,
             reinterpret_cast<float2*>(part), nullptr, batch, c, hw, groups,
             eps, vec, false, stream);
}

// K6: the arguments of ldmseg_group_norm_silu with q int8 [batch, c, hw], s
// fp32 [batch] and amax, a scratch of batch words; vec = 1 also needs an
// 8-byte (bf16) or 4-byte (fp32) aligned q.
extern "C" int ldmseg_group_norm_silu_quant(
    int dtype, int wdtype, const void* x, int8_t* q, float* s,
    const void* scale, const void* bias, float* part, unsigned* amax,
    int batch, int c, int hw, int groups, float eps, int vec, void* stream) {
  return run(dtype, wdtype, x, q, s, scale, bias,
             reinterpret_cast<float2*>(part), amax, batch, c, hw, groups, eps,
             vec, true, stream);
}
