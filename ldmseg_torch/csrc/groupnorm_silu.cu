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
// Per call the data is small (0.16-7.9 MB), so a launch's fixed cost, a
// few microseconds, is of the order of the bytes' time: one launch per call
// for K5 and two for K6 are what the design can reach.
//
// Design. The TPU kernel holds one image's whole (H, W, C) tile in VMEM and
// takes the group sums with a [C, G] one-hot matmul, since Mosaic cannot
// reshape across lanes. In NCHW one (image, group) is one contiguous span
// of C/G * H * W values (1,280 to 61,440 at the UNet's sites, 65,536 at the
// 8 MiB rule's edge), and B * G spans (64 at batch 2) are too few blocks
// for 132 SMs. So each span gets a thread-block cluster of k <= 8 CTAs of
// 256 threads (ops/groupnorm_silu.py:sm90_gn_plan chooses k and the
// elements per CTA; the entry points check the plan):
//   1. each CTA loads its slice of the span once, 16 bytes a thread at a
//      time, into registers (at most 32 values a thread: 8,192 a CTA);
//   2. it folds (sum x, sum x^2) in a fixed order: each thread over its
//      values in load order, the warp by a butterfly, the warps in order;
//   3. through distributed shared memory every CTA reads the k CTAs'
//      partials in rank order, so all of them hold the same sums and the
//      same mean and inv (gn_common.cuh:span_stats);
//   4. K5 applies gn_silu (gn_common.cuh) to the registers and stores: one
//      launch, one read of x, one write, no scratch;
//   4. K6 (launch A) computes the same y and its max |y|; the first CTA of
//      the span stores (mean, inv) and every CTA its max in a scratch, plain
//      stores; launch B, one 16-byte pack a thread and no clusters, takes
//      s[b] from the image's maxima and recomputes y from x (still in L2)
//      with the stored mean and inv through the same device function, so it
//      gets A's bits, then q = rint(y / s) with a true division.
// The scale and bias of a pack that lies in one channel are read with x, so
// that no load waits behind the statistics.
// A span larger than k * 8,192 values (fewer than 32 groups at the 8 MiB
// edge) takes several rounds of registers and reads its slice twice; the
// UNet's spans take one. The sums run in another order than on the TPU;
// nothing else differs.

#include <cooperative_groups.h>

#include "gn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gn;

constexpr int kValues = 32;                 // x values a thread holds
constexpr int kRound = kThreads * kValues;  // elements a CTA holds at once
constexpr int kMaxCluster = 8;              // CTAs of a span (portable)

// ops/groupnorm_silu.py:GNPlan.fields(): 16-byte accesses (1) or scalar
// (0), CTAs per span, elements per CTA, rounds of registers
struct Plan {
  int vec, k, per_cta, rounds;
};

// The arguments of both K6 launches and K5's
template <typename T, typename W>
struct Args {
  const T* x;
  void* out;            // K5: T [B, C, HW]; K6: int8 q
  const W* scale;
  const W* bias;
  float* scratch;       // K6: (mean, inv) [spans], max |y| [spans * k], s [B]
  int span, hw, cg, groups, spans, per_cta, rounds;
  float eps;
};

// The y of one pack of kVec values at element i of span s. A pack that
// lies in one channel (whole: hw % kVec == 0) takes that channel's scale
// and bias, sc and bi, read ahead by the caller; else each value reads its
// own.
template <typename T, typename W, int kVec>
__device__ __forceinline__ void pack_y(const Args<T, W>& a, int s, int i,
                                       const Pack<T, kVec>& p, float mean,
                                       float inv, bool whole, float sc,
                                       float bi, float* y) {
  if (whole) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      y[e] = gn_silu(to_f(p.v[e]), mean, inv, sc, bi);
    }
    return;
  }
  const int c0 = (s % a.groups) * a.cg;
  int cl = i / a.hw;  // channel in the group, then the pixel
  int r = i - cl * a.hw;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    y[e] = gn_silu(to_f(p.v[e]), mean, inv, to_f(a.scale[c0 + cl]),
                   to_f(a.bias[c0 + cl]));
    if (++r == a.hw) {
      r = 0;
      ++cl;
    }
  }
}

// the channel of element i of span s, as an index into scale and bias
template <typename T, typename W>
__device__ __forceinline__ int channel_of(const Args<T, W>& a, int s,
                                          int i) {
  return (s % a.groups) * a.cg + i / a.hw;
}

// K5, and K6's launch A: one cluster of k CTAs per span, grid spans * k.
// A cluster of one CTA takes the block's barrier in place of the
// cluster's.
template <typename T, typename W, int kVec, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    gn_cluster_kernel(const Args<T, W> a) {
  constexpr int kIt = kValues / kVec;
  // the packs' scale and bias are read with x when each pack lies in one
  // channel (16-byte packs: 2 * kIt registers; the scalar path's 32
  // values a thread read theirs as they go)
  constexpr bool kAhead = kVec > 1;
  __shared__ float2 part;             // this CTA's (sum x, sum x^2)
  __shared__ float red[2][kThreads / 32];
  const cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const T* xs = a.x + static_cast<long long>(s) * a.span;
  const int start = rank * a.per_cta;
  const int end = min(start + a.per_cta, a.span);
  const bool whole = kAhead && a.hw % kVec == 0;

  // 1-2. load the slice (and the packs' scale and bias) and fold its sums
  Pack<T, kVec> v[kIt];
  float sc[kAhead ? kIt : 1], bi[kAhead ? kIt : 1];
  float s1 = 0.f, s2 = 0.f;
  for (int rd = 0; rd < a.rounds; ++rd) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = start + rd * kRound + (it * kThreads + threadIdx.x) * kVec;
      if (i < end) {
        v[it] = *reinterpret_cast<const Pack<T, kVec>*>(xs + i);
        if (whole && a.rounds == 1) {
          const int ch = channel_of(a, s, i);
          sc[kAhead ? it : 0] = to_f(a.scale[ch]);
          bi[kAhead ? it : 0] = to_f(a.bias[ch]);
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float f = to_f(v[it].v[e]);
          s1 = __fadd_rn(s1, f);
          s2 = __fadd_rn(s2, __fmul_rn(f, f));
        }
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      t1 = __fadd_rn(t1, red[0][w]);
      t2 = __fadd_rn(t2, red[1][w]);
    }
    part = make_float2(t1, t2);
  }
  // 3. the cluster's sums in rank order
  float t1 = 0.f, t2 = 0.f;
  if (k == 1) {
    __syncthreads();
    t1 = __fadd_rn(t1, part.x);
    t2 = __fadd_rn(t2, part.y);
  } else {
    cluster_arrive();
    cluster_wait();
    float2 p[kMaxCluster];  // every rank's read in flight at once
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < k) p[q] = *cluster.map_shared_rank(&part, q);
    }
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < k) {
        t1 = __fadd_rn(t1, p[q].x);
        t2 = __fadd_rn(t2, p[q].y);
      }
    }
    // done with the other CTAs' `part`; the wait before the exit keeps
    // this CTA's until every CTA of the cluster has read it
    cluster_arrive();
  }
  float mean, inv;
  span_stats(t1, t2, static_cast<float>(a.span), a.eps, mean, inv);

  // 4. apply (and K6's max |y|)
  float amax = 0.f;
  for (int rd = 0; rd < a.rounds; ++rd) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = start + rd * kRound + (it * kThreads + threadIdx.x) * kVec;
      if (i < end) {
        float y[kVec];
        if (a.rounds > 1) {  // held a round at a time: read the slice again
          v[it] = *reinterpret_cast<const Pack<T, kVec>*>(xs + i);
          const int ch = whole ? channel_of(a, s, i) : 0;
          pack_y<T, W, kVec>(a, s, i, v[it], mean, inv, whole,
                             to_f(a.scale[ch]), to_f(a.bias[ch]), y);
        } else {
          pack_y<T, W, kVec>(a, s, i, v[it], mean, inv, whole,
                             sc[kAhead ? it : 0], bi[kAhead ? it : 0], y);
        }
        if constexpr (kQuant) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(y[e]));
        } else {
          Pack<T, kVec> o;
#pragma unroll
          for (int e = 0; e < kVec; ++e) o.v[e] = from_f<T>(y[e]);
          *reinterpret_cast<Pack<T, kVec>*>(
              static_cast<T*>(a.out) + static_cast<long long>(s) * a.span +
              i) = o;
        }
      }
    }
  }
  if constexpr (kQuant) {
    amax = warp_max(amax);
    __syncthreads();  // red was read above
    if (lane == 0) red[0][warp] = amax;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[0][w]);
      a.scratch[2 * a.spans + s * k + rank] = amax;
      if (rank == 0) {
        reinterpret_cast<float2*>(a.scratch)[s] = make_float2(mean, inv);
      }
    }
  }
  if (k > 1) cluster_wait();
}

// K6's launch B: one pack of kVec elements a thread, grid
// (packs of a span / kThreads, spans), no clusters: x's pack and the
// span's (mean, inv) are read with the image's maxima, then s[b] and the
// codes
template <typename T, typename W, int kVec>
__global__ void __launch_bounds__(kThreads)
    gn_quant_kernel(const Args<T, W> a, int k) {
  __shared__ float red[kThreads / 32];
  const int s = blockIdx.y;
  const int b = s / a.groups;
  const int i = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  Pack<T, kVec> p{};
  float sc = 0.f, bi = 0.f;
  const bool whole = kVec > 1 && a.hw % kVec == 0;
  if (i < a.span) {
    p = *reinterpret_cast<const Pack<T, kVec>*>(
        a.x + static_cast<long long>(s) * a.span + i);
    if (whole) {
      const int ch = channel_of(a, s, i);
      sc = to_f(a.scale[ch]);
      bi = to_f(a.bias[ch]);
    }
  }
  const float2 mi = reinterpret_cast<const float2*>(a.scratch)[s];
  const float* maxima = a.scratch + 2 * a.spans + b * a.groups * k;
  float m = 0.f;
  for (int j = threadIdx.x; j < a.groups * k; j += kThreads) {
    m = fmaxf(m, maxima[j]);
  }
  m = block_reduce<true>(m, red);
  const float scale = __fdiv_rn(fmaxf(m, 1e-6f), 127.f);
  if (blockIdx.x == 0 && s % a.groups == 0 && threadIdx.x == 0) {
    a.scratch[2 * a.spans + a.spans * k + b] = scale;
  }
  if (i >= a.span) return;
  float y[kVec];
  pack_y<T, W, kVec>(a, s, i, p, mi.x, mi.y, whole, sc, bi, y);
  Pack<int8_t, kVec> o;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    o.v[e] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(y[e], scale)));
  }
  *reinterpret_cast<Pack<int8_t, kVec>*>(
      static_cast<int8_t*>(a.out) + static_cast<long long>(s) * a.span + i) =
      o;
}

template <typename T, typename W, int kVec, bool kQuant>
int launch(const Args<T, W>& a, int k, cudaStream_t stream) {
  int err = 0;
  if (k == 1) {  // a cluster of one: a plain launch
    gn_cluster_kernel<T, W, kVec, kQuant><<<a.spans, kThreads, 0, stream>>>(
        a);
    err = static_cast<int>(cudaGetLastError());
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.spans * k);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = static_cast<int>(
        cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, W, kVec, kQuant>, a));
  }
  if (err != 0 || !kQuant) return err;
  const dim3 grid((a.span / kVec + kThreads - 1) / kThreads, a.spans);
  gn_quant_kernel<T, W, kVec><<<grid, kThreads, 0, stream>>>(a, k);
  return static_cast<int>(cudaGetLastError());
}

// the plan is what the kernels take: every CTA of a span non-empty and the
// CTAs tiling it, the slices whole vectors, the rounds covering a slice
bool plan_ok(const Plan& p, int span, int vec) {
  const long long per = p.per_cta;
  return p.k >= 1 && p.k <= kMaxCluster && per >= 1 && per % vec == 0 &&
         (p.k - 1) * per < span && p.k * per >= span && p.rounds >= 1 &&
         static_cast<long long>(p.rounds) * kRound >= per &&
         static_cast<long long>(p.rounds - 1) * kRound < per;
}

template <typename T, typename W, bool kQuant>
int dispatch(const void* x, void* out, float* scratch, const void* scale,
             const void* bias, int batch, int c, int hw, int groups,
             float eps, const Plan& p, cudaStream_t stream) {
  const int cg = c / groups;
  const Args<T, W> a{static_cast<const T*>(x), out,
                     static_cast<const W*>(scale),
                     static_cast<const W*>(bias), scratch, cg * hw, hw, cg,
                     groups, batch * groups, p.per_cta, p.rounds, eps};
  constexpr int kV = 16 / sizeof(T);
  if ((p.vec != 0 && p.vec != 1) ||
      !plan_ok(p, a.span, p.vec ? kV : 1) ||
      (p.vec && a.span % kV != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return p.vec ? launch<T, W, kV, kQuant>(a, p.k, stream)
               : launch<T, W, 1, kQuant>(a, p.k, stream);
}

template <bool kQuant>
int run(int dtype, int wdtype, const void* x, void* out, float* scratch,
        const void* scale, const void* bias, int batch, int c, int hw,
        int groups, float eps, const int* plan, void* stream) {
  if (batch < 1 || c < 1 || hw < 1 || groups < 1 || c % groups != 0 ||
      batch * groups > 65535 ||
      static_cast<long long>(c / groups) * hw > (1ll << 30) || dtype < 0 ||
      dtype > 1 || wdtype < 0 || wdtype > 1 || plan == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p{plan[0], plan[1], plan[2], plan[3]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  auto go = [&](auto t, auto w) {
    return dispatch<decltype(t), decltype(w), kQuant>(
        x, out, scratch, scale, bias, batch, c, hw, groups, eps, p, s);
  };
  if (dtype == 0) {
    return wdtype == 0 ? go(float{}, float{}) : go(float{}, bf16{});
  }
  return wdtype == 0 ? go(bf16{}, float{}) : go(bf16{}, bf16{});
}

}  // namespace

// K5. dtype of x and wdtype of scale and bias: 0 = float32, 1 = bfloat16. x
// and out [batch, c, hw] contiguous, out in x's dtype; scale, bias [c].
// plan: the four ints of ops/groupnorm_silu.py:sm90_gn_plan; its 16-byte
// accesses (plan[0] = 1) need c / groups * hw to be a multiple of 16 /
// sizeof(x) and 16-byte aligned x and out. Returns a cudaError_t.
extern "C" int ldmseg_group_norm_silu(int dtype, int wdtype, const void* x,
                                      void* out, const void* scale,
                                      const void* bias, int batch, int c,
                                      int hw, int groups, float eps,
                                      const int* plan, void* stream) {
  return run<false>(dtype, wdtype, x, out, nullptr, scale, bias, batch, c,
                    hw, groups, eps, plan, stream);
}

// K6: the arguments of ldmseg_group_norm_silu with q int8 [batch, c, hw]
// and scratch fp32 of 2 * spans + spans * k + batch words (spans = batch *
// groups, k = plan[1]), whose last batch words receive s; 16-byte accesses
// also need an 8-byte (bf16) or 4-byte (fp32) aligned q.
extern "C" int ldmseg_group_norm_silu_quant(
    int dtype, int wdtype, const void* x, int8_t* q, float* scratch,
    const void* scale, const void* bias, int batch, int c, int hw, int groups,
    float eps, const int* plan, void* stream) {
  return run<true>(dtype, wdtype, x, q, scratch, scale, bias, batch, c, hw,
                   groups, eps, plan, stream);
}
