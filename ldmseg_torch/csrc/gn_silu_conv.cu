// K7 on Hopper: one ResnetBlock half, out = conv3x3(silu(gn(x) * scale +
// bias), w) + b, padding 1, on bf16 NCHW x [B, Cin, H, W], fp32 sums, bf16
// out [B, Cout, H, W].
//
// Replaces the TPU kernel ldmseg_tpu/ops/pallas/gn_silu_conv.py:_kernel
// (pallas_call in _forward, public fused_gn_silu_conv / gn_silu_conv). Its
// rounding points: the GN + SiLU output y is stored in x's dtype (the TPU
// kernel's pad_ref scratch), zero-padded AFTER the activation (pad_ref is
// zeros: silu(gn(0)) is not 0, so the halo must be a 0 of y, not of x), the
// nine taps are products of bf16 values summed in fp32, and the bias is
// added in fp32 before the cast.
//
// What bounds it on an H100: at the first level of the UNet (B = 2, 32x64,
// Cin = Cout = 320) operations, ~7.5 GFLOP (~7.6 us at 989 TFLOP/s)
// against ~5.3 MB (~1.6 us at 3.35 TB/s); at 8x16 and 4x8 (Cout = 1,280,
// Cin up to 2,560) the weights, 29.5-59 MB (9-18 us).
//
// Design: the TPU kernel's own trick, nine shifted matmuls over a padded
// scratch, in three launches at most.
//   a. gn_pad_kernel: y into a zero-padded, channel-last bf16 scratch of
//      `wp` columns a row, [B][H + 2][wp][C8] (C8: Cin rounded up to 8, so
//      that a row is a multiple of 16 bytes; the product's map is Cin wide
//      and reads zeros past Cin): image row r, column c at
//      padded position p = (img (H + 2) + r + 1) wp + c; rows 0 and H + 1
//      of each image and the columns [W, wp) of every row are zeros, which
//      this pass writes itself. One column of zeros between two rows is
//      both the right halo of one and the left halo of the next (p - 1 at
//      c = 0 lands in the previous row's last column), so wp = W + 1
//      rounded up to even: positions pair up as columns do. One thread-
//      block cluster of k <= 8 CTAs per (image, group), as many as hold the
//      span at 8,192 values a CTA (K5's budget; one CTA and no cluster
//      barrier for a small span), each CTA a range of image rows of the
//      group's channels: x read once (16-byte loads
//      when W % 8 == 0) into shared memory, or, where the CTA's slice
//      exceeds 200 KB, twice (the sums, then chunk by chunk), the sums
//      folded in a fixed
//      order (gn_common.cuh, through distributed shared memory), then y =
//      gn_silu of the held values (gn_common.cuh, K5's arithmetic) stored
//      channel-last, pairs of channels at a time (plan:
//      ops/gn_silu_conv.py:sm90_conv_plan, checked here);
//   b. the conv as one implicit GEMM on gemm_sm90.cuh, its operands
//      swapped: A = the weights packed once tap-major and K-major, [Cout,
//      9 C8] (w.permute(0, 2, 3, 1), by the wrapper, cached per weight),
//      W = the scratch seen as [positions, Cin]; rows of the product are
//      output channels, columns padded positions. The reduction runs over
//      (tap, 64-channel block) stages: tap (dy, dx) reads A at columns tap
//      Cin + 64 cb and the scratch at rows p + (dy - 1) wp + (dx - 1), a
//      2-D TMA box at a shifted row coordinate, zeros past either end (and
//      past Cin, so a partial channel block's A columns of the next tap
//      multiply zeros). Interior outputs never read across an image, so a
//      tile may run over padded positions of several images; the epilogue
//      drops the halo positions (9% of the columns at 32x64, up to 47% at
//      4x8). ConvEpi adds b in fp32 and stores bf16 NCHW, a pair of
//      columns two pixels of one row (one 4-byte store when W is even);
//   c. where row tiles x column tiles is under the card's 132 SMs (the
//      deep levels, whose weights bound them), the stages split over
//      `splits` blocks per tile; each writes its fp32 partials to a
//      workspace [splits][Cout][n] and conv_sum_kernel adds them in split
//      order, then b, so that repeats are bit-equal.
// The TPU kernel's per-image grid and VMEM limit are gone; the JAX dispatch
// rule (6 MiB) stays in the wrapper.

#include <cooperative_groups.h>

#include "gemm_sm90.cuh"
#include "gn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using gn::gn_silu;
using gn::kThreads;
using bf16 = __nv_bfloat16;

constexpr int kMaxCluster = 8;
constexpr int kPadValues = 8192;  // x values a CTA of the pass holds
constexpr int kPadSmemLimit = 200 * 1024;  // the activation pass's slice

// ops/gn_silu_conv.py:ConvPlan.fields(): the product's nine plan ints, then
// these
struct TapsPlan {
  int wp, cblocks, splits;    // padded row width, 64-channel blocks, split
  int k, rows_per_cta, vec;   // the activation pass's cluster, rows, loads
  int pad_smem;               // its dynamic shared memory
  int chunk_ch, chunk_pix;    // its chunk (pad_chunk)
};

struct PadArgs {
  const bf16* x;
  const float* scale;
  const float* bias;
  bf16* y;
  int c, c8, h, w, wp, groups, cg, rows_per_cta, chunk_ch, chunk_pix;
  float eps;
};

// the pass's shared-memory chunk (ops/gn_silu_conv.py:pad_chunk): the
// whole slice, cg channels x npix pixels, when it fits; else all cg
// channels and the most pixels, a multiple of 8, that fit; else 64 pixels
// and an even number of channels
void pad_chunk(int cg, int npix, int& ch, int& pix) {
  constexpr long long kVals = kPadSmemLimit / 2;
  if (static_cast<long long>(cg) * (npix + 2) <= kVals) {
    ch = cg;
    pix = npix;
  } else if (static_cast<long long>(cg) * 10 <= kVals) {
    ch = cg;
    pix = (static_cast<int>(kVals) / cg - 2) / 8 * 8;
  } else {
    pix = npix < 64 ? npix : 64;
    ch = static_cast<int>(kVals) / (pix + 2);
    ch -= ch % 2;
  }
}

// ---- a: GN + SiLU into the padded channel-last scratch ---------------------
// grid spans * k, clusters of k: CTA `rank` of span s = img * groups + g
// takes image rows [rank r, rank r + r) (r = rows_per_cta) of the group's
// cg channels, npix = r w pixels a channel. When that slice fits the plan's
// chunk it is held whole in shared memory, [channel][pixel], ld = npix + 2
// (odd in words: the y loop's reads across channels fall in distinct
// banks), and x is read once. Otherwise x is read twice: once for the sums
// (straight from global memory, in the same order), then chunk by chunk,
// chunk_ch channels x chunk_pix pixels, into shared memory to be
// normalised and stored. The scratch's rows are c8 (Cin rounded up to 8)
// channels apart; the channels [Cin, c8) are never written: the product's
// tensor map is Cin wide and reads zeros there.
template <int kVec>
__global__ void __launch_bounds__(kThreads) gn_pad_kernel(const PadArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  __shared__ float2 part;
  __shared__ float red[2][kThreads / 32];
  using P = gn::Pack<bf16, kVec>;
  const cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / k;
  const int img = s / a.groups;
  const int c0 = (s - img * a.groups) * a.cg;
  const int r0 = rank * a.rows_per_cta;
  const int r1 = min(a.h, r0 + a.rows_per_cta);
  const int npix = (r1 - r0) * a.w;
  const bool whole = a.chunk_ch == a.cg && a.chunk_pix >= npix;
  const long long hw = static_cast<long long>(a.h) * a.w;
  // channel cl of the group, pixel 0 of this CTA's rows
  const bf16* xg = a.x + (static_cast<long long>(img) * a.c + c0) * hw +
                   static_cast<long long>(r0) * a.w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;

  // 1. the sums over the slice, per channel a contiguous run of npix
  // values, in load order; held on the way when the slice fits
  const int per_ch = npix / kVec;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < a.cg * per_ch; i += kThreads) {
    const int cl = i / per_ch;
    const int pv = (i - cl * per_ch) * kVec;
    const P p = *reinterpret_cast<const P*>(xg + cl * hw + pv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float f = __bfloat162float(p.v[e]);
      s1 = __fadd_rn(s1, f);
      s2 = __fadd_rn(s2, __fmul_rn(f, f));
      if (whole) xs[cl * (npix + 2) + pv + e] = p.v[e];
    }
  }
  // 2. the span's sums: the warps in order, then the cluster's CTAs
  s1 = gn::warp_sum(s1);
  s2 = gn::warp_sum(s2);
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
  float t1 = 0.f, t2 = 0.f;
  if (k == 1) {
    __syncthreads();
    t1 = __fadd_rn(t1, part.x);
    t2 = __fadd_rn(t2, part.y);
  } else {
    gn::cluster_arrive();
    gn::cluster_wait();
    float2 p[kMaxCluster];
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
    gn::cluster_arrive();
  }
  float mean, inv;
  gn::span_stats(t1, t2, static_cast<float>(a.cg * a.h * a.w), a.eps, mean,
                 inv);

  // 3. y channel-last, chunk by chunk (one chunk when the slice is held),
  // two channels a store where the group's and the chunk's counts are even
  bf16* yimg = a.y + static_cast<long long>(img) * (a.h + 2) * a.wp * a.c8;
  for (int ch0 = 0; ch0 < a.cg; ch0 += a.chunk_ch) {
    const int nch = min(a.chunk_ch, a.cg - ch0);
    for (int p0 = 0; p0 < npix; p0 += a.chunk_pix) {
      const int np = whole ? npix : min(a.chunk_pix, npix - p0);
      const int ld = np + 2;
      if (!whole) {
        __syncthreads();  // the previous chunk's reads are done
        const int per = np / kVec;
        for (int i = threadIdx.x; i < nch * per; i += kThreads) {
          const int cl = i / per;
          const int pv = (i - cl * per) * kVec;
          const P p = *reinterpret_cast<const P*>(xg + (ch0 + cl) * hw +
                                                  p0 + pv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) xs[cl * ld + pv + e] = p.v[e];
        }
        __syncthreads();
      }
      const int per_unit = a.cg % 2 == 0 && nch % 2 == 0 ? 2 : 1;
      const int units = nch / per_unit;  // stores a pixel
      for (int i = threadIdx.x; i < np * units; i += kThreads) {
        const int pix = i / units;
        const int j = (i - pix * units) * per_unit;
        const int q = p0 + pix;  // pixel of the slice
        const int rr = r0 + q / a.w;
        const int cc = q - (rr - r0) * a.w;
        const int ch = c0 + ch0 + j;
        bf16* dst =
            yimg + (static_cast<long long>(rr + 1) * a.wp + cc) * a.c8 + ch;
        const float y0 = gn_silu(__bfloat162float(xs[j * ld + pix]), mean,
                                 inv, a.scale[ch], a.bias[ch]);
        if (per_unit == 2) {
          const float y1 =
              gn_silu(__bfloat162float(xs[(j + 1) * ld + pix]), mean, inv,
                      a.scale[ch + 1], a.bias[ch + 1]);
          *reinterpret_cast<uint32_t*>(dst) = sm90::pack_bf16(y0, y1);
        } else {
          *dst = __float2bfloat16_rn(y0);
        }
      }
    }
  }
  // 4. the halo's zeros in the group's channels: the columns [w, wp) of
  // this CTA's rows, row 0 (rank 0) and row h + 1 (the last rank)
  const int per_unit = a.cg % 2 == 0 ? 2 : 1;
  const int units = a.cg / per_unit;
  const int right = a.wp - a.w;
  const int side = (r1 - r0) * right;
  const int top = rank == 0 ? a.wp : 0;
  const int bottom = rank == k - 1 ? a.wp : 0;
  for (int i = threadIdx.x; i < (side + top + bottom) * units;
       i += kThreads) {
    const int q = i / units;
    const int j = (i - q * units) * per_unit;
    int prow, col;
    if (q < side) {
      prow = r0 + 1 + q / right;
      col = a.w + q % right;
    } else if (q < side + top) {
      prow = 0;
      col = q - side;
    } else {
      prow = a.h + 1;
      col = q - side - top;
    }
    bf16* dst = yimg + (static_cast<long long>(prow) * a.wp + col) * a.c8 +
                c0 + j;
    if (per_unit == 2) {
      *reinterpret_cast<uint32_t*>(dst) = 0u;
    } else {
      *dst = __float2bfloat16_rn(0.f);
    }
  }
  if (k > 1) gn::cluster_wait();
}

// ---- b: the product's taps and epilogue ------------------------------------
// rows: output channels; columns: padded positions of [B][h + 2][wp]
struct ConvEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 0;
  static constexpr int kIntCols = 0;
  static constexpr bool kTaps = true;
  using RowPre = float;  // b of the row
  using Pre = gemm90::NoPre;
  const float* bias;
  bf16* out;      // [batch][cout][h][w], splits == 1
  float* part;    // [splits][cout][n], splits > 1
  int batch, cout, h, w, wp, n, c8, cblocks, splits;
  // stage kt: tap t = kt / cblocks (dy = t / 3, dx = t % 3), channel block
  // cb; A (the weights, c8 columns a tap) at column t c8 + 64 cb, W (the
  // scratch) at column 64 cb and the row shift of the tap
  __device__ void tap(int kt, int& ak, int& wk, int& shift) const {
    const int t = kt / cblocks;
    const int cb = kt - t * cblocks;
    ak = t * c8 + 64 * cb;
    wk = 64 * cb;
    shift = (t / 3 - 1) * wp + (t % 3 - 1);
  }
  __device__ float col_value(int, int) const { return 0.f; }
  __device__ RowPre row_pre(int row) const { return __ldg(bias + row); }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int row, int col, const float2*, const int2*,
                             const RowPre& b, const Pre&, float s0,
                             float s1) const {
    if (splits > 1) {
      *reinterpret_cast<float2*>(
          part + (static_cast<long long>(blockIdx.z) * cout + row) * n +
          col) = make_float2(s0, s1);
      return;
    }
    const int per_img = (h + 2) * wp;
    const int img = col / per_img;
    const int rem = col - img * per_img;
    const int prow = rem / wp;
    const int cc = rem - prow * wp;  // even: wp and col are
    if (img >= batch || prow < 1 || prow > h || cc >= w) return;
    bf16* o = out + ((static_cast<long long>(img) * cout + row) * h +
                     (prow - 1)) * w + cc;
    const float v0 = __fadd_rn(s0, b), v1 = __fadd_rn(s1, b);
    if (w % 2 == 0) {
      *reinterpret_cast<uint32_t*>(o) = sm90::pack_bf16(v0, v1);
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (cc + 1 < w) o[1] = __float2bfloat16_rn(v1);
    }
  }
};

// ---- c: the split's partials summed in split order, then b -----------------
__global__ void __launch_bounds__(kThreads)
    conv_sum_kernel(const float* __restrict__ part,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    int cout, int h, int w, int wp, int n, int splits,
                    long long total) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= total) return;
  const int cc = static_cast<int>(i % w);
  long long r = i / w;
  const int rr = static_cast<int>(r % h);
  r /= h;
  const int co = static_cast<int>(r % cout);
  const int img = static_cast<int>(r / cout);
  const long long p =
      (static_cast<long long>(img) * (h + 2) + rr + 1) * wp + cc;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) {
    s = __fadd_rn(s, part[(static_cast<long long>(z) * cout + co) * n + p]);
  }
  out[i] = __float2bfloat16_rn(__fadd_rn(s, __ldg(bias + co)));
}

template <int kVec>
int launch_pad(const PadArgs& a, int spans, int k, int smem,
               cudaStream_t stream) {
  auto kernel = gn_pad_kernel<kVec>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPadSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = k;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(spans * k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

// the plan's geometry is the shape's (ops/gn_silu_conv.py:sm90_conv_plan)
bool taps_ok(const TapsPlan& t, int batch, int cin, int cout, int h, int w,
             int groups, bool aligned) {
  const int cg_ = cin / groups;
  // as many CTAs as hold the span at kPadValues each, at most kMaxCluster
  const long long span = static_cast<long long>(cg_) * h * w;
  const long long need = (span + kPadValues - 1) / kPadValues;  // >= 1
  const int ctas = static_cast<int>(need < kMaxCluster ? need : kMaxCluster);
  int ch = 0, pix = 0;
  if (t.rows_per_cta >= 1) pad_chunk(cg_, t.rows_per_cta * w, ch, pix);
  return t.wp == w + 1 + (w + 1) % 2 && t.cblocks == (cin + 63) / 64 &&
         t.rows_per_cta >= 1 && t.k >= 1 && t.k <= kMaxCluster &&
         t.k == (h + t.rows_per_cta - 1) / t.rows_per_cta &&
         t.rows_per_cta == (h + ctas - 1) / ctas &&
         (t.vec == 1 || (t.vec == 8 && w % 8 == 0 && aligned)) &&
         t.chunk_ch == ch && t.chunk_pix == pix &&
         t.pad_smem == t.chunk_ch * (t.chunk_pix + 2) * 2 &&
         t.pad_smem <= kPadSmemLimit && batch * groups * t.k <= 65535 * 8 &&
         cout >= 1;
}

}  // namespace

// x bf16 [batch, cin, h, w] and out bf16 [batch, cout, h, w] contiguous;
// c8 = cin rounded up to 8 (a scratch row and a weight row are then
// multiples of 16 bytes, as a tensor map's stride must be); wpack bf16
// [cout, 9 c8] (w.permute(0, 2, 3, 1), zeros in the channels [cin, c8) of
// each tap); scale, bias fp32 [cin], b fp32 [cout]; ypad bf16 scratch
// [batch (h + 2) wp, c8]; part fp32 scratch of splits * cout * n words when
// splits > 1; all 16-byte aligned. plan: ops/gn_silu_conv.py:
// ConvPlan.fields(), the product's nine ints (sm90_gemm_plan of [cout, n,
// 576 cblocks] bf16, n the positions rounded up to 8) and TapsPlan's nine,
// checked. Returns a cudaError_t.
extern "C" int ldmseg_gn_silu_conv(const void* x, const float* scale,
                                   const float* bias, const void* wpack,
                                   const float* b, void* out, void* ypad,
                                   float* part, int batch, int cin, int cout,
                                   int h, int wd, int groups, float eps,
                                   const int* plan, void* stream) {
  if (plan == nullptr || batch < 1 || cin < 1 || cout < 1 || h < 1 ||
      wd < 1 || groups < 1 || cin % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int c8 = (cin + 7) / 8 * 8;
  const int* tp = plan + gemm90::kPlanInts;
  const TapsPlan t{tp[0], tp[1], tp[2], tp[3], tp[4],
                   tp[5], tp[6], tp[7], tp[8]};
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long positions = static_cast<long long>(batch) * (h + 2) * t.wp;
  const long long n = (positions + 7) / 8 * 8;
  if (!taps_ok(t, batch, cin, cout, h, wd, groups, aligned) ||
      plan[5] != 9 * t.cblocks ||
      n > (1ll << 30) || (t.splits > 1 && part == nullptr) ||
      reinterpret_cast<uintptr_t>(ypad) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int current = sm90::make_current(x);
  if (current != 0) return current;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PadArgs a{static_cast<const bf16*>(x), scale, bias,
                  static_cast<bf16*>(ypad), cin, c8, h, wd, t.wp, groups,
                  cin / groups, t.rows_per_cta, t.chunk_ch, t.chunk_pix,
                  eps};
  int err = t.vec == 8
                ? launch_pad<8>(a, batch * groups, t.k, t.pad_smem, s)
                : launch_pad<1>(a, batch * groups, t.k, t.pad_smem, s);
  if (err != 0) return err;
  const ConvEpi epi{b, static_cast<bf16*>(out), part, batch, cout, h, wd,
                    t.wp, static_cast<int>(n), c8, t.cblocks, t.splits};
  // the scratch's map is cin wide with rows c8 apart: zeros past cin
  err = gemm90::launch_gemm_taps(plan, wpack, ypad, cout, 9 * c8,
                                 static_cast<int>(n),
                                 static_cast<int>(positions), cin, c8,
                                 t.splits, epi, s);
  if (err != 0 || t.splits == 1) return err;
  const long long total = static_cast<long long>(batch) * cout * h * wd;
  conv_sum_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                    kThreads, 0, s>>>(part, b, static_cast<bf16*>(out), cout,
                                      h, wd, t.wp, static_cast<int>(n),
                                      t.splits, total);
  return static_cast<int>(cudaGetLastError());
}
