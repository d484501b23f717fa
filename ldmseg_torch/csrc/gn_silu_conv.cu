// K7 on Hopper: one ResnetBlock half, out = conv3x3(silu(gn(x) * scale +
// bias), w) + b, padding 1, on bf16 NCHW x [B, Cin, H, W], w [Cout, Cin, 3,
// 3], fp32 sums, bf16 out [B, Cout, H, W].
//
// Replaces the TPU kernel ldmseg_tpu/ops/pallas/gn_silu_conv.py:_kernel
// (pallas_call in _forward, public fused_gn_silu_conv / gn_silu_conv). Its
// rounding points: the GN + SiLU output y is stored in x's dtype (the TPU
// kernel's pad_ref scratch), zero-padded AFTER the activation (pad_ref is
// zeros: silu(gn(0)) is not 0, so the halo must be a 0 of y, not of x), the
// nine taps are products of bf16 values summed in fp32, and the bias is
// added in fp32 before the cast.
//
// What bounds it on an H100: operations. 2 * B * H * W * 9 * Cin * Cout
// bf16 operations at 989 TFLOP/s against x, w and the output at 3.35 TB/s;
// at the first level of the UNet (B=2, 2048 pixels, Cin=Cout=320) ~7.5
// GFLOP (~7.6 us) against ~5.3 MB (~1.6 us).
//
// Design. The statistics are gn_common.cuh's stats pass. The conv is an
// implicit GEMM: a block owns 4 rows x 16 columns of output pixels (one
// 16-pixel row per warp, one wmma M fragment) and 64 output channels, and
// walks Cin 16 channels at a time. For each 16 channels it stages
//   - the input tile with its one-pixel halo, 6 x 18 pixels x 16 channels,
//     normalized, scaled, shifted and SiLU'd from x and rounded to bf16,
//     with zeros outside the image, laid out [row][column][channel] so that
//     the A fragment of tap (dy, dx) for warp r is the 16 x 16 block at
//     [r + dy][dx][0] with ld 16 (every such block starts on a 32-byte
//     boundary, as wmma asks);
//   - the weights of the 9 taps, [tap][16 channels][64 outputs], read from
//     w's own layout (each output's 16 x 9 values are contiguous);
// and runs 9 taps x 4 bf16 wmma m16n16k16 products per warp into fp32
// accumulators. The epilogue stages the accumulators channel-major, adds the
// bias in fp32 and writes bf16 rows of pixels. No stage overlaps its loads
// with the products: a first design, right before fast.

#include <mma.h>

#include "gn_common.cuh"

namespace {

using namespace nvcuda;
using gn::group_stats;
using gn::gn_silu;

constexpr int kTW = 16;               // output columns of a tile
constexpr int kTH = 4;                // output rows of a tile, one per warp
constexpr int kTN = 64;               // output channels of a tile
constexpr int kKC = 16;               // input channels of one stage
constexpr int kThreads = 32 * kTH;
constexpr int kHaloW = kTW + 2;
constexpr int kHaloH = kTH + 2;
constexpr int kPix = kTH * kTW;
constexpr int kStLd = kPix + 4;       // fp32 staging row (one channel)

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kThreads)
    gn_conv_kernel(const bf16* __restrict__ x, const float2* __restrict__ part,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, const bf16* __restrict__ w,
                   const float* __restrict__ b, bf16* __restrict__ out, int cin,
                   int cout, int h, int wd, int groups, int chunks, float eps,
                   int tiles_x) {
  __shared__ __align__(32) bf16 Hs[kHaloH * kHaloW * kKC];
  __shared__ __align__(32) bf16 Ws[9 * kKC * kTN];
  __shared__ __align__(32) float St[kTN * kStLd];
  __shared__ float s_mean[kKC], s_inv[kKC];

  const int img = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int n0 = blockIdx.y * kTN;
  const int warp = threadIdx.x / 32;
  const int cg = cin / groups;
  const float n = static_cast<float>(cg) * static_cast<float>(h * wd);
  const bf16* ximg = x + static_cast<long long>(img) * cin * h * wd;
  const bool vec_w = cin % kKC == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTN / 16];
#pragma unroll
  for (int f = 0; f < kTN / 16; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int c0 = 0; c0 < cin; c0 += kKC) {
    __syncthreads();  // the previous stage's products are done
    if (threadIdx.x < kKC && c0 + threadIdx.x < cin) {
      group_stats(part, img * groups + (c0 + threadIdx.x) / cg, chunks, n,
                  eps, s_mean[threadIdx.x], s_inv[threadIdx.x]);
    }
    // weights: Ws[tap][ci][co] = w[n0 + co][c0 + ci][tap]
    if (vec_w) {
      constexpr int kRow = kKC * 9 / 8;  // 16-byte words per output
      for (int i = threadIdx.x; i < kTN * kRow; i += kThreads) {
        const int co = i / kRow;
        const int j = (i - co * kRow) * 8;  // first (ci * 9 + tap) of 8
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + co < cout) {
          raw = *reinterpret_cast<const uint4*>(
              w + (static_cast<long long>(n0 + co) * cin + c0) * 9 + j);
        }
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int ci = (j + k) / 9;
          const int tap = j + k - ci * 9;
          Ws[(tap * kKC + ci) * kTN + co] = v[k];
        }
      }
    } else {
      for (int i = threadIdx.x; i < kTN * kKC * 9; i += kThreads) {
        const int co = i / (kKC * 9);
        const int j = i - co * (kKC * 9);
        const int ci = j / 9;
        const int tap = j - ci * 9;
        bf16 v = __float2bfloat16_rn(0.f);
        if (n0 + co < cout && c0 + ci < cin) {
          v = w[(static_cast<long long>(n0 + co) * cin + c0 + ci) * 9 + tap];
        }
        Ws[(tap * kKC + ci) * kTN + co] = v;
      }
    }
    __syncthreads();  // s_mean, s_inv
    // the activation tile with its halo; y = 0 outside the image
    for (int i = threadIdx.x; i < kKC * kHaloH * kHaloW; i += kThreads) {
      const int hx = i % kHaloW;
      const int rest = i / kHaloW;
      const int hy = rest % kHaloH;
      const int ci = rest / kHaloH;
      const int c = c0 + ci;
      const int yy = y0 - 1 + hy;
      const int xx = x0 - 1 + hx;
      float v = 0.f;
      if (c < cin && yy >= 0 && yy < h && xx >= 0 && xx < wd) {
        v = gn_silu(__bfloat162float(
                        ximg[(static_cast<long long>(c) * h + yy) * wd + xx]),
                    s_mean[ci], s_inv[ci], scale[c], bias[c]);
      }
      Hs[(hy * kHaloW + hx) * kKC + ci] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Hs + ((warp + dy) * kHaloW + dx) * kKC, kKC);
#pragma unroll
      for (int f = 0; f < kTN / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, Ws + tap * kKC * kTN + f * 16, kTN);
        wmma::mma_sync(acc[f], a, bm, acc[f]);
      }
    }
  }
  // epilogue: St[co][pixel], then bias in fp32 and the bf16 cast
#pragma unroll
  for (int f = 0; f < kTN / 16; ++f) {
    wmma::store_matrix_sync(St + f * 16 * kStLd + warp * 16, acc[f], kStLd,
                            wmma::mem_col_major);
  }
  __syncthreads();
  bf16* oimg = out + static_cast<long long>(img) * cout * h * wd;
  for (int i = threadIdx.x; i < kTN * kPix; i += kThreads) {
    const int co = i / kPix;
    const int p = i - co * kPix;
    const int yy = y0 + p / kTW;
    const int xx = x0 + p % kTW;
    if (n0 + co < cout && yy < h && xx < wd) {
      oimg[(static_cast<long long>(n0 + co) * h + yy) * wd + xx] =
          __float2bfloat16_rn(__fadd_rn(St[co * kStLd + p], b[n0 + co]));
    }
  }
}

}  // namespace

// x bf16 [batch, cin, h, w] and out bf16 [batch, cout, h, w] contiguous; w
// bf16 [cout, cin, 3, 3] contiguous (16-byte aligned when cin % 16 == 0);
// scale, bias fp32 [cin], b fp32 [cout]; part fp32 scratch of 2 * batch *
// groups * chunks words (chunks = ceil(cin / groups * h * w / 4096)). vec =
// 1 takes 16-byte loads in the statistics: it needs cin / groups * h * w % 8
// == 0 and a 16-byte aligned x. Returns a cudaError_t.
extern "C" int ldmseg_gn_silu_conv(const void* x, const float* scale,
                                   const float* bias, const void* w,
                                   const float* b, void* out, float* part,
                                   int batch, int cin, int cout, int h, int wd,
                                   int groups, float eps, int vec,
                                   void* stream) {
  if (batch < 1 || cin < 1 || cout < 1 || h < 1 || wd < 1 || groups < 1 ||
      cin % groups != 0 || batch > 65535 || batch * groups > 65535 ||
      (cout + kTN - 1) / kTN > 65535 ||
      static_cast<long long>(cin / groups) * h * wd > (1ll << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  float2* p2 = reinterpret_cast<float2*>(part);
  const int span = cin / groups * h * wd;
  int err = gn::launch_stats<bf16>(xb, p2, batch * groups, span, nullptr, 0,
                                   vec != 0, s);
  if (err != 0) return err;
  const int tiles_x = (wd + kTW - 1) / kTW;
  const int tiles = tiles_x * ((h + kTH - 1) / kTH);
  const dim3 grid(tiles, (cout + kTN - 1) / kTN, batch);
  gn_conv_kernel<<<grid, kThreads, 0, s>>>(
      xb, p2, scale, bias, static_cast<const bf16*>(w), b,
      static_cast<bf16*>(out), cin, cout, h, wd, groups, gn::num_chunks(span),
      eps, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
