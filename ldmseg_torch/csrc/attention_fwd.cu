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
// bf16 design (attention_fwd_kernel_sm90):
//   * one block per (b*h, query tile): 128 query rows as two consumer
//     warpgroups of 64 rows, plus a producer warpgroup whose one thread
//     issues the copies (setmaxnreg gives the consumers 240 registers); or,
//     where ceil(T / 128) * B*H would leave SMs idle, one consumer warpgroup
//     of 64 rows. The launch plan (tile sizes, ring depth, box widths, shared
//     memory, grid) is chosen by ops/attention.py:sm90_launch_plan and checked
//     here.
//   * copies are TMA tile loads through 4-D tensor maps over (D, H, T, B)
//     built from the caller's element strides, so K1's [B, T, H, D], K14's
//     head view of [B, T, C] and K16's q, k, v buffers are read in place.
//     A box is 64 columns (one 128-byte swizzle row); D is covered by 1-3
//     boxes and TMA writes zeros past D and past T. Q loads once per block;
//     K (pass 1), then K and V (pass 2), stream through a ring of 2-4 stages
//     with full/empty mbarriers.
//   * S = Q K^T is wgmma m64nNk16 (N = the key tile, 128, or 64 at D > 80)
//     from shared memory; O += P V is wgmma with P from registers (the fp32
//     fragment of S converted pairwise to bf16 is the A fragment) and V
//     MN-major in shared memory, N = D rounded up to a compiled class
//     (16, 32, 40, 64, 80, 128, 160; V's zero columns give zero outputs).
//     Each consumer issues its products one step ahead (Consumer below),
//     so its exponentials overlap the tensor cores' work.
//   * the scale is folded with log2(e) into c; pass 1 keeps each row's
//     running max and sum in registers (a row's 4 threads share the max);
//     pass 2 computes p = 2^(s c - m) * (1 / l), one reciprocal per row.
//     Exponentials are ex2.approx.ftz.f32: about 2 ulp of fp32 (PTX ISA),
//     far below the bf16 rounding of p (2^-9). Keys past T are masked in the
//     last tile of both passes (their zero-filled rows would score 0, not
//     -inf). O is rounded to bf16 once, rows < T and columns < D stored.
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

#include "s8_common.cuh"  // bf16_gemm_kernel (K16's projections)
#include "sm90.cuh"

namespace {

constexpr int kMaxD = 160;  // largest head dim taken

struct Strides {
  long long b, t, h;  // element strides of the B, T and H axes (D is 1)
};

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
constexpr int kBox = 64;          // columns of a TMA box: one swizzled row
constexpr int kRowBytes = 128;    // bytes of a box row
constexpr int kSmemLimit = 232448;
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

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

constexpr int kClasses[] = {16, 32, 40, 64, 80, 128, 160};

int head_class(int d) {
  for (int c : kClasses) {
    if (c >= d) return c;
  }
  return 0;
}

// 1,024 bytes of slack to align the swizzled tiles, Q, the ring, and one
// q barrier plus a full and an empty barrier per stage
int plan_smem(int block_q, int block_k, int chunks, int stages) {
  return 1024 + block_q * chunks * kRowBytes +
         stages * 2 * block_k * chunks * kRowBytes + 8 * (1 + 2 * stages);
}

bool plan_ok(const Plan& p, int bh, int t, int d) {
  const int chunks = (p.head_class + kBox - 1) / kBox;
  return p.head_class == head_class(d) &&
         (p.block_q == 64 || p.block_q == 128) &&
         p.block_k == (p.head_class <= 80 ? 128 : 64) && p.box_d == kBox &&
         p.chunks == chunks && p.stages >= 2 && p.stages <= 8 &&
         p.smem_bytes == plan_smem(p.block_q, p.block_k, chunks, p.stages) &&
         p.smem_bytes <= kSmemLimit &&
         p.grid_x == (t + p.block_q - 1) / p.block_q && p.grid_y == bh &&
         bh >= 1 && bh <= 65535;
}

template <int kDN, int kWG>
struct Cfg {
  static constexpr int kChunks = (kDN + kBox - 1) / kBox;
  static constexpr int kBQ = 64 * kWG;
  static constexpr int kBK = kDN <= 80 ? 128 : 64;  // registers
  static constexpr int kSteps = (kDN + 15) / 16;  // k16 steps of Q K^T
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQSub = 64 * kChunks * kRowBytes;   // a warpgroup's Q
  static constexpr int kTile = kBK * kChunks * kRowBytes;  // a K or V tile
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One consumer warpgroup: 64 query rows of a block against every key tile,
// twice; the ring's tiles come in that order, each waited for and released
// once. Products are issued one step ahead, and every loop starts and ends
// in the same state of products in flight, so the compiler can follow which
// registers each product owns: in pass 1 the tensor cores compute tile
// kt + 1's scores while this warpgroup reduces tile kt's; in pass 2 they
// compute tile kt's P V while the exponentials of tile kt + 1 run (its
// scores issued just before).
template <class C>
struct Consumer {
  static constexpr int kS = C::kBK / 2;  // score registers per thread
  static constexpr int kWG = C::kBQ / 64;
  uint32_t q_sub, kv_smem, full_bar, empty_bar;
  int t, ntiles, stages, lane, wg;
  float c;  // scale * log2(e)
  sm90::Slot load, done;  // the next tile to wait for, and to release

  // With two consumer warpgroups their products are issued in turns (named
  // barriers 1 and 2): one warpgroup's products run on the tensor cores
  // while the other's exponentials run on the SFU. Each issues the same
  // number of sections, warpgroup 0 first.
  __device__ void my_turn() const {
    if constexpr (kWG == 2) sm90::bar_sync(1 + wg, 256);
  }
  __device__ void your_turn() const {
    if constexpr (kWG == 2) sm90::bar_arrive(2 - wg, 256);
  }

  __device__ uint32_t k_tile(const sm90::Slot& slot) const {
    return kv_smem + 2 * slot.stage * C::kTile;
  }

  // S = Q K^T (unscaled) of the next tile of the ring, issued, not waited
  // for
  __device__ void issue_scores(float (&s)[kS]) {
    sm90::mbar_wait(full_bar + 8 * load.stage, load.phase);
    const uint32_t k = k_tile(load);
    load.next(stages);
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      const uint32_t along = (kk % 4) * 32;  // 16 bf16 along a swizzled row
      const uint32_t chunk = kk / 4;
      sm90::WgmmaSs<C::kBK>::ss(
          s,
          sm90::desc_sw128(q_sub + chunk * 64 * kRowBytes + along, 16, 1024),
          sm90::desc_sw128(k + chunk * C::kBK * kRowBytes + along, 16, 1024),
          kk > 0);
    }
    sm90::wgmma_commit();
  }

  // wait until at most kPending product groups are in flight; s is ready
  template <int kPending>
  __device__ void wait(float (&s)[kS]) const {
    sm90::wgmma_wait<kPending>();
    sm90::fence_regs(s);
  }

  // the oldest tile held is read: its stage goes back to the producer
  __device__ void release() {
    if (lane == 0) sm90::mbar_arrive(empty_bar + 8 * done.stage);
    done.next(stages);
  }

  // keys >= t of key tile kt (zero-filled rows, scored 0) set to `value`;
  // only the last tile can hold them
  __device__ void mask(float (&s)[kS], int kt, float value) const {
    const int key0 = kt * C::kBK + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kS / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + 8 * j + (e & 1) >= t) s[4 * j + e] = value;
      }
    }
  }

  // pass 1 on key tile kt: update the running max m (log2 units) and this
  // thread's share of the sum l of 2^(s c - m), for its two rows. With c > 0
  // the max of s c is c times the max of s, and 2^(s c - m) is one FMA and
  // one exponential per score; c <= 0 (no caller's) scales first.
  __device__ void stats(float (&s)[kS], int kt, float (&m)[2],
                        float (&l)[2]) const {
    const bool ragged = (kt + 1) * C::kBK > t;
    const bool positive = c > 0.f;
    if (!positive) {
#pragma unroll
      for (int i = 0; i < kS; ++i) s[i] *= c;
    }
    if (ragged) mask(s, kt, -INFINITY);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kS; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    const float cs = positive ? c : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every tile holds a key < t, so the new max is finite
      const float mn = fmaxf(m[r], quad_max(mx[r]) * cs);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kS / 4; ++j) {
        sum += ex2(fmaf(s[4 * j + 2 * r], cs, -mn)) +
               ex2(fmaf(s[4 * j + 2 * r + 1], cs, -mn));
      }
      l[r] = l[r] * ex2(m[r] - mn) + sum;
      m[r] = mn;
    }
  }

  // pass 2 on key tile kt, in place: p = 2^(s c - m) * (1 / l) in fp32,
  // keys >= t masked to 0
  __device__ void probs(float (&s)[kS], int kt, const float (&m)[2],
                        const float (&r)[2]) const {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = (i / 2) % 2;
      s[i] = ex2(fmaf(s[i], c, -m[row])) * r[row];
    }
    if ((kt + 1) * C::kBK > t) mask(s, kt, 0.f);
  }

  // P rounded to bf16 (K1's rounding point). Keys 16kk..16kk+15 are the
  // score column blocks 2kk and 2kk+1: their bf16 pairs p[4kk..4kk+3] are
  // the A fragment of that k16 step of P V.
  __device__ void round(const float (&s)[kS], uint32_t (&p)[kS / 2]) const {
#pragma unroll
    for (int j = 0; j < kS / 4; ++j) {
      p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  }

  // O += P V of the oldest tile held, issued
  template <int kDN>
  __device__ void issue_pv(uint32_t (&p)[kS / 2],
                           float (&acc)[kDN / 2]) const {
    const uint32_t v = k_tile(done) + C::kTile;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk) {
      sm90::WgmmaRs<kDN>::rs(
          acc, &p[4 * kk],
          sm90::desc_sw128(v + kk * 16 * kRowBytes, C::kBK * kRowBytes, 1024),
          1);
    }
    sm90::wgmma_commit();
  }

  // the oldest tile's P V done: its operands and its stage are free
  template <int kDN>
  __device__ void finish_pv(uint32_t (&p)[kS / 2], float (&acc)[kDN / 2]) {
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(p);
    release();
  }
};

// Shared memory, from a 1,024-byte aligned base: Q (one 64-row sub-tile per
// consumer warpgroup, each `chunks` boxes of 64 x 64), then per stage a K
// tile and a V tile (`chunks` boxes of block_k x 64 each), then the
// barriers: q, full[stages], empty[stages].
template <int kDN, int kWG>
__global__ void __launch_bounds__(Cfg<kDN, kWG>::kThreads, 1)
    attention_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ o, Strides so,
                              int heads, int t, int d, int stages, float c) {
  using C = Cfg<kDN, kWG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_smem = q_smem + kWG * C::kQSub;
  const uint32_t q_bar = kv_smem + 2 * stages * C::kTile;
  const uint32_t full_bar = q_bar + 8;            // + 8 s
  const uint32_t empty_bar = full_bar + 8 * stages;  // + 8 s

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * C::kBQ;
  const int ntiles = (t + C::kBK - 1) / C::kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, 4 * kWG);  // one arrival per warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it is uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kWG) {
    // producer warpgroup: one thread issues every copy
    if constexpr (kWG == 2) sm90::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kWG) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tk);
      sm90::tma_prefetch_map(&tv);
      sm90::mbar_expect_tx(q_bar, kWG * C::kQSub);
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          sm90::tma_load_4d(q_smem + w * C::kQSub + ch * 64 * kRowBytes, &tq,
                            q_bar, ch * kBox, h, q0 + 64 * w, b);
        }
      }
      sm90::Slot slot;  // the ring across both passes
      for (int pass = 0; pass < 2; ++pass) {
        for (int kt = 0; kt < ntiles; ++kt, slot.next(stages)) {
          const uint32_t s = slot.stage;
          const uint32_t k_tile = kv_smem + 2 * s * C::kTile;
          sm90::mbar_wait(empty_bar + 8 * s, slot.phase ^ 1);
          sm90::mbar_expect_tx(full_bar + 8 * s, (pass + 1) * C::kTile);
#pragma unroll
          for (int ch = 0; ch < C::kChunks; ++ch) {
            sm90::tma_load_4d(k_tile + ch * C::kBK * kRowBytes, &tk,
                              full_bar + 8 * s, ch * kBox, h, kt * C::kBK, b);
          }
          if (pass == 1) {
#pragma unroll
            for (int ch = 0; ch < C::kChunks; ++ch) {
              sm90::tma_load_4d(k_tile + C::kTile + ch * C::kBK * kRowBytes,
                                &tv, full_bar + 8 * s, ch * kBox, h,
                                kt * C::kBK, b);
            }
          }
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64)
    if constexpr (kWG == 2) sm90::regs_alloc<kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    const int row = q0 + 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);  // this thread's first column of each 8
    Consumer<C> cons{q_smem + wg * C::kQSub, kv_smem, full_bar, empty_bar,
                     t, ntiles, stages, lane, wg, c};
    if (wg == 1) cons.your_turn();  // warpgroup 0 issues first
    // two score buffers: tile kt's in one while kt + 1's is computed
    float sa[C::kBK / 2], sb[C::kBK / 2];
    // rows `row` and `row + 8`: running max (log2 units) and this thread's
    // share of the sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    sm90::mbar_wait(q_bar, 0);

    // pass 1: row max and row sum of 2^(s c - max); tile kt's scores in
    // sa (kt even) or sb (kt odd)
    cons.my_turn();
    cons.issue_scores(sa);
    cons.your_turn();
    int kt = 0;
    for (; kt + 2 < ntiles; kt += 2) {
      cons.my_turn();
      cons.issue_scores(sb);
      cons.your_turn();
      cons.template wait<1>(sa);
      cons.release();
      cons.stats(sa, kt, m, l);
      cons.my_turn();
      cons.issue_scores(sa);
      cons.your_turn();
      cons.template wait<1>(sb);
      cons.release();
      cons.stats(sb, kt + 1, m, l);
    }
    if (kt + 1 < ntiles) {
      cons.my_turn();
      cons.issue_scores(sb);
      cons.your_turn();
      cons.template wait<1>(sa);
      cons.release();
      cons.stats(sa, kt, m, l);
      cons.template wait<0>(sb);
      cons.release();
      cons.stats(sb, kt + 1, m, l);
    } else {
      cons.template wait<0>(sa);
      cons.release();
      cons.stats(sa, kt, m, l);
    }
    const float r[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};

    // pass 2: P rounded to bf16 after the division, O += P V in fp32; sa
    // holds tile kt's scores, then its probabilities
    float acc[kDN / 2];
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) acc[i] = 0.f;
    uint32_t p[C::kBK / 4];
    cons.my_turn();
    cons.issue_scores(sa);
    cons.your_turn();
    cons.template wait<0>(sa);
    cons.probs(sa, 0, m, r);
    for (kt = 0; kt + 1 < ntiles; ++kt) {
      cons.round(sa, p);
      cons.my_turn();
      cons.issue_scores(sa);
      cons.template issue_pv<kDN>(p, acc);
      cons.your_turn();
      cons.template wait<1>(sa);  // the scores, issued first; P V in flight
      cons.probs(sa, kt + 1, m, r);
      cons.template finish_pv<kDN>(p, acc);
    }
    cons.round(sa, p);
    cons.my_turn();
    cons.template issue_pv<kDN>(p, acc);
    cons.your_turn();
    cons.template finish_pv<kDN>(p, acc);
    if (wg == 0) cons.my_turn();  // takes warpgroup 1's last turn

    // O rounded to bf16 once; rows < t, columns < d
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int j = 0; j < kDN / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < d) {
        if (row < t) {
          *reinterpret_cast<uint32_t*>(ob + row * so.t + col) =
              pack_bf16(acc[4 * j], acc[4 * j + 1]);
        }
        if (row + 8 < t) {
          *reinterpret_cast<uint32_t*>(ob + (row + 8) * so.t + col) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

template <int kDN, int kWG>
int launch_sm90_as(const Plan& p, const CUtensorMap* maps, void* o,
                   const Strides& so, int heads, int t, int d, float c,
                   cudaStream_t stream) {
  auto kernel = attention_fwd_kernel_sm90<kDN, kWG>;
  // once per instantiation: any plan's shared memory is within the limit
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(p.grid_x, p.grid_y), Cfg<kDN, kWG>::kThreads, p.smem_bytes,
           stream>>>(maps[0], maps[1], maps[2],
                     static_cast<__nv_bfloat16*>(o), so, heads, t, d,
                     p.stages, c);
  return static_cast<int>(cudaGetLastError());
}

template <int kWG>
int launch_sm90_wg(const Plan& p, const CUtensorMap* maps, void* o,
                   const Strides& so, int heads, int t, int d, float c,
                   cudaStream_t stream) {
  switch (p.head_class) {
    case 16: return launch_sm90_as<16, kWG>(p, maps, o, so, heads, t, d, c, stream);
    case 32: return launch_sm90_as<32, kWG>(p, maps, o, so, heads, t, d, c, stream);
    case 40: return launch_sm90_as<40, kWG>(p, maps, o, so, heads, t, d, c, stream);
    case 64: return launch_sm90_as<64, kWG>(p, maps, o, so, heads, t, d, c, stream);
    case 80: return launch_sm90_as<80, kWG>(p, maps, o, so, heads, t, d, c, stream);
    case 128: return launch_sm90_as<128, kWG>(p, maps, o, so, heads, t, d, c, stream);
    case 160: return launch_sm90_as<160, kWG>(p, maps, o, so, heads, t, d, c, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int batch, int t, int heads, int d, const long long* st,
                float scale, const int* plan, cudaStream_t stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[5], plan[6], plan[7], plan[8]};
  if (!plan_ok(p, batch * heads, t, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int current = sm90::make_current(q);
  if (current != 0) return current;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = sm90::encode_map(&maps[i], src[i], batch, t, heads,
                                     d, st + 3 * i, i == 0 ? 64 : p.block_k);
    if (err != 0) return err;
  }
  const Strides so{st[9], st[10], st[11]};
  const float c = scale * kLog2e;
  return p.block_q == 128
             ? launch_sm90_wg<2>(p, maps, o, so, heads, t, d, c, stream)
             : launch_sm90_wg<1>(p, maps, o, so, heads, t, d, c, stream);
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
                    float scale, const int* plan, cudaStream_t stream) {
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
  const int err = launch(std::is_same<T, float>::value ? 0 : 1, qkvo[0],
                         qkvo[1], qkvo[2], qkvo[3], batch, t, heads, d, st,
                         scale, plan, stream);
  if (err != 0) return err;
  return gemm<T>(qkvo[3], w[3], out, rows, c, c, stream);
}

}  // namespace

// K16: dtype 0 = float32, 1 = bfloat16 for every tensor. x [batch * t, c]
// contiguous; wq, wk, wv, wo [c, c] contiguous in the (out, in) layout of a
// torch Linear weight. q, k, v and oh ([batch * t, c] each, contiguous) and
// out ([batch * t, c]) are written: the three projections, the attention
// output before to_out, and to_out of it without the bias. c = heads * d
// with d a multiple of 8 up to 160; plan is K1's for (batch * heads, t, d),
// for the attention stage. Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_absorbed(int dtype, const void* x,
                                         const void* wq, const void* wk,
                                         const void* wv, const void* wo,
                                         void* q, void* k, void* v, void* oh,
                                         void* out, int batch, int t, int c,
                                         int heads, float scale,
                                         const int* plan, void* stream) {
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
                                  plan, s);
  }
  if (dtype == 1) {
    return launch_absorbed<__nv_bfloat16>(x, w, qkvo, out, batch, t, c, heads,
                                          scale, plan, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
