// The Hopper (sm_90a) attention forward skeleton, O = softmax(S) V with S =
// Q K^T * scale, per (image * head, query tile). Three callers instantiate
// it, each through a __global__ wrapper of its own name:
//   * attention_fwd.cu: attention_fwd_kernel_sm90 (K1, K14 and K16's
//     attention stage): bf16 Q and K (kS8 false), P normalised by the row's
//     final sum before it rounds to bf16 (K1's rounding point);
//   * attention_ln_s8.cu: attn_s8_kernel_sm90 (K3's attention stage, and
//     through it K8's and K10's): int8 q8 and k8 (kS8 true), P rounded to
//     bf16 before any division and O = (P V) / l, l the sum of the rounded
//     P (K3's rounding point, _abs_padded_ln_s8_vt_body's);
//   * attention_s8.cu: attn_s8pv_kernel_sm90 (K13's attention stage, and
//     through it K15's, K11's, K10's without v_bf16, K17's and K18's):
//     int8 q8 and k8, e = exp((s - max) + ln 127) with the sum l over the
//     unrounded e, e8 = rint(e) (codes 0..127) and O = e8 V8 on int8 wgmma
//     into int32 (kPV, K13's rounding point, _attn_kernel_s8's), then one of
//     three epilogues (bf16, int8 or fp32 out).
// V is bf16 in the first two. In the third it is int8 and transposed, keys
// contiguous per head column (8-bit wgmma takes B only K-major), with the
// keys of every 16 permuted so that the score registers of a thread, packed
// four codes to a register, are the A fragment of the e8 V product without
// a shuffle: position q of a 16-key group holds key
// 2 ((q / 4) % 4) + (q % 2) + 8 ((q / 2) % 2) (ops/attention_s8.py:
// key_of_position). The int32 sums are exact in any key order.
//
// Design (one block per (b*h, query tile)):
//   * 128 query rows as two consumer warpgroups of 64 rows, plus a producer
//     warpgroup whose one thread issues the copies (setmaxnreg gives the
//     consumers 240 registers); or, where ceil(T / 128) * B*H would leave
//     SMs idle, one consumer warpgroup of 64 rows. The caller's launch plan
//     (ops/attention.py:sm90_launch_plan, ops/attention_s8.py:
//     sm90_s8_attention_plan) chooses the tiles, ring depth, shared memory
//     and grid; tiles_ok() holds the rules both plans follow.
//   * TMA tile loads through 4-D tensor maps over (D, H, T, B): a box is one
//     128-byte swizzle row (64 bf16 or 128 int8 columns) wide; TMA writes
//     zeros past D and past T. Q loads once per block; K (pass 1), then K and
//     V (pass 2) stream through a ring of 2-4 stages with full/empty
//     mbarriers.
//   * S = Q K^T is wgmma from shared memory, both operands K-major: bf16
//     m64nNk16 into fp32 or int8 m64nNk32 into int32 (N = the key tile: 128,
//     or 64 above class 80). O += P V is bf16 wgmma with P from registers
//     (the fragment of S converted pairwise to bf16 is the A fragment) and V
//     MN-major in shared memory, N = D rounded up to a compiled class (16,
//     32, 40, 64, 80, 128, 160; V's zero columns give zero outputs). Each
//     consumer issues its products one step ahead, so its exponentials
//     overlap the tensor cores' work; two consumer warpgroups issue in turns.
//   * kPV: the P V product is m64nNk32 s8 with the codes from registers and
//     V^T from shared memory, N = d rounded up to an .s8 class (16, 32, 48,
//     64, 80, 128, 160); a V^T box is 128 keys wide (one swizzle row) and
//     `N` head columns deep (zeros past d), loaded at the tile's first key
//     (at 64-key tiles only its first 64 keys are used).
//   * Why two passes: the rounding point needs the row's exact max (and,
//     for K1, its final sum) before any p rounds to bf16 (K13: to a code);
//     a one-pass online softmax rounds p against a running max. Pass 1
//     computes S and the row statistics: bf16, the running max and sum of
//     2^(s c - m) with c = scale * log2(e); int8, only the int32 row max
//     (scale > 0, so the max of float(s) * scale is float(max s) * scale).
//     Pass 2 recomputes S and forms p = 2^(s c - m c) (K1: times 1 / l) in
//     fp32, rounds it to bf16, (K3: adds the rounded p to l) and
//     accumulates P V in fp32 (kPV: the codes and e8 V in int32).
//     Exponentials are ex2.approx.ftz.f32: about 2 ulp of fp32 (PTX ISA),
//     far below the bf16 rounding of p (2^-9). Keys past T are masked in the
//     last tile of both passes (their zero-filled rows would score 0).
//   * O is rounded to bf16 once (K3: after the true division by l; kPV:
//     the caller's epilogue), rows < T and columns < D stored through the
//     caller's strides.
//   * K1's wide class (head dims above 160: the image VAE's mid attention,
//     one head of D = 512): a 64 x 512 fp32 O would take 256 registers a
//     thread and Q with two stages of full-width K and V 320 KB of shared
//     memory, so V and O are split into column slices of kWideN across the
//     grid (blockIdx.x = query tile * slices + slice: the slices of one
//     query tile run side by side and share its Q and K in L2). Each block
//     computes S = Q K^T over the whole depth kDQK (both passes) and P V
//     on its slice of V only, into a 64 x kWideN accumulator: one consumer
//     warpgroup, 64-key tiles, two stages.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "s8_common.cuh"  // quant_s8, warp_max (kPV's epilogues)
#include "sm90.cuh"

namespace attn90 {

using sm90::kRowBytes;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn127 = 4.844187086458591f;

// ---- the launch plans' shared rules (host) ---------------------------------
constexpr int kClasses[] = {16, 32, 40, 64, 80, 128, 160};
// K1's class above 160 (bf16 only) and the V/O columns of one of its blocks
constexpr int kWideClass = 512;
constexpr int kWideN = 128;
constexpr int kWideSlices = kWideClass / kWideN;
// the N of the s8 e8 V product: .s8 wgmma takes N = 8, 16, 24 and then
// multiples of 16 only
constexpr int kS8Classes[] = {16, 32, 48, 64, 80, 128, 160};

inline int head_class(int d) {
  for (int c : kClasses) {
    if (c >= d) return c;
  }
  return 0;
}

inline int s8_class(int d) {
  for (int c : kS8Classes) {
    if (c >= d) return c;
  }
  return 0;
}

// kPV's shared memory: the slack, Q, per stage a K tile and a V^T tile of
// `cls` rows of 128 keys, the barriers
inline int smem_bytes_s8pv(int block_q, int block_k, int qk_chunks, int cls,
                           int stages) {
  return 1024 + block_q * qk_chunks * kRowBytes +
         stages * (block_k * qk_chunks + cls) * kRowBytes +
         8 * (1 + 2 * stages);
}

// 1,024 bytes of slack to align the swizzled tiles, Q (qk_chunks boxes a
// row), the ring (a K tile of qk_chunks and a V tile of v_chunks boxes a row
// per stage), and one q barrier plus a full and an empty barrier per stage
inline int smem_bytes(int block_q, int block_k, int qk_chunks, int v_chunks,
                      int stages) {
  return 1024 + block_q * qk_chunks * kRowBytes +
         stages * block_k * (qk_chunks + v_chunks) * kRowBytes +
         8 * (1 + 2 * stages);
}

// the tiles and the grid of a plan for (bh, t) at head class cls (the wide
// class: 64-row query tiles, each kWideSlices blocks along x)
inline bool tiles_ok(int cls, int block_q, int block_k, int stages,
                     int smem, int grid_x, int grid_y, int bh, int t) {
  const bool wide = cls == kWideClass;
  const int slices = wide ? kWideSlices : 1;
  return cls != 0 && (block_q == 64 || (block_q == 128 && !wide)) &&
         block_k == (cls <= 80 ? 128 : 64) && stages >= 2 && stages <= 8 &&
         smem <= sm90::kSmemLimit &&
         grid_x == slices * ((t + block_q - 1) / block_q) &&
         grid_y == bh && bh >= 1 && bh <= 65535;
}

// ---- device -----------------------------------------------------------------
struct Strides {
  long long b, t, h;  // element strides of O's B, T and H axes (D is 1)
};

// kPV: the e8 V product and its epilogue into O
constexpr int kPVBf16 = 0;   // (no kPV) bf16 P V, bf16 O
constexpr int kOutBf16 = 1;  // O = bf16(float(o32) * (out / l))    (K13, K15)
constexpr int kOutS8 = 2;    // O = clip(rint(float(o32) * (out / l))) (K11)
constexpr int kOutF32 = 3;   // O = (float(o32) * out) / l in fp32  (K17, K18)

// kPV's per-block scales: s = float(S) * sc0 (sc0 = (qs ks) scale), the
// epilogue's `out` (K13: (vs / 127) * 127; K11: wos[h] / max(wos); K17:
// vs), and for kOutF32 the (image, head) slot that takes max|O| as float
// bits
struct PV8 {
  float sc0 = 0.f, out = 0.f;
  unsigned* amax = nullptr;
};

// kDN: the N of P V (the head class, or the wide class's slice kWideN);
// kDQK: the depth of Q K^T (the head class; kWideClass for the wide one)
template <bool kS8_, int kDN, int kWG, int kPV_ = kPVBf16, int kDQK = kDN>
struct Cfg {
  static constexpr bool kS8 = kS8_;
  static constexpr int kPV = kPV_;
  using Score = typename std::conditional<kS8, int, float>::type;
  static constexpr int kBytes = kS8 ? 1 : 2;  // of a Q or K element
  static constexpr int kBox = kRowBytes / kBytes;  // Q/K columns of a box
  static constexpr int kSteps = (kDQK * kBytes + 31) / 32;  // 32-byte k steps
  static constexpr int kQKChunks = (kSteps + 3) / 4;  // Q/K boxes across D
  static constexpr int kVChunks = (kDN + 63) / 64;    // V boxes of a slice
  static constexpr int kSlices = kDQK / kDN;  // V/O slices across the grid
  static constexpr int kBQ = 64 * kWG;
  static constexpr int kBK = kDN <= 80 && kDQK <= 80 ? 128 : 64;  // registers
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQSub = 64 * kQKChunks * kRowBytes;  // a warpgroup's Q
  static constexpr int kKTile = kBK * kQKChunks * kRowBytes;
  static constexpr int kVTile =
      kPV ? kDN * kRowBytes : kBK * kVChunks * kRowBytes;
  static constexpr int kStage = kKTile + kVTile;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ int quad_max(int x) {
  x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// pass 2 keeps p in the score registers: an int8 score's register holds
// the bits of its fp32 p
__device__ __forceinline__ float p_of(float s) { return s; }
__device__ __forceinline__ float p_of(int s) { return __int_as_float(s); }
__device__ __forceinline__ void set_p(float& s, float p) { s = p; }
__device__ __forceinline__ void set_p(int& s, float p) {
  s = __float_as_int(p);
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
  using Score = typename C::Score;
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

  __device__ uint32_t stage_of(const sm90::Slot& slot) const {
    return kv_smem + slot.stage * C::kStage;
  }

  // S = Q K^T (unscaled) of the next tile of the ring, issued, not waited
  // for
  __device__ void issue_scores(Score (&s)[kS]) {
    sm90::mbar_wait(full_bar + 8 * load.stage, load.phase);
    const uint32_t k = stage_of(load);
    load.next(stages);
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      const uint32_t along = (kk % 4) * 32;  // 32 bytes along a swizzled row
      const uint32_t chunk = kk / 4;
      sm90::WgmmaK<C::kS8, C::kBK>::ss(
          s,
          sm90::desc_sw128(q_sub + chunk * 64 * kRowBytes + along, 16, 1024),
          sm90::desc_sw128(k + chunk * C::kBK * kRowBytes + along, 16, 1024),
          kk > 0);
    }
    sm90::wgmma_commit();
  }

  // wait until at most kPending product groups are in flight; s is ready
  template <int kPending>
  __device__ void wait(Score (&s)[kS]) const {
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
  __device__ void mask(Score (&s)[kS], int kt, Score value) const {
    const int key0 = kt * C::kBK + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kS / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + 8 * j + (e & 1) >= t) s[4 * j + e] = value;
      }
    }
  }

  // pass 1 on key tile kt, for this thread's two rows. bf16: update the
  // running max m (log2 units) and this thread's share of the sum l of
  // 2^(s c - m); with c > 0 the max of s c is c times the max of s, and
  // 2^(s c - m) is one FMA and one exponential per score; c <= 0 (no
  // caller's) scales first. int8: the int32 max of s only.
  __device__ void stats(Score (&s)[kS], int kt, Score (&m)[2],
                        float (&l)[2]) const {
    const bool ragged = (kt + 1) * C::kBK > t;
    if constexpr (C::kS8) {
      if (ragged) mask(s, kt, INT_MIN);
#pragma unroll
      for (int i = 0; i < kS; ++i) m[(i / 2) % 2] = max(m[(i / 2) % 2], s[i]);
    } else {
      const bool positive = c > 0.f;
      if (!positive) {
#pragma unroll
        for (int i = 0; i < kS; ++i) s[i] *= c;
      }
      if (ragged) mask(s, kt, -INFINITY);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      }
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
  }

  // pass 2 on key tile kt, in place: p = 2^(s c - mc) in fp32, times r
  // (bf16: 1 / l) or not (int8), keys >= t masked to 0
  __device__ void probs(Score (&s)[kS], int kt, const float (&mc)[2],
                        const float (&r)[2]) const {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = (i / 2) % 2;
      float p = ex2(fmaf(static_cast<float>(s[i]), c, -mc[row]));
      if constexpr (!C::kS8) p *= r[row];
      set_p(s[i], p);
    }
    if ((kt + 1) * C::kBK > t) mask(s, kt, 0);  // 0: the bits of +0.f
  }

  // P rounded to bf16 (both rounding points round here; int8 adds the
  // rounded p to l). Keys 16kk..16kk+15 are the score column blocks 2kk and
  // 2kk+1: their bf16 pairs p[4kk..4kk+3] are the A fragment of that k16
  // step of P V.
  __device__ void round(const Score (&s)[kS], uint32_t (&p)[kS / 2],
                        float (&l)[2]) const {
#pragma unroll
    for (int j = 0; j < kS / 4; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            p_of(s[4 * j + 2 * r]), p_of(s[4 * j + 2 * r + 1]));
        p[2 * j + r] = *reinterpret_cast<const uint32_t*>(&v);
        if constexpr (C::kS8) l[r] += __low2float(v) + __high2float(v);
      }
    }
  }

  // O += P V of the oldest tile held, issued
  template <int kDN>
  __device__ void issue_pv(uint32_t (&p)[kS / 2],
                           float (&acc)[kDN / 2]) const {
    const uint32_t v = stage_of(done) + C::kKTile;
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

  // kPV's pass 2 on key tile kt, in place (c = sc0): s = float(S) * sc0,
  // rounded first (no fused multiply-add, as the TPU kernel); e = 2^(((s -
  // m) + ln 127) log2 e), its sum into l unrounded, e8 = rint(e). Keys >= t
  // give e = 0. ex2.approx against the reference's exp: about 2 ulp, so a
  // code flips only where e lies that close to a half. The conversions run
  // on the FMA pipe, not the conversion unit that ex2 shares: float(S) is
  // exact as (S + 1.5 2^23) - 1.5 2^23 for |S| < 2^22 (|S| <= 160 127^2),
  // and e + 1.5 2^23 rounds e to the nearest even integer in the low bits
  // (0 <= e < 2^22), whose low byte is the code.
  template <bool kRagged>
  __device__ __forceinline__ void codes_in(Score (&s)[kS], int kt,
                                           const float (&mf)[2],
                                           float (&l)[2]) const {
    constexpr float kMagic = 12582912.f;  // 1.5 2^23
    const int key0 = kt * C::kBK + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = (i / 2) % 2;
      const float sv =
          __fsub_rn(__int_as_float(s[i] + 0x4B400000), kMagic);  // exact
      const float sf = __fmul_rn(sv, c);
      float e = ex2(__fmul_rn(__fadd_rn(__fsub_rn(sf, mf[row]), kLn127),
                              kLog2e));
      if constexpr (kRagged) {
        if (key0 + 8 * (i / 4) + (i & 1) >= t) e = 0.f;
      }
      l[row] += e;
      s[i] = __float_as_int(__fadd_rn(e, kMagic));  // the code in byte 0
    }
  }

  __device__ void codes(Score (&s)[kS], int kt, const float (&mf)[2],
                        float (&l)[2]) const {
    if ((kt + 1) * C::kBK > t) {
      codes_in<true>(s, kt, mf, l);
    } else {
      codes_in<false>(s, kt, mf, l);
    }
  }

  // the codes (byte 0 of each score register) packed four to a register
  // as the A fragment of each k32 step: step kk's registers 4kk + r (r:
  // row lane/4 or + 8, then depth + 16) take the codes s[16kk + 2 (r % 2)
  // + 8 (r / 2) + {0, 1, 4, 5}], which the permuted key order of V^T puts
  // at depth 4 (lane % 4) + {0..3}
  __device__ void pack8(const Score (&s)[kS], uint32_t (&p)[kS / 4]) const {
#pragma unroll
    for (int kk = 0; kk < kS / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 16 * kk + 2 * (r % 2) + 8 * (r / 2);
        p[4 * kk + r] = __byte_perm(
            __byte_perm(s[i], s[i + 1], 0x0040),
            __byte_perm(s[i + 4], s[i + 5], 0x0040), 0x5410);
      }
    }
  }

  // O += e8 V of the oldest tile held, issued: V^T K-major, one k32 step
  // per 32 keys
  template <int kDN>
  __device__ void issue_pv8(uint32_t (&p)[kS / 4],
                            int (&acc)[kDN / 2]) const {
    const uint32_t v = stage_of(done) + C::kKTile;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kBK / 32; ++kk) {
      sm90::WgmmaRsS8<kDN>::rs(acc, &p[4 * kk],
                               sm90::desc_sw128(v + kk * 32, 16, 1024), 1);
    }
    sm90::wgmma_commit();
  }

  template <int kDN>
  __device__ void finish_pv8(uint32_t (&p)[kS / 4], int (&acc)[kDN / 2]) {
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(p);
    release();
  }
};

// The body of a caller's __global__ wrapper. Shared memory, from a
// 1,024-byte aligned base: Q (one 64-row sub-tile per consumer warpgroup,
// kQKChunks boxes each), then per stage a K tile (kQKChunks boxes of kBK
// rows) and a V tile (kVChunks boxes of kBK rows; kPV: one V^T box of kDN
// rows), then the barriers: q, full[stages], empty[stages]. O is bf16
// (kPV: bf16, int8 or fp32) through the element strides `so`; `pv` holds
// kPV's scales (c is then unused). kDQK > kDN: the wide class, V and O
// column slice blockIdx.x % kSlices.
template <bool kS8, int kDN, int kWG, int kPV = kPVBf16, int kDQK = kDN>
__device__ __forceinline__ void forward(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        void* __restrict__ o, Strides so,
                                        int heads, int t, int d, int stages,
                                        float c, PV8 pv = PV8{}) {
  using C = Cfg<kS8, kDN, kWG, kPV, kDQK>;
  static_assert(kPV == kPVBf16 || kS8, "the e8 V product needs int8 scores");
  static_assert(C::kSlices == 1 || (!kS8 && kWG == 1 &&
                                    C::kSlices * kDN == kDQK),
                "V/O slices: bf16 scores, one consumer warpgroup");
  using Score = typename C::Score;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_smem = q_smem + kWG * C::kQSub;
  const uint32_t q_bar = kv_smem + stages * C::kStage;
  const uint32_t full_bar = q_bar + 8;            // + 8 s
  const uint32_t empty_bar = full_bar + 8 * stages;  // + 8 s

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int slice = static_cast<int>(blockIdx.x) % C::kSlices;
  const int q0 = (static_cast<int>(blockIdx.x) / C::kSlices) * C::kBQ;
  const int v0 = slice * kDN;  // this block's first V and O column
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
    if constexpr (kWG == 2) sm90::regs_dealloc<sm90::kProducerRegs>();
    if (threadIdx.x == 128 * kWG) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tk);
      sm90::tma_prefetch_map(&tv);
      sm90::mbar_expect_tx(q_bar, kWG * C::kQSub);
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
#pragma unroll
        for (int ch = 0; ch < C::kQKChunks; ++ch) {
          sm90::tma_load_4d(q_smem + w * C::kQSub + ch * 64 * kRowBytes, &tq,
                            q_bar, ch * C::kBox, h, q0 + 64 * w, b);
        }
      }
      sm90::Slot slot;  // the ring across both passes
      for (int pass = 0; pass < 2; ++pass) {
        for (int kt = 0; kt < ntiles; ++kt, slot.next(stages)) {
          const uint32_t s = slot.stage;
          const uint32_t st = kv_smem + s * C::kStage;
          sm90::mbar_wait(empty_bar + 8 * s, slot.phase ^ 1);
          sm90::mbar_expect_tx(full_bar + 8 * s,
                               C::kKTile + (pass == 1 ? C::kVTile : 0));
#pragma unroll
          for (int ch = 0; ch < C::kQKChunks; ++ch) {
            sm90::tma_load_4d(st + ch * C::kBK * kRowBytes, &tk,
                              full_bar + 8 * s, ch * C::kBox, h, kt * C::kBK,
                              b);
          }
          if (pass == 1) {
            if constexpr (kPV != kPVBf16) {
              // V^T: 128 keys from the tile's first, kDN head columns
              sm90::tma_load_4d(st + C::kKTile, &tv, full_bar + 8 * s,
                                kt * C::kBK, 0, h, b);
            } else {
#pragma unroll
              for (int ch = 0; ch < C::kVChunks; ++ch) {
                sm90::tma_load_4d(st + C::kKTile + ch * C::kBK * kRowBytes,
                                  &tv, full_bar + 8 * s, v0 + ch * 64, h,
                                  kt * C::kBK, b);
              }
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
                     t, ntiles, stages, lane, wg,
                     kPV != kPVBf16 ? pv.sc0 : c};
    if (wg == 1) cons.your_turn();  // warpgroup 0 issues first
    // two score buffers: tile kt's in one while kt + 1's is computed
    Score sa[C::kBK / 2], sb[C::kBK / 2];
    // rows `row` and `row + 8`: the max (bf16: running, log2 units; int8:
    // of the int32 scores) and this thread's share of the sum
    Score m[2];
    if constexpr (kS8) {
      m[0] = m[1] = INT_MIN;
    } else {
      m[0] = m[1] = -INFINITY;
    }
    float l[2] = {0.f, 0.f};
    sm90::mbar_wait(q_bar, 0);

    // pass 1: the row statistics; tile kt's scores in sa (kt even) or sb
    // (kt odd)
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

    if constexpr (kPV != kPVBf16) {
      // pass 2, K13's rounding point: the max of s = float(S) sc0 is
      // float(max S) sc0 (sc0 > 0); e8 V summed in int32
      float mf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mf[i] = __fmul_rn(static_cast<float>(quad_max(m[i])), pv.sc0);
        l[i] = 0.f;
      }
      int acc[kDN / 2];
#pragma unroll
      for (int i = 0; i < kDN / 2; ++i) acc[i] = 0;
      uint32_t p[C::kBK / 8];
      cons.my_turn();
      cons.issue_scores(sa);
      cons.your_turn();
      cons.template wait<0>(sa);
      cons.codes(sa, 0, mf, l);
      for (kt = 0; kt + 1 < ntiles; ++kt) {
        cons.pack8(sa, p);
        cons.my_turn();
        cons.issue_scores(sa);
        cons.template issue_pv8<kDN>(p, acc);
        cons.your_turn();
        cons.template wait<1>(sa);  // the scores, issued first; e8 V in flight
        cons.codes(sa, kt + 1, mf, l);
        cons.template finish_pv8<kDN>(p, acc);
      }
      cons.pack8(sa, p);
      cons.my_turn();
      cons.template issue_pv8<kDN>(p, acc);
      cons.your_turn();
      cons.template finish_pv8<kDN>(p, acc);
      if (wg == 0) cons.my_turn();  // takes warpgroup 1's last turn

      // the epilogue on rows < t, columns < d: f = out / l once per row (a
      // true division), or (kOutF32) (o32 out) / l per element
      const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
      const float f[2] = {pv.out / lt[0], pv.out / lt[1]};
      const long long base = b * so.b + h * so.h;
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < kDN / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < d) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            if (row + 8 * rr < t) {
              const long long at = base + (row + 8 * rr) * so.t + col;
              const float a0 = static_cast<float>(acc[4 * j + 2 * rr]);
              const float a1 = static_cast<float>(acc[4 * j + 2 * rr + 1]);
              if constexpr (kPV == kOutBf16) {
                *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(o) +
                                             at) =
                    sm90::pack_bf16(a0 * f[rr], a1 * f[rr]);
              } else if constexpr (kPV == kOutS8) {
                *reinterpret_cast<char2*>(static_cast<int8_t*>(o) + at) =
                    make_char2(s8::quant_s8(a0 * f[rr]),
                               s8::quant_s8(a1 * f[rr]));
              } else {
                const float o0 = (a0 * pv.out) / lt[rr];
                const float o1 = (a1 * pv.out) / lt[rr];
                *reinterpret_cast<float2*>(static_cast<float*>(o) + at) =
                    make_float2(o0, o1);
                amax = fmaxf(amax, fmaxf(fabsf(o0), fabsf(o1)));
              }
            }
          }
        }
      }
      if constexpr (kPV == kOutF32) {
        // non-negative floats order as their bits; a max is exact in any
        // order
        amax = s8::warp_max(amax);
        if (lane == 0 && pv.amax != nullptr) {
          atomicMax(pv.amax, __float_as_uint(amax));
        }
      }
      return;
    } else {
      // pass 2's p = 2^(s c - mc) * r: bf16, mc the running max and r =
      // 1 / l; int8, mc = float(max s) * c (max(float(s) * c) for c > 0), l
      // anew
      float mc[2], r[2] = {1.f, 1.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (kS8) {
          mc[i] = static_cast<float>(quad_max(m[i])) * c;
          l[i] = 0.f;
        } else {
          mc[i] = m[i];
          r[i] = 1.f / quad_sum(l[i]);
        }
      }

      // pass 2: P rounded to bf16, O += P V in fp32; sa holds tile kt's
      // scores, then its probabilities
      float acc[kDN / 2];
#pragma unroll
      for (int i = 0; i < kDN / 2; ++i) acc[i] = 0.f;
      uint32_t p[C::kBK / 4];
      cons.my_turn();
      cons.issue_scores(sa);
      cons.your_turn();
      cons.template wait<0>(sa);
      cons.probs(sa, 0, mc, r);
      for (kt = 0; kt + 1 < ntiles; ++kt) {
        cons.round(sa, p, l);
        cons.my_turn();
        cons.issue_scores(sa);
        cons.template issue_pv<kDN>(p, acc);
        cons.your_turn();
        cons.template wait<1>(sa);  // the scores, issued first; P V in flight
        cons.probs(sa, kt + 1, mc, r);
        cons.template finish_pv<kDN>(p, acc);
      }
      cons.round(sa, p, l);
      cons.my_turn();
      cons.template issue_pv<kDN>(p, acc);
      cons.your_turn();
      cons.template finish_pv<kDN>(p, acc);
      if (wg == 0) cons.my_turn();  // takes warpgroup 1's last turn

      // O rounded to bf16 once; int8 divides by l first, a true division
      // as the plain version's; rows < t, columns < d
      float lt[2] = {1.f, 1.f};
      if constexpr (kS8) {
        lt[0] = quad_sum(l[0]);
        lt[1] = quad_sum(l[1]);
      }
      __nv_bfloat16* ob =
          static_cast<__nv_bfloat16*>(o) + b * so.b + h * so.h + v0;
#pragma unroll
      for (int j = 0; j < kDN / 8; ++j) {
        const int col = 8 * j + col0;
        if (v0 + col < d) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            if (row + 8 * rr < t) {
              float o0 = acc[4 * j + 2 * rr], o1 = acc[4 * j + 2 * rr + 1];
              if constexpr (kS8) {
                o0 = o0 / lt[rr];
                o1 = o1 / lt[rr];
              }
              *reinterpret_cast<uint32_t*>(ob + (row + 8 * rr) * so.t + col) =
                  sm90::pack_bf16(o0, o1);
            }
          }
        }
      }
    }
  }
}

// What a launch of the skeleton reads: the plan's choices and the kernel's
// arguments. K names the caller's wrapper: K::kS8, and K::kernel<kDN,
// kWG>() the __global__ function that runs forward<K::kS8, kDN, kWG>.
struct Launch {
  int head_class, block_q, smem_bytes, grid_x, grid_y, stages;
  const CUtensorMap* maps;  // q, k, v
  __nv_bfloat16* o;
  Strides so;
  int heads, t, d;
  float c;  // scale * log2(e)
};

template <class K, int kDN, int kWG>
int launch_as(const Launch& a, cudaStream_t stream) {
  auto kernel = K::template kernel<kDN, kWG>();
  // once per instantiation: any plan's shared memory is within the limit
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(a.grid_x, a.grid_y), Cfg<K::kS8, kDN, kWG>::kThreads,
           a.smem_bytes, stream>>>(a.maps[0], a.maps[1], a.maps[2], a.o,
                                   a.so, a.heads, a.t, a.d, a.stages, a.c);
  return static_cast<int>(cudaGetLastError());
}

template <class K, int kWG>
int launch_wg(const Launch& a, cudaStream_t stream) {
  switch (a.head_class) {
    case 16: return launch_as<K, 16, kWG>(a, stream);
    case 32: return launch_as<K, 32, kWG>(a, stream);
    case 40: return launch_as<K, 40, kWG>(a, stream);
    case 64: return launch_as<K, 64, kWG>(a, stream);
    case 80: return launch_as<K, 80, kWG>(a, stream);
    case 128: return launch_as<K, 128, kWG>(a, stream);
    case 160: return launch_as<K, 160, kWG>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// one launch of K's kernel at the plan's head class and query tile
template <class K>
int launch(const Launch& a, cudaStream_t stream) {
  return a.block_q == 128 ? launch_wg<K, 2>(a, stream)
                          : launch_wg<K, 1>(a, stream);
}

}  // namespace attn90
