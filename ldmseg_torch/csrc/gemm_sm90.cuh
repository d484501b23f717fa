// One Hopper (sm_90a) product for the int8 blocks: C = A W^T with A [rows,
// k] and W [n, k] both row-major (K-major), int8 with int32 sums or bf16
// with fp32 sums, each output handed to the caller's epilogue straight from
// the accumulator registers. It carries the products of K3 (the Q/K/V
// projection, to_out; attention_ln_s8.cu), K4 and K12 (W1 with the gating,
// W2; geglu_ln_s8.cu), and through them K8, K9 and K10; and of K11, K10
// without v_bf16, K17 and K18 (attention_s8.cu: the Q/K projection, the
// swapped V projection, to_out; K17's projection with its group amax and
// its per-head to_out, gemm_heads_kernel below); gemm_sm90.cu holds its two
// test entry points (a plain int32 and a plain fp32 store).
//
// Replaces, for those kernels, the Ampere-era helpers of s8_common.cuh
// (synchronous 8-byte tile loads between __syncthreads, wmma 16x16x16 on
// 64x64 tiles, each tile staged through shared memory before a scalar
// epilogue). What bounds it on an H100: at the first level (4,096 rows,
// k = 320 or 1,280) the tensor cores (1,979 TOPS int8, 989 TFLOP/s bf16);
// at T = 128 and 32 (256 and 64 rows) the weights' bytes (3.35 TB/s).
//
// Design:
//   * one block per (64 or 128 rows, 64 or 128 columns) output tile, or
//     256 x 64 for two operands (K4's up, whose gating epilogue is most of
//     its time: four warpgroups share it): one consumer warpgroup per 64
//     rows, plus a producer warpgroup whose one thread issues the copies
//     (setmaxnreg gives two consumers 240 registers, four 112);
//   * A and W stream through a ring of `stages` stages by TMA tile loads
//     through 2-D tensor maps (one 128-byte swizzle row deep: 128 int8 or
//     64 bf16 per stage; zeros past k, rows and n), with full/empty
//     mbarriers; a stage can hold a second W tile (`Epi::kOps == 2`: K4's
//     h and gate rows of W1, `w_row2` rows apart, in two accumulator sets);
//   * wgmma m64nNk32 (int8) or m64nNk16 (bf16), N = the tile's columns,
//     both operands K-major in shared memory, one stage's products in
//     flight while the next stage's are issued;
//   * the epilogue runs on the accumulator fragment: the thread of lane l
//     in warp w of consumer warpgroup g owns rows 64g + 16w + l/4 and that
//     + 8, columns 8j + 2 (l % 4) and + 1. What it reads is fetched before
//     the main loop, so that its latency hides behind the products (read
//     after them, one pair at a time, it took most of the time):
//     Epi::kCols fp32 per-column vectors (epi.col_value(v, col), v <
//     kCols: scales, biases) and Epi::kIntCols int ones (epi.col_int(v,
//     col): where a column's outputs go) staged by the consumers in shared
//     memory, and per thread
//     epi.row_pre(row) for its two rows and epi.pre(row, col) for each of
//     its pairs, held in registers (the residual x; Epi::RowPre and
//     Epi::Pre, NoPre when there is none). Then the kernel calls, for each
//     pair inside the output (rows < rows, columns < n; n is a multiple of
//     8), with cv[v] and ci[v] the pair's two entries of fp32 and int
//     vector v:
//       kOps 1: epi(row, col, cv, ci, row_pre, pre, s0, s1), the sums at
//               (row, col) and (row, col + 1);
//       kOps 2: float epi(row, col, cv, ci, a0, a1, b0, b1), the two operands'
//               sums, which returns a value whose maximum over each group
//               of 8 rows the warp takes, handed (when Epi::kRowMax) to
//               epi.row_max(first row of the group, max) by lane 0. The
//               caller keeps an 8-row group inside one scale slot (K4's
//               interior scale per image and 512-token block; T % 8 == 0).
//       kOps 1 with Epi::kGroupMax (K17's and K18's projection): epi(...)
//               returns the pair's max|value|; int vector 0 holds each
//               column's group, the same for the 8 columns of a block, so
//               the warp folds its maximum per group and 8-row group and
//               lane 0 hands it to epi.group_max(first row, group, max).
// The launch plan (tile, ring depth, shared memory, grid) is chosen by
// ldmseg_torch/ops/gemm.py:sm90_gemm_plan and checked here.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace gemm90 {

using sm90::kRowBytes;  // a swizzle row: one stage's depth
using sm90::kSmemLimit;
// registers of a consumer thread under setmaxnreg: 240 with two consumer
// warpgroups, 112 with four (whose accumulators are 64 registers at most)
template <int kWG>
struct ConsumerRegs {
  static constexpr int value = kWG == 4 ? 112 : 240;
};
constexpr int kMaxStages = 8;
constexpr int kMaxCols = 4;  // per-column vectors an epilogue stages (4 bytes)
constexpr int kColBytes = kMaxCols * 128 * 4;

// what an epilogue without prefetched reads holds
struct NoPre {};

template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct PairOf<int> {
  using type = int2;
};

// two consecutive values at p through the read-only path (the epilogues
// read only what no launch of theirs writes)
__device__ __forceinline__ float2 ldg_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ __nv_bfloat162 ldg_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// the launch plan as ops/gemm.py:sm90_gemm_plan lays it out
struct Plan {
  int dtype;       // 0: int8 operands, int32 sums; 1: bf16, fp32 sums
  int block_m;     // rows of a tile: 64 per consumer warpgroup
  int block_n;     // columns of a tile (the wgmma N)
  int operands;    // W tiles per stage (Epi::kOps)
  int stages;      // depth of the ring
  int k_tiles;     // stages of depth along k
  int smem_bytes;  // dynamic shared memory of the launch
  int grid_x;      // row tiles
  int grid_y;      // column tiles
};
constexpr int kPlanInts = 9;

// 1,024 bytes of slack to align the swizzled tiles, the ring, a full and
// an empty barrier per stage, and the epilogue's per-column vectors
inline int plan_smem(int block_m, int block_n, int operands, int stages) {
  return 1024 + stages * (block_m + operands * block_n) * kRowBytes +
         16 * stages + kColBytes;
}

inline bool plan_ok(const Plan& p, bool s8, int rows, int n, int k,
                    int operands) {
  const int depth = s8 ? kRowBytes : kRowBytes / 2;
  const int esize = s8 ? 1 : 2;
  return p.dtype == (s8 ? 0 : 1) &&
         (p.block_m == 64 || p.block_m == 128 ||
          (p.block_m == 256 && p.block_n == 64 && operands == 2)) &&
         (p.block_n == 64 || p.block_n == 128) && p.operands == operands &&
         p.stages >= 2 && p.stages <= kMaxStages &&
         p.k_tiles == (k + depth - 1) / depth &&
         p.smem_bytes ==
             plan_smem(p.block_m, p.block_n, operands, p.stages) &&
         p.smem_bytes <= kSmemLimit &&
         p.grid_x == (rows + p.block_m - 1) / p.block_m &&
         p.grid_y == (n + p.block_n - 1) / p.block_n && p.grid_y <= 65535 &&
         rows >= 1 && n >= 8 && n % 8 == 0 && k >= 1 &&
         (k * esize) % 16 == 0;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Epi::kGroupMax, false where an epilogue does not name it
template <class E, class = void>
struct GroupMax : std::false_type {};
template <class E>
struct GroupMax<E, std::void_t<decltype(E::kGroupMax)>>
    : std::integral_constant<bool, E::kGroupMax> {};

// the warp's maxima of its two 8-row groups (rows group0 and group0 + 8)
// in column group `group`, handed over by lane 0
template <class Epi>
__device__ __forceinline__ void flush_group(const Epi& epi, int group,
                                            const float (&mx)[2], int group0,
                                            int rows, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float v = warp_max(mx[r]);
    if (lane == 0 && group0 + 8 * r < rows) epi.group_max(group0 + 8 * r,
                                                          group, v);
  }
}

// Shared memory, from a 1,024-byte aligned base: per stage the A tile
// (block_m rows) and Epi::kOps W tiles (kBN rows each), one swizzle row
// deep; then the full and the empty barriers, then the epilogue's
// per-column vectors: [kCols][kBN] fp32, then [kIntCols][kBN] int.
template <bool kS8, int kBN, int kWG, class Epi>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tw, int rows, int n,
                int w_row2, int k_tiles, int stages, Epi epi) {
  constexpr int kOps = Epi::kOps;
  using Acc = typename std::conditional<kS8, int, float>::type;
  constexpr int kATile = 64 * kWG * kRowBytes;
  constexpr int kWTile = kBN * kRowBytes;
  constexpr int kStage = kATile + kOps * kWTile;
  constexpr int kDepth = kS8 ? kRowBytes : kRowBytes / 2;  // elements
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = tiles + stages * kStage;
  const uint32_t empty_bar = full_bar + 8 * stages;
  const int m0 = blockIdx.x * 64 * kWG;
  const int n0 = blockIdx.y * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, 4 * kWG);  // one arrival per warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kWG) {
    // producer warpgroup: one thread issues every copy
    if constexpr (kWG > 1) sm90::regs_dealloc<sm90::kProducerRegs>();
    if (threadIdx.x == 128 * kWG) {
      sm90::tma_prefetch_map(&ta);
      sm90::tma_prefetch_map(&tw);
      sm90::Slot slot;
      for (int kt = 0; kt < k_tiles; ++kt, slot.next(stages)) {
        const uint32_t s = slot.stage;
        const uint32_t st = tiles + s * kStage;
        sm90::mbar_wait(empty_bar + 8 * s, slot.phase ^ 1);
        sm90::mbar_expect_tx(full_bar + 8 * s, kStage);
        sm90::tma_load_2d(st, &ta, full_bar + 8 * s, kt * kDepth, m0);
        sm90::tma_load_2d(st + kATile, &tw, full_bar + 8 * s, kt * kDepth,
                          n0);
        if constexpr (kOps == 2) {
          sm90::tma_load_2d(st + kATile + kWTile, &tw, full_bar + 8 * s,
                            kt * kDepth, w_row2 + n0);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [m0 + 64 wg, m0 + 64 wg + 64)
  static_assert(kWG < 4 || kBN * kOps <= 128, "accumulators in 112 regs");
  if constexpr (kWG > 1) sm90::regs_alloc<ConsumerRegs<kWG>::value>();
  const int lane = threadIdx.x % 32;
  const int group0 = m0 + 64 * wg + 16 * ((threadIdx.x % 128) / 32);
  const int row0 = group0 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);

  // the epilogue's reads, issued now: per-column vectors into shared
  // memory (the fp32 ones, then the int ones), the rows' and pairs' values
  // into registers
  static_assert(Epi::kCols + Epi::kIntCols <= kMaxCols, "per-column vectors");
  float* cols = reinterpret_cast<float*>(
      smem_raw + (tiles - sm90::smem_addr(smem_raw)) + stages * kStage +
      16 * stages);
  int* int_cols = reinterpret_cast<int*>(cols + Epi::kCols * kBN);
  for (int i = threadIdx.x; i < Epi::kCols * kBN; i += 128 * kWG) {
    const int v = i / kBN;
    const int cc = i - v * kBN;
    cols[i] = n0 + cc < n ? epi.col_value(v, n0 + cc) : 0.f;
  }
  if constexpr (Epi::kIntCols > 0) {
    for (int i = threadIdx.x; i < Epi::kIntCols * kBN; i += 128 * kWG) {
      const int v = i / kBN;
      const int cc = i - v * kBN;
      int_cols[i] = n0 + cc < n ? epi.col_int(v, n0 + cc) : 0;
    }
  }
  typename Epi::RowPre row_pre[2];
  typename Epi::Pre pre[kBN / 8][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < rows) row_pre[r] = epi.row_pre(row);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (row < rows && col0 + 8 * j < n) pre[j][r] = epi.pre(row, col0 + 8 * j);
    }
  }

  Acc acc[kOps][kBN / 2];
#pragma unroll
  for (int op = 0; op < kOps; ++op) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[op][i] = 0;
  }
  sm90::Slot load, done;
  for (int kt = 0; kt < k_tiles; ++kt) {
    sm90::mbar_wait(full_bar + 8 * load.stage, load.phase);
    const uint32_t st = tiles + load.stage * kStage;
    load.next(stages);
#pragma unroll
    for (int op = 0; op < kOps; ++op) sm90::fence_regs(acc[op]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 32 bytes along the swizzled rows
      const uint64_t da =
          sm90::desc_sw128(st + wg * 64 * kRowBytes + kk * 32, 16, 1024);
#pragma unroll
      for (int op = 0; op < kOps; ++op) {
        sm90::WgmmaK<kS8, kBN>::ss(
            acc[op], da,
            sm90::desc_sw128(st + kATile + op * kWTile + kk * 32, 16, 1024),
            1);
      }
    }
    sm90::wgmma_commit();
    if (kt > 0) {
      // the previous stage's products are done: its tiles go back
      sm90::wgmma_wait<1>();
#pragma unroll
      for (int op = 0; op < kOps; ++op) sm90::fence_regs(acc[op]);
      if (lane == 0) sm90::mbar_arrive(empty_bar + 8 * done.stage);
      done.next(stages);
    }
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int op = 0; op < kOps; ++op) sm90::fence_regs(acc[op]);
  sm90::bar_sync(1, 128 * kWG);  // the per-column vectors are staged

  constexpr bool kGroups = kOps == 1 && GroupMax<Epi>::value;
  float mx[2] = {0.f, 0.f};
  int group = -1;  // kGroups: the column group mx holds
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = col0 + 8 * j;
    float2 cv[Epi::kCols > 0 ? Epi::kCols : 1];
    int2 ci[Epi::kIntCols > 0 ? Epi::kIntCols : 1];
#pragma unroll
    for (int v = 0; v < Epi::kCols; ++v) {
      cv[v] = *reinterpret_cast<const float2*>(cols + v * kBN + col - n0);
    }
#pragma unroll
    for (int v = 0; v < Epi::kIntCols; ++v) {
      ci[v] = *reinterpret_cast<const int2*>(int_cols + v * kBN + col - n0);
    }
    if constexpr (kGroups) {
      // the same for the whole warp: its 8-column block lies in one group
      if (ci[0].x != group) {
        if (group >= 0) flush_group(epi, group, mx, group0, rows, lane);
        group = ci[0].x;
        mx[0] = mx[1] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (col < n && row < rows) {
        if constexpr (kGroups) {
          mx[r] = fmaxf(mx[r], epi(row, col, cv, ci, row_pre[r], pre[j][r],
                                   acc[0][4 * j + 2 * r],
                                   acc[0][4 * j + 2 * r + 1]));
        } else if constexpr (kOps == 1) {
          epi(row, col, cv, ci, row_pre[r], pre[j][r],
              acc[0][4 * j + 2 * r], acc[0][4 * j + 2 * r + 1]);
        } else {
          mx[r] = fmaxf(mx[r], epi(row, col, cv, ci, acc[0][4 * j + 2 * r],
                                   acc[0][4 * j + 2 * r + 1],
                                   acc[1][4 * j + 2 * r],
                                   acc[1][4 * j + 2 * r + 1]));
        }
      }
    }
  }
  if constexpr (kGroups) {
    if (group >= 0) flush_group(epi, group, mx, group0, rows, lane);
  }
  if constexpr (kOps == 2) {
    if constexpr (Epi::kRowMax) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = warp_max(mx[r]);
        if (lane == 0 && group0 + 8 * r < rows) {
          epi.row_max(group0 + 8 * r, v);
        }
      }
    }
  }
}

template <bool kS8, int kBN, int kWG, class Epi>
int launch_as(const Plan& p, const CUtensorMap* maps, int rows, int n,
              int w_row2, Epi epi, cudaStream_t stream) {
  auto kernel = gemm_kernel<kS8, kBN, kWG, Epi>;
  // once per instantiation: any plan's shared memory is within the limit
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(p.grid_x, p.grid_y), 128 * (kWG + 1), p.smem_bytes,
           stream>>>(maps[0], maps[1], rows, n, w_row2, p.k_tiles, p.stages,
                     epi);
  return static_cast<int>(cudaGetLastError());
}

// C = A W^T with the caller's epilogue: A [rows, k] and W row-major with k
// contiguous, int8 (kS8) or bf16, 16-byte aligned, k * element size a
// multiple of 16; W holds n rows, or 2n (Epi::kOps == 2: the second
// operand's rows start at w_row2). `plan` is sm90_gemm_plan's, checked.
// Returns a cudaError_t.
template <bool kS8, class Epi>
int launch_gemm(const int* plan, const void* a, const void* w, int rows,
                int n, int k, int w_row2, Epi epi, cudaStream_t stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[5], plan[6], plan[7], plan[8]};
  if (!plan_ok(p, kS8, rows, n, k, Epi::kOps) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int current = sm90::make_current(a);
  if (current != 0) return current;
  const int esize = kS8 ? 1 : 2;
  CUtensorMap maps[2];
  int err = sm90::encode_map_2d(&maps[0], a, esize, rows, k, k, p.block_m);
  if (err != 0) return err;
  err = sm90::encode_map_2d(&maps[1], w, esize,
                            Epi::kOps == 2 ? w_row2 + n : n, k, k,
                            p.block_n);
  if (err != 0) return err;
  if constexpr (Epi::kOps == 2) {  // four consumer warpgroups
    if (p.block_m == 256) {
      return launch_as<kS8, 64, 4>(p, maps, rows, n, w_row2, epi, stream);
    }
  }
  if (p.block_m == 128) {
    return p.block_n == 128
               ? launch_as<kS8, 128, 2>(p, maps, rows, n, w_row2, epi, stream)
               : launch_as<kS8, 64, 2>(p, maps, rows, n, w_row2, epi, stream);
  }
  return p.block_n == 128
             ? launch_as<kS8, 128, 1>(p, maps, rows, n, w_row2, epi, stream)
             : launch_as<kS8, 64, 1>(p, maps, rows, n, w_row2, epi, stream);
}

// ---- the per-head product (K17's and K18's to_out) ------------------------
// out = sum over heads h, h = 0 first, of float(int32 A_h W_h^T) * f[b][h],
// b = row / t, with A [rows, heads * dp] and W [n, heads * dp] int8, each
// head's dp columns (a multiple of 32, zeros past the head dim in W) one
// group of head_steps = dp / 32 k32 steps. Each group's int32 sums are
// promoted into fp32 registers when the group ends: acc = acc + float(c32)
// * f, both rounded (no fused multiply-add), as the TPU kernel sums the
// heads. f = epi.head_factor(b, h), staged per block in the per-column
// vectors' shared memory for the images its rows touch. Each stage's
// products are waited for before its tiles go back (the promotion needs
// them done anyway). Then epi(row, col, a0, a1) for each pair inside the
// output.
template <int kBN, int kWG, class Epi>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
    gemm_heads_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tw, int rows, int n,
                      int k_tiles, int stages, int heads, int head_steps,
                      int t, Epi epi) {
  constexpr int kATile = 64 * kWG * kRowBytes;
  constexpr int kWTile = kBN * kRowBytes;
  constexpr int kStage = kATile + kWTile;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = tiles + stages * kStage;
  const uint32_t empty_bar = full_bar + 8 * stages;
  const int m0 = blockIdx.x * 64 * kWG;
  const int n0 = blockIdx.y * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, 4 * kWG);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kWG) {
    if constexpr (kWG > 1) sm90::regs_dealloc<sm90::kProducerRegs>();
    if (threadIdx.x == 128 * kWG) {
      sm90::tma_prefetch_map(&ta);
      sm90::tma_prefetch_map(&tw);
      sm90::Slot slot;
      for (int kt = 0; kt < k_tiles; ++kt, slot.next(stages)) {
        const uint32_t s = slot.stage;
        const uint32_t st = tiles + s * kStage;
        sm90::mbar_wait(empty_bar + 8 * s, slot.phase ^ 1);
        sm90::mbar_expect_tx(full_bar + 8 * s, kStage);
        sm90::tma_load_2d(st, &ta, full_bar + 8 * s, kt * kRowBytes, m0);
        sm90::tma_load_2d(st + kATile, &tw, full_bar + 8 * s, kt * kRowBytes,
                          n0);
      }
    }
    return;
  }

  if constexpr (kWG > 1) sm90::regs_alloc<ConsumerRegs<kWG>::value>();
  const int lane = threadIdx.x % 32;
  const int row0 = m0 + 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  // the block's images and their head factors, [image - img0][heads]
  const int img0 = m0 / t;
  const int img_n = (min(m0 + 64 * kWG, rows) - 1) / t - img0 + 1;
  float* fs = reinterpret_cast<float*>(
      smem_raw + (tiles - sm90::smem_addr(smem_raw)) + stages * kStage +
      16 * stages);
  for (int i = threadIdx.x; i < img_n * heads; i += 128 * kWG) {
    const int im = i / heads;
    fs[i] = epi.head_factor(img0 + im, i - im * heads);
  }
  int fi[2];  // this thread's rows' offsets into fs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    fi[r] = (min(row0 + 8 * r, rows - 1) / t - img0) * heads;
  }

  // each head's int32 sums, zeroed after each promotion so that every
  // product accumulates; the steps past the last head (k_tiles' zero
  // tail) add zeros that are never promoted
  int acc[kBN / 2];
  float out[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    acc[i] = 0;
    out[i] = 0.f;
  }
  bool staged = false;
  int h = 0, in_head = 0;  // the head and the step within it
  sm90::Slot load;
  for (int kt = 0; kt < k_tiles; ++kt) {
    sm90::mbar_wait(full_bar + 8 * load.stage, load.phase);
    const uint32_t st = tiles + load.stage * kStage;
    const uint32_t done_stage = load.stage;
    load.next(stages);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::WgmmaS8<kBN>::ss(
          acc, sm90::desc_sw128(st + wg * 64 * kRowBytes + kk * 32, 16, 1024),
          sm90::desc_sw128(st + kATile + kk * 32, 16, 1024), 1);
      if (++in_head == head_steps && h < heads) {
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        if (!staged) {
          sm90::bar_sync(1, 128 * kWG);  // fs is staged
          staged = true;
        }
        const float f0 = fs[fi[0] + h], f1 = fs[fi[1] + h];
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          out[i] = __fadd_rn(out[i], __fmul_rn(static_cast<float>(acc[i]),
                                               (i / 2) % 2 ? f1 : f0));
          acc[i] = 0;
        }
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
        in_head = 0;
        ++h;
      }
    }
    // the stage's products done before its tiles go back
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(empty_bar + 8 * done_stage);
  }

#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (col < n && row < rows) {
        epi(row, col, out[4 * j + 2 * r], out[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int kBN, int kWG, class Epi>
int launch_heads_as(const Plan& p, const CUtensorMap* maps, int rows, int n,
                    int heads, int head_steps, int t, Epi epi,
                    cudaStream_t stream) {
  auto kernel = gemm_heads_kernel<kBN, kWG, Epi>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(p.grid_x, p.grid_y), 128 * (kWG + 1), p.smem_bytes,
           stream>>>(maps[0], maps[1], rows, n, p.k_tiles, p.stages, heads,
                     head_steps, t, epi);
  return static_cast<int>(cudaGetLastError());
}

// the per-head product of int8 A [rows, heads * dp] and W [n, heads * dp]
// (dp = 32 head_steps), `plan` sm90_gemm_plan's of [rows, n, heads * dp]
// int8, checked; rows are images of t. Returns a cudaError_t.
template <class Epi>
int launch_gemm_heads(const int* plan, const int8_t* a, const int8_t* w,
                      int rows, int n, int heads, int head_steps, int t,
                      Epi epi, cudaStream_t stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[5], plan[6], plan[7], plan[8]};
  const int k = heads * head_steps * 32;
  if (!plan_ok(p, true, rows, n, k, 1) || head_steps < 1 || t < 1 ||
      rows % t != 0 ||
      ((p.block_m + t - 1) / t + 1) * heads * 4 > kColBytes ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int current = sm90::make_current(a);
  if (current != 0) return current;
  CUtensorMap maps[2];
  int err = sm90::encode_map_2d(&maps[0], a, 1, rows, k, k, p.block_m);
  if (err != 0) return err;
  err = sm90::encode_map_2d(&maps[1], w, 1, n, k, k, p.block_n);
  if (err != 0) return err;
  if (p.block_m == 128) {
    return p.block_n == 128
               ? launch_heads_as<128, 2>(p, maps, rows, n, heads, head_steps,
                                         t, epi, stream)
               : launch_heads_as<64, 2>(p, maps, rows, n, heads, head_steps,
                                        t, epi, stream);
  }
  return p.block_n == 128
             ? launch_heads_as<128, 1>(p, maps, rows, n, heads, head_steps, t,
                                       epi, stream)
             : launch_heads_as<64, 1>(p, maps, rows, n, heads, head_steps, t,
                                      epi, stream);
}

// ---- epilogues shared by the blocks ---------------------------------------
// out = bf16((float(x) + sum) + bias[col]), x the residual stream [rows, n]
// in its type (K3's, K8's and K10's to_out)
template <typename T>
struct ResidualEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 1;  // bias
  static constexpr int kIntCols = 0;
  using RowPre = NoPre;
  using Pre = typename PairOf<T>::type;  // x
  const T* x;
  const float* bias;
  __nv_bfloat16* out;
  int n;
  __device__ float col_value(int, int col) const { return __ldg(bias + col); }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int row, int col) const {
    return ldg_pair(x + static_cast<long long>(row) * n + col);
  }
  __device__ void operator()(int row, int col, const float2* cv,
                             const int2*, const RowPre&, const Pre& xv,
                             float s0, float s1) const {
    const float2 xf = to_f2(xv);
    *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * n +
                                 col) =
        sm90::pack_bf16((xf.x + s0) + cv[0].x, (xf.y + s1) + cv[0].y);
  }
};

}  // namespace gemm90
