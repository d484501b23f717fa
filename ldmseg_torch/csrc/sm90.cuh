// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tile loads
// through a tensor map (and the maps' encoding on the host), bulk copies,
// threads' stores into a swizzled tile, and warpgroup matrix products
// (wgmma) on bf16 with fp32 sums and on int8 with int32 sums. Used by
// attention_sm90.cuh (the forward skeleton of K1, K14, K16's, K3's and
// K13's attention stage), attention_bwd.cu (K2) and gemm_sm90.cuh (the
// products of K3, K4, K8-K12 and K16-K18).
//
// Shared-memory operands of wgmma are described by a 64-bit descriptor. The
// tiles here are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes: rows
// of 64 bf16 (128 bytes), swizzled in atoms of 8 rows (1,024 bytes), each
// tile 1,024-byte aligned. Read that way:
//   * K-major (the depth contiguous: Q and K for S = Q K^T): 8-row groups
//     1,024 bytes apart (the stride offset); a k16 step moves the start 32
//     bytes along the row, a 64-deep chunk to the next tile;
//   * MN-major (the output column contiguous: V for O = P V, "transposed"):
//     8-deep groups 1,024 bytes apart (the stride offset), 64-column chunks
//     `chunk_bytes` apart (the leading offset).
// An int8 tile has the same byte geometry: a swizzled row holds 128 int8, a
// k32 step of the int8 product moves 32 bytes along it, as a bf16 k16 step
// does. The int8 product takes its shared-memory operands K-major only (the
// PTX ISA has no transposed 8-bit operand); every int8 operand here is
// K-major, V of K13's e8 V product too (stored transposed, keys contiguous).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block
constexpr int kRowBytes = 128;      // a swizzle row: a TMA box's row
constexpr int kProducerRegs = 24;   // a producer warpgroup under setmaxnreg

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// --- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// a stage of a ring of `stages` buffers and the parity of its current
// round, advanced without a division
struct Slot {
  uint32_t stage = 0, phase = 0;
  __device__ void next(int stages) {
    if (++stage == static_cast<uint32_t>(stages)) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// wait until the phase of parity `parity` has completed; a wait that
// never ends (a lost copy, a miscounted arrival) traps instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// --- TMA -------------------------------------------------------------------
// the box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at `dst`; completion counted in bytes on `bar`. Elements
// outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// the box of the 2-D `map` at (c0, c1), innermost first; as tma_load_4d
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the box of the 3-D `map` at (c0, c1, c2), innermost first; as tma_load_4d
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global `src` into shared memory at `dst`, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` from shared memory at `src` to global `dst` (kAdd: added to the
// fp32 values there, in L2); both 16-byte aligned, bytes a multiple of 16.
// Completion is tracked per thread by bulk_commit / bulk_wait.
template <bool kAdd>
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  if constexpr (kAdd) {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
        "[%1], %2;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
        "r"(src), "r"(bytes)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            reinterpret_cast<uint64_t>(dst)),
        "r"(src), "r"(bytes)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every bulk store this thread committed has completed (its writes made)
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// --- threads' own stores into a swizzled operand ---------------------------
// The byte offset of (row, 16-byte unit `unit`) in a tile of 128-byte rows
// with the 128-byte swizzle (the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B, the tile 1,024-byte aligned): the unit's
// index is XORed with the row's index within its 8-row atom.
__device__ __forceinline__ uint32_t sw128(int row, int unit) {
  return static_cast<uint32_t>(row * 128 + ((unit ^ (row & 7)) << 4));
}

// a 4-byte value at (row, column `col`) of a 64-column bf16 tile at shared
// address `tile`, in the 128-byte swizzle; col even
__device__ __forceinline__ void store_sw128(uint32_t tile, int row, int col,
                                            uint32_t value) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                   tile + sw128(row, col >> 3) + ((col & 7) << 1)),
               "r"(value)
               : "memory");
}

// make the threads' own shared-memory stores visible to wgmma and TMA (the
// async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// order this thread's accesses of every state space between the generic
// and the async proxy (bulk stores to global memory and flags around them)
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// --- named barriers (0 is __syncthreads') ---------------------------------
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- registers of a warpgroup ----------------------------------------------
template <int kRegs>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// --- wgmma -----------------------------------------------------------------
// descriptor of a 128-byte-swizzled operand starting at shared address
// `addr`; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t leading,
                                               uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((leading >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keep the compiler from moving reads or writes of a product's registers
// (its accumulators, or A operand) across the asynchronous product
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void fence_regs(int (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// m64nNk16, bf16 in, fp32 accumulators d[N / 2] per thread. The warp w of
// the warpgroup owns rows 16w + lane / 4 and 16w + lane / 4 + 8; d[4j + 0,
// 1] are the first row at columns 8j + 2 (lane % 4) + {0, 1}, d[4j + 2, 3]
// the second. `accumulate` 0 overwrites d.
//   WgmmaSs<N>::ss: A (64 x 16) and B (16 x N) both K-major in shared memory.
//   WgmmaRs<N>::rs: A from registers (a[0..3]: the bf16 pairs of rows lane/4
//     and lane/4 + 8 at depth 2 (lane % 4) and 8 + 2 (lane % 4), the layout
//     of d above for a 16-column slice), B MN-major in shared memory.
//   WgmmaSsT<N>::ss: A and B both MN-major in shared memory (the backward's
//     dQ = dS K, with dS stored as dS^T by store_sw128 and K as loaded).
//   WgmmaSsAT<N>::ss: A MN-major, B K-major in shared memory (gemm_sm90.cuh
//     on a channel-major A: K8's proj_in prologue on the GroupNorm's NCHW
//     output, tokens contiguous).
//   WgmmaS8<N>::ss: m64nNk32, int8 A (64 x 32) and B (32 x N) both K-major
//     in shared memory, int32 sums d[N / 2] in the layout of d above.
//   WgmmaRsS8<N>::rs: m64nNk32, int8 A from registers (a[0..3], 4 int8 each,
//     byte 0 the lowest depth: rows lane/4 and lane/4 + 8 at depth
//     4 (lane % 4) + 0..3, then the same two rows at 16 + 4 (lane % 4) +
//     0..3), B K-major in shared memory (the only 8-bit B the PTX ISA
//     has), int32 sums; N is one of the .s8 shapes (above 24 a multiple of
//     16: 48, not 40).
template <int kN>
struct WgmmaSs;
template <int kN>
struct WgmmaS8;
template <int kN>
struct WgmmaRsS8;
template <int kN>
struct WgmmaRs;
template <int kN>
struct WgmmaSsT;
template <int kN>
struct WgmmaSsAT;

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <>
struct WgmmaSs<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct WgmmaSs<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28), F4(d, 32), F4(d, 36), F4(d, 40), F4(d, 44),
          F4(d, 48), F4(d, 52), F4(d, 56), F4(d, 60)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaRs<16> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRs<32> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRs<40> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19"
        "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRs<64> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRs<80> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28), F4(d, 32), F4(d, 36)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRs<128> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28), F4(d, 32), F4(d, 36), F4(d, 40), F4(d, 44),
          F4(d, 48), F4(d, 52), F4(d, 56), F4(d, 60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRs<160> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28), F4(d, 32), F4(d, 36), F4(d, 40), F4(d, 44),
          F4(d, 48), F4(d, 52), F4(d, 56), F4(d, 60), F4(d, 64), F4(d, 68),
          F4(d, 72), F4(d, 76)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct WgmmaSsT<16> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct WgmmaSsT<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct WgmmaSsT<40> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19"
        "}, %20, %21, p, 1, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct WgmmaSsT<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaSsAT<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct WgmmaSsAT<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20),
          F4(d, 24), F4(d, 28), F4(d, 32), F4(d, 36), F4(d, 40), F4(d, 44),
          F4(d, 48), F4(d, 52), F4(d, 56), F4(d, 60)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

#define R4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void ss(int* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12), R4(d, 16), R4(d, 20),
          R4(d, 24), R4(d, 28)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void ss(int* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12), R4(d, 16), R4(d, 20),
          R4(d, 24), R4(d, 28), R4(d, 32), R4(d, 36), R4(d, 40), R4(d, 44),
          R4(d, 48), R4(d, 52), R4(d, 56), R4(d, 60)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaRsS8<16> {
  static __device__ __forceinline__ void rs(int* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : R4(d, 0), R4(d, 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRsS8<32> {
  static __device__ __forceinline__ void rs(int* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRsS8<48> {
  static __device__ __forceinline__ void rs(int* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p;\n}\n"
        : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12), R4(d, 16), R4(d, 20)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRsS8<64> {
  static __device__ __forceinline__ void rs(int* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12), R4(d, 16), R4(d, 20), R4(d, 24), R4(d, 28)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRsS8<80> {
  static __device__ __forceinline__ void rs(int* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p;\n}\n"
        : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12), R4(d, 16), R4(d, 20), R4(d, 24), R4(d, 28), R4(d, 32), R4(d, 36)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRsS8<128> {
  static __device__ __forceinline__ void rs(int* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12), R4(d, 16), R4(d, 20), R4(d, 24), R4(d, 28), R4(d, 32), R4(d, 36), R4(d, 40), R4(d, 44), R4(d, 48), R4(d, 52), R4(d, 56), R4(d, 60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};
template <>
struct WgmmaRsS8<160> {
  static __device__ __forceinline__ void rs(int* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p;\n}\n"
        : R4(d, 0), R4(d, 4), R4(d, 8), R4(d, 12), R4(d, 16), R4(d, 20), R4(d, 24), R4(d, 28), R4(d, 32), R4(d, 36), R4(d, 40), R4(d, 44), R4(d, 48), R4(d, 52), R4(d, 56), R4(d, 60), R4(d, 64), R4(d, 68), R4(d, 72), R4(d, 76)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};


#undef R4
#undef F4

// both operands K-major in shared memory: bf16 m64nNk16 into fp32 (kS8
// false) or int8 m64nNk32 into int32; either step is 32 bytes deep
template <bool kS8, int kN>
struct WgmmaK;
template <int kN>
struct WgmmaK<false, kN> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    WgmmaSs<kN>::ss(d, a, b, accumulate);
  }
};
template <int kN>
struct WgmmaK<true, kN> {
  static __device__ __forceinline__ void ss(int* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    WgmmaS8<kN>::ss(d, a, b, accumulate);
  }
};

// --- tensor maps (host) ----------------------------------------------------
// Make the primary context of the device that holds `ptr` current to the
// calling thread. The driver's tensor-map encoder needs a current context,
// and a thread that has made no CUDA call yet (autograd's worker thread
// running a backward, say) has none. Returns a cudaError_t.
inline int make_current(const void* ptr) {
  cudaPointerAttributes at;
  cudaError_t err = cudaPointerGetAttributes(&at, ptr);
  if (err == cudaSuccess) err = cudaSetDevice(at.device);
  return static_cast<int>(err);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// a 4-D map over (D, H, T, B) of a bf16 [B, T, H, D] tensor with element
// strides st = (b, t, h); boxes of 64 columns x `rows` tokens
inline int encode_map(CUtensorMap* map, const void* ptr, int batch, int t,
                      int heads, int d, const long long* st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a 4-D map over (D, H, T, B) of an int8 [B, T, H, dp] tensor (K3's
// head-padded q8 and k8: element strides (T H dp, H dp, dp), bytes here);
// the map's D is the head dim d <= dp, so TMA writes zeros past d whatever
// the padding holds; boxes of 128 columns (one swizzle row) x `rows` tokens.
// CU_TENSOR_MAP_DATA_TYPE_UINT8: there is no signed 8-bit type, and the bits
// are the same.
inline int encode_map_s8(CUtensorMap* map, const void* ptr, int batch, int t,
                         int heads, int d, int dp, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(dp),
      static_cast<cuuint64_t>(dp) * heads,
      static_cast<cuuint64_t>(dp) * heads * t};
  const cuuint32_t box[4] = {128, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a 4-D map over (T, D, H, B) of K13's transposed int8 values v8t [B, H,
// d, tp] (keys contiguous, tp a multiple of 16): element strides (tp,
// d tp, H d tp), bytes here; boxes of 128 keys (one swizzle row) x `rows`
// head columns, zeros past tp and d
inline int encode_map_s8t(CUtensorMap* map, const void* ptr, int batch,
                          int tp, int heads, int d, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(tp),
                              static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(tp), static_cast<cuuint64_t>(tp) * d,
      static_cast<cuuint64_t>(tp) * d * heads};
  const cuuint32_t box[4] = {128, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a 2-D map over a row-major [rows, cols] matrix of int8 (esize 1) or bf16
// (esize 2) with rows `ld` elements apart; boxes of one 128-byte swizzle
// row (128 int8 or 64 bf16) x `box_rows` rows, zeros past the edges
inline int encode_map_2d(CUtensorMap* map, const void* ptr, int esize,
                         long long rows, long long cols, long long ld,
                         int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map,
      esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a 3-D map over (T, K, B) of a bf16 channel-major [B, K, T] tensor (a
// GroupNorm's NCHW output: tokens contiguous, T a multiple of 8 so that the
// strides are multiples of 16 bytes); boxes of 64 tokens (one 128-byte
// swizzle row) x 64 channels x 1 image, zeros past T and K: a 64-row
// MN-major A operand one swizzle row deep
inline int encode_map_cm(CUtensorMap* map, const void* ptr, int batch, int k,
                         int t) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(t) * 2,
                                 static_cast<cuuint64_t>(t) * k * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
