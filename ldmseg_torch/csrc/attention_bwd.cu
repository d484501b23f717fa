// K2 on Hopper: the UNet self-attention backward. From q, k, v and dO
// ([B, T, H, D]) it computes
//
//   P  = softmax(Q K^T * scale)        (fp32, row max subtracted)
//   dV = P^T dO                        (P rounded to the input dtype)
//   dP = dO V^T
//   dS = P o (dP - rowsum(dP o P))     (fp32, rounded to the input dtype
//                                       only as a product operand)
//   dQ = dS K * scale,  dK = dS^T Q * scale
//
// Replaces the TPU kernel ldmseg_tpu/ops/pallas/attention.py:_attn_bwd_kernel
// (pallas_call in _flash_bwd, the custom_vjp backward of
// _fused_self_attention_flat). Same rounding points: S, the softmax and the
// dS algebra in fp32; P and dS rounded to the input dtype only where they
// enter a product; every product accumulated in fp32; dQ, dK and dV stored in
// the input dtype. delta = rowsum(dP o P) is computed from dP and the fp32 P,
// as the TPU kernel does, not as rowsum(dO o O) from the forward's output.
//
// What bounds it on an H100. The five products owed are 10*BH*T^2*D
// operations against 7*BH*T*D*2 bytes in and out; at the training path's
// largest shape (B*H = 64, T = 1920, D = 40) that is ~94 GFLOP (~95 us at
// 989 TFLOP/s) against ~69 MB (~21 us at 3.35 TB/s): the tensor cores, on
// paper. This design runs seven products (the stats pass's two again), D
// padded to the next 16 as a depth and to a compiled class as an N, and
// 2 * BH * T^2 exponentials (~32 us on the SFU at that shape). On the card
// neither binds the main kernel: without its products, or without its
// exponentials, it runs about as long (tools/ablate_attention_bwd.py).
// Each consumer warpgroup runs its steps per query tile (scores, softmax
// algebra, dV and dK, dS's store, dQ, dQ's hand-off) one after the other,
// and its two warpgroups overlap them only in part; the registers (dK and
// dV stay in them) allow two per block up to D = 80 (232 a consumer thread
// under setmaxnreg), one above. Issuing the next tile's scores before this
// tile's dQ is written out was tried and is slower (the registers spill).
//
// bf16 design (two kernels on the stream, TMA + wgmma; the launch plan --
// tiles, ring depths, register split, shared memory, grids -- is chosen by
// ops/attention.py:sm90_bwd_launch_plan and checked here):
//   1. attention_bwd_stats_kernel, one block per (b*h, 64 or 128 queries):
//      a producer warpgroup streams K and V tiles through a TMA ring; each
//      consumer warpgroup (64 query rows) computes S = Q K^T and dP = dO V^T
//      (wgmma, both operands K-major) and keeps, per row, the running max
//      m of s*c (c = scale * log2 e), the running sum l of 2^(s c - m) and
//      the running a = sum 2^(s c - m) * dP, both rescaled whenever m grows.
//      It writes (m, 1 / l, delta = a / l) per 64-query tile to the stats
//      scratch (rows past T: (0, 0, 0), so that their P is 0), and zeroes
//      the tile's dQ counter. Two products where the old design had three.
//   2. attention_bwd_main_kernel, one block per (b*h, 64 or 128 keys): the
//      block loads its K and V tiles once; a TMA ring streams Q, dO and the
//      stats of every 64-query tile; each consumer warpgroup owns 64 keys:
//        S^T = K Q^T, dP^T = V dO^T             (SS, K-major)
//        P^T = 2^(s^T c - m) * (1 / l)          (fp32; keys past T 0)
//        dS^T = P^T o (dP^T - delta)            (fp32)
//        dV += P^T dO, dK += dS^T Q             (RS: P^T, dS^T rounded to
//                                                bf16 in registers; dO, Q
//                                                the MN-major B)
//        dQ_part = dS K                         (SS: dS^T stored by the
//                                                threads into a 128-byte-
//                                                swizzled tile, read as an
//                                                MN-major A; K MN-major B;
//                                                in chunks of <= 64 columns)
//      dK and dV stay in fp32 registers across the query loop and are
//      scaled and rounded once. Five products per (query tile, key tile).
//   3. dQ across key blocks, deterministic (two calls give the same bits;
//      no unordered atomics): an fp32 workspace [B*H, T rounded up to 64,
//      D] and an int32 counter per (b*h, 64-query tile). A block adds its
//      warpgroups' partials of a query tile (from fp32 tiles in shared
//      memory), warpgroup 0's first, with a bulk copy (rank 0) or bulk adds
//      in L2 from a reducer thread of the producer warpgroup, after the
//      counter reads the block's rank (a bounded wait that traps); the
//      copies done, it raises the counter. The block of the last rank
//      converts the tile's sum to bf16 dQ after its query loop.
//      Blocks of one b*h start their query loops at staggered tiles (block
//      x at tile kWG * x) so that they do not queue behind each other; the
//      ranks follow the order in which they reach a tile (above kMaxRotate
//      key blocks every block starts at tile 0 and the rank is its index).
//      Neither a reducer nor a consumer waits for a turn while it holds a
//      partial that another block waits for.
//   4. D (8..160) is zero-filled by TMA to 64-column boxes; the products run
//      at depth D rounded up to 16 and at N = D's class (16, 32, 40, 64,
//      80, 128, 160). Query rows past T are zero-filled and get P = 0 from
//      their stats; keys past T are masked to P = 0; stores are masked.
//      Inputs are read through 4-D tensor maps over the caller's strides
//      (K14's and K16's head views of [B, T, C] in place).
//
// fp32 (a test and check path, on no training path) keeps the plain SIMT
// kernels: attention_bwd_dq_kernel_f32 (per query tile: the row statistics,
// delta and dQ in three passes) and attention_bwd_dkv_kernel_f32 (per key
// tile: dK and dV), FMA loops on 32-row tiles through shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxD = 160;

struct Strides {
  long long b, t, h;  // element strides of the B, T and H axes (D is 1)
};

// ---------------------------------------------------------------------------
// fp32: plain SIMT
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;  // 8 warps
constexpr int kB = 32;         // rows of a query or key tile
constexpr int kLds = kB + 4;   // score row stride
constexpr int kLdp = kB + 8;   // dS / P row stride

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory layout of both kernels for one head dim. Strides in
// elements: tiles [kB][ld], scores [kB][kLds], P / dS [kB][kLdp],
// accumulators [kB][lda].
struct Plan32 {
  int d, dp, ld, lda;
  __host__ __device__ explicit Plan32(int d_)
      : d(d_), dp((d_ + 15) & ~15), ld(((d_ + 15) & ~15) + 8),
        lda(((d_ + 15) & ~15) + 4) {}
  __host__ __device__ size_t tile() const { return align128(size_t(kB) * ld * 4); }
  __host__ __device__ size_t score() const { return align128(size_t(kB) * kLds * 4); }
  __host__ __device__ size_t operand() const { return align128(size_t(kB) * kLdp * 4); }
  __host__ __device__ size_t acc() const { return align128(size_t(kB) * lda * 4); }
  __host__ __device__ size_t stats() const { return align128(3 * kB * 4); }
  // kernel 1: Q, dO, K, V tiles, S and dP, dS, dQ
  __host__ __device__ size_t dq_bytes() const { return 4 * tile() + 2 * score() + operand() + acc(); }
  // kernel 2: K, V, Q, dO tiles, S^T and dP^T, P^T and dS^T, dK and dV, stats
  __host__ __device__ size_t dkv_bytes() const {
    return 4 * tile() + 2 * score() + 2 * operand() + 2 * acc() + stats();
  }
};

__device__ __forceinline__ float* carve(unsigned char*& ptr, size_t bytes) {
  float* out = reinterpret_cast<float*>(ptr);
  ptr += bytes;
  return out;
}

// Rows [row0, row0 + kB) of one (b, h) slice into shared memory [kB][ld],
// columns [0, d); rows at or past t are zero-filled. 16-byte vectors: the
// wrapper checks that d and the strides are multiples of 8 elements and that
// the base pointers are 16-byte aligned.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long st, int row0, int t,
                                          int d) {
  const int vecs = d / 4;
  for (int i = threadIdx.x; i < kB * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t) {
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * st + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// Columns [d, dp) of a [kB][ld] tile to zero: loads never write them, and
// the padded products read them.
__device__ __forceinline__ void zero_pad(float* tile, int ld, int d, int dp) {
  const int pad = dp - d;
  for (int i = threadIdx.x; i < kB * pad; i += kThreads) {
    const int r = i / pad;
    tile[r * ld + d + (i - r * pad)] = 0.f;
  }
}

__device__ __forceinline__ void zero_acc(float* acc, int lda) {
  for (int i = threadIdx.x; i < kB * lda; i += kThreads) acc[i] = 0.f;
}

// C[M x N] (row-major, ldc) = (kAcc: +=) A[M x K] B[K x N], one thread per
// output element. A is row-major [M][lda], or with kTA its transpose stored
// [K][lda]; B is row-major [K][ldb], or with kTB its transpose stored
// [N][ldb].
template <bool kTA, bool kTB, bool kAcc>
__device__ __forceinline__ void gemm(const float* A, int lda, const float* B,
                                     int ldb, float* C, int ldc, int M, int N,
                                     int K) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int r = i / N;
    const int c = i - r * N;
    float s = kAcc ? C[r * ldc + c] : 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float a = kTA ? A[kk * lda + r] : A[r * lda + kk];
      const float b = kTB ? B[c * ldb + kk] : B[kk * ldb + c];
      s = fmaf(a, b, s);
    }
    C[r * ldc + c] = s;
  }
}

// max / sum over the kTpr neighbouring lanes that share one query row
template <int kTpr>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < kTpr; o <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
template <int kTpr>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < kTpr; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Kernel 1: per (b*h, query tile) the row statistics (m, l, delta) into
// stats, then dQ.
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel_f32(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                float* __restrict__ dq,
                                float* __restrict__ stats, int heads, int t,
                                int d, Strides sq, Strides sk, Strides sv,
                                Strides sdo, Strides sdq, float scale) {
  constexpr int kTpr = kThreads / kB;  // threads per query row
  constexpr int kCols = kB / kTpr;     // score columns per thread
  const Plan32 pl(d);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  float* Qs = carve(ptr, pl.tile());
  float* dOs = carve(ptr, pl.tile());
  float* Ks = carve(ptr, pl.tile());
  float* Vs = carve(ptr, pl.tile());
  float* Ss = carve(ptr, pl.score());
  float* dPs = carve(ptr, pl.score());
  float* dSs = carve(ptr, pl.operand());
  float* dQacc = carve(ptr, pl.acc());

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kB;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;

  zero_pad(Qs, pl.ld, d, pl.dp);
  zero_pad(dOs, pl.ld, d, pl.dp);
  zero_pad(Ks, pl.ld, d, pl.dp);
  zero_pad(Vs, pl.ld, d, pl.dp);
  zero_acc(dQacc, pl.lda);
  load_tile(Qs, pl.ld, qb, sq.t, q0, t, d);
  load_tile(dOs, pl.ld, dob, sdo.t, q0, t, d);

  const int row = threadIdx.x / kTpr;
  const int sub = threadIdx.x - row * kTpr;  // columns sub, sub + kTpr, ...

  // pass 1: row max and row sum of exp(s - max)
  float m_run = -INFINITY;
  float l_run = 0.f;
  for (int k0 = 0; k0 < t; k0 += kB) {
    __syncthreads();
    load_tile(Ks, pl.ld, kb, sk.t, k0, t, d);
    __syncthreads();
    gemm<false, true, false>(Qs, pl.ld, Ks, pl.ld, Ss, kLds, kB, kB, pl.dp);
    __syncthreads();
    float s[kCols];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + kTpr * j;
      s[j] = (k0 + c < t) ? Ss[row * kLds + c] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_run, group_max<kTpr>(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) sum += expf(s[j] - m_new);
    l_run = l_run * expf(m_run - m_new) + group_sum<kTpr>(sum);
    m_run = m_new;
  }

  // pass 2: delta = rowsum(dP o P), P in fp32
  float delta = 0.f;
  for (int k0 = 0; k0 < t; k0 += kB) {
    __syncthreads();
    load_tile(Ks, pl.ld, kb, sk.t, k0, t, d);
    load_tile(Vs, pl.ld, vb, sv.t, k0, t, d);
    __syncthreads();
    gemm<false, true, false>(Qs, pl.ld, Ks, pl.ld, Ss, kLds, kB, kB, pl.dp);
    gemm<false, true, false>(dOs, pl.ld, Vs, pl.ld, dPs, kLds, kB, kB, pl.dp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + kTpr * j;
      if (k0 + c < t) {
        const float p = expf(Ss[row * kLds + c] * scale - m_run) / l_run;
        delta += p * dPs[row * kLds + c];
      }
    }
  }
  delta = group_sum<kTpr>(delta);
  const long long n = static_cast<long long>(gridDim.y) * t;
  if (sub == 0 && q0 + row < t) {
    const long long i = static_cast<long long>(bh) * t + q0 + row;
    stats[i] = m_run;
    stats[n + i] = l_run;
    stats[2 * n + i] = delta;
  }

  // pass 3: dS = P o (dP - delta), dQ += dS K
  for (int k0 = 0; k0 < t; k0 += kB) {
    __syncthreads();
    load_tile(Ks, pl.ld, kb, sk.t, k0, t, d);
    load_tile(Vs, pl.ld, vb, sv.t, k0, t, d);
    __syncthreads();
    gemm<false, true, false>(Qs, pl.ld, Ks, pl.ld, Ss, kLds, kB, kB, pl.dp);
    gemm<false, true, false>(dOs, pl.ld, Vs, pl.ld, dPs, kLds, kB, kB, pl.dp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + kTpr * j;
      float ds = 0.f;
      if (k0 + c < t) {
        const float p = expf(Ss[row * kLds + c] * scale - m_run) / l_run;
        ds = p * (dPs[row * kLds + c] - delta);
      }
      dSs[row * kLdp + c] = ds;
    }
    __syncthreads();
    gemm<false, false, true>(dSs, kLdp, Ks, pl.ld, dQacc, pl.lda, kB, pl.dp, kB);
  }
  __syncthreads();

  float* dqb = dq + b * sdq.b + h * sdq.h;
  for (int i = threadIdx.x; i < kB * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    if (q0 + r < t) dqb[(q0 + r) * sdq.t + c] = dQacc[r * pl.lda + c] * scale;
  }
}

// Kernel 2: per (b*h, key tile) dK and dV over all query tiles, from the
// statistics kernel 1 wrote.
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel_f32(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv,
                                 const float* __restrict__ stats, int heads,
                                 int t, int d, Strides sq, Strides sk,
                                 Strides sv, Strides sdo, Strides sdk,
                                 Strides sdv, float scale) {
  const Plan32 pl(d);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  float* Ks = carve(ptr, pl.tile());
  float* Vs = carve(ptr, pl.tile());
  float* Qs = carve(ptr, pl.tile());
  float* dOs = carve(ptr, pl.tile());
  float* Ss = carve(ptr, pl.score());   // S^T [key][query]
  float* dPs = carve(ptr, pl.score());  // dP^T
  float* Ps = carve(ptr, pl.operand());   // P^T
  float* dSs = carve(ptr, pl.operand());  // dS^T
  float* dKacc = carve(ptr, pl.acc());
  float* dVacc = carve(ptr, pl.acc());
  float* Ms = carve(ptr, pl.stats());
  float* Ls = Ms + kB;
  float* Ds = Ls + kB;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * kB;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const long long n = static_cast<long long>(gridDim.y) * t;
  const float* mb = stats + static_cast<long long>(bh) * t;

  zero_pad(Ks, pl.ld, d, pl.dp);
  zero_pad(Vs, pl.ld, d, pl.dp);
  zero_pad(Qs, pl.ld, d, pl.dp);
  zero_pad(dOs, pl.ld, d, pl.dp);
  zero_acc(dKacc, pl.lda);
  zero_acc(dVacc, pl.lda);
  load_tile(Ks, pl.ld, k + b * sk.b + h * sk.h, sk.t, k0, t, d);
  load_tile(Vs, pl.ld, v + b * sv.b + h * sv.h, sv.t, k0, t, d);

  for (int q0 = 0; q0 < t; q0 += kB) {
    __syncthreads();
    load_tile(Qs, pl.ld, qb, sq.t, q0, t, d);
    load_tile(dOs, pl.ld, dob, sdo.t, q0, t, d);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      const bool ok = q0 + i < t;
      Ms[i] = ok ? mb[q0 + i] : 0.f;
      Ls[i] = ok ? mb[n + q0 + i] : 1.f;
      Ds[i] = ok ? mb[2 * n + q0 + i] : 0.f;
    }
    __syncthreads();
    gemm<false, true, false>(Ks, pl.ld, Qs, pl.ld, Ss, kLds, kB, kB, pl.dp);
    gemm<false, true, false>(Vs, pl.ld, dOs, pl.ld, dPs, kLds, kB, kB, pl.dp);
    __syncthreads();
    for (int i = threadIdx.x; i < kB * kB; i += kThreads) {
      const int r = i / kB;      // key
      const int c = i - r * kB;  // query
      float p = 0.f;
      if (q0 + c < t) p = expf(Ss[r * kLds + c] * scale - Ms[c]) / Ls[c];
      Ps[r * kLdp + c] = p;
      dSs[r * kLdp + c] = p * (dPs[r * kLds + c] - Ds[c]);
    }
    __syncthreads();
    gemm<false, false, true>(Ps, kLdp, dOs, pl.ld, dVacc, pl.lda, kB, pl.dp, kB);
    gemm<false, false, true>(dSs, kLdp, Qs, pl.ld, dKacc, pl.lda, kB, pl.dp, kB);
  }
  __syncthreads();

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
  for (int i = threadIdx.x; i < kB * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    if (k0 + r < t) {
      dkb[(k0 + r) * sdk.t + c] = dKacc[r * pl.lda + c] * scale;
      dvb[(k0 + r) * sdv.t + c] = dVacc[r * pl.lda + c];
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int batch, int t,
               int heads, int d, const long long* st, float scale,
               cudaStream_t stream) {
  const Plan32 pl(d);
  const size_t dq_smem = pl.dq_bytes();
  const size_t dkv_smem = pl.dkv_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]},
      sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const dim3 grid((t + kB - 1) / kB, batch * heads);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  attention_bwd_dq_kernel_f32<<<grid, kThreads, dq_smem, stream>>>(
      qt, kt, vt, dot, static_cast<float*>(dq), stats, heads, t, d, sq, sk,
      sv, sdo, sdq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel_f32<<<grid, kThreads, dkv_smem, stream>>>(
      qt, kt, vt, dot, static_cast<float*>(dk), static_cast<float*>(dv),
      stats, heads, t, d, sq, sk, sv, sdo, sdk, sdv, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------
constexpr int kBox = 64;            // columns of a TMA box: one swizzled row
constexpr int kRowBytes = 128;      // bytes of a box row
constexpr int kBoxBytes = 64 * kRowBytes;  // a box of 64 rows
constexpr int kStatsBytes = 3 * 64 * 4;    // (m, 1 / l, delta) of 64 queries
constexpr int kSmemLimit = 232448;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;  // the TMA thread and the dQ reducers
constexpr int kMaxRotate = 32;  // key blocks per b*h up to which starts rotate
constexpr float kLog2e = 1.4426950408889634f;

// The launch plan as ops/attention.py:sm90_bwd_launch_plan lays it out
struct BwdPlan {
  int head_class;     // N of dV, dK (and of dQ in chunks of <= 64)
  int chunks;         // 64-column boxes across D
  int q_tiles;        // 64-query tiles: ceil(t / 64)
  int stats_block_q;  // query rows per stats block, 64 per warpgroup
  int stats_block_k;  // keys per stats K/V tile
  int stats_stages;   // depth of the stats kernel's K/V ring
  int stats_regs;     // consumer registers (setmaxnreg; 0: none)
  int stats_smem;     // dynamic shared memory of the stats kernel
  int stats_grid_x;   // query blocks
  int main_block_k;   // keys per main block, 64 per warpgroup
  int main_stages;    // depth of the main kernel's Q/dO/stats ring
  int main_regs;      // consumer registers (setmaxnreg; 0: none)
  int main_smem;      // dynamic shared memory of the main kernel
  int main_grid_x;    // key blocks
  int grid_y;         // B * H
};

constexpr int kClasses[] = {16, 32, 40, 64, 80, 128, 160};

int head_class(int d) {
  for (int c : kClasses) {
    if (c >= d) return c;
  }
  return 0;
}

// 1,024 bytes of slack to align the swizzled tiles; Q and dO (a 64-row
// sub-tile per warpgroup); a K and a V tile per stage; the q barrier and a
// full and an empty barrier per stage
int stats_smem(int block_q, int block_k, int chunks, int stages) {
  return 1024 + 2 * block_q * chunks * kRowBytes +
         stages * 2 * block_k * chunks * kRowBytes + 8 * (1 + 2 * stages);
}

// slack; K and V (64 rows per warpgroup); dS^T per warpgroup; per stage a Q
// and a dO tile of 64 rows and the stats of 64 queries; the dQ tiles (one
// per dQ reducer, MainCfg::kDqBufs: three up to D = 64, two up to 80, else
// one), each an fp32 64 x D's class per warpgroup; the kv barrier, a full
// and an empty barrier per stage and per dQ tile
int main_smem(int block_k, int head_class, int chunks, int stages) {
  const int tiles = head_class <= 64 ? 3 : head_class <= 80 ? 2 : 1;
  return 1024 + 2 * block_k * chunks * kRowBytes +
         (block_k / 64) * kBoxBytes +
         stages * (2 * chunks * kBoxBytes + kStatsBytes) +
         tiles * (block_k / 64) * 64 * head_class * 4 +
         8 * (1 + 2 * stages + 2 * tiles);
}

bool plan_ok(const BwdPlan& p, int bh, int t, int d) {
  const int cls = head_class(d);
  const int chunks = (cls + kBox - 1) / kBox;
  const bool stats_ok =
      (p.stats_block_q == 64 || p.stats_block_q == 128) &&
      p.stats_block_k == (cls <= 80 ? 128 : 64) && p.stats_stages >= 2 &&
      p.stats_stages <= 8 &&
      p.stats_regs == (p.stats_block_q == 128 ? kConsumerRegs : 0) &&
      p.stats_smem == stats_smem(p.stats_block_q, p.stats_block_k, chunks,
                                 p.stats_stages) &&
      p.stats_smem <= kSmemLimit &&
      p.stats_grid_x == (t + p.stats_block_q - 1) / p.stats_block_q;
  const bool main_ok =
      (p.main_block_k == 64 || (p.main_block_k == 128 && cls <= 80)) &&
      p.main_stages >= 2 && p.main_stages <= 8 &&
      p.main_regs == (p.main_block_k == 128 ? kConsumerRegs : 0) &&
      p.main_smem == main_smem(p.main_block_k, cls, chunks, p.main_stages) &&
      p.main_smem <= kSmemLimit &&
      p.main_grid_x == (t + p.main_block_k - 1) / p.main_block_k;
  return cls != 0 && p.head_class == cls && p.chunks == chunks &&
         p.q_tiles == (t + 63) / 64 && stats_ok && main_ok &&
         p.grid_y == bh && bh >= 1 && bh <= 65535;
}

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

// K-major operand of a k16 step kk over a tile of `rows` rows whose
// 64-column boxes lie rows * 128 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
  return sm90::desc_sw128(tile + (kk / 4) * rows * kRowBytes + (kk % 4) * 32,
                          16, 1024);
}

// MN-major operand of a k16 step kk (16 rows of depth) over a tile of 64
// rows whose 64-column boxes lie kBoxBytes apart
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sm90::desc_sw128(tile + kk * 16 * kRowBytes, kBoxBytes, 1024);
}

// ---------------------------------------------------------------------------
// 1. the stats pass
// ---------------------------------------------------------------------------
template <int kDN, int kWG>
struct StatsCfg {
  static constexpr int kChunks = (kDN + kBox - 1) / kBox;
  static constexpr int kBK = kDN <= 80 ? 128 : 64;
  static constexpr int kS = kBK / 2;  // score registers per thread
  static constexpr int kSteps = (kDN + 15) / 16;  // k16 steps across D
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQSub = 64 * kChunks * kRowBytes;   // 64 rows of Q
  static constexpr int kTile = kBK * kChunks * kRowBytes;  // a K or V tile
};

// Shared memory, from a 1,024-byte aligned base: Q (one 64-row sub-tile per
// consumer warpgroup), dO (the same), then per stage a K and a V tile, then
// the barriers: q, full[stages], empty[stages].
template <int kDN, int kWG>
__global__ void __launch_bounds__(StatsCfg<kDN, kWG>::kThreads, 1)
    attention_bwd_stats_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               float* __restrict__ stats,
                               int* __restrict__ counters, int heads, int t,
                               int q_tiles, int stages, float c) {
  using C = StatsCfg<kDN, kWG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_smem = q_smem + kWG * C::kQSub;
  const uint32_t kv_smem = do_smem + kWG * C::kQSub;
  const uint32_t q_bar = kv_smem + 2 * stages * C::kTile;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * stages;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * 64 * kWG;
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

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kWG) {
    // producer warpgroup: one thread issues every copy
    if constexpr (kWG == 2) sm90::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kWG) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tdo);
      sm90::tma_prefetch_map(&tk);
      sm90::tma_prefetch_map(&tv);
      sm90::mbar_expect_tx(q_bar, 2 * kWG * C::kQSub);
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          const uint32_t off = w * C::kQSub + ch * kBoxBytes;
          sm90::tma_load_4d(q_smem + off, &tq, q_bar, ch * kBox, h,
                            q0 + 64 * w, b);
          sm90::tma_load_4d(do_smem + off, &tdo, q_bar, ch * kBox, h,
                            q0 + 64 * w, b);
        }
      }
      sm90::Slot slot;
      for (int kt = 0; kt < ntiles; ++kt, slot.next(stages)) {
        const uint32_t s = slot.stage;
        const uint32_t k_tile = kv_smem + 2 * s * C::kTile;
        sm90::mbar_wait(empty_bar + 8 * s, slot.phase ^ 1);
        sm90::mbar_expect_tx(full_bar + 8 * s, 2 * C::kTile);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          const uint32_t off = ch * C::kBK * kRowBytes;
          sm90::tma_load_4d(k_tile + off, &tk, full_bar + 8 * s, ch * kBox,
                            h, kt * C::kBK, b);
          sm90::tma_load_4d(k_tile + C::kTile + off, &tv, full_bar + 8 * s,
                            ch * kBox, h, kt * C::kBK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64)
  if constexpr (kWG == 2) sm90::regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int local = 16 * ((threadIdx.x % 128) / 32) + lane / 4;  // row 0 of 2
  const uint32_t q_sub = q_smem + wg * C::kQSub;
  const uint32_t do_sub = do_smem + wg * C::kQSub;
  const bool positive = c > 0.f;
  const float cs = positive ? c : 1.f;
  // rows local and local + 8: the running max of s c (log2 units), this
  // thread's shares of l = sum 2^(s c - m) and of a = sum 2^(s c - m) dP
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  sm90::mbar_wait(q_bar, 0);
  sm90::Slot slot;
  for (int kt = 0; kt < ntiles; ++kt) {
    sm90::mbar_wait(full_bar + 8 * slot.stage, slot.phase);
    const uint32_t k_tile = kv_smem + 2 * slot.stage * C::kTile;
    float s[C::kS], dp[C::kS];
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      sm90::WgmmaSs<C::kBK>::ss(s, kmajor(q_sub, 64, kk),
                                kmajor(k_tile, C::kBK, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      sm90::WgmmaSs<C::kBK>::ss(dp, kmajor(do_sub, 64, kk),
                                kmajor(k_tile + C::kTile, C::kBK, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if (lane == 0) sm90::mbar_arrive(empty_bar + 8 * slot.stage);
    slot.next(stages);

    // with c > 0 the max of s c is c times the max of s, and 2^(s c - m) is
    // one FMA and one exponential; c <= 0 scales first
    if (!positive) {
#pragma unroll
      for (int i = 0; i < C::kS; ++i) s[i] *= c;
    }
    if ((kt + 1) * C::kBK > t) {  // keys >= t: zero-filled rows
      const int key0 = kt * C::kBK + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < C::kS / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (key0 + 8 * j + (e & 1) >= t) s[4 * j + e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < C::kS; ++i) {
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every tile holds a key < t, so the new max is finite
      const float mn = fmaxf(m[r], quad_max(mx[r]) * cs);
      const float alpha = ex2(m[r] - mn);
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < C::kS / 4; ++j) {
        const float e0 = ex2(fmaf(s[4 * j + 2 * r], cs, -mn));
        const float e1 = ex2(fmaf(s[4 * j + 2 * r + 1], cs, -mn));
        sum += e0 + e1;
        dsum = fmaf(e0, dp[4 * j + 2 * r],
                    fmaf(e1, dp[4 * j + 2 * r + 1], dsum));
      }
      l[r] = fmaf(l[r], alpha, sum);
      a[r] = fmaf(a[r], alpha, dsum);
      m[r] = mn;
    }
  }

  const int tile = q0 / 64 + wg;
  if (tile >= q_tiles) return;
  float* st = stats + (static_cast<long long>(bh) * q_tiles + tile) * 192;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    const float at = quad_sum(a[r]);
    const int row = local + 8 * r;
    if (lane % 4 == 0) {
      const bool in = tile * 64 + row < t;
      // rows past t: m = 0 and 1 / l = 0 give them P = 0
      st[row] = in ? m[r] : 0.f;
      st[64 + row] = in ? 1.f / lt : 0.f;
      st[128 + row] = in ? at / lt : 0.f;
    }
  }
  if (threadIdx.x % 128 == 0) counters[bh * q_tiles + tile] = 0;
}

// ---------------------------------------------------------------------------
// 2. the main pass
// ---------------------------------------------------------------------------
template <int kDN, int kWG>
struct MainCfg {
  static constexpr int kChunks = (kDN + kBox - 1) / kBox;
  static constexpr int kSteps = (kDN + 15) / 16;  // k16 steps across D
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kTile = kChunks * kBoxBytes;  // 64 rows of a tensor
  // dQ's products: 64-column chunks of D's class, the last one narrower
  static constexpr int kDqChunks = (kDN + 63) / 64;
  // a warpgroup's fp32 dQ tile [64][d] (room for D's class); the block
  // holds one per warpgroup per dQ reducer: as many as shared memory
  // holds, up to three reducers
  static constexpr int kDqBytes = 64 * kDN * 4;
  static constexpr int kDqBufs = kDN <= 64 ? 3 : kDN <= 80 ? 2 : 1;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// wait until *counter reads `rank`; a wait that never ends traps
__device__ __forceinline__ void wait_rank(const int* counter, int rank) {
  for (uint32_t spins = 0; ld_acquire(counter) != rank; ++spins) {
    if (spins == (1u << 24)) __trap();
    __nanosleep(64);
  }
}

// the position of key block x among the key blocks that add to the dQ of
// query tile i: by the step at which each reaches tile i (block x' starts
// at tile o(x') = kWG x' when the starts rotate, else 0), then by index
template <int kWG>
__device__ __forceinline__ int dq_rank(int x, int i, int blocks, int q_tiles,
                                       bool rotate) {
  auto step = [&](int xx) {
    const int s = i - (rotate ? kWG * xx : 0);
    return s < 0 ? s + q_tiles : s;
  };
  const int mine = step(x);
  int before = 0;
  for (int xx = 0; xx < blocks; ++xx) {
    const int s = step(xx);
    before += (s < mine || (s == mine && xx < x)) ? 1 : 0;
  }
  return before;
}

// One consumer warpgroup of the main pass: 64 keys against every query
// tile of the ring.
template <int kDN, int kWG>
struct MainConsumer {
  using C = MainCfg<kDN, kWG>;
  uint32_t kw, vw, dsw;  // this warpgroup's K, V and dS^T tiles
  int t, d, key0, lane, wg;
  int local;  // the first of this thread's two rows of a 64-row tile
  float c;    // scale * log2(e)

  // S^T = K Q^T and dP^T = V dO^T of one query tile, issued
  __device__ __forceinline__ void issue_scores(uint32_t qt, uint32_t dot, float (&s)[32],
                               float (&dp)[32]) const {
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      sm90::WgmmaSs<64>::ss(s, kmajor(kw, 64, kk), kmajor(qt, 64, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      sm90::WgmmaSs<64>::ss(dp, kmajor(vw, 64, kk), kmajor(dot, 64, kk),
                            kk > 0);
    }
    sm90::wgmma_commit();
  }

  // P^T = 2^(s c - m) (1 / l) and dS^T = P^T (dP^T - delta) in fp32, each
  // rounded to bf16 pairs: p[4kk..4kk+3] (ds the same) is the A fragment of
  // the k16 step kk (queries 16kk..16kk+15). Keys >= t get P = 0; query
  // columns past t have 1 / l = 0.
  __device__ __forceinline__ void probs(const float* st, const float (&s)[32],
                        const float (&dp)[32], uint32_t (&p)[16],
                        uint32_t (&ds)[16]) const {
    const bool ragged = key0 + 64 > t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 mm = *reinterpret_cast<const float2*>(st + col);
      const float2 rl = *reinterpret_cast<const float2*>(st + 64 + col);
      const float2 dl = *reinterpret_cast<const float2*>(st + 128 + col);
      float pv[4], dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 1;
        const int i = 4 * j + e;
        float pe =
            ex2(fmaf(s[i], c, -(hi ? mm.y : mm.x))) * (hi ? rl.y : rl.x);
        if (ragged && key0 + local + 8 * (e >> 1) >= t) pe = 0.f;
        pv[e] = pe;
        dv[e] = pe * (dp[i] - (hi ? dl.y : dl.x));
      }
      p[2 * j] = pack_bf16(pv[0], pv[1]);
      p[2 * j + 1] = pack_bf16(pv[2], pv[3]);
      ds[2 * j] = pack_bf16(dv[0], dv[1]);
      ds[2 * j + 1] = pack_bf16(dv[2], dv[3]);
    }
  }

  // dV += P^T dO and dK += dS^T Q, issued
  __device__ __forceinline__ void grads(uint32_t qt, uint32_t dot, uint32_t (&p)[16],
                        uint32_t (&ds)[16], float (&dv)[kDN / 2],
                        float (&dk)[kDN / 2]) const {
    sm90::fence_regs(p);
    sm90::fence_regs(ds);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::WgmmaRs<kDN>::rs(dv, &p[4 * kk], mnmajor(dot, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::WgmmaRs<kDN>::rs(dk, &ds[4 * kk], mnmajor(qt, kk), 1);
    }
    sm90::wgmma_commit();
  }

  // dS^T into the warpgroup's swizzled tile: row = key, 64 query columns
  __device__ __forceinline__ void store_ds(const uint32_t (&ds)[16]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      sm90::store_sw128(dsw, local, col, ds[2 * j]);
      sm90::store_sw128(dsw, local + 8, col, ds[2 * j + 1]);
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(1 + wg, 128);
  }

  // D <= 80: dQ = dS K into one accumulator, in products of <= 64 columns,
  // issued (behind dV and dK)
  __device__ __forceinline__ void issue_dq(float (&acc)[kDN / 2]) const {
    constexpr int kN0 = kDN < 64 ? kDN : 64;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::WgmmaSsT<kN0>::ss(acc, mnmajor(dsw, kk), mnmajor(kw, kk), kk > 0);
    }
    if constexpr (kDN > 64) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::WgmmaSsT<kDN - 64>::ss(acc + 32, mnmajor(dsw, kk),
                                     mnmajor(kw + kBoxBytes, kk), kk > 0);
      }
    }
    sm90::wgmma_commit();
  }

  // This thread's share of dQ's columns [col0, col0 + 8 kGroups) of the
  // warpgroup's fp32 tile dqs [64][d], from acc
  template <int kGroups, int kN>
  __device__ __forceinline__ void write_dq(const float (&acc)[kN], int col0,
                                           float* dqs) const {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int col = col0 + 8 * j + 2 * (lane % 4);
      if (col >= d) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(dqs + (local + 8 * r) * d + col) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }

  // D > 80: dQ = dS K in products of <= 64 columns (chunk kC: columns
  // 64 kC ..), each issued, waited for and written as write_dq does
  template <int kC>
  __device__ __forceinline__ void dq_chunks(float* dqs) const {
    if constexpr (kC < C::kDqChunks) {
      constexpr int kN = (kDN - 64 * kC) < 64 ? (kDN - 64 * kC) : 64;
      float acc[kN / 2];
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::WgmmaSsT<kN>::ss(acc, mnmajor(dsw, kk),
                               mnmajor(kw + kC * kBoxBytes, kk), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      write_dq<kN / 8>(acc, 64 * kC, dqs);
      dq_chunks<kC + 1>(dqs);
    }
  }
};

// Shared memory, from a 1,024-byte aligned base: K and V (64 rows per
// consumer warpgroup), dS^T (one 64 x 64 tile per warpgroup), per stage a
// Q and a dO tile, per stage the stats of 64 queries, kDqBufs dQ tiles
// (each an fp32 [64][d] per warpgroup), then the barriers: kv,
// full[stages], empty[stages], and per dQ tile full and empty.
//
// dQ: each block adds one partial per query tile i to i's ordered sum, its
// consumer warpgroups' partials (warpgroup 0's first), from the dQ tile of
// its step n (tile n % kDqBufs). The producer warpgroup's warp 1 + r (lane
// 0) is the reducer of dQ tile r: for each partial in it, it waits for the
// query tile's counter to read the block's rank, bulk-stores the partial
// to the workspace (rank 0) or bulk-adds it there (in L2), one warpgroup's
// after the other, waits for the copies, frees the dQ tile and raises the
// counter. After its
// query loop the block converts the tiles whose sum it ended (the last
// rank) to bf16 dQ. A reducer holds no unfinished partial while it waits,
// and a consumer waits for no turn inside its loop, so every wait is for a
// partial of an earlier step (or of the same step and a lower block).
template <int kDN, int kWG>
__global__ void __launch_bounds__(MainCfg<kDN, kWG>::kThreads, 1)
    attention_bwd_main_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ stats,
                              float* __restrict__ ws,
                              int* __restrict__ counters,
                              __nv_bfloat16* __restrict__ dq,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, Strides sdq,
                              Strides sdk, Strides sdv, int heads, int t,
                              int d, int q_tiles, int stages, float c,
                              float scale) {
  using C = MainCfg<kDN, kWG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t k_smem = (raw + 1023u) & ~1023u;
  const uint32_t v_smem = k_smem + kWG * C::kTile;
  const uint32_t ds_smem = v_smem + kWG * C::kTile;
  const uint32_t q_ring = ds_smem + kWG * kBoxBytes;
  const uint32_t do_ring = q_ring + stages * C::kTile;
  const uint32_t st_ring = do_ring + stages * C::kTile;
  const uint32_t dq_smem = st_ring + stages * kStatsBytes;
  const uint32_t kv_bar = dq_smem + C::kDqBufs * kWG * C::kDqBytes;
  const uint32_t full_bar = kv_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * stages;
  const uint32_t dq_full = empty_bar + 8 * stages;  // + 8 r
  const uint32_t dq_empty = dq_full + 8 * C::kDqBufs;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * 64 * kWG;
  // the block's first query tile; the rest follow in order, wrapping
  const bool rotate = gridDim.x <= kMaxRotate;
  const int first = rotate ? kWG * blockIdx.x : 0;
  const int blocks = gridDim.x;
  const int tile_floats = 64 * d;  // a query tile of the workspace
  float* ws_bh = ws + static_cast<long long>(bh) * q_tiles * tile_floats;
  int* ctr_bh = counters + bh * q_tiles;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_bar, 1);
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, 4 * kWG);  // one arrival per warp
    }
    for (int r = 0; r < C::kDqBufs; ++r) {
      sm90::mbar_init(dq_full + 8 * r, 4 * kWG);  // every consumer warp
      sm90::mbar_init(dq_empty + 8 * r, 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kWG) {
    if constexpr (kWG == 2) sm90::regs_dealloc<kProducerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    if (threadIdx.x == 128 * kWG) {
      // the TMA producer
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tdo);
      sm90::tma_prefetch_map(&tk);
      sm90::tma_prefetch_map(&tv);
      sm90::mbar_expect_tx(kv_bar, 2 * kWG * C::kTile);
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          const uint32_t off = w * C::kTile + ch * kBoxBytes;
          sm90::tma_load_4d(k_smem + off, &tk, kv_bar, ch * kBox, h,
                            k0 + 64 * w, b);
          sm90::tma_load_4d(v_smem + off, &tv, kv_bar, ch * kBox, h,
                            k0 + 64 * w, b);
        }
      }
      const float* st_bh = stats + static_cast<long long>(bh) * q_tiles * 192;
      sm90::Slot slot;
      int i = first;
      for (int n = 0; n < q_tiles; ++n, slot.next(stages)) {
        const uint32_t s = slot.stage;
        sm90::mbar_wait(empty_bar + 8 * s, slot.phase ^ 1);
        sm90::mbar_expect_tx(full_bar + 8 * s, 2 * C::kTile + kStatsBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          const uint32_t off = s * C::kTile + ch * kBoxBytes;
          sm90::tma_load_4d(q_ring + off, &tq, full_bar + 8 * s, ch * kBox,
                            h, 64 * i, b);
          sm90::tma_load_4d(do_ring + off, &tdo, full_bar + 8 * s, ch * kBox,
                            h, 64 * i, b);
        }
        sm90::bulk_load(st_ring + s * kStatsBytes, st_bh + i * 192,
                        kStatsBytes, full_bar + 8 * s);
        if (++i == q_tiles) i = 0;
      }
    } else if (warp >= 1 && warp <= C::kDqBufs && threadIdx.x % 32 == 0) {
      // the reducer of dQ tile r: the partials of steps r, r + kDqBufs, ...
      const int r = warp - 1;
      const uint32_t src = dq_smem + r * kWG * C::kDqBytes;
      for (int n = r; n < q_tiles; n += C::kDqBufs) {
        const int i = first + n < q_tiles ? first + n : first + n - q_tiles;
        const int rank = dq_rank<kWG>(blockIdx.x, i, blocks, q_tiles, rotate);
        sm90::mbar_wait(dq_full + 8 * r, (n / C::kDqBufs) & 1);
        wait_rank(ctr_bh + i, rank);
        sm90::fence_proxy_async_all();
        // the block's partial: its warpgroups' in order, each copy done
        // before the next starts (two bulk adds to one place need not
        // land in the order they were issued)
        float* dst = ws_bh + static_cast<long long>(i) * tile_floats;
        for (int w = 0; w < kWG; ++w) {
          if (rank == 0 && w == 0) {
            sm90::bulk_store<false>(dst, src, 4 * tile_floats);
          } else {
            sm90::bulk_store<true>(dst, src + w * C::kDqBytes,
                                   4 * tile_floats);
          }
          sm90::bulk_commit();
          sm90::bulk_wait();
        }
        sm90::mbar_arrive(dq_empty + 8 * r);
        sm90::fence_proxy_async_all();
        __threadfence();
        atomicAdd(ctr_bh + i, 1);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys [k0 + 64 wg, k0 + 64 wg + 64)
  if constexpr (kWG == 2) sm90::regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const MainConsumer<kDN, kWG> cons{
      k_smem + wg * C::kTile, v_smem + wg * C::kTile, ds_smem + wg * kBoxBytes,
      t, d, k0 + 64 * wg, lane, wg,
      16 * static_cast<int>((threadIdx.x % 128) / 32) + lane / 4, c};
  // the ring's stats and the dQ tiles, by generic address
  const float* st_ring_ptr =
      reinterpret_cast<const float*>(smem_raw + (st_ring - raw));
  float* dq_tiles = reinterpret_cast<float*>(smem_raw + (dq_smem - raw));

  float acc_dv[kDN / 2], acc_dk[kDN / 2];
#pragma unroll
  for (int i = 0; i < kDN / 2; ++i) acc_dv[i] = acc_dk[i] = 0.f;
  sm90::mbar_wait(kv_bar, 0);

  sm90::Slot slot;
  for (int n = 0; n < q_tiles; ++n) {
    sm90::mbar_wait(full_bar + 8 * slot.stage, slot.phase);
    const uint32_t qt = q_ring + slot.stage * C::kTile;
    const uint32_t dot = do_ring + slot.stage * C::kTile;
    const float* st = st_ring_ptr + slot.stage * (kStatsBytes / 4);
    float s[32], dp[32];
    cons.issue_scores(qt, dot, s, dp);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    uint32_t p[16], ds[16];
    cons.probs(st, s, dp, p, ds);
    cons.grads(qt, dot, p, ds, acc_dv, acc_dk);
    cons.store_ds(ds);

    // this warpgroup's partial of query tile i's dQ, in its half of dQ
    // tile r once the reducer has sent that tile's last partial on
    const int r = n % C::kDqBufs;
    const uint32_t use = (n / C::kDqBufs) & 1;  // parity of its round
    float* dqs = dq_tiles + (r * kWG + wg) * (C::kDqBytes / 4);
    if constexpr (kDN <= 80) {
      // dQ issued behind dV and dK; the dQ tile waited for meanwhile
      float acc_dq[kDN / 2];
      cons.issue_dq(acc_dq);
      sm90::mbar_wait(dq_empty + 8 * r, use ^ 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_dq);
      cons.template write_dq<kDN / 8>(acc_dq, 0, dqs);
    } else {
      // dV and dK done first: their operands' registers are free for dQ's
      sm90::wgmma_wait<0>();
      sm90::fence_regs(p);
      sm90::fence_regs(ds);
      sm90::mbar_wait(dq_empty + 8 * r, use ^ 1);
      cons.template dq_chunks<0>(dqs);
    }
    // hand the dQ tile on to the reducer
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(dq_full + 8 * r);
    // the tile's products are done: its stage goes back to the producer
    sm90::fence_regs(p);
    sm90::fence_regs(ds);
    sm90::fence_regs(acc_dv);
    sm90::fence_regs(acc_dk);
    if (lane == 0) sm90::mbar_arrive(empty_bar + 8 * slot.stage);
    slot.next(stages);
  }

  // every product waited for here, outside the stores' divergent paths
  // (else ptxas waits there, and then serialises every wgmma)
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc_dv);
  sm90::fence_regs(acc_dk);

  // dQ of the query tiles whose ordered sum this block ended (its last
  // steps), once its reducer has added the last partial: the workspace's
  // sum scaled, rounded and stored, four columns a thread at a time
  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
  for (int n = 0, i = first; n < q_tiles;
       ++n, i = i + 1 < q_tiles ? i + 1 : 0) {
    if (dq_rank<kWG>(blockIdx.x, i, blocks, q_tiles, rotate) != blocks - 1) {
      continue;
    }
    if (threadIdx.x % 128 == 0) {
      wait_rank(ctr_bh + i, blocks);
      sm90::fence_proxy_async_all();
    }
    sm90::bar_sync(1 + wg, 128);
    const float* sum = ws_bh + static_cast<long long>(i) * tile_floats;
    for (int e = 4 * threadIdx.x; e < tile_floats; e += 4 * 128 * kWG) {
      const int row = e / d;
      if (64 * i + row >= t) break;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(sum + e));
      uint2 out;
      out.x = pack_bf16(v.x * scale, v.y * scale);
      out.y = pack_bf16(v.z * scale, v.w * scale);
      *reinterpret_cast<uint2*>(dqb + (64 * i + row) * sdq.t + e - row * d) =
          out;
    }
  }

  // dK scaled, both rounded to bf16 once; keys < t, columns < d
  __nv_bfloat16* dkb = dk + b * sdk.b + h * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int j = 0; j < kDN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col >= d) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = cons.key0 + cons.local + 8 * r;
      if (key >= t) continue;
      *reinterpret_cast<uint32_t*>(dkb + key * sdk.t + col) =
          pack_bf16(acc_dk[4 * j + 2 * r] * scale,
                    acc_dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key * sdv.t + col) =
          pack_bf16(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
}

struct BwdArgs {
  CUtensorMap q, dout, k, v, k_stats, v_stats;
  float* stats;
  float* ws;
  int* counters;
  __nv_bfloat16 *dq, *dk, *dv;
  Strides sdq, sdk, sdv;
  int heads, t, d;
  float c, scale;
};

template <int kDN, int kWG>
int launch_stats(const BwdPlan& p, const BwdArgs& a, cudaStream_t stream) {
  auto kernel = attention_bwd_stats_kernel<kDN, kWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(p.stats_grid_x, p.grid_y), StatsCfg<kDN, kWG>::kThreads,
           p.stats_smem, stream>>>(a.q, a.dout, a.k_stats, a.v_stats,
                                   a.stats, a.counters, a.heads, a.t,
                                   p.q_tiles, p.stats_stages, a.c);
  return static_cast<int>(cudaGetLastError());
}

template <int kDN, int kWG>
int launch_main(const BwdPlan& p, const BwdArgs& a, cudaStream_t stream) {
  auto kernel = attention_bwd_main_kernel<kDN, kWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(p.main_grid_x, p.grid_y), MainCfg<kDN, kWG>::kThreads,
           p.main_smem, stream>>>(a.q, a.dout, a.k, a.v, a.stats, a.ws,
                                  a.counters, a.dq, a.dk, a.dv, a.sdq, a.sdk,
                                  a.sdv, a.heads, a.t, a.d, p.q_tiles,
                                  p.main_stages, a.c, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// the stats kernel, then the main kernel, of one head-dim class
template <int kDN>
int launch_class(const BwdPlan& p, const BwdArgs& a, cudaStream_t stream) {
  const int err = p.stats_block_q == 128 ? launch_stats<kDN, 2>(p, a, stream)
                                         : launch_stats<kDN, 1>(p, a, stream);
  if (err != 0) return err;
  if constexpr (kDN <= 80) {
    if (p.main_block_k == 128) return launch_main<kDN, 2>(p, a, stream);
  }
  return launch_main<kDN, 1>(p, a, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                void* dq, void* dk, void* dv, float* stats, float* ws,
                int* counters, int batch, int t, int heads, int d,
                const long long* st, float scale, const int* plan,
                cudaStream_t stream) {
  const BwdPlan p{plan[0], plan[1], plan[2],  plan[3],  plan[4],
                  plan[5], plan[6], plan[7],  plan[8],  plan[9],
                  plan[10], plan[11], plan[12], plan[13], plan[14]};
  if (!plan_ok(p, batch * heads, t, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int current = sm90::make_current(q);
  if (current != 0) return current;
  BwdArgs a;
  const void* src[4] = {q, k, v, dout};
  CUtensorMap* maps64[4] = {&a.q, &a.k, &a.v, &a.dout};
  for (int i = 0; i < 4; ++i) {
    const int err = sm90::encode_map(maps64[i], src[i], batch, t, heads, d,
                                     st + 3 * i, 64);
    if (err != 0) return err;
  }
  for (int i = 0; i < 2; ++i) {
    CUtensorMap* map = i == 0 ? &a.k_stats : &a.v_stats;
    const int err = sm90::encode_map(map, src[1 + i], batch, t, heads, d,
                                     st + 3 * (1 + i), p.stats_block_k);
    if (err != 0) return err;
  }
  a.stats = stats;
  a.ws = ws;
  a.counters = counters;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.sdq = Strides{st[12], st[13], st[14]};
  a.sdk = Strides{st[15], st[16], st[17]};
  a.sdv = Strides{st[18], st[19], st[20]};
  a.heads = heads;
  a.t = t;
  a.d = d;
  a.c = scale * kLog2e;
  a.scale = scale;
  switch (p.head_class) {
    case 16: return launch_class<16>(p, a, stream);
    case 32: return launch_class<32>(p, a, stream);
    case 40: return launch_class<40>(p, a, stream);
    case 64: return launch_class<64>(p, a, stream);
    case 80: return launch_class<80>(p, a, stream);
    case 128: return launch_class<128>(p, a, stream);
    case 160: return launch_class<160>(p, a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq, dk, dv are
// [batch, t, heads, d] with unit stride on d; strides holds the (b, t, h)
// element strides of q, k, v, dout, dq, dk and dv in that order. stats is
// fp32 scratch of batch * heads * ceil(t / 64) * 192 elements (at least 3 *
// batch * heads * t); bf16 also takes workspace, fp32 scratch of batch *
// heads * ceil(t / 64) * 64 * d elements, and counters, int32 scratch of batch * heads *
// ceil(t / 64) elements (neither needs zeroing), and plan, the 15 ints of
// ops/attention.py:sm90_bwd_launch_plan for (batch * heads, t, d), checked
// (fp32 ignores these three). Returns a cudaError_t (0 on success).
extern "C" int ldmseg_attention_bwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* dout, void* dq,
                                    void* dk, void* dv, void* stats,
                                    void* workspace, void* counters,
                                    int batch, int t, int heads, int d,
                                    const long long* strides, float scale,
                                    const int* plan, void* stream) {
  if (t < 1 || d < 8 || d > kMaxD || d % 8 != 0 || batch * heads < 1 ||
      batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0) {
    return launch_f32(q, k, v, dout, dq, dk, dv, st, batch, t, heads, d,
                      strides, scale, s);
  }
  if (dtype == 1) {
    return launch_bf16(q, k, v, dout, dq, dk, dv, st,
                       static_cast<float*>(workspace),
                       static_cast<int*>(counters), batch, t, heads, d,
                       strides, scale, plan, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
