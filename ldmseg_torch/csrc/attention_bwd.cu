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
// What bounds it on an H100: the five products, 10*BH*T^2*D operations,
// against 7*BH*T*D*bytes of input and output. At the training path's largest
// shape (B*H = 64, T = 1920, D = 40, bf16) that is ~94 GFLOP (~95 us at 989
// TFLOP/s) against ~69 MB (~21 us at 3.35 TB/s): the tensor cores bound it.
//
// Design (simple first, fast later):
//   * the cross-block reduction. On the TPU the q-grid runs in order and dK/dV
//     accumulate in place across q-blocks. Blocks on Hopper run in no order,
//     so each sum has one owner and the result does not depend on the order
//     blocks run in (no atomics, deterministic):
//       - kernel 1, one block per (b*h, query tile): pass 1 computes each
//         row's max and sum, pass 2 delta; it writes (m, l, delta) to a
//         scratch buffer, then pass 3 accumulates dQ over all key tiles;
//       - kernel 2, one block per (b*h, key tile), after kernel 1 on the same
//         stream: it loops over all query tiles, recomputes P^T and dS^T from
//         (m, l, delta), and keeps dK and dV in fp32 in shared memory.
//     That is ten products per (query tile, key tile) pair where five are
//     needed: the recomputation is the price of owning each sum.
//   * products: nvcuda::wmma 16x16x16 bf16 tiles with fp32 accumulators,
//     spread over the block's 8 warps, every operand and accumulator in shared
//     memory (registers stay few); the head dim is zero-padded in shared
//     memory to a multiple of 16 (40 -> 48, 80, 160) as in K1. fp32 inputs
//     take plain FMA loops on 32-row tiles (their tiles are twice the bytes).
//   * inputs are read through their [B, T, H, D] strides; any T >= 1 is
//     taken, the ragged last tile masked (P = 0 for a key or query past T).
//     Shared memory is dynamic: 219 KB per block in kernel 2 at D = 160 bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 160;

// rows of a query or key tile: 64 for bf16 (wmma), 32 for fp32 (FMA)
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 2 ? 64 : 32;
}

struct Strides {
  long long b, t, h;  // element strides of the B, T and H axes (D is 1)
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory layout of both kernels for one head dim. Strides in
// elements: tiles [rows][ld] in T, fp32 scores [rows][lds], P / dS operands
// [rows][ldp] in T, fp32 accumulators [rows][lda].
template <typename T>
struct Plan {
  static constexpr int kB = tile_rows<T>();
  static constexpr int kLds = kB + 4;
  static constexpr int kLdp = kB + 8;
  int d, dp, ld, lda;
  __host__ __device__ explicit Plan(int d_)
      : d(d_), dp((d_ + 15) & ~15), ld(((d_ + 15) & ~15) + 8),
        lda(((d_ + 15) & ~15) + 4) {}
  __host__ __device__ size_t tile() const { return align128(size_t(kB) * ld * sizeof(T)); }
  __host__ __device__ size_t score() const { return align128(size_t(kB) * kLds * sizeof(float)); }
  __host__ __device__ size_t operand() const { return align128(size_t(kB) * kLdp * sizeof(T)); }
  __host__ __device__ size_t acc() const { return align128(size_t(kB) * lda * sizeof(float)); }
  __host__ __device__ size_t stats() const { return align128(3 * kB * sizeof(float)); }
  // kernel 1: Q, dO, K, V tiles, S and dP, dS, dQ
  __host__ __device__ size_t dq_bytes() const { return 4 * tile() + 2 * score() + operand() + acc(); }
  // kernel 2: K, V, Q, dO tiles, S^T and dP^T, P^T and dS^T, dK and dV, stats
  __host__ __device__ size_t dkv_bytes() const {
    return 4 * tile() + 2 * score() + 2 * operand() + 2 * acc() + stats();
  }
};

template <typename P>
__device__ __forceinline__ P* carve(unsigned char*& ptr, size_t bytes) {
  P* out = reinterpret_cast<P*>(ptr);
  ptr += bytes;
  return out;
}

// Rows [row0, row0 + kB) of one (b, h) slice into shared memory [kB][ld],
// columns [0, d); rows at or past t are zero-filled. 16-byte vectors: the
// wrapper checks that d and the strides are multiples of 8 elements and that
// the base pointers are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long st, int row0, int t,
                                          int d) {
  constexpr int kB = tile_rows<T>();
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = d / kVec;
  for (int i = threadIdx.x; i < kB * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * st + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Columns [d, dp) of a [kB][ld] tile to zero: loads never write them, and
// the padded products read them.
template <typename T>
__device__ __forceinline__ void zero_pad(T* tile, int ld, int d, int dp) {
  constexpr int kB = tile_rows<T>();
  const int pad = dp - d;
  for (int i = threadIdx.x; i < kB * pad; i += kThreads) {
    const int r = i / pad;
    tile[r * ld + d + (i - r * pad)] = from_float<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void zero_acc(float* acc, int lda) {
  constexpr int kB = tile_rows<T>();
  for (int i = threadIdx.x; i < kB * lda; i += kThreads) acc[i] = 0.f;
}

// C[M x N] (fp32, row-major, ldc) = (kAcc: +=) A[M x K] B[K x N].
// A is row-major [M][lda], or with kTA its transpose stored [K][lda]; B is
// row-major [K][ldb], or with kTB its transpose stored [N][ldb]. M, N and K
// are multiples of 16. bf16: wmma tiles spread over the warps, each output
// tile owned by one warp; fp32: one thread per output element.
template <typename T, bool kTA, bool kTB, bool kAcc>
__device__ __forceinline__ void gemm(const T* A, int lda, const T* B, int ldb,
                                     float* C, int ldc, int M, int N, int K) {
  if constexpr (std::is_same<T, float>::value) {
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
  } else {
    using namespace nvcuda;
    using LA = typename std::conditional<kTA, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<kTB, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    const int tn = N / 16;
    const int tiles = (M / 16) * tn;
    for (int tile = warp; tile < tiles; tile += kWarps) {
      const int i = tile / tn;
      const int j = tile - i * tn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (kAcc) {
        wmma::load_matrix_sync(acc, C + i * 16 * ldc + j * 16, ldc,
                               wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc, 0.f);
      }
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
        wmma::load_matrix_sync(
            a, kTA ? A + kk * lda + i * 16 : A + i * 16 * lda + kk, lda);
        wmma::load_matrix_sync(
            b, kTB ? B + j * 16 * ldb + kk : B + kk * ldb + j * 16, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + i * 16 * ldc + j * 16, acc, ldc,
                              wmma::mem_row_major);
    }
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            T* __restrict__ dq, float* __restrict__ stats,
                            int heads, int t, int d, Strides sq, Strides sk,
                            Strides sv, Strides sdo, Strides sdq,
                            float scale) {
  using Pl = Plan<T>;
  constexpr int kB = Pl::kB;
  constexpr int kLds = Pl::kLds;
  constexpr int kLdp = Pl::kLdp;
  constexpr int kTpr = kThreads / kB;  // threads per query row
  constexpr int kCols = kB / kTpr;     // score columns per thread
  const Pl pl(d);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* Qs = carve<T>(ptr, pl.tile());
  T* dOs = carve<T>(ptr, pl.tile());
  T* Ks = carve<T>(ptr, pl.tile());
  T* Vs = carve<T>(ptr, pl.tile());
  float* Ss = carve<float>(ptr, pl.score());
  float* dPs = carve<float>(ptr, pl.score());
  T* dSs = carve<T>(ptr, pl.operand());
  float* dQacc = carve<float>(ptr, pl.acc());

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kB;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;

  zero_pad(Qs, pl.ld, d, pl.dp);
  zero_pad(dOs, pl.ld, d, pl.dp);
  zero_pad(Ks, pl.ld, d, pl.dp);
  zero_pad(Vs, pl.ld, d, pl.dp);
  zero_acc<T>(dQacc, pl.lda);
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
    gemm<T, false, true, false>(Qs, pl.ld, Ks, pl.ld, Ss, kLds, kB, kB, pl.dp);
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
    gemm<T, false, true, false>(Qs, pl.ld, Ks, pl.ld, Ss, kLds, kB, kB, pl.dp);
    gemm<T, false, true, false>(dOs, pl.ld, Vs, pl.ld, dPs, kLds, kB, kB, pl.dp);
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

  // pass 3: dS = P o (dP - delta) rounded to T, dQ += dS K in fp32
  for (int k0 = 0; k0 < t; k0 += kB) {
    __syncthreads();
    load_tile(Ks, pl.ld, kb, sk.t, k0, t, d);
    load_tile(Vs, pl.ld, vb, sv.t, k0, t, d);
    __syncthreads();
    gemm<T, false, true, false>(Qs, pl.ld, Ks, pl.ld, Ss, kLds, kB, kB, pl.dp);
    gemm<T, false, true, false>(dOs, pl.ld, Vs, pl.ld, dPs, kLds, kB, kB, pl.dp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + kTpr * j;
      float ds = 0.f;
      if (k0 + c < t) {
        const float p = expf(Ss[row * kLds + c] * scale - m_run) / l_run;
        ds = p * (dPs[row * kLds + c] - delta);
      }
      dSs[row * kLdp + c] = from_float<T>(ds);
    }
    __syncthreads();
    gemm<T, false, false, true>(dSs, kLdp, Ks, pl.ld, dQacc, pl.lda, kB, pl.dp, kB);
  }
  __syncthreads();

  T* dqb = dq + b * sdq.b + h * sdq.h;
  for (int i = threadIdx.x; i < kB * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    if (q0 + r < t) {
      dqb[(q0 + r) * sdq.t + c] = from_float<T>(dQacc[r * pl.lda + c] * scale);
    }
  }
}

// Kernel 2: per (b*h, key tile) dK and dV over all query tiles, from the
// statistics kernel 1 wrote.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout, T* __restrict__ dk,
                             T* __restrict__ dv,
                             const float* __restrict__ stats, int heads, int t,
                             int d, Strides sq, Strides sk, Strides sv,
                             Strides sdo, Strides sdk, Strides sdv,
                             float scale) {
  using Pl = Plan<T>;
  constexpr int kB = Pl::kB;
  constexpr int kLds = Pl::kLds;
  constexpr int kLdp = Pl::kLdp;
  const Pl pl(d);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* Ks = carve<T>(ptr, pl.tile());
  T* Vs = carve<T>(ptr, pl.tile());
  T* Qs = carve<T>(ptr, pl.tile());
  T* dOs = carve<T>(ptr, pl.tile());
  float* Ss = carve<float>(ptr, pl.score());   // S^T [key][query]
  float* dPs = carve<float>(ptr, pl.score());  // dP^T
  T* Ps = carve<T>(ptr, pl.operand());         // P^T rounded to T
  T* dSs = carve<T>(ptr, pl.operand());        // dS^T rounded to T
  float* dKacc = carve<float>(ptr, pl.acc());
  float* dVacc = carve<float>(ptr, pl.acc());
  float* Ms = carve<float>(ptr, pl.stats());
  float* Ls = Ms + kB;
  float* Ds = Ls + kB;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * kB;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const long long n = static_cast<long long>(gridDim.y) * t;
  const float* mb = stats + static_cast<long long>(bh) * t;

  zero_pad(Ks, pl.ld, d, pl.dp);
  zero_pad(Vs, pl.ld, d, pl.dp);
  zero_pad(Qs, pl.ld, d, pl.dp);
  zero_pad(dOs, pl.ld, d, pl.dp);
  zero_acc<T>(dKacc, pl.lda);
  zero_acc<T>(dVacc, pl.lda);
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
    gemm<T, false, true, false>(Ks, pl.ld, Qs, pl.ld, Ss, kLds, kB, kB, pl.dp);
    gemm<T, false, true, false>(Vs, pl.ld, dOs, pl.ld, dPs, kLds, kB, kB, pl.dp);
    __syncthreads();
    for (int i = threadIdx.x; i < kB * kB; i += kThreads) {
      const int r = i / kB;  // key
      const int c = i - r * kB;  // query
      float p = 0.f;
      if (q0 + c < t) p = expf(Ss[r * kLds + c] * scale - Ms[c]) / Ls[c];
      Ps[r * kLdp + c] = from_float<T>(p);
      dSs[r * kLdp + c] = from_float<T>(p * (dPs[r * kLds + c] - Ds[c]));
    }
    __syncthreads();
    gemm<T, false, false, true>(Ps, kLdp, dOs, pl.ld, dVacc, pl.lda, kB, pl.dp, kB);
    gemm<T, false, false, true>(dSs, kLdp, Qs, pl.ld, dKacc, pl.lda, kB, pl.dp, kB);
  }
  __syncthreads();

  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
  for (int i = threadIdx.x; i < kB * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    if (k0 + r < t) {
      dkb[(k0 + r) * sdk.t + c] = from_float<T>(dKacc[r * pl.lda + c] * scale);
      dvb[(k0 + r) * sdv.t + c] = from_float<T>(dVacc[r * pl.lda + c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats, int batch, int t,
           int heads, int d, const long long* st, float scale,
           cudaStream_t stream) {
  const Plan<T> pl(d);
  const size_t dq_smem = pl.dq_bytes();
  const size_t dkv_smem = pl.dkv_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]},
      sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const dim3 grid((t + Plan<T>::kB - 1) / Plan<T>::kB, batch * heads);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  attention_bwd_dq_kernel<T><<<grid, kThreads, dq_smem, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dq), stats, heads, t, d, sq, sk, sv,
      sdo, sdq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<T><<<grid, kThreads, dkv_smem, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dk), static_cast<T*>(dv), stats,
      heads, t, d, sq, sk, sv, sdo, sdk, sdv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq, dk, dv are
// [batch, t, heads, d] with unit stride on d; strides holds the (b, t, h)
// element strides of q, k, v, dout, dq, dk and dv in that order. stats is
// fp32 scratch of 3 * batch * heads * t elements. Returns a cudaError_t (0 on
// success).
extern "C" int ldmseg_attention_bwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* dout, void* dq,
                                    void* dk, void* dv, void* stats,
                                    int batch, int t, int heads, int d,
                                    const long long* strides, float scale,
                                    void* stream) {
  if (t < 1 || d < 8 || d > kMaxD || d % 8 != 0 || batch * heads < 1 ||
      batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0) {
    return launch<float>(q, k, v, dout, dq, dk, dv, st, batch, t, heads, d,
                         strides, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, st, batch, t,
                                 heads, d, strides, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
