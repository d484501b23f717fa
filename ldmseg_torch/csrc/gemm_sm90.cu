// The Hopper product of gemm_sm90.cuh with nothing around it: C = A W^T
// stored as it is summed, int8 operands into int32 (ldmseg_gemm_s8) or
// bf16 operands into fp32 (ldmseg_gemm_bf16), and the per-head product of
// K17's to_out with the caller's factors (ldmseg_gemm_s8_heads). No model
// path calls these entry points; chip_smoke.py and the card tests hold them
// against torch._int_mm (bit for bit: int8 sums are exact; per head for the
// third, the fp32 promotion repeated in PyTorch in the same order) and
// torch.matmul at the blocks' product shapes, which gives the blocks'
// products their library yardstick (ops/gemm.py: gemm_s8, gemm_bf16,
// gemm_s8_heads). The int8 entry also runs the two-operand form that K4's
// up product launches (two W tiles per stage into two accumulator sets,
// 256 x 64 tiles at the first level).

#include "gemm_sm90.cuh"

namespace {

// a (row, col) pair of sums as one 8-byte store (col is even, n % 8 == 0)
template <typename T>
__device__ __forceinline__ void store_pair(T* at, T s0, T s1) {
  using P = typename gemm90::PairOf<T>::type;
  *reinterpret_cast<P*>(at) = P{s0, s1};
}

template <typename T>
struct StoreEpi {
  static constexpr int kOps = 1;
  static constexpr int kCols = 0;
  static constexpr int kIntCols = 0;
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  T* out;
  int n;
  __device__ float col_value(int, int) const { return 0.f; }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ void operator()(int row, int col, const float2*, const int2*,
                             const RowPre&, const Pre&, T s0, T s1) const {
    store_pair(out + static_cast<long long>(row) * n + col, s0, s1);
  }
};

// two operands (W's rows [0, n) and [n, 2n)): their sums side by side in
// out [rows, 2n], so that out = A W^T of the whole [2n, k] W
struct Store2Epi {
  static constexpr int kOps = 2;
  static constexpr int kCols = 0;
  static constexpr int kIntCols = 0;
  static constexpr bool kRowMax = false;
  using RowPre = gemm90::NoPre;
  using Pre = gemm90::NoPre;
  int* out;
  int n;
  __device__ float col_value(int, int) const { return 0.f; }
  __device__ RowPre row_pre(int) const { return {}; }
  __device__ Pre pre(int, int) const { return {}; }
  __device__ float operator()(int row, int col, const float2*, const int2*,
                              int a0, int a1, int b0, int b1) const {
    int* at = out + static_cast<long long>(row) * 2 * n + col;
    store_pair(at, a0, a1);
    store_pair(at + n, b0, b1);
    return 0.f;
  }
};

// the per-head product stored in fp32, f[b][h] = factors[b * heads + h]
struct HeadsStoreEpi {
  const float* factors;
  float* out;
  int n, heads;
  __device__ float head_factor(int b, int h) const {
    return factors[b * heads + h];
  }
  __device__ void operator()(int row, int col, float a0, float a1) const {
    store_pair(out + static_cast<long long>(row) * n + col, a0, a1);
  }
};

}  // namespace

// a int8 [rows, k], w int8 [operands * n, k], out int32 [rows, operands *
// n], all contiguous; operands 1 or 2 (two W tiles per stage, the second
// n rows down); plan is ops/gemm.py:sm90_gemm_plan(rows, n, k, "int8",
// operands). Returns a cudaError_t (0 on success).
extern "C" int ldmseg_gemm_s8(const void* a, const void* w, void* out,
                              int rows, int n, int k, int operands,
                              const int* plan, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (operands == 2) {
    return gemm90::launch_gemm<true>(
        plan, a, w, rows, n, k, n, Store2Epi{static_cast<int*>(out), n}, s);
  }
  if (operands != 1) return static_cast<int>(cudaErrorInvalidValue);
  return gemm90::launch_gemm<true>(
      plan, a, w, rows, n, k, 0, StoreEpi<int>{static_cast<int*>(out), n},
      s);
}

// a bf16 [rows, k], w bf16 [n, k], out fp32 [rows, n], all contiguous;
// operands must be 1; plan is sm90_gemm_plan(rows, n, k, "bfloat16").
// Returns a cudaError_t.
extern "C" int ldmseg_gemm_bf16(const void* a, const void* w, void* out,
                                int rows, int n, int k, int operands,
                                const int* plan, void* stream) {
  if (operands != 1) return static_cast<int>(cudaErrorInvalidValue);
  return gemm90::launch_gemm<false>(
      plan, a, w, rows, n, k, 0,
      StoreEpi<float>{static_cast<float*>(out), n},
      static_cast<cudaStream_t>(stream));
}

// a int8 [rows, heads * dp], w int8 [n, heads * dp] (dp = 32 head_steps),
// factors fp32 [rows / t, heads], out fp32 [rows, n], all contiguous: out =
// sum over h, h = 0 first, of float(int32 a_h w_h^T) * factors[row / t][h]
// (gemm_sm90.cuh's gemm_heads_kernel); plan is sm90_gemm_plan(rows, n,
// heads * dp, "int8"). Returns a cudaError_t.
extern "C" int ldmseg_gemm_s8_heads(const void* a, const void* w,
                                    const float* factors, void* out, int rows,
                                    int n, int heads, int head_steps, int t,
                                    const int* plan, void* stream) {
  return gemm90::launch_gemm_heads(
      plan, static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      rows, n, heads, head_steps, t,
      HeadsStoreEpi{factors, static_cast<float*>(out), n, heads},
      static_cast<cudaStream_t>(stream));
}
