// Projected-Jacobi contact solve for a batch of environments, for Hopper.
//
// Replaces the TPU kernel learning_to_adapt_tpu/ops/pallas_jacobi.py:
// jacobi_solve (body _kernel), i.e. the fori_loop of
// learning_to_adapt_tpu/physics/engine.py constraint_forces:
//
//     f <- max(f - omega * (A f + b) * aii_inv, 0)     from f = 0,
//
// repeated n_sweeps times, for every env e of a batch, each with its own
// A (N, N), b, aii_inv (N,) and omega.
//
// What bounds it on an H100: neither bytes nor operations. At HalfCheetah's
// shape (5 envs, N = 76, 60 sweeps) a launch reads ~117 KB and does ~3.5
// MFLOP, ~0.05 us at the card's rates. The floor is the chain of 60 sweeps:
// each needs the whole f of the sweep before it, so each costs at least one
// round trip of f through shared memory, a cross-thread sum and one block
// barrier (jacobi_study.py times that chain alone as `handshake_only`).
//
// What the design does about it: it keeps that round trip the only thing on
// the chain, and the work beside it short. One block per env runs every
// sweep. A lives in registers: each row is split over kT threads, a thread
// holding kCols columns (part + kT k) of kRows rows, so a sweep reads only f
// from shared memory: kCols independent loads, conflict-free, broadcast
// across the row groups of a warp, each serving kRows rows. The products run
// as unrolled FMA chains in registers; a reduce-scatter of warp shuffles
// leaves row r's total in lane r of its group, which writes its new f into
// the other half of a double buffer (b, aii_inv and f[row] stay in that
// lane's registers). One __syncthreads() per sweep. The prologue loads the
// thread's slice of A straight from global memory, every load in flight at
// once. Few threads per row keep the shuffle rounds few, several rows per
// thread keep the shared-memory loads few: with 8 threads per row and one
// row each, 19 warps issued 12 loads each per sweep and the loads, not the
// chain, set the time. kT, kCols and kRows are template constants, so the
// sweep unrolls fully; each launch tier is one instantiation, chosen on the
// host from N (learning_to_adapt_torch/ops/jacobi.py, TIERS).
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChains = 2;  // independent FMA chains per row product

// the column of A and f that thread `part` of a row holds in its slot k
template <int kT, int kCols>
__device__ __forceinline__ int column(int part, int k) {
  return part + kT * k;
}

// threads of the largest block a tier launches: whole warps of row groups,
// each group of kRows rows taking kT threads
template <int kT, int kCols, int kRows>
constexpr int max_threads() {
  constexpr int per_warp = 32 / kT;
  return ((kT * kCols + kRows - 1) / kRows + per_warp - 1) / per_warp * 32;
}

// s[r] holds this lane's part of row r's product. Returns the total over
// the kT lanes of the row group of row part % kRows: each step halves the
// rows a lane keeps, sending the other half to the lane whose bit `mask`
// differs, then the lanes of one row add up what is left.
template <int kT, int kRows>
__device__ __forceinline__ float reduce_rows(float (&s)[kRows], int part) {
#pragma unroll
  for (int width = kRows; width > 1; width /= 2) {
    const int mask = width / 2;
    const bool upper = part & mask;
#pragma unroll
    for (int i = 0; i < mask; ++i) {
      const float keep = upper ? s[i + mask] : s[i];
      const float send = upper ? s[i] : s[i + mask];
      s[i] = keep + __shfl_xor_sync(kFull, send, mask);
    }
  }
#pragma unroll
  for (int mask = kRows; mask < kT; mask *= 2)
    s[0] += __shfl_xor_sync(kFull, s[0], mask);
  return s[0];
}

template <int kT, int kCols, int kRows>
__global__ void __launch_bounds__(max_threads<kT, kCols, kRows>(), 1)
    jacobi_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  const float* __restrict__ aii_inv,
                  const float* __restrict__ omega, float* __restrict__ out,
                  int n, int n_sweeps) {
  static_assert(32 % kT == 0 && kRows <= kT && (kRows & (kRows - 1)) == 0,
                "a row group lies in one warp; kRows is a power of 2");
  constexpr int kLd = kT * kCols;
  __shared__ float fbuf[2][kLd];  // f double buffer, zero beyond row n

  const int e = blockIdx.x;
  const int part = threadIdx.x % kT;
  const int group = threadIdx.x / kT;
  const int n_groups = blockDim.x / kT;
  const float* Ae = A + static_cast<size_t>(e) * n * n;

  // the thread's slice of A: rows group + r * n_groups, zero past N
  float a[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = group + r * n_groups;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = column<kT, kCols>(part, k);
      a[r][k] = row < n && col < n ? __ldg(Ae + row * n + col) : 0.f;
    }
  }
  // lane part == r of a group owns the group's row r: its b, aii_inv, f
  const int my_row = group + part * n_groups;
  const bool owner = part < kRows && my_row < n;
  const size_t my_idx = static_cast<size_t>(e) * n + my_row;
  const float my_b = owner ? __ldg(b + my_idx) : 0.f;
  const float my_ai = owner ? __ldg(aii_inv + my_idx) : 0.f;
  const float w = __ldg(omega + e);
  float my_f = 0.f;
  for (int i = threadIdx.x; i < 2 * kLd; i += blockDim.x)
    fbuf[i / kLd][i % kLd] = 0.f;
  __syncthreads();

  // every lane of a warp runs the same sweeps, so the full-mask shuffles
  // are always convergent
  int cur = 0;
  for (int s = 0; s < n_sweeps; ++s) {
    float fv[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      fv[k] = fbuf[cur][column<kT, kCols>(part, k)];
    float sum[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float acc[kChains] = {};
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        acc[k % kChains] = fmaf(a[r][k], fv[k], acc[k % kChains]);
      sum[r] = acc[0];
#pragma unroll
      for (int c = 1; c < kChains; ++c) sum[r] += acc[c];
    }
    const float row_sum = reduce_rows<kT, kRows>(sum, part);
    if (owner) {
      my_f = fmaxf(my_f - w * (row_sum + my_b) * my_ai, 0.f);
      fbuf[cur ^ 1][my_row] = my_f;
    }
    __syncthreads();
    cur ^= 1;
  }
  if (owner) out[my_idx] = my_f;
}

template <int kT, int kCols, int kRows>
int launch(const float* A, const float* b, const float* aii_inv,
           const float* omega, float* out, int n_envs, int n, int n_sweeps,
           int threads, cudaStream_t stream) {
  if (n > kT * kCols || threads % 32 != 0 ||
      threads > max_threads<kT, kCols, kRows>() ||
      threads / kT * kRows < n)
    return static_cast<int>(cudaErrorInvalidValue);
  jacobi_kernel<kT, kCols, kRows><<<n_envs, threads, 0, stream>>>(
      A, b, aii_inv, omega, out, n, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A (E, n, n), b / aii_inv / out (E, n), omega (E,): contiguous float32 on
// the device, n_envs and n at least 1. (threads_per_row, cols,
// rows_per_thread) name the launch tier and `threads` the block size
// (ops/jacobi.py launch_shape). Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tier or block size the
// kernel was not built for.
int jacobi_solve(const void* A, const void* b, const void* aii_inv,
                 const void* omega, void* out, int n_envs, int n,
                 int n_sweeps, int threads_per_row, int cols,
                 int rows_per_thread, int threads, void* stream) {
  const auto* a = static_cast<const float*>(A);
  const auto* bv = static_cast<const float*>(b);
  const auto* ai = static_cast<const float*>(aii_inv);
  const auto* w = static_cast<const float*>(omega);
  auto* f = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // one instantiation per tier of ops/jacobi.py TIERS
#define JACOBI_TIER(T, C, R)                                          \
  if (threads_per_row == T && cols == C && rows_per_thread == R)      \
    return launch<T, C, R>(a, bv, ai, w, f, n_envs, n, n_sweeps, threads, s);
  JACOBI_TIER(4, 8, 1)
  JACOBI_TIER(4, 16, 2)
  JACOBI_TIER(4, 20, 4)
  JACOBI_TIER(4, 32, 2)
  JACOBI_TIER(4, 56, 2)
#undef JACOBI_TIER
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
