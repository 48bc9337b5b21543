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
//
// Above the largest tier (N > 224) A no longer fits one SM: at the blocks
// env's 988 rows it is 3.9 MB of f32 per env, beyond a block's registers
// and its 227 KB of shared memory. That path, jacobi_cluster_kernel, runs
// one thread-block cluster of C blocks per env (C = 16, or the portable 8
// when 16 per env would not fit the card at once; ops/jacobi.py
// cluster_shape). Block `rank` owns rows [rank R, rank R + R), R = ceil(N /
// C), and keeps their f, double-buffered, in its shared memory. A sweep:
// gather the whole f from the cluster's blocks through distributed shared
// memory into a local copy; stream the block's rows of A from L2 (5 envs x
// 3.9 MB fit the 50 MB L2), a warp per row, 16-byte coalesced loads where
// N % 4 == 0, dot them with the local f and write the new f of each row
// into the other buffer; one cluster barrier. The buffer written this
// sweep is read only after the barrier and the one read this sweep is
// written only after the next, so one barrier per sweep suffices. What
// bounds it is the L2 stream (each block re-reads its R x N slice of A
// every sweep) and the cluster barrier; jacobi_study.py times the barrier
// and gather alone as the floor of its sweep chain.
#include <cooperative_groups.h>
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

constexpr int kClusterMax = 16;  // the largest cluster cluster_shape picks

// One row of A (N floats from Ar) dotted with the gathered f, by the 32
// lanes of a warp: a lane's partial sum (the caller reduces across lanes).
template <int kVec>
__device__ __forceinline__ float row_dot(const float* __restrict__ Ar,
                                         const float* f, int n, int lane) {
  float acc0 = 0.f, acc1 = 0.f;
  if constexpr (kVec == 4) {
    const float4* a4 = reinterpret_cast<const float4*>(Ar);
    const float4* f4 = reinterpret_cast<const float4*>(f);
#pragma unroll 4
    for (int k = lane; k < n / 4; k += 32) {
      const float4 a = __ldcg(a4 + k);
      const float4 x = f4[k];
      acc0 = fmaf(a.x, x.x, acc0);
      acc1 = fmaf(a.y, x.y, acc1);
      acc0 = fmaf(a.z, x.z, acc0);
      acc1 = fmaf(a.w, x.w, acc1);
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < n; k += 32) acc0 = fmaf(__ldcg(Ar + k), f[k], acc0);
  }
  return acc0 + acc1;
}

// Dynamic shared memory: f_all[n] (this sweep's whole f, gathered), then
// slice[2][rows] (the block's own rows of f, double-buffered).
template <int kVec>
__global__ void __launch_bounds__(512)
    jacobi_cluster_kernel(const float* __restrict__ A,
                          const float* __restrict__ b,
                          const float* __restrict__ aii_inv,
                          const float* __restrict__ omega,
                          float* __restrict__ out, int n, int n_sweeps,
                          int rows) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* f_all = reinterpret_cast<float*>(smem4);
  float* slice = f_all + n;
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / static_cast<int>(cluster.num_blocks());
  const int row0 = rank * rows;
  const int mine = max(0, min(rows, n - row0));
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const float* Ae = A + static_cast<size_t>(e) * n * n;
  const float w = __ldg(omega + e);

  for (int i = threadIdx.x; i < 2 * rows; i += blockDim.x) slice[i] = 0.f;
  cluster.sync();  // every block's f = 0 before anyone gathers it

  int cur = 0;
  for (int s = 0; s < n_sweeps; ++s) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int owner = i / rows;
      const float* peer = cluster.map_shared_rank(slice, owner);
      f_all[i] = peer[cur * rows + i - owner * rows];
    }
    __syncthreads();
    for (int r = warp; r < mine; r += n_warps) {
      const int row = row0 + r;
      const float* Ar = Ae + static_cast<size_t>(row) * n;
      float sum = row_dot<kVec>(Ar, f_all, n, lane);
#pragma unroll
      for (int m = 16; m > 0; m /= 2) sum += __shfl_xor_sync(kFull, sum, m);
      if (lane == 0) {
        const size_t idx = static_cast<size_t>(e) * n + row;
        const float f_old = slice[cur * rows + r];
        slice[(cur ^ 1) * rows + r] = fmaxf(
            f_old - w * (sum + __ldg(b + idx)) * __ldg(aii_inv + idx), 0.f);
      }
    }
    cluster.sync();
    cur ^= 1;
  }
  for (int r = threadIdx.x; r < mine; r += blockDim.x)
    out[static_cast<size_t>(e) * n + row0 + r] = slice[cur * rows + r];
}

template <int kVec>
cudaError_t cluster_attributes(int cluster, size_t smem) {
  const auto kernel = jacobi_cluster_kernel<kVec>;
  cudaError_t err = cudaSuccess;
  if (cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  return err;
}

cudaLaunchConfig_t cluster_config(int n_envs, int cluster, int threads,
                                  size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_envs * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kVec>
int launch_cluster(const float* A, const float* b, const float* aii_inv,
                   const float* omega, float* out, int n_envs, int n,
                   int n_sweeps, int cluster, int threads,
                   cudaStream_t stream) {
  if (cluster < 1 || cluster > kClusterMax || threads % 32 != 0 ||
      threads > 512 || (kVec == 4 && n % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (n + cluster - 1) / cluster;
  const size_t smem = sizeof(float) * (static_cast<size_t>(n) + 2 * rows);
  cudaError_t err = cluster_attributes<kVec>(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(n_envs, cluster, threads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, jacobi_cluster_kernel<kVec>, A, b, aii_inv,
                           omega, out, n, n_sweeps, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// The large-N path: the same arguments and result as jacobi_solve, for any
// n, launched as n_envs clusters of `cluster` blocks of `threads` threads
// (ops/jacobi.py cluster_shape). vec 4 takes 16-byte loads of A, and needs
// n % 4 == 0 and A 16-byte aligned; vec 1 takes any n.
int jacobi_solve_cluster(const void* A, const void* b, const void* aii_inv,
                         const void* omega, void* out, int n_envs, int n,
                         int n_sweeps, int cluster, int threads, int vec,
                         void* stream) {
  const auto* a = static_cast<const float*>(A);
  const auto* bv = static_cast<const float*>(b);
  const auto* ai = static_cast<const float*>(aii_inv);
  const auto* w = static_cast<const float*>(omega);
  auto* f = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch_cluster<4>(a, bv, ai, w, f, n_envs, n, n_sweeps, cluster,
                             threads, s);
  if (vec == 1)
    return launch_cluster<1>(a, bv, ai, w, f, n_envs, n, n_sweeps, cluster,
                             threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of this shape the card can hold at once
// (cudaOccupancyMaxActiveClusters), written to *active; returns the
// cudaError_t of the query. 0 clusters means the shape cannot launch.
int jacobi_cluster_occupancy(int n, int cluster, int threads, int vec,
                             int* active) {
  const int rows = (n + cluster - 1) / cluster;
  const size_t smem = sizeof(float) * (static_cast<size_t>(n) + 2 * rows);
  cudaError_t err = vec == 4 ? cluster_attributes<4>(cluster, smem)
                             : cluster_attributes<1>(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, cluster, threads, smem, nullptr, &attr);
  err = vec == 4 ? cudaOccupancyMaxActiveClusters(
                       active, jacobi_cluster_kernel<4>, &cfg)
                 : cudaOccupancyMaxActiveClusters(
                       active, jacobi_cluster_kernel<1>, &cfg);
  return static_cast<int>(err);
}

}  // extern "C"
