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
// and its 227 KB of shared memory. That path is jacobi_cluster_kernel, one
// thread-block cluster per env; its own note stands above it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

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

constexpr int kClusterMax = 16;       // the largest cluster of a plan
constexpr int kClusterThreads = 512;  // threads of a cluster block
constexpr int kSmallMax = 224;        // most live rows of one block
constexpr int kSmemLimit = 232448;    // shared memory a block may use
constexpr int kRegVec = 8;  // float4 of a row a lane holds in registers
constexpr int kRegCols = 4 * 32 * kRegVec;  // columns of a register row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive, and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for phase `parity` of the barrier; a wait of ~2^32 cycles (seconds)
// can only be a fault, so trap and fail the launch rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}

// One contiguous global -> shared copy that reports its bytes to `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The address in block `rank` of the cluster of the shared-memory word at
// `addr` in this block.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Store v at `addr` in a peer's shared memory and report its 4 bytes to
// that peer's mbarrier `bar` (both addresses from peer_addr).
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Neither NaN nor +-Inf (every comparison with NaN is false).
__device__ __forceinline__ bool finite_f32(float x) {
  return fabsf(x) <= 3.402823466e+38f;
}

// Byte offsets of a cluster block's dynamic shared memory (ops/jacobi.py
// cluster_shape sums the same): the mbarrier and two ints (the block's live
// rows, a non-finite flag) in the first 32 bytes, then L[n4] (the env's
// live rows in order), flag[r4] (each scanned row live or not), lst[r4]
// (the block's live rows), bo[r4] and aio[r4] (b and aii_inv of its rows in
// the sweeps), then one region: f[2][n4] and `held` rows of A, n4 floats
// each (the dense path), or A[L, L] with rows of m | 1 floats, b, aii_inv
// and f[2] of the live rows (the one-block path, up to `small` rows).
struct ClusterLayout {
  int n4, L, flag, lst, bo, aio, region, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(int n, int rows,
                                                        int held, int small) {
  ClusterLayout s;
  s.n4 = round4(n);
  const int r4 = round4(rows);
  s.L = 32;
  s.flag = s.L + 4 * s.n4;
  s.lst = s.flag + 4 * r4;
  s.bo = s.lst + 4 * r4;
  s.aio = s.bo + 4 * r4;
  s.region = s.aio + 4 * r4;
  const long long dense = 4ll * (2 + held) * s.n4;
  const long long one = 4ll * (static_cast<long long>(small) * (small + 1) +
                               4 * small);
  const long long bytes = s.region + (dense > one ? dense : one);
  s.bytes = bytes > kSmemLimit ? kSmemLimit + 1 : static_cast<int>(bytes);
  return s;
}

// Row `row` of A (n floats at p) by the lanes of a warp: whether it has a
// non-zero entry off the diagonal, and whether any entry is not finite.
// vec: 16-byte loads (n % 4 == 0, p 16-byte aligned).
__device__ __forceinline__ void scan_row(const float* p, int n, int row,
                                         int lane, bool vec, bool& nonzero,
                                         bool& bad) {
  bool z = false, f = false;
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll 4
    for (int k4 = lane; k4 < n / 4; k4 += 32) {
      const float4 a = p4[k4];
      const int k = 4 * k4;
      z |= (a.x != 0.f && k != row) || (a.y != 0.f && k + 1 != row) ||
           (a.z != 0.f && k + 2 != row) || (a.w != 0.f && k + 3 != row);
      f |= !finite_f32(a.x) || !finite_f32(a.y) || !finite_f32(a.z) ||
           !finite_f32(a.w);
    }
  } else {
    for (int k = lane; k < n; k += 32) {
      const float a = p[k];
      z |= a != 0.f && k != row;
      f |= !finite_f32(a);
    }
  }
  nonzero = __any_sync(kFull, z);
  bad = __any_sync(kFull, f);
}

// A held row (m4 floats, zero past the live count) dotted with f: a lane's
// partial sum.
__device__ __forceinline__ float dot_held(const float* __restrict__ a,
                                          const float* f, int m4, int lane) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* f4 = reinterpret_cast<const float4*>(f);
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
  for (int k = lane; k < m4 / 4; k += 32) {
    const float4 x = a4[k];
    const float4 y = f4[k];
    acc0 = fmaf(x.x, y.x, acc0);
    acc1 = fmaf(x.y, y.y, acc1);
    acc0 = fmaf(x.z, y.z, acc0);
    acc1 = fmaf(x.w, y.w, acc1);
  }
  return acc0 + acc1;
}

// Two held rows at once, sharing the loads of f.
__device__ __forceinline__ float2 dot_held2(const float* __restrict__ a,
                                            const float* __restrict__ a2,
                                            const float* f, int m4,
                                            int lane) {
  const float4* p4 = reinterpret_cast<const float4*>(a);
  const float4* q4 = reinterpret_cast<const float4*>(a2);
  const float4* f4 = reinterpret_cast<const float4*>(f);
  float p0 = 0.f, p1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll 4
  for (int k = lane; k < m4 / 4; k += 32) {
    const float4 y = f4[k];
    const float4 x = p4[k];
    const float4 z = q4[k];
    p0 = fmaf(x.x, y.x, p0);
    p1 = fmaf(x.y, y.y, p1);
    p0 = fmaf(x.z, y.z, p0);
    p1 = fmaf(x.w, y.w, p1);
    q0 = fmaf(z.x, y.x, q0);
    q1 = fmaf(z.y, y.y, q1);
    q0 = fmaf(z.z, y.z, q0);
    q1 = fmaf(z.w, y.w, q1);
  }
  return make_float2(p0 + p1, q0 + q1);
}

// A row held in registers (float4 k = lane + 32 j in slot j) dotted with f.
__device__ __forceinline__ float dot_registers(const float4 (&a)[kRegVec],
                                               const float* f, int m4,
                                               int lane) {
  const float4* f4 = reinterpret_cast<const float4*>(f);
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int j = 0; j < kRegVec; ++j) {
    if (lane + 32 * j < m4 / 4) {
      const float4 y = f4[lane + 32 * j];
      acc0 = fmaf(a[j].x, y.x, acc0);
      acc1 = fmaf(a[j].y, y.y, acc1);
      acc0 = fmaf(a[j].z, y.z, acc0);
      acc1 = fmaf(a[j].w, y.w, acc1);
    }
  }
  return acc0 + acc1;
}

// A streamed row: A[row, L[k]] read from L2 for the m live columns.
__device__ __forceinline__ float dot_streamed(const float* __restrict__ ar,
                                              const int* L, const float* f,
                                              int m, int lane) {
  float acc0 = 0.f, acc1 = 0.f;
  int k = lane;
#pragma unroll 2
  for (; k + 32 < m; k += 64) {
    acc0 = fmaf(__ldcg(ar + L[k]), f[k], acc0);
    acc1 = fmaf(__ldcg(ar + L[k + 32]), f[k + 32], acc1);
  }
  if (k < m) acc0 = fmaf(__ldcg(ar + L[k]), f[k], acc0);
  return acc0 + acc1;
}

// The cluster kernel: the projected-Jacobi solve above for N > 224, one
// thread-block cluster of C blocks (16, or 8 where the card cannot hold 16
// of these blocks at once; ops/jacobi.py cluster_size) per env, in one
// launch.
//
// Replaces the same TPU kernel as jacobi_kernel: pallas_jacobi.py:73
// jacobi_solve (body _kernel), 2 * iterations projected sweeps over a dense
// f32 A from f = 0.
//
// What bounds it: one read of A (3.9 MB an env at N = 988), which any
// implementation must make, and then the chain of dependent sweeps over the
// rows that can move. The engine zeroes the Jacobian row of every inactive
// contact (physics/engine.py constraint_forces), which leaves that row of A
// zero off the diagonal and its b zero: on the blocks env ~4 of an env's
// 988 rows are live, so a dense sweep would multiply exact zeros.
//
// Why skipping is exact: call row j dead when b_j == 0 and A_jk == 0 for
// every k != j. From f = 0, if f_j = 0 then its next value is
// max(0 - w (A_jj 0 + 0 + 0) aii_inv_j, 0) = 0 whatever the other f hold, so
// f_j is 0 after every sweep; and A_ij f_j adds exactly 0 to every other
// row i, whatever column j holds. So the sweeps restricted to the live rows
// L, over A[L, L], give the dense result on L and 0 elsewhere. The step
// needs A_jj, aii_inv_j and w finite: an env with any value of A, b,
// aii_inv or w that is not finite takes every row as live, so NaN and Inf
// travel as in the dense sweeps (where fmaxf, as in jacobi_kernel, makes a
// NaN row total's f 0).
//
// The design:
//  1. Scan: block `rank` reads its rows [rank R, rank R + R) of A once
//     (R = ceil(N / C)): the first `held` of them by bulk copies into
//     shared memory (cp.async.bulk, completing on an mbarrier) where N % 4
//     == 0, the rest by plain loads, a warp a row, marking each row live or
//     dead and seeing non-finite values. The blocks read each other's live
//     lists and counts through distributed shared memory after one cluster
//     barrier and build the same ordered list L (m entries) in every block;
//     a second cluster barrier ends all reads of a peer's shared memory.
//  2. m <= `small` (224 where it fits): block 0 alone gathers A[L, L],
//     b[L], aii_inv[L] into its shared memory (rows padded to an odd
//     length: no bank conflicts between rows) and runs every sweep, each
//     row split over G lanes (G from m), one __syncthreads() a sweep and no
//     cluster barrier, then writes f[L]. The other blocks leave once they
//     have written 0 to their dead rows. m = 0 runs no sweep.
//  3. m > `small`: the live rows are split over the cluster's blocks, each
//     block holding its rows of A[L, L] on chip for the whole chain: the
//     first `held` in shared memory (the rows it scanned, when every row is
//     live and they came by bulk copy; else gathered once from L2), the
//     next `in_registers` in registers, one a warp (up to 1024 columns:
//     at N = 988, 55 + 7 of a block's 62 rows), the rest streamed from L2
//     every sweep. Every block keeps the whole f, double-buffered. A sweep:
//     each warp dots its rows with f (16-byte shared loads, two held rows
//     sharing each load of f), and C lanes push the row's new f into the
//     other buffer of every block of the cluster by st.async, a store to
//     distributed shared memory that completes its 4 bytes on that block's
//     mbarrier of the buffer; then each block waits on its own mbarrier for
//     all m values (4 m bytes, armed by one thread at the sweep's start).
//     No barrier of the cluster or the block is in the loop: waiting for
//     the m values of sweep s + 1 in every block replaces the cluster
//     barrier (jacobi_study.py cluster_barrier, plain stores and a cluster
//     barrier a sweep, is 12 % slower at 5 x 988). Two buffers, two
//     mbarriers: a block pushes f_{s+1} into a peer's buffer only once it
//     holds all of f_s, so the peer has pushed all of f_s: it has finished
//     reading that buffer (as f_{s-1}) and completed the phase of its
//     mbarrier that f_{s-1} filled. One cluster barrier after the last
//     sweep keeps every block resident while stores to it may be in
//     flight.
__global__ void __launch_bounds__(kClusterThreads, 1)
    jacobi_cluster_kernel(const float* __restrict__ A,
                          const float* __restrict__ b,
                          const float* __restrict__ aii_inv,
                          const float* __restrict__ omega,
                          float* __restrict__ out, int n, int n_sweeps,
                          int rows, int held, int in_registers, int small,
                          int bulk) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const ClusterLayout lay = cluster_layout(n, rows, held, small);
  const int n4 = lay.n4;
  const uint32_t bar = smem_addr(smem);
  int* sc = reinterpret_cast<int*>(smem + 8);  // live count, non-finite
  // smem + 16 and + 24: the mbarriers of the two f buffers
  int* L = reinterpret_cast<int*>(smem + lay.L);
  int* flag = reinterpret_cast<int*>(smem + lay.flag);
  int* lst = reinterpret_cast<int*>(smem + lay.lst);
  float* bo = reinterpret_cast<float*>(smem + lay.bo);
  float* aio = reinterpret_cast<float*>(smem + lay.aio);
  float* fbuf = reinterpret_cast<float*>(smem + lay.region);
  float* Ah = fbuf + 2 * n4;

  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const int row0 = rank * rows;
  const int mine = max(0, min(rows, n - row0));
  const int staged = bulk ? min(held, mine) : 0;
  const size_t e0 = static_cast<size_t>(e) * n;
  const float* Ae = A + e0 * n;
  const float w = __ldg(omega + e);

  // 1. the scan
  if (tid == 0) {
    sc[1] = !finite_f32(w);
    mbar_init(bar, 1);
    mbar_init(bar + 16, 1);  // f arrives in buffer 0
    mbar_init(bar + 24, 1);  // and in buffer 1
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, static_cast<uint32_t>(staged) * n * 4);
    for (int i = 0; i < staged; ++i)
      bulk_load(smem_addr(Ah + static_cast<size_t>(i) * n4),
                Ae + static_cast<size_t>(row0 + i) * n, n * 4, bar);
  }
  for (int i = tid; i < 2 * n4; i += blockDim.x) fbuf[i] = 0.f;
  // scanned row i (n floats at p), by a warp: live or dead, finite or not
  auto mark = [&](int i, const float* p) {
    bool nonzero, bad;
    scan_row(p, n, row0 + i, lane, bulk, nonzero, bad);
    if (lane == 0) {
      const float bj = __ldg(b + e0 + row0 + i);
      flag[i] = nonzero || bj != 0.f;
      const float ai = __ldg(aii_inv + e0 + row0 + i);
      if (bad || !finite_f32(bj) || !finite_f32(ai)) atomicOr(sc + 1, 1);
    }
  };
  for (int i = staged + warp; i < mine; i += n_warps)  // while copies land
    mark(i, Ae + static_cast<size_t>(row0 + i) * n);
  mbar_wait(bar, 0);
  for (int i = warp; i < staged; i += n_warps)
    mark(i, Ah + static_cast<size_t>(i) * n4);
  __syncthreads();
  if (warp == 0) {  // the block's live rows, in order
    const int per = (mine + 31) / 32;
    const int lo = min(mine, lane * per), hi = min(mine, lo + per);
    int count = 0;
    for (int i = lo; i < hi; ++i) count += flag[i];
    int upto = count;
    for (int d = 1; d < 32; d *= 2) {
      const int t = __shfl_up_sync(kFull, upto, d);
      if (lane >= d) upto += t;
    }
    int at = upto - count;
    for (int i = lo; i < hi; ++i)
      if (flag[i]) lst[at++] = row0 + i;
    if (lane == 31) sc[0] = upto;
  }
  cluster.sync();  // every block's list and flags are written

  // the env's live count m and each block's offset in L: lane q of every
  // warp reads block q's count
  int count_q = 0, bad_q = 0;
  if (lane < C) {
    const int* peer = cluster.map_shared_rank(sc, lane);
    count_q = peer[0];
    bad_q = peer[1];
  }
  int upto_q = count_q;
  for (int d = 1; d < 32; d *= 2) {
    const int t = __shfl_up_sync(kFull, upto_q, d);
    if (lane >= d) upto_q += t;
  }
  const bool bad_env = __any_sync(kFull, bad_q);
  const int m = bad_env ? n : __shfl_sync(kFull, upto_q, 31);
  const bool one_block = m <= small;
  if (!one_block || rank == 0) {
    if (bad_env) {
      for (int k = tid; k < n; k += blockDim.x) L[k] = k;
    } else {
      for (int q = 0; q < C; ++q) {
        const int cq = __shfl_sync(kFull, count_q, q);
        const int oq = __shfl_sync(kFull, upto_q, q) - cq;
        const int* peer = cluster.map_shared_rank(lst, q);
        for (int t = tid; t < cq; t += blockDim.x) L[oq + t] = peer[t];
      }
    }
  }
  if (!bad_env)
    for (int i = tid; i < mine; i += blockDim.x)
      if (!flag[i]) out[e0 + row0 + i] = 0.f;
  cluster.sync();  // no block reads a peer's shared memory until the sweeps

  if (one_block) {
    // 2. the live rows in block 0 alone
    if (rank != 0 || m == 0) return;
    const int ld = m | 1;
    float* As = fbuf;
    float* bs = As + m * ld;
    float* ais = bs + m;
    float* fs = ais + m;  // f[2][m]
    for (int idx = tid; idx < m * m; idx += blockDim.x) {
      const int i = idx / m, k = idx - i * m;
      As[i * ld + k] = Ae[static_cast<size_t>(L[i]) * n + L[k]];
    }
    for (int i = tid; i < m; i += blockDim.x) {
      bs[i] = __ldg(b + e0 + L[i]);
      ais[i] = __ldg(aii_inv + e0 + L[i]);
      fs[i] = 0.f;
      fs[m + i] = 0.f;
    }
    __syncthreads();
    int G = 1;  // lanes a row: about 8 columns a lane
    while (G < 32 && 8 * G < m) G *= 2;
    const int part = tid % G, group = tid / G;
    const int groups = blockDim.x / G;
    const int passes = (m + groups - 1) / groups;
    for (int s = 0; s < n_sweeps; ++s) {
      const float* fc = fs + (s & 1) * m;
      float* fn = fs + ((s & 1) ^ 1) * m;
      for (int p = 0; p < passes; ++p) {
        const int r = group + p * groups;
        float sum = 0.f;
        if (r < m)
          for (int k = part; k < m; k += G)
            sum = fmaf(As[r * ld + k], fc[k], sum);
        for (int mask = G / 2; mask > 0; mask /= 2)
          sum += __shfl_xor_sync(kFull, sum, mask);
        if (part == 0 && r < m)
          fn[r] = fmaxf(fc[r] - w * (sum + bs[r]) * ais[r], 0.f);
      }
      __syncthreads();
    }
    const float* ff = fs + (n_sweeps & 1) * m;
    for (int i = tid; i < m; i += blockDim.x) out[e0 + L[i]] = ff[i];
    return;
  }

  // 3. the live rows over the cluster: local rows [0, hd) in shared
  // memory, [hd, hd + rg) in registers (one a warp), the rest streamed
  const int per_block = (m + C - 1) / C;
  const int c0 = min(m, rank * per_block);
  const int mo = min(m, c0 + per_block) - c0;
  const int hd = min(held, mo);
  const int m4 = round4(m);
  const int rg = m4 <= kRegCols ? min(in_registers, mo - hd) : 0;
  const bool as_scanned = bulk && m == n;  // L is 0..n-1, rows 16B-aligned
  if (!as_scanned) {  // the held rows are not the scanned ones
    for (int idx = tid; idx < hd * m4; idx += blockDim.x) {
      const int i = idx / m4, k = idx - i * m4;
      Ah[static_cast<size_t>(i) * n4 + k] =
          k < m ? Ae[static_cast<size_t>(L[c0 + i]) * n + L[k]] : 0.f;
    }
  }
  for (int i = tid; i < mo; i += blockDim.x) {
    bo[i] = __ldg(b + e0 + L[c0 + i]);
    aio[i] = __ldg(aii_inv + e0 + L[c0 + i]);
  }
  float4 areg[kRegVec];
  const bool has_reg = warp < rg;
  {
    const float* ar =
        Ae + static_cast<size_t>(has_reg ? L[c0 + hd + warp] : 0) * n;
#pragma unroll
    for (int j = 0; j < kRegVec; ++j) {
      const int k4 = lane + 32 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has_reg && k4 < m4 / 4) {
        if (as_scanned) {
          v = __ldg(reinterpret_cast<const float4*>(ar) + k4);
        } else {
          const int k = 4 * k4;
          v.x = k < m ? ar[L[k]] : 0.f;
          v.y = k + 1 < m ? ar[L[k + 1]] : 0.f;
          v.z = k + 2 < m ? ar[L[k + 2]] : 0.f;
          v.w = k + 3 < m ? ar[L[k + 3]] : 0.f;
        }
      }
      areg[j] = v;
    }
  }
  // lane p < C pushes to block p: its f buffers and their mbarriers
  const uint32_t f_peer = lane < C ? peer_addr(smem_addr(fbuf), lane) : 0;
  const uint32_t bar_peer = lane < C ? peer_addr(bar + 16, lane) : 0;
  __syncthreads();
  for (int s = 0; s < n_sweeps; ++s) {
    const float* fc = fbuf + (s & 1) * n4;
    const int nxt = (s & 1) ^ 1;
    if (tid == 0) mbar_expect_tx(bar + 16 + 8 * nxt, 4 * m);
    // the new f of local row i from its row total, stored by C lanes into
    // the other buffer of every block of the cluster
    auto finish = [&](int i, float sum) {
#pragma unroll
      for (int mask = 16; mask > 0; mask /= 2)
        sum += __shfl_xor_sync(kFull, sum, mask);
      const int c = c0 + i;
      const float v = fmaxf(fc[c] - w * (sum + bo[i]) * aio[i], 0.f);
      if (lane < C) push(f_peer + 4 * (nxt * n4 + c), v, bar_peer + 8 * nxt);
    };
    for (int i = warp; i < hd; i += 2 * n_warps) {
      const int i2 = i + n_warps;
      if (i2 < hd) {
        const float2 s2 = dot_held2(Ah + static_cast<size_t>(i) * n4,
                                    Ah + static_cast<size_t>(i2) * n4, fc,
                                    m4, lane);
        finish(i, s2.x);
        finish(i2, s2.y);
      } else {
        finish(i, dot_held(Ah + static_cast<size_t>(i) * n4, fc, m4, lane));
      }
    }
    if (has_reg) finish(hd + warp, dot_registers(areg, fc, m4, lane));
    for (int i = hd + rg + warp; i < mo; i += n_warps)
      finish(i, dot_streamed(Ae + static_cast<size_t>(L[c0 + i]) * n, L, fc,
                             m, lane));
    mbar_wait(bar + 16 + 8 * nxt, (s >> 1) & 1);  // all m values of f
  }
  cluster.sync();  // no block leaves while its pushes may be in flight
  const float* ff = fbuf + (n_sweeps & 1) * n4;
  for (int i = tid; i < mo; i += blockDim.x) out[e0 + L[c0 + i]] = ff[c0 + i];
}

cudaError_t cluster_attributes(int cluster, int smem) {
  cudaError_t err = cudaSuccess;
  if (cluster > 8)
    err = cudaFuncSetAttribute(
        jacobi_cluster_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(jacobi_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  return err;
}

cudaLaunchConfig_t cluster_config(int n_envs, int cluster, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_envs * cluster);
  cfg.blockDim = dim3(kClusterThreads);
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

// The shared memory of a plan, or -1 when the plan is not one the kernel
// takes.
int cluster_smem(int n, int cluster, int rows, int held, int small) {
  if (n < 1 || cluster < 1 || cluster > kClusterMax ||
      rows != (n + cluster - 1) / cluster || held < 0 || held > rows ||
      small < 0 || small > kSmallMax)
    return -1;
  const int bytes = cluster_layout(n, rows, held, small).bytes;
  return bytes > kSmemLimit ? -1 : bytes;
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
// n, launched as n_envs clusters of `cluster` blocks by the plan of
// ops/jacobi.py cluster_shape: `rows` of A scanned a block (ceil(n /
// cluster)), the first `held` of them kept in shared memory and the next
// `in_registers` in registers (at most one a warp, n <= 1024), up to
// `small` live rows solved by one block. bulk 1 reads the held rows by
// bulk copies, and needs n % 4 == 0 and A 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernel does
// not take.
int jacobi_solve_cluster(const void* A, const void* b, const void* aii_inv,
                         const void* omega, void* out, int n_envs, int n,
                         int n_sweeps, int cluster, int rows, int held,
                         int in_registers, int small, int bulk,
                         void* stream) {
  const int smem = cluster_smem(n, cluster, rows, held, small);
  if (smem < 0 || n_envs < 1 || (bulk && n % 4 != 0) || in_registers < 0 ||
      in_registers > min(kClusterThreads / 32, rows - held) ||
      (in_registers > 0 && round4(n) > kRegCols))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cluster_attributes(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      n_envs, cluster, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, jacobi_cluster_kernel,
                           static_cast<const float*>(A),
                           static_cast<const float*>(b),
                           static_cast<const float*>(aii_inv),
                           static_cast<const float*>(omega),
                           static_cast<float*>(out), n, n_sweeps, rows, held,
                           in_registers, small, bulk ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), written to *active; returns the
// cudaError_t of the query. 0 clusters means the plan cannot launch.
int jacobi_cluster_occupancy(int n, int cluster, int rows, int held,
                             int small, int* active) {
  const int smem = cluster_smem(n, cluster, rows, held, small);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cluster_attributes(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, cluster, smem, nullptr, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(active, jacobi_cluster_kernel, &cfg));
}

}  // extern "C"
