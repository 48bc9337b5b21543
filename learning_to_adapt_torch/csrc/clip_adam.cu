// Clip by global norm, then Adam, over every leaf of a parameter tree at
// once and in place: optax.chain(clip_by_global_norm(max_norm),
// adam(lr)) for models/optim.py ClipAdam.step_, through ops/clip_adam.py.
//
// Replaces no TPU kernel: the JAX package's clip and Adam are optax's,
// which XLA fuses into its jitted epoch. The plain version
// (ops/clip_adam.py clip_adam_plain) runs them as ~18 torch._foreach_* ops
// and ~12 one-element kernels; each _foreach launch gives one block to a
// 65,536-element chunk of a leaf, so the fits' 6-8 leaves (286k-549k
// parameters) ran ~9-14 blocks on 132 SMs for each of ~30 launches.
//
// Bound: bytes. A step reads g, p, mu and nu once and writes p, mu and nu,
// 28 bytes a parameter: 8.0 MB for MB-MPC's 286k parameters, 15.4 MB for
// GrBAL's 549k, 2.4-4.6 us at 3.35 TB/s, and all of it fits in the 50 MB
// L2. At that size a launch's latency is the rest of the bound, so the
// design is two launches over a grid that covers every SM (grid-stride
// over units of 4 elements, one a thread at these sizes; 16-byte accesses
// where a leaf's four pointers are aligned, scalar ones for the rest and
// for a leaf's tail):
//   clip_adam_norm_kernel    each block sums g^2 (f32 squares, f64 sums)
//                            over its units into partial[block]; block 0
//                            adds 1 to the step count
//   clip_adam_update_kernel  each thread loads its first unit, then each
//                            block sums the partials in one fixed order
//                            (so every block, and every run, reads the
//                            same norm), takes the clip and the bias
//                            corrections and updates p, mu and nu
// No atomics and no state carried between launches: a step repeats itself
// bit for bit (the multi-rank fits keep their ranks identical), and a CUDA
// graph replays the pair as captured. The leaves' pointers and sizes are
// a kernel argument (a struct by value, as PyTorch's multi_tensor_apply
// passes them), so a capture holds them and no table is copied to the card.
//
// Arithmetic: each product and sum is rounded on its own (__fmul_rn and
// the like, which nvcc never contracts into an FMA) in the plain version's
// order, which is optax's, with the constants as Python's floats cast to
// f32 and the bias corrections 1 - powf(b, count) in f32, as the plain
// version computes them on the card. Where the clip does not fire, a step
// is the plain version's bit for bit; only the norm's summation order
// differs, which shows where it does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 48;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long numel[kMaxLeaves];
  long long first[kMaxLeaves + 1];  // each leaf's first unit of 4 elements
  unsigned long long aligned;       // bit i: leaf i's pointers 16-byte aligned
  int n;
};

struct Hyper {
  float lr, max_norm, b1, b2, one_minus_b1, one_minus_b2, eps;
};

// A thread's units of 4 elements, in grid-stride order: the leaf, first
// element and elements (k, 0 past the last unit) of the current one. A
// thread's units, and so its sums, are fixed by the leaves and the grid.
struct Cursor {
  long long u, e = 0;
  int leaf = 0, k = 0;
  bool vec = false;  // all 4 elements, through 16-byte accesses

  __device__ explicit Cursor(const Leaves& L)
      : u((long long)blockIdx.x * kThreads + threadIdx.x) {
    find(L);
  }
  __device__ void advance(const Leaves& L) {
    u += (long long)gridDim.x * kThreads;
    find(L);
  }
  __device__ void find(const Leaves& L) {
    if (u >= L.first[L.n]) {
      k = 0;
      return;
    }
    while (u >= L.first[leaf + 1]) ++leaf;
    e = 4 * (u - L.first[leaf]);
    const long long left = L.numel[leaf] - e;
    k = left < 4 ? (int)left : 4;
    vec = k == 4 && (L.aligned >> leaf & 1);
  }
};

__device__ __forceinline__ void load4(const float* x, const Cursor& c,
                                      float (&out)[4]) {
  if (c.vec) {
    const float4 t = *reinterpret_cast<const float4*>(x + c.e);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = j < c.k ? x[c.e + j] : 0.0f;
  }
}

__device__ __forceinline__ void store4(float* x, const Cursor& c,
                                       const float (&in)[4]) {
  if (c.vec) {
    *reinterpret_cast<float4*>(x + c.e) = make_float4(in[0], in[1], in[2],
                                                      in[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < c.k) x[c.e + j] = in[j];
  }
}

// The block's sum, in thread 0, in a fixed order: a shuffle tree in each
// warp, then one over the warps.
__device__ __forceinline__ double block_sum(double x,
                                            double (&warps)[kThreads / 32]) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0.0;
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? warps[threadIdx.x] : 0.0;
    for (int o = 16; o > 0; o >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
clip_adam_norm_kernel(const __grid_constant__ Leaves L, double* partial,
                      int* count) {
  __shared__ double warps[kThreads / 32];
  double acc = 0.0;
  for (Cursor c(L); c.k; c.advance(L)) {
    float g[4];
    load4(L.g[c.leaf], c, g);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < c.k) acc += (double)__fmul_rn(g[j], g[j]);
  }
  acc = block_sum(acc, warps);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    if (blockIdx.x == 0) *count += 1;
  }
}

struct Step {
  float norm, bc1, bc2;
  bool keep;
  Hyper h;

  // one element, in the plain version's order
  __device__ __forceinline__ void operator()(float g, float& p, float& m,
                                             float& v) const {
    if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), h.max_norm);
    m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.one_minus_b1));
    v = __fadd_rn(__fmul_rn(v, h.b2),
                  __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
    p = __fsub_rn(p, __fmul_rn(__fdiv_rn(__fdiv_rn(m, bc1), den), h.lr));
  }
};

__global__ void __launch_bounds__(kThreads)
clip_adam_update_kernel(const __grid_constant__ Leaves L,
                        double* partial, int n_partial, const int* count,
                        Hyper h) {
  __shared__ double warps[kThreads / 32];
  __shared__ Step shared;
  // the first unit's loads go out before the norm is known
  Cursor c(L);
  float g[4], p[4], m[4], v[4];
  if (c.k) {
    load4(L.g[c.leaf], c, g);
    load4(L.p[c.leaf], c, p);
    load4(L.m[c.leaf], c, m);
    load4(L.v[c.leaf], c, v);
  }
  double t = 0.0;
  for (int j = threadIdx.x; j < n_partial; j += kThreads) t += partial[j];
  t = block_sum(t, warps);
  if (threadIdx.x == 0) {
    Step s;
    s.norm = __fsqrt_rn((float)t);
    s.keep = s.norm < h.max_norm;
    const float n = (float)*count;
    s.bc1 = __fsub_rn(1.0f, powf(h.b1, n));
    s.bc2 = __fsub_rn(1.0f, powf(h.b2, n));
    s.h = h;
    shared = s;
    // the norm, for the caller, past the partials every block reads
    if (blockIdx.x == 0)
      *reinterpret_cast<float*>(partial + n_partial) = s.norm;
  }
  __syncthreads();
  const Step step = shared;
  while (c.k) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < c.k) step(g[j], p[j], m[j], v[j]);
    store4(L.p[c.leaf], c, p);
    store4(L.m[c.leaf], c, m);
    store4(L.v[c.leaf], c, v);
    c.advance(L);
    if (c.k) {
      load4(L.g[c.leaf], c, g);
      load4(L.p[c.leaf], c, p);
      load4(L.m[c.leaf], c, m);
      load4(L.v[c.leaf], c, v);
    }
  }
}

}  // namespace

// Blocks of both launches for `units` units of 4 elements on the current
// device: one thread a unit, at most kBlocksPerSm blocks an SM.
extern "C" int clip_adam_blocks(long long units, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const long long want = (units + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  *blocks = (int)(want < 1 ? 1 : want < most ? want : most);
  return 0;
}

// One step over n leaves: p, g, m, v their f32 pointers (g read only),
// numel their sizes, count the int32 step count (+1), partial `blocks`
// doubles of scratch and one more, into whose first 4 bytes the norm is
// written. Both launches go on `stream`; returns the cudaError_t.
extern "C" int clip_adam(int n, void* const* p, void* const* g,
                         void* const* m, void* const* v,
                         const long long* numel, void* count, void* partial,
                         int blocks, float lr, float max_norm, float b1,
                         float b2, float one_minus_b1, float one_minus_b2,
                         float eps, void* stream) {
  // ops/clip_adam.py MAX_LEAVES is kMaxLeaves
  if (n < 1 || n > kMaxLeaves || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Leaves L = {};
  L.n = n;
  for (int i = 0; i < n; ++i) {
    L.p[i] = (float*)p[i];
    L.g[i] = (const float*)g[i];
    L.m[i] = (float*)m[i];
    L.v[i] = (float*)v[i];
    L.numel[i] = numel[i];
    L.first[i + 1] = L.first[i] + (numel[i] + 3) / 4;
    const uintptr_t all = (uintptr_t)p[i] | (uintptr_t)g[i] |
                          (uintptr_t)m[i] | (uintptr_t)v[i];
    if (all % 16 == 0) L.aligned |= 1ull << i;
  }
  const Hyper h = {lr, max_norm, b1, b2, one_minus_b1, one_minus_b2, eps};
  cudaStream_t s = (cudaStream_t)stream;
  clip_adam_norm_kernel<<<blocks, kThreads, 0, s>>>(L, (double*)partial,
                                                    (int*)count);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  clip_adam_update_kernel<<<blocks, kThreads, 0, s>>>(
      L, (double*)partial, blocks, (const int*)count, h);
  return (int)cudaGetLastError();
}
