// Grouped fused MLP forward (bf16 products, f32 accumulation), for Hopper.
//
// Replaces the TPU kernel learning_to_adapt_tpu/ops/fused_mlp.py:
// fused_mlp_forward (body _kernel): an L-layer MLP whose every layer is
//
//     h = bf16(h) @ bf16(W) (f32 accumulation) + b (f32), then the hidden
//     nonlinearity (relu / tanh / swish / sigmoid); identity on the output.
//
// This kernel adds a group axis: x (G, R, in) runs through group g's own
// weights W_l[g] and biases b_l[g]. On the planner path G = 5 envs, R = 500
// candidates, 26 -> 512 -> 512 -> 512 -> 20, 10 launches per env step on
// the same adapted weights.
//
// The weights arrive packed (ops/fused_mlp.py pack_weights, once per env
// step): per group, one bf16 stream of equal 64-deep x 128-wide tiles in the
// order this kernel consumes them (layer, 128-column output chunk, k-tile),
// zero-padded at ragged edges, each tile already laid out as the shared
// memory image the fragment loads read: column-major (32 words of k pairs
// per column) with the 16-byte groups of column n XOR-swizzled by (n & 7),
// so B-fragment loads are free of bank conflicts without padding. A group
// stride of 0 gives one weight set shared by all groups without a copy. The
// rounding to bf16 (round-to-nearest-even) happens in the pack, as the JAX
// wrapper casts outside its Pallas body.
//
// What bounds it on an H100: operations. One launch reads 5.5 MB of bf16
// weights (1.1 MB per group) and does 2.74 GFLOP of bf16 products: ~2.8 us
// at 989 TFLOP/s against ~1.8 us of bytes at 3.35 TB/s. This kernel stays
// on mma.sync, which peaks near 0.5 PFLOP/s on the card (a microbenchmark,
// PERF.md), and each block re-reads its group's 1.2 MB of tiles from L2
// (~200 MB per launch at 16 rows per block). Measured with the parts taken
// out one at a time (PERF.md): streaming the tiles alone takes about 60%
// of a launch, the products alone over 90%, so the consumer warps'
// fragment loads and products are what a launch waits on.
//
// What the design does about that:
//  - one block owns a 16-row (kBM) tile of one group: 160 blocks on 132
//    SMs at the planner's shape, 2 per SM where they land together (~97 KB
//    of shared memory each; 32-row blocks measured slower, PERF.md). Its activation stays in
//    shared memory, as bf16, across all layers (ping-pong buffers, rows
//    padded by 4 words so fragment loads hit 32 distinct banks): no
//    inter-layer activation goes to device memory;
//  - weight tiles stream through a ring of kStages 16 KB stages, each filled
//    by one bulk copy (cp.async.bulk, one thread of a producer warp) that
//    completes on the stage's "full" mbarrier. The 8 consumer warps wait on
//    it by phase parity, multiply, and each arrives once on the stage's
//    "empty" mbarrier, which the producer waits on before it refills the
//    stage. So kStages - 1 tiles are in flight while one is multiplied and
//    no block-wide barrier is taken per tile: the consumers synchronise only
//    after loading x and at each layer's end (the activations swap). The
//    stream is one sequence of equal tiles, so the next layer's first tiles
//    arrive during the current layer's epilogue. Deeper rings measured no
//    faster;
//  - products use mma.sync m16n8k16 bf16 with f32 accumulators; each of the
//    8 consumer warps owns 16 of the 128 columns of an output chunk for all
//    kBM rows. Fragments come in by ldmatrix.x4, all of a tile's before its
//    products, so the loads overlap. Biases are read as f32 ahead of each
//    chunk's k-loop; the last layer writes f32 with ragged rows and columns
//    masked.
// Warpgroup MMA, copies through a tensor descriptor and multicast of weight
// tiles across blocks are left for later; the products stay on mma.sync.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kBM = 16;                       // rows of x per block
constexpr int kNC = 128;                      // output columns per tile
constexpr int kKC = 64;                       // depth of one weight tile
constexpr int kTileWords = kKC / 2 * kNC;     // bf16 pairs per tile
constexpr int kTileBytes = 4 * kTileWords;    // 16 KB
constexpr int kStages = 4;                    // ring depth
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;     // + 1 producer warp

struct Layer {
  const float* b;
  long long b_gstride;
  int k;
  int n;
};

struct MlpArgs {
  Layer layers[kMaxLayers];
  const char* w;          // packed tiles of group 0
  long long w_gstride;    // bytes between groups' tile streams (0: shared)
  const float* x;
  float* out;
  int n_layers;
  int n_tiles;
  int act;
  int rows;
  int act_words;  // 32-bit words per activation row in shared memory
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 0: return fmaxf(v, 0.f);
    case 1: return tanhf(v);
    case 2: return v * (1.f / (1.f + expf(-v)));
    default: return 1.f / (1.f + expf(-v));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive, and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait of more than ~2^32 cycles (seconds) can only be a fault: trap, so
// the launch fails instead of hanging the card.
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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}

// Four 8x8 b16 matrices from shared memory; lanes 8j..8j+7 give the row
// addresses of matrix j, which lands in r[j].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// Barrier of the consumer warps only (the producer warp has left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const MlpArgs args) {
  constexpr int MT = kBM / 16;  // 16-row m-tiles per warp
  extern __shared__ __align__(128) uint32_t smem[];
  const int SA = args.act_words;
  uint32_t* ring = smem;                          // kStages tiles
  uint32_t* ain = ring + kStages * kTileWords;    // (kBM, SA) bf16 pairs
  uint32_t* aout = ain + kBM * SA;                // (kBM, SA)
  uint64_t* bars = reinterpret_cast<uint64_t*>(aout + kBM * SA);
  const uint32_t full0 = smem_addr(bars);         // full[s] at full0 + 8 s
  const uint32_t empty0 = smem_addr(bars + kStages);

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: one thread streams every tile
    if (lane == 0) {
      const char* src = args.w + g * args.w_gstride;
      for (int t = 0; t < args.n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, kTileBytes);
        bulk_load(smem_addr(ring + s * kTileWords),
                  src + static_cast<size_t>(t) * kTileBytes, kTileBytes,
                  full0 + 8 * s);
      }
    }
    return;
  }

  const int gid = lane >> 2, tig = lane & 3;

  // this tile of x, rounded to bf16, zero-padded to a whole weight tile
  const int in_dim = args.layers[0].k;
  const int kw0 = (in_dim + kKC - 1) / kKC * kKC / 2;
  const float* xg = args.x + static_cast<size_t>(g) * args.rows * in_dim;
  for (int idx = threadIdx.x; idx < kBM * kw0; idx += kConsumers) {
    const int r = idx / kw0, c = 2 * (idx - r * kw0);
    const int row = row0 + r;
    float v0 = 0.f, v1 = 0.f;
    if (row < args.rows) {
      const float* xr = xg + static_cast<size_t>(row) * in_dim;
      if (c < in_dim) v0 = xr[c];
      if (c + 1 < in_dim) v1 = xr[c + 1];
    }
    ain[r * SA + c / 2] = pack_bf16(v0, v1);
  }
  consumer_sync();

  // ldmatrix row addresses of this lane. A (row-major activations): lanes
  // 0-15 give rows 0-15 at k 0-7, lanes 16-31 the same rows at k 8-15.
  // B (tile column n holds 64 k): lanes 8j..8j+7 give columns n of matrix
  // j = (n-tile j / 2, k half j % 2), so b[0..3] = b0, b1 of n-tiles 0, 1.
  const uint32_t ring_addr = smem_addr(ring);
  const uint32_t b_col = 4 * (kKC / 2) * (warp * 16 + (lane >> 4) * 8 +
                                          (lane & 7));
  const int b_half = (lane >> 3) & 1;
  const int a_lane = (lane & 15) * SA + (lane >> 4) * 4;

  int t = 0;  // index of the next tile in the packed stream
  for (int l = 0; l < args.n_layers; ++l) {
    const uint32_t a_addr = smem_addr(ain) + 4 * a_lane;
    const Layer L = args.layers[l];
    const float* B = L.b + g * L.b_gstride;
    const bool last = l == args.n_layers - 1;
    const int nk = (L.k + kKC - 1) / kKC;
    const int nn = (L.n + kNC - 1) / kNC;

    for (int nc = 0; nc < nn; ++nc) {
      float acc[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
      // this thread's bias columns, loaded ahead of the k-loop
      float bias[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nc * kNC + warp * 16 + nt * 8 + 2 * tig + j;
          bias[nt][j] = col < L.n ? B[col] : 0.f;
        }

      for (int kc = 0; kc < nk; ++kc, ++t) {
        const int s = t % kStages;
        mbar_wait(full0 + 8 * s, (t / kStages) & 1);
        // every fragment of the tile first, then the products: the loads
        // overlap instead of each product waiting on its own load
        const uint32_t wt = ring_addr + s * kTileBytes;
        constexpr int KS = kKC / 16;
        uint32_t a[KS][MT][4], b[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[ks][mt], a_addr + 4 * (mt * 16 * SA + kc * (kKC / 2) +
                                             ks * 8));
          // 16-byte group j of column n sits at group j ^ (n & 7)
          ldsm_x4(b[ks], wt + b_col + 16 * ((2 * ks + b_half) ^ (lane & 7)));
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_bf16(acc[mt][nt], a[ks][mt], b[ks][2 * nt],
                       b[ks][2 * nt + 1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);  // stage s may refill
      }

      // epilogue of output chunk nc
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = mt * 16 + gid + half * 8;
            const int col = nc * kNC + warp * 16 + nt * 8 + 2 * tig;
            const float v0 = acc[mt][nt][2 * half] + bias[nt][0];
            const float v1 = acc[mt][nt][2 * half + 1] + bias[nt][1];
            if (!last) {
              aout[r * SA + col / 2] =
                  pack_bf16(activate(v0, args.act), activate(v1, args.act));
            } else if (row0 + r < args.rows) {
              float* o = args.out +
                         (static_cast<size_t>(g) * args.rows + row0 + r) * L.n;
              if (col < L.n) o[col] = v0;
              if (col + 1 < L.n) o[col + 1] = v1;
            }
          }
    }
    consumer_sync();  // aout complete before it is read as the next input
    uint32_t* tmp = ain;
    ain = aout;
    aout = tmp;
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

int act_words(int n_layers, const int* dims) {
  // widest activation the block keeps: the input padded to whole k-tiles,
  // every hidden layer padded to whole output chunks; /2 for bf16 pairs,
  // +4 words so that 8 rows x 4 pair-columns of a fragment load hit 32
  // distinct banks
  int width = round_up(dims[0], kKC);
  for (int l = 1; l < n_layers; ++l) {
    const int w = round_up(dims[l], kNC);
    if (w > width) width = w;
  }
  return width / 2 + 4;
}

}  // namespace

extern "C" {

int fused_mlp_max_layers() { return kMaxLayers; }

// Bytes of one packed weight tile (kKC x kNC bf16).
int fused_mlp_tile_bytes() { return kTileBytes; }

// Shared-memory bytes of one block for layer widths dims[0..n_layers]: the
// ring, two activation buffers, the mbarriers.
int fused_mlp_smem_bytes(int n_layers, const int* dims) {
  return kStages * kTileBytes + 2 * kBM * act_words(n_layers, dims) * 4 +
         2 * kStages * 8;
}

// x (groups, rows, dims[0]) and out (groups, rows, dims[n_layers]):
// contiguous float32. w: the packed bf16 tile stream of group 0 (16-byte
// aligned), group g at w + g * w_gstride bytes. Layer l's bias (dims[l+1],)
// float32 at b_ptrs[l], group g at offset g * b_gstrides[l] elements.
// act: 0 relu, 1 tanh, 2 swish, 3 sigmoid. Launches on `stream`; returns cudaGetLastError() (or
// cudaErrorInvalidValue for bad arguments).
int fused_mlp_forward(const void* x, void* out, int groups, int rows,
                      int n_layers, const int* dims, const void* w,
                      long long w_gstride, const unsigned long long* b_ptrs,
                      const long long* b_gstrides, int act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || act < 0 || act > 3 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || w_gstride % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups <= 0 || rows <= 0) return 0;
  MlpArgs args;
  int n_tiles = 0;
  for (int l = 0; l < n_layers; ++l) {
    args.layers[l].b = reinterpret_cast<const float*>(b_ptrs[l]);
    args.layers[l].b_gstride = b_gstrides[l];
    args.layers[l].k = dims[l];
    args.layers[l].n = dims[l + 1];
    n_tiles += (dims[l] + kKC - 1) / kKC * ((dims[l + 1] + kNC - 1) / kNC);
  }
  args.w = static_cast<const char*>(w);
  args.w_gstride = w_gstride;
  args.x = static_cast<const float*>(x);
  args.out = static_cast<float*>(out);
  args.n_layers = n_layers;
  args.n_tiles = n_tiles;
  args.act = act;
  args.rows = rows;
  args.act_words = act_words(n_layers, dims);
  const int smem = fused_mlp_smem_bytes(n_layers, dims);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((rows + kBM - 1) / kBM, groups);
  fused_mlp_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
