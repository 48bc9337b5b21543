// Grouped fused MLP forward (bf16 products, f32 accumulation), for Hopper.
//
// Replaces the TPU kernel learning_to_adapt_tpu/ops/fused_mlp.py:
// fused_mlp_forward (body _kernel): an L-layer MLP whose every layer is
//
//     h = bf16(h) @ bf16(W) (f32 accumulation) + b (f32), then the hidden
//     nonlinearity (relu / tanh / swish / sigmoid); identity on the output.
//
// This kernel adds a group axis: x (G, R, in) runs through group g's own
// weights W_l[g] and biases b_l[g]. Two kernels share the packed weights,
// the argument struct and the C entry point, and the caller picks one per
// launch (ops/fused_mlp.py `wgmma_path`):
//
//  - fused_mlp_kernel, 16 rows a block on mma.sync, for groups with their
//    own weights and for few rows: GrBAL's planner, G = 5 envs x R = 500
//    candidates, 26 -> 512 -> 512 -> 512 -> 20, 10 launches per env step on
//    the same adapted weights (or one shared set before adaptation);
//  - fused_mlp_kernel_wgmma, 64 rows a block on warpgroup MMA, where one
//    weight set serves every row and the rows fill the SMs: MB-MPC's
//    planner, 1 x 20,000 rows, 26 -> 512 -> 512 -> 20 (below, after the
//    first kernel).
//
// The weights arrive packed (ops/fused_mlp.py pack_weights, once per env
// step): per group, one bf16 stream of equal 64-deep x 128-wide tiles in the
// order both kernels consume them (layer, 128-column output chunk, k-tile),
// zero-padded at ragged edges, each tile already laid out as the shared
// memory image the fragment loads read: column-major (32 words of k pairs
// per column) with the 16-byte groups of column n XOR-swizzled by (n & 7),
// so B-fragment loads are free of bank conflicts without padding. That is
// also warpgroup MMA's K-major B operand with the 128-byte swizzle (the
// swizzle XORs address bits 4-6 with bits 7-9, the column within its 8),
// so the second kernel reads the same tiles through a matrix descriptor. A
// group stride of 0 gives one weight set shared by all groups without a
// copy. The rounding to bf16 (round-to-nearest-even) happens in the pack,
// as the JAX wrapper casts outside its Pallas body.
//
// fused_mlp_kernel, at GrBAL's launch. What bounds it on an H100:
// operations. One launch reads 5.5 MB of bf16
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
//
// fused_mlp_kernel_wgmma: at MB-MPC's launch the 16-row kernel runs 1,250
// blocks, each streaming the whole 704 KB tile stream from L2 (880 MB a
// launch) for 16 rows of mma.sync products. This one takes 64 rows a block
// (one warpgroup m-tile), and multiplies with wgmma.mma_async m64nNk16
// (bf16 operands, f32 accumulators in registers):
//  - A, the block's activations, and B, the weight tiles, both come from
//    shared memory through descriptors (K-major, 128-byte swizzle). The
//    activations are kept in that layout: per 64 columns of k, 64 rows of
//    128 bytes, groups of 8 k XOR-swizzled by (row & 7); the epilogue
//    writes them so and the input rows are stored so;
//  - a ring stage holds k-tile kc of two adjacent 128-column chunks, which
//    the tile layout makes one 256-row B operand, so the products run
//    N = 256 wide (an output chunk left alone: N = 128; the output layer's
//    last chunk N = 24 or 48 where its columns fit, HalfCheetah's 20, the
//    arm's 23, the Ant's 41, and only those columns are copied);
//  - two blocks form a cluster and share the tiles: each copies half of
//    every tile into both (cp.async.bulk .multicast::cluster), so a launch
//    reads each tile from L2 once for 128 rows (~94 MB at MB-MPC's launch,
//    a ninth of the 16-row kernel's), and a stage is refilled once both
//    blocks' consumers have freed it (their arrivals on each block's
//    "empty" mbarrier);
//  - one producer warp fills kWStages 32 KB stages through mbarriers as
//    above; one consumer warpgroup issues a stage's 4 k16 products, commits
//    them, and frees the previous stage once its group is done, so one
//    stage's products overlap the wait for the next;
//  - the epilogue adds the f32 bias, applies the activation (a template
//    argument: one activation's code in the unrolled epilogue) and writes
//    bf16 for the next layer; the output layer writes f32 with ragged rows
//    and columns masked. Two activation buffers (a layer's input and
//    output) of 64 rows x 1 KB at width 512 and the ring fill ~225 KB: one
//    block an SM.
// One weight set serves all rows: the groups' rows are one (G * R) matrix,
// as x and out are contiguous. Widths whose buffers and ring exceed shared
// memory (wider than 512) go to the 16-row kernel (`wgmma_path`). What
// bounds it (fused_mlp_study.py, PERF.md): the products alone and the tile
// stream alone each take most of a launch, and 313 blocks fill 132 SMs in
// three waves, the last a third full.
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
  int act_bytes;  // fused_mlp_kernel_wgmma: bytes of one activation buffer
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

// ------------------------------------------------- fused_mlp_kernel_wgmma
constexpr int kWM = 64;                          // rows a block: one m-tile
constexpr int kWThreads = 128 + 32;              // a warpgroup + a producer
constexpr int kWPair = 2;                        // tiles a stage: N = 256
constexpr int kWStageBytes = kWPair * kTileBytes;
constexpr int kWStages = 3;                      // ring depth
constexpr int kWRowBytes = 2 * kKC;              // 64 k of one row
constexpr int kWKBlockBytes = kWM * kWRowBytes;  // 64 k of the 64 rows: 8 KB
constexpr int kAlign = 1024;                     // the 128-byte swizzle's atom
constexpr int kWCluster = 2;                     // blocks sharing each tile

// Width of the products of an output-layer chunk of w columns: N = 24 or 48
// where they fit, else the whole 128-column chunk.
__device__ __forceinline__ int wg_width(int w) {
  return w <= 24 ? 24 : w <= 48 ? 48 : kNC;
}

// Shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 bytes (64 bf16 of k), 8-row groups 1,024 bytes apart (the
// stride byte offset); the leading byte offset is unused in this layout.
// Adding 2 moves it 32 bytes, one k16 step, along k.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset of (row r, column c) in an activation buffer: 64-column
// blocks of kWKBlockBytes, rows of 128 bytes, the 16-byte group of column c
// XOR-swizzled by (r & 7), as the products read it from a 1,024-aligned
// base.
__device__ __forceinline__ uint32_t wg_act_off(int r, int c) {
  return (c >> 6) * kWKBlockBytes + r * kWRowBytes +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void wg_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// activate(v, act) with the activation fixed at compile time: the unrolled
// epilogue then holds one activation's code, not the four of a switch.
template <int ACT>
__device__ __forceinline__ float activate_t(float v) {
  if (ACT == 0) return fmaxf(v, 0.f);
  if (ACT == 1) return tanhf(v);
  if (ACT == 2) return v * (1.f / (1.f + expf(-v)));
  return 1.f / (1.f + expf(-v));
}

// Makes this thread's generic writes to shared memory (the activations)
// visible to the products, which read through the async proxy.
__device__ __forceinline__ void wg_fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of the consumer warpgroup only.
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Barrier of every thread of the cluster's blocks.
__device__ __forceinline__ void wg_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// Frees a ring stage: one arrival on its "empty" mbarrier in every block of
// the cluster, since each block's producer copies into all of them. The
// arrivals release at the block's scope, as the wait before them has
// finished the products' reads of the stage (an arrival that releases at
// the cluster's scope costs ~700 cycles a stage).
__device__ __forceinline__ void wg_release(uint32_t bar) {
  mbar_arrive(bar);
  const uint32_t rank = cta_rank();
#pragma unroll
  for (uint32_t r = 0; r < kWCluster; ++r) {
    if (r == rank) continue;
    uint32_t peer;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(peer) : "r"(bar), "r"(r));
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(peer)
                 : "memory");
  }
}

// One contiguous global -> shared copy into the same offset of every block
// of the cluster, reported to each block's mbarrier at `bar`'s offset.
__device__ __forceinline__ void bulk_load_all(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar),
      "h"(static_cast<uint16_t>((1 << kWCluster) - 1))
      : "memory");
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D8(i) WG_D4(i), WG_D4(i + 4)
#define WG_D32(i) WG_D8(i), WG_D8(i + 8), WG_D8(i + 16), WG_D8(i + 24)

// d (64 x N, f32) += A (64 x 16, bf16) B (16 x N, bf16), both from shared
// memory by descriptor; d holds N / 2 values a thread.
template <int N>
__device__ __forceinline__ void wg_mma(float (&d)[N / 2], uint64_t a,
                                       uint64_t b);

template <>
__device__ __forceinline__ void wg_mma<256>(float (&d)[128], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0), WG_D32(32), WG_D32(64), WG_D32(96)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wg_mma<128>(float (&d)[64], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wg_mma<48>(float (&d)[24], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wg_mma<24>(float (&d)[12], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D4(8)
      : "l"(a), "l"(b), "r"(1));
}

#undef WG_D32
#undef WG_D8
#undef WG_D4

// The N output columns of layer L from column nc * 128 on (two chunks at
// N = 256) for the block's 64 rows: the layer's k-steps from the ring (its
// t-th stage use onwards; returns the count after them), then the epilogue
// into `aout` (bf16, swizzled) or, on the output layer, into args.out (f32,
// masked).
template <int N, int ACT>
__device__ __forceinline__ int wg_chunk(const MlpArgs& args, const Layer& L,
                                        bool last, int nc, int t,
                                        uint32_t ain, uint8_t* aout,
                                        uint32_t ring, uint32_t full0,
                                        uint32_t empty0, int row0) {
  const int nk = (L.k + kKC - 1) / kKC;
  constexpr int R = N / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's bias columns, loaded ahead of the k-loop
  float bias[N / 8][2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nc * kNC + 8 * j + 2 * tig + e;
      bias[j][e] = col < L.n ? L.b[col] : 0.f;
    }
  float d[R];
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
  wg_pin(d);

  for (int kc = 0; kc < nk; ++kc, ++t) {
    const int s = t % kWStages;
    mbar_wait(full0 + 8 * s, (t / kWStages) & 1);
    const uint64_t da = wg_desc(ain + kc * kWKBlockBytes);
    const uint64_t db = wg_desc(ring + s * kWStageBytes);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks)
      wg_mma<N>(d, da + 2 * ks, db + 2 * ks);
    wg_commit();
    wg_pin(d);
    if (kc > 0) {  // the previous stage's products are done: free it
      wg_wait<1>();
      wg_pin(d);
      if (lane == 0) wg_release(empty0 + 8 * ((t - 1) % kWStages));
    }
  }
  wg_wait<0>();
  wg_pin(d);
  if (lane == 0) wg_release(empty0 + 8 * ((t - 1) % kWStages));

  // d[4j + 2h + e]: row warp * 16 + gid + 8h, column 8j + 2 tig + e
  if (!last) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + gid + 8 * h;
        const int col = nc * kNC + 8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(aout + wg_act_off(r, col)) = pack_bf16(
            activate_t<ACT>(d[4 * j + 2 * h] + bias[j][0]),
            activate_t<ACT>(d[4 * j + 2 * h + 1] + bias[j][1]));
      }
    return t;
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gid + 8 * h;
      const int col = nc * kNC + 8 * j + 2 * tig;
      if (row0 + r < args.rows) {
        float* o = args.out + static_cast<size_t>(row0 + r) * L.n;
        if (col < L.n) o[col] = d[4 * j + 2 * h] + bias[j][0];
        if (col + 1 < L.n) o[col + 1] = d[4 * j + 2 * h + 1] + bias[j][1];
      }
    }
  return t;
}

// The consumer warpgroup: this block's 64 rows through every layer, 256
// output columns at a time.
template <int ACT>
__device__ __forceinline__ void wg_consume(const MlpArgs& args, uint8_t* act0,
                                           uint8_t* act1, uint32_t ring,
                                           uint32_t full0, uint32_t empty0) {
  const int row0 = blockIdx.x * kWM;
  // this block's rows of x, rounded to bf16, zero-padded to whole k-tiles
  const int in_dim = args.layers[0].k;
  const int pairs = (in_dim + kKC - 1) / kKC * kKC / 2;
  for (int idx = threadIdx.x; idx < kWM * pairs; idx += 128) {
    const int r = idx / pairs, c = 2 * (idx - r * pairs);
    const int row = row0 + r;
    float v0 = 0.f, v1 = 0.f;
    if (row < args.rows) {
      const float* xr = args.x + static_cast<size_t>(row) * in_dim;
      if (c < in_dim) v0 = xr[c];
      if (c + 1 < in_dim) v1 = xr[c + 1];
    }
    *reinterpret_cast<uint32_t*>(act0 + wg_act_off(r, c)) = pack_bf16(v0, v1);
  }
  wg_fence_smem();
  wg_sync();

  int t = 0;  // stages used so far
  for (int l = 0; l < args.n_layers; ++l) {
    const Layer L = args.layers[l];
    const bool last = l == args.n_layers - 1;
    const int nn = (L.n + kNC - 1) / kNC;
    const uint32_t ain = smem_addr(l & 1 ? act1 : act0);
    uint8_t* aout = l & 1 ? act0 : act1;
    for (int nc = 0; nc < nn; nc += kWPair) {
      const int w = nc + 1 < nn ? 2 * kNC
                    : last      ? wg_width(L.n - nc * kNC)
                                : kNC;
      if (w == 2 * kNC)
        t = wg_chunk<2 * kNC, ACT>(args, L, last, nc, t, ain, aout, ring,
                                   full0, empty0, row0);
      else if (w == kNC)
        t = wg_chunk<kNC, ACT>(args, L, last, nc, t, ain, aout, ring,
                               full0, empty0, row0);
      else if (w == 48)
        t = wg_chunk<48, ACT>(args, L, last, nc, t, ain, aout, ring, full0,
                              empty0, row0);
      else
        t = wg_chunk<24, ACT>(args, L, last, nc, t, ain, aout, ring, full0,
                              empty0, row0);
    }
    wg_fence_smem();
    wg_sync();  // aout complete before it is read as the next input
  }
}

// args.rows: all rows (the groups' rows as one matrix, one weight set);
// args.act_bytes: bytes of one activation buffer; ACT: args.act.
template <int ACT>
__global__ void __launch_bounds__(kWThreads, 1)
fused_mlp_kernel_wgmma(const MlpArgs args) {
  extern __shared__ __align__(1024) uint8_t wsmem[];
  uint8_t* base = wsmem + ((kAlign - (smem_addr(wsmem) & (kAlign - 1))) &
                           (kAlign - 1));
  // the ring, then two activation buffers, then the "full" and "empty"
  // mbarriers of the ring's stages
  uint8_t* act0 = base + kWStages * kWStageBytes;  // 1,024-aligned
  uint8_t* act1 = act0 + args.act_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(act1 + args.act_bytes);
  const uint32_t ring = smem_addr(base);
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = full0 + 8 * kWStages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      // one arrival per consumer warp of each block of the cluster
      mbar_init(empty0 + 8 * s, 4 * kWCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the peers' barriers are ready before any copy or arrival reaches them
  wg_cluster_sync();

  if (warp == 4) {  // producer: one thread streams every tile
    const uint32_t rank = cta_rank();
    if (lane == 0) {
      int t = 0;  // tiles of the stream before this layer's
      int q = 0;  // stages filled so far
      for (int l = 0; l < args.n_layers; ++l) {
        const Layer L = args.layers[l];
        const int nk = (L.k + kKC - 1) / kKC;
        const int nn = (L.n + kNC - 1) / kNC;
        for (int nc = 0; nc < nn; nc += kWPair) {
          // a stage holds k-tile kc of chunks nc and nc + 1; of a single
          // chunk in the output layer, the columns multiplied only
          const int tiles = nc + 1 < nn ? 2 : 1;
          const uint32_t bytes =
              tiles == 1 && l == args.n_layers - 1
                  ? kWRowBytes * wg_width(L.n - nc * kNC)
                  : kTileBytes;
          // this block copies its share of each tile into every block
          const uint32_t part = bytes / kWCluster, off = rank * part;
          for (int kc = 0; kc < nk; ++kc, ++q) {
            const int s = q % kWStages;
            if (q >= kWStages)
              mbar_wait(empty0 + 8 * s, (q / kWStages - 1) & 1);
            mbar_expect_tx(full0 + 8 * s, tiles * bytes);
            for (int i = 0; i < tiles; ++i)
              bulk_load_all(
                  ring + s * kWStageBytes + i * kTileBytes + off,
                  args.w + static_cast<size_t>(t + (nc + i) * nk + kc) *
                               kTileBytes + off,
                  part, full0 + 8 * s);
          }
        }
        t += nn * nk;
      }
    }
  } else {
    wg_consume<ACT>(args, act0, act1, ring, full0, empty0);
  }
  // no block leaves while its peers may still copy into it or arrive on it
  wg_cluster_sync();
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

int wgmma_act_bytes(int n_layers, const int* dims) {
  // the widest activation, as act_words, in 64-column blocks of 64 rows
  int width = round_up(dims[0], kKC);
  for (int l = 1; l < n_layers; ++l) {
    const int w = round_up(dims[l], kNC);
    if (w > width) width = w;
  }
  return width / kKC * kWKBlockBytes;
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

// Shared-memory bytes of one fused_mlp_kernel_wgmma block: the alignment
// slack, the ring, two activation buffers, the mbarriers.
int fused_mlp_wgmma_smem_bytes(int n_layers, const int* dims) {
  return kAlign + kWStages * kWStageBytes +
         2 * wgmma_act_bytes(n_layers, dims) + 2 * kWStages * 8;
}

// x (groups, rows, dims[0]) and out (groups, rows, dims[n_layers]):
// contiguous float32. w: the packed bf16 tile stream of group 0 (16-byte
// aligned), group g at w + g * w_gstride bytes. Layer l's bias (dims[l+1],)
// float32 at b_ptrs[l], group g at offset g * b_gstrides[l] elements.
// act: 0 relu, 1 tanh, 2 swish, 3 sigmoid. wgmma: 0 launches
// fused_mlp_kernel, 1 fused_mlp_kernel_wgmma, which needs one weight set for
// all groups (w_gstride and every b_gstrides 0, or one group). Launches on
// `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue for bad
// arguments).
int fused_mlp_forward(const void* x, void* out, int groups, int rows,
                      int n_layers, const int* dims, const void* w,
                      long long w_gstride, const unsigned long long* b_ptrs,
                      const long long* b_gstrides, int act, int wgmma,
                      void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || act < 0 || act > 3 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || w_gstride % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wgmma && groups > 1) {
    bool shared = w_gstride == 0;
    for (int l = 0; l < n_layers; ++l) shared = shared && b_gstrides[l] == 0;
    if (!shared) return static_cast<int>(cudaErrorInvalidValue);
  }
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
  args.act_bytes = wgmma_act_bytes(n_layers, dims);
  if (wgmma) {
    void (*const kernels[])(MlpArgs) = {
        fused_mlp_kernel_wgmma<0>, fused_mlp_kernel_wgmma<1>,
        fused_mlp_kernel_wgmma<2>, fused_mlp_kernel_wgmma<3>};
    args.rows = groups * rows;
    const int smem = fused_mlp_wgmma_smem_bytes(n_layers, dims);
    cudaError_t err = cudaFuncSetAttribute(
        kernels[act], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    const int blocks = (args.rows + kWM - 1) / kWM;
    cfg.gridDim = dim3((blocks + kWCluster - 1) / kWCluster * kWCluster);
    cfg.blockDim = dim3(kWThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kWCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernels[act], args);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
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
