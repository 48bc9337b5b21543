"""What bounds the fused-MLP kernel: timings of variants of its source.

    python3 fused_mlp_study.py

Needs an NVIDIA card and nvcc; run from the repository root. Builds
learning_to_adapt_torch/csrc/fused_mlp.cu as it is and with parts taken out
by text substitution, each at its 16 rows per block and at 32 (the `kBM`
constant), and times each at the planner's shape (5 groups x 500 rows,
26 -> 512 -> 512 -> 512 -> 20, relu, packed weights) by the kernel's own
device time in a torch.profiler window:

  kept            the source as it is
  ring3/6/8       the ring with 3, 6 or 8 stages instead of 4
  stream_only     tiles stream through the ring; no fragment loads or products
  no_copies       the producer signals each stage without copying into it
  products_only   no copies and no waits: fragment loads and products alone
  handshake_only  neither copies nor products: the mbarrier ring alone

Variants other than `kept` and the ring depths compute wrong results and
are timed only. The substitutions match the kernel's text exactly, so an
edit of a line they match makes this script raise until they follow it.
Then a microbenchmark of mma.sync m16n8k16 bf16 (f32 accumulation) gives
the rate that path can reach on this card. Prints one line per measurement
and the card (name, power limit) first.
"""
import ctypes
import subprocess

import torch

from learning_to_adapt_torch.ops import build
from learning_to_adapt_torch.ops import fused_mlp as fm

DIMS = (26, 512, 512, 512, 20)
GROUPS, ROWS = 5, 500

_ROWS32 = ('constexpr int kBM = 16;', 'constexpr int kBM = 32;')
_LOADS = ('        for (int ks = 0; ks < KS; ++ks) {\n',
          '        for (int ks = 0; ks < 0; ++ks) {\n')
_PRODUCTS = ('        for (int ks = 0; ks < KS; ++ks)\n#pragma unroll\n',
             '        for (int ks = 0; ks < 0; ++ks)\n#pragma unroll\n')
_COPY = ('''        mbar_expect_tx(full0 + 8 * s, kTileBytes);
        bulk_load(smem_addr(ring + s * kTileWords),
                  src + static_cast<size_t>(t) * kTileBytes, kTileBytes,
                  full0 + 8 * s);''', '        mbar_arrive(full0 + 8 * s);')
_WAITS = [('        mbar_wait(full0 + 8 * s, (t / kStages) & 1);\n', ''),
          ('        if (lane == 0) mbar_arrive(empty0 + 8 * s);', ''),
          ('      for (int t = 0; t < args.n_tiles; ++t) {',
           '      for (int t = 0; t < 0; ++t) {')]


def _stages(n):
    return ('constexpr int kStages = 4;', f'constexpr int kStages = {n};')


VARIANTS = {
    'kept': [], 'ring3': [_stages(3)], 'ring6': [_stages(6)],
    'ring8': [_stages(8)], 'stream_only': [_LOADS, _PRODUCTS],
    'no_copies': [_COPY], 'products_only': _WAITS,
    'handshake_only': [_LOADS, _PRODUCTS, _COPY],
}

MMA_RATE_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <int C>
__global__ void chains(float* out, int iters) {
  const uint32_t a0 = threadIdx.x, a1 = 1, a2 = 2, a3 = 3;
  float d[C][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(i + c), "r"(i));
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ms of one launch of `blocks` x `warps` warps, each with `c` independent
// accumulator chains of `iters` products
extern "C" float mma_rate_ms(float* out, int blocks, int warps, int c,
                             int iters) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int rep = 0; rep < 2; ++rep) {  // the first launch warms up
    cudaEventRecord(a);
    if (c == 2) chains<2><<<blocks, 32 * warps>>>(out, iters);
    else if (c == 4) chains<4><<<blocks, 32 * warps>>>(out, iters);
    else chains<8><<<blocks, 32 * warps>>>(out, iters);
    cudaEventRecord(b);
  }
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}
'''


def _compile(name, text):
    src = build.BUILD_DIR / f'study_{name}.cu'
    lib = build.BUILD_DIR / f'libstudy_{name}.so'
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    subprocess.run([build.nvcc()] + build.NVCC_FLAGS + ['-o', str(lib),
                                                        str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _variant(subs):
    text = (build.CSRC / 'fused_mlp.cu').read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f'study: source changed, no {old[:50]!r}')
        text = text.replace(old, new)
    return text


def _device_ms(fn, iters=100):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    runs = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and 'fused_mlp' in e.name]
    return sum(runs) / len(runs) / 1e3


def main():
    from concurrent.futures import ThreadPoolExecutor
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f'card: {card}', flush=True)
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((GROUPS, ROWS, DIMS[0]), generator=gen, device=dev)
    ws = [(torch.rand((GROUPS, k, n), generator=gen, device=dev) * 2 - 1) *
          (6.0 / (k + n)) ** 0.5 for k, n in zip(DIMS[:-1], DIMS[1:])]
    bs = [0.1 * torch.randn((GROUPS, n), generator=gen, device=dev)
          for n in DIMS[1:]]
    packed = fm.pack_weights(ws, bs)
    ref = fm.fused_mlp_plain(x, ws, bs)
    builds = {(name, rows): subs + ([_ROWS32] if rows == 32 else [])
              for name, subs in VARIANTS.items() for rows in (16, 32)}
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        futs = {key: pool.submit(_compile, f'{key[0]}_{key[1]}',
                                 _variant(subs))
                for key, subs in builds.items()}
        rate_lib = pool.submit(_compile, 'mma_rate', MMA_RATE_SRC).result()
        libs = {key: f.result() for key, f in futs.items()}

    def launch():
        return fm.fused_mlp_cuda(x, packed, None, 'relu')

    times = {}
    for key in list(libs) + list(libs)[::-1]:   # two passes, in turn
        build._LIBS['fused_mlp'] = libs[key]
        err = float((launch() - ref).abs().max())
        times.setdefault(key, [err]).append(_device_ms(launch))
    build._LIBS.pop('fused_mlp')
    for (name, rows), (err, *ms) in times.items():
        print(f'{name:15s} {rows} rows/block: device ms per launch '
              f'{" ".join(f"{m:.5f}" for m in ms)} (max_abs_err {err:.2e})')
    out = torch.empty(132 * 512, device=dev)
    rate_lib.mma_rate_ms.restype = ctypes.c_float
    rate_lib.mma_rate_ms.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    iters = 4096
    for warps, c in ((8, 2), (8, 4), (16, 4), (16, 8)):
        ms = rate_lib.mma_rate_ms(out.data_ptr(), 132, warps, c, iters)
        flop = 2.0 * 16 * 8 * 16 * iters * c * warps * 132
        print(f'mma.sync bf16: 132 blocks x {warps} warps x {c} chains: '
              f'{flop / ms / 1e9:.1f} TFLOP/s')


if __name__ == '__main__':
    main()
