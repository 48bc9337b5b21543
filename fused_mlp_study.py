"""The fused-MLP kernels against each other and against cuBLAS.

    python3 fused_mlp_study.py [--out FILE]

Needs an NVIDIA card and nvcc; run from the repository root. Prints the
card (name, power limit) and the kernels' registers and spills first, then
one line per measurement, each a kernel's device time per launch from a
torch.profiler window (the mean over its launches, after one warm launch):

  shapes   the 16-row kernel (fused_mlp_kernel), the warpgroup-MMA kernel
           (fused_mlp_kernel_wgmma, where one weight set serves the rows)
           and cuBLAS's bf16 chain (addmm, or baddbmm per group, with the
           activation between) at MB-MPC's planner launch (1 x 20,000 rows,
           26 -> 512 -> 512 -> 20), GrBAL's (5 x 500, 26 -> 512 x 3 -> 20,
           per-env weights) and GrBAL's before adaptation (the same, one
           shared set); each warm, and with L2 flushed before every launch
           (a 256 MB fill, left out of the time)
  sweep    both kernels at MB-MPC's widths from 1,024 to 20,000 rows: where
           the warpgroup-MMA kernel overtakes (ops/fused_mlp.py
           WGMMA_MIN_ROWS_PER_SM)
  variants the warpgroup-MMA kernel built with parts taken out by text
           substitution, at MB-MPC's launch: `stream_only` (the tiles
           stream through the ring, no products), `no_copies` (the products
           and the ring's handshake, nothing copied), `no_cluster` (each
           block copies its own tiles, no multicast) and `ring2` (2 stages
           instead of 3).
           The substitutions match the source's text exactly, so an edit of
           a line they match makes this script raise until they follow it.
           `stream_only` and `no_copies` compute wrong results and are timed
           only.

Every kernel output is held against `fused_mlp_plain` (max |error| shown).
--out writes the numbers as JSON too.
"""
import argparse
import ctypes
import json
import subprocess

import torch

from learning_to_adapt_torch.ops import build
from learning_to_adapt_torch.ops import fused_mlp as fm

MB_MPC = (26, 512, 512, 20)
GRBAL = (26, 512, 512, 512, 20)
SHAPES = {'mb_mpc': (1, 20000, MB_MPC, True),
          'grbal': (5, 500, GRBAL, False),
          'grbal_shared': (5, 500, GRBAL, True)}
SWEEP_ROWS = (1024, 2500, 4224, 6336, 8448, 10560, 12672, 16896, 20000)
FLUSH_BYTES = 256 << 20
ITERS = 50

_NO_PRODUCTS = ('      wg_mma<N>(d, da + 2 * ks, db + 2 * ks);\n',
                '      ;\n')
_NO_COPIES = ('''            mbar_expect_tx(full0 + 8 * s, tiles * bytes);
            for (int i = 0; i < tiles; ++i)
              bulk_load_all(
                  ring + s * kWStageBytes + i * kTileBytes + off,
                  args.w + static_cast<size_t>(t + (nc + i) * nk + kc) *
                               kTileBytes + off,
                  part, full0 + 8 * s);''',
              '            mbar_arrive(full0 + 8 * s);')
_ONE_BLOCK = ('constexpr int kWCluster = 2;', 'constexpr int kWCluster = 1;')
_RING2 = ('constexpr int kWStages = 3;', 'constexpr int kWStages = 2;')

VARIANTS = {'kept': [], 'stream_only': [_NO_PRODUCTS],
            'no_copies': [_NO_COPIES], 'no_cluster': [_ONE_BLOCK],
            'ring2': [_RING2]}


def _compile(name, text):
    src = build.BUILD_DIR / f'study_{name}.cu'
    lib = build.BUILD_DIR / f'libstudy_{name}.so'
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    proc = subprocess.run([build.nvcc()] + build.NVCC_FLAGS +
                          ['-o', str(lib), str(src)], capture_output=True,
                          text=True, check=True)
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def _variant(subs):
    text = (build.CSRC / 'fused_mlp.cu').read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f'study: source changed, {old[:50]!r} is '
                               'not there once')
        text = text.replace(old, new)
    return text


def _device_ms(fn, flush=None, iters=ITERS):
    """Mean device time per call of fn's kernels; with `flush`, a fill of
    it runs before each call and its kernels are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and
             'FillFunctor' not in e.name)
    return us / iters / 1e3


def _mlp(dev, g, r, dims, shared, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((g, r, dims[0]), generator=gen, device=dev)
    sets = 1 if shared else g
    ws = [((torch.rand((sets, k, n), generator=gen, device=dev) * 2 - 1) *
           (6.0 / (k + n)) ** 0.5).expand(g, k, n)
          for k, n in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * torch.randn((sets, n), generator=gen, device=dev)).expand(
        g, n) for n in dims[1:]]
    return x, ws, bs


def _cublas(x, ws, bs):
    """The bf16 chain: weights cast once (not timed), then per layer one
    addmm (one group) or baddbmm, bias in the product's epilogue, and the
    activation."""
    grouped = x.shape[0] > 1
    w16 = [w.to(torch.bfloat16) for w in ws]
    b16 = [b.to(torch.bfloat16) for b in bs]

    def run():
        h = x.to(torch.bfloat16)
        for i, (w, b) in enumerate(zip(w16, b16)):
            h = (torch.baddbmm(b[:, None, :], h, w) if grouped else
                 torch.addmm(b[0], h[0], w[0])[None])
            if i < len(w16) - 1:
                h = torch.relu(h)
        return h.float()
    return run


def _kernels(x, packed, shared):
    out = {'kernel_16row': lambda: fm._launch(x, packed, 'relu', False)}
    if shared:
        out['kernel_wgmma'] = lambda: fm._launch(x, packed, 'relu', True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', help='also write the numbers here as JSON')
    args = ap.parse_args()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f'card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}', flush=True)
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futs = {name: pool.submit(_compile, f'wgmma_{name}', _variant(subs))
                for name, subs in VARIANTS.items()}
        libs = {name: f.result() for name, f in futs.items()}
    for line in libs['kept'][1].splitlines():
        if 'registers' in line or 'spill' in line or 'wgmma' in line:
            print(f'  ptxas: {line.strip()}')
    build._LIBS['fused_mlp'] = libs['kept'][0]
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    res = dict(card=card, shapes={}, sweep={}, variants={})

    for shape, (g, r, dims, shared) in SHAPES.items():
        x, ws, bs = _mlp(dev, g, r, dims, shared)
        packed = fm.pack_weights(ws, bs)
        ref = fm.fused_mlp_plain(x, ws, bs, 'relu')
        runs = dict(_kernels(x, packed, shared), cublas=_cublas(x, ws, bs))
        for name, fn in runs.items():
            err = float((fn() - ref).abs().max())
            warm = _device_ms(fn)
            cold = _device_ms(fn, flush)
            res['shapes'][f'{shape}.{name}'] = dict(
                device_ms=warm, l2_flushed_ms=cold, max_abs_err=err)
            print(f'{shape:12s} {g} x {r} {dims}: {name:12s} device ms per '
                  f'launch {warm:.5f}, L2 flushed {cold:.5f} (max_abs_err '
                  f'{err:.2e})', flush=True)

    for rows in SWEEP_ROWS:
        x, ws, bs = _mlp(dev, 1, rows, MB_MPC, True)
        packed = fm.pack_weights(ws, bs)
        ms = {name: _device_ms(fn) for name, fn in
              _kernels(x, packed, True).items()}
        res['sweep'][rows] = ms
        print(f'sweep {rows:6d} rows: 16-row {ms["kernel_16row"]:.5f} ms, '
              f'wgmma {ms["kernel_wgmma"]:.5f} ms', flush=True)

    x, ws, bs = _mlp(dev, 1, 20000, MB_MPC, True)
    packed = fm.pack_weights(ws, bs)
    ref = fm.fused_mlp_plain(x, ws, bs, 'relu')
    for name, (lib, _) in libs.items():
        build._LIBS['fused_mlp'] = lib
        err = float((fm._launch(x, packed, 'relu', True) - ref).abs().max())
        ms = [_device_ms(lambda: fm._launch(x, packed, 'relu', True))
              for _ in range(2)]
        res['variants'][name] = dict(device_ms=ms, max_abs_err=err)
        print(f'variant {name:12s} at mb_mpc: device ms per launch '
              f'{" ".join(f"{m:.5f}" for m in ms)} (max_abs_err {err:.2e})',
              flush=True)
    build._LIBS.pop('fused_mlp')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)


if __name__ == '__main__':
    main()
