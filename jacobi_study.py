"""What bounds the projected-Jacobi kernel: timings of variants of its source.

    python3 jacobi_study.py

Needs an NVIDIA card and nvcc; run from the repository root. Builds
learning_to_adapt_torch/csrc/jacobi.cu as it is and with parts changed by
text substitution, and times each at HalfCheetah's contact shape (N = 76
rows, 60 sweeps) for 5 envs (the main path) and for 512 (the saturated
sampling width), by the kernel's own device time in a torch.profiler window:

  kept            the source as it is
  prologue_only   the source as it is, launched for 0 sweeps
  handshake_only  no row products: each sweep still reads f from shared
                  memory, sums across the threads of a row by shuffles,
                  writes the new f and meets the block barrier (the floor
                  of the sweep chain)
  no_barrier      no block barrier between sweeps
  contiguous      a thread holds a contiguous chunk of a row's columns
                  (part * kCols + k) instead of every kT-th (part + kT k)
  quads           a thread holds every kT-th group of 4 columns, so its f
                  loads merge into 16-byte loads
  chains4         four independent FMA chains per row product, not two
  cols32          N = 76 launched in the next tier (32 columns, 2 rows per
                  thread), not its own
  t<T>r<R>[_quads] N = 76 launched with T threads per row and R rows per
                  thread (the kept tier is t4r4), with the quads layout
                  where named; each also with no row products (`_handshake`,
                  the chain floor of that launch shape)

The cluster kernel (N > 224) is timed at the blocks env's N = 988 for 5
and 512 envs, as it is (`kept`) and as:

  cluster_barrier_only  no rows of A: each sweep still gathers f from the
                  cluster's blocks, sums across a warp, writes the new f and
                  meets the cluster barrier (the floor of its sweep chain)
  cluster_unroll8 eight 16-byte loads of a row in flight per lane, not four
  cluster_pairs   two rows a warp at a time (their loads interleaved), and
  cluster_pairs8  with eight loads of each in flight
  cluster_c8      clusters of 8 blocks at 5 envs too (the kept launch takes
                  16 while every env's cluster fits the card at once)

Variants that change the arithmetic (handshake_only, no_barrier,
prologue_only, cluster_barrier_only) compute wrong results and are timed
only. The substitutions
match the kernel's text exactly, so an edit of a line they match makes this
script raise until they follow it. Prints the card (name, power limit)
first, then per variant the registers and spills of the instantiation it
launches and its counts of shared loads, shuffles, FMAs and barriers in the
SASS, then one line per variant and env count.
"""
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from learning_to_adapt_torch.ops import build
from learning_to_adapt_torch.ops import jacobi as jc

N, SWEEPS = 76, 60
N_CLUSTER = 988
ENV_COUNTS = (5, 512)

_PRODUCT = ('''#pragma unroll
      for (int k = 0; k < kCols; ++k)
        acc[k % kChains] = fmaf(a[r][k], fv[k], acc[k % kChains]);
''', '''      acc[0] = fv[r % kCols];
''')
_BARRIER = ('    __syncthreads();\n    cur ^= 1;', '    cur ^= 1;')
_UNROLL8 = ('#pragma unroll 4\n    for (int k = lane; k < n / 4; k += 32) {',
            '#pragma unroll 8\n    for (int k = lane; k < n / 4; k += 32) {')
_PAIR_DOT = ('// Dynamic shared memory: f_all[n]', """// Two rows at once.
template <int kVec>
__device__ __forceinline__ float2 row_dot2(const float* __restrict__ A0,
                                           const float* __restrict__ A1,
                                           const float* f, int n, int lane) {
  float a0 = 0.f, a1 = 0.f, c0 = 0.f, c1 = 0.f;
  if constexpr (kVec == 4) {
    const float4* p4 = reinterpret_cast<const float4*>(A0);
    const float4* q4 = reinterpret_cast<const float4*>(A1);
    const float4* f4 = reinterpret_cast<const float4*>(f);
#pragma unroll 4
    for (int k = lane; k < n / 4; k += 32) {
      const float4 p = __ldcg(p4 + k);
      const float4 q = __ldcg(q4 + k);
      const float4 x = f4[k];
      a0 = fmaf(p.x, x.x, a0);
      a1 = fmaf(p.y, x.y, a1);
      a0 = fmaf(p.z, x.z, a0);
      a1 = fmaf(p.w, x.w, a1);
      c0 = fmaf(q.x, x.x, c0);
      c1 = fmaf(q.y, x.y, c1);
      c0 = fmaf(q.z, x.z, c0);
      c1 = fmaf(q.w, x.w, c1);
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < n; k += 32) {
      a0 = fmaf(__ldcg(A0 + k), f[k], a0);
      c0 = fmaf(__ldcg(A1 + k), f[k], c0);
    }
  }
  return make_float2(a0 + a1, c0 + c1);
}

// Dynamic shared memory: f_all[n]""")
_PAIR_LOOP = ("""    for (int r = warp; r < mine; r += n_warps) {
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
    }""", """    for (int r = warp; r < mine; r += 2 * n_warps) {
      const int rr[2] = {r, min(r + n_warps, mine - 1)};
      float2 s2 = row_dot2<kVec>(Ae + static_cast<size_t>(row0 + rr[0]) * n,
                                 Ae + static_cast<size_t>(row0 + rr[1]) * n,
                                 f_all, n, lane);
#pragma unroll
      for (int m = 16; m > 0; m /= 2) {
        s2.x += __shfl_xor_sync(kFull, s2.x, m);
        s2.y += __shfl_xor_sync(kFull, s2.y, m);
      }
      const float sums[2] = {s2.x, s2.y};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (lane == 0 && (j == 0 || r + n_warps < mine)) {
          const size_t idx = static_cast<size_t>(e) * n + row0 + rr[j];
          const float f_old = slice[cur * rows + rr[j]];
          slice[(cur ^ 1) * rows + rr[j]] = fmaxf(
              f_old - w * (sums[j] + __ldg(b + idx)) * __ldg(aii_inv + idx),
              0.f);
        }
      }
    }""")
_PAIR_UNROLL8 = ('#pragma unroll 4\n    for (int k = lane; k < n / 4; '
                 'k += 32) {\n      const float4 p',
                 '#pragma unroll 8\n    for (int k = lane; k < n / 4; '
                 'k += 32) {\n      const float4 p')
_ROW_DOT = ('      float sum = row_dot<kVec>(Ar, f_all, n, lane);',
            '      float sum = f_all[row];')
_COLUMN = '  return part + kT * k;'
_CONTIGUOUS = (_COLUMN, '  return part * kCols + k;')
_QUADS = (_COLUMN, '  return 4 * part + 4 * kT * (k / 4) + k % 4;')
_CHAINS4 = ('constexpr int kChains = 2;', 'constexpr int kChains = 4;')


def _tier(per_row, cols, rows, subs=()):
    """A variant that launches N = 76 in the tier (per_row, cols, rows),
    built as one more instantiation than ops/jacobi.py TIERS names."""
    last = '  JACOBI_TIER({}, {}, {})\n'.format(*jc.TIERS[-1])
    more = f'  JACOBI_TIER({per_row}, {cols}, {rows})\n'
    return ([(last, last + more)] + list(subs), SWEEPS,
            ((per_row, cols, rows),) + jc.TIERS)


#: other launch tiers for N = 76: (threads per row, columns, rows per
#: thread) and the column layout's substitutions
SHAPES = {
    't8r1': ((8, 12, 1), []), 't8r2': ((8, 12, 2), []),
    't16r4': ((16, 5, 4), []), 't4r2': ((4, 20, 2), []),
    't2r2_quads': ((2, 40, 2), [_QUADS]), 't1r1': ((1, 76, 1), []),
}

#: name -> (substitutions, sweeps per launch, launch tiers)
VARIANTS = {
    'kept': ([], SWEEPS, jc.TIERS),
    'prologue_only': ([], 0, jc.TIERS),
    'handshake_only': ([_PRODUCT], SWEEPS, jc.TIERS),
    'no_barrier': ([_BARRIER], SWEEPS, jc.TIERS),
    'contiguous': ([_CONTIGUOUS], SWEEPS, jc.TIERS),
    'quads': ([_QUADS], SWEEPS, jc.TIERS),
    'chains4': ([_CHAINS4], SWEEPS, jc.TIERS),
    'cols32': ([], SWEEPS, ((4, 32, 2),) + jc.TIERS),
    **{name: _tier(*shape, subs=subs)
       for name, (shape, subs) in SHAPES.items()},
    **{f'{name}_handshake': _tier(*shape, subs=subs + [_PRODUCT])
       for name, (shape, subs) in SHAPES.items()},
    'cluster_barrier_only': ([_ROW_DOT], SWEEPS, jc.TIERS),
    'cluster_unroll8': ([_UNROLL8], SWEEPS, jc.TIERS),
    'cluster_pairs': ([_PAIR_DOT, _PAIR_LOOP], SWEEPS, jc.TIERS),
    'cluster_pairs8': ([_PAIR_DOT, _PAIR_LOOP, _PAIR_UNROLL8], SWEEPS,
                       jc.TIERS),
    'cluster_c8': ([], SWEEPS, jc.TIERS),
}
#: the variant whose time is the floor of the sweep chain
FLOOR = 'handshake_only'
#: the same for the cluster kernel
CLUSTER_FLOOR = 'cluster_barrier_only'
#: variants timed through the cluster kernel at N_CLUSTER rows
CLUSTER_VARIANTS = ('kept', CLUSTER_FLOOR, 'cluster_unroll8',
                    'cluster_pairs', 'cluster_pairs8', 'cluster_c8')


def variant_source(name):
    text = (build.CSRC / 'jacobi.cu').read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise RuntimeError(f'study: source changed, no {old[:50]!r}')
        text = text.replace(old, new)
    return text


def compile_variant(name):
    """Build a variant into _build/; returns (ctypes library, path, nvcc's
    output)."""
    src = build.BUILD_DIR / f'study_{name}.cu'
    lib = build.BUILD_DIR / f'libstudy_{name}.so'
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(variant_source(name))
    proc = subprocess.run([build.nvcc()] + build.NVCC_FLAGS +
                          ['-o', str(lib), str(src)], check=True,
                          capture_output=True, text=True)
    return ctypes.CDLL(str(lib)), lib, proc.stdout + proc.stderr


def run_variant(name, libs, fn):
    """Call fn() with the kernel wrapper bound to variant `name`'s build
    and tiers; restores both."""
    lib, tiers = build._LIBS.get('jacobi'), jc.TIERS
    build._LIBS['jacobi'], jc.TIERS = libs[name], VARIANTS[name][2]
    try:
        return fn()
    finally:
        build._LIBS.pop('jacobi')
        if lib is not None:
            build._LIBS['jacobi'] = lib
        jc.TIERS = tiers


def system(dev, n_envs, n, seed):
    """Random SPD systems with omega from the row-sum bound, as
    chip_smoke.py and tests/test_torch_kernels.py build them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn((n_envs, n, n), generator=gen, device=dev)
    a = m @ m.transpose(-1, -2) + n * torch.eye(n, device=dev)
    b = torch.randn((n_envs, n), generator=gen, device=dev)
    aii_inv = 1.0 / torch.diagonal(a, dim1=-2, dim2=-1)
    rho = torch.amax(a.abs().sum(-1) * aii_inv, dim=-1)
    return a, b, aii_inv, torch.clamp(1.8 / rho, max=1.0)


def kernel_device_ms(fn, iters=100):
    """Mean device time of the Jacobi kernel per call of fn, from a
    torch.profiler window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    runs = [e.time_range.elapsed_us() for e in events if 'jacobi' in e.name]
    if not runs:
        raise RuntimeError('no Jacobi kernel in the profile; device events: '
                           f'{sorted({e.name[:80] for e in events})}')
    return sum(runs) / len(runs) / 1e3


def _instantiation(path, nvcc_log, per_row, cols, rows):
    """Registers, spills and SASS instruction counts of one instantiation."""
    tag = f'jacobi_kernelILi{per_row}ELi{cols}ELi{rows}E'
    lines = nvcc_log.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if 'Compiling entry' in ln and tag in ln)
    info = [ln.split(':')[-1].strip() for ln in lines[at + 1:at + 4]
            if 'registers' in ln or 'spill' in ln]
    tool = Path(build.nvcc()).parent / 'cuobjdump'
    sass = subprocess.run([str(tool), '-sass', str(path)], check=True,
                          capture_output=True, text=True).stdout
    body = next(s for s in sass.split('Function : ')[1:]
                if tag in s.split('\n', 1)[0])
    ops = re.findall(r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)',
                     body)
    count = {k: sum(op.startswith(k) for op in ops)
             for k in ('LDS', 'LDS.128', 'SHFL', 'FFMA', 'BAR')}
    return '; '.join(info) + f'; SASS {len(ops)} instructions, ' + \
        ', '.join(f'{k} {v}' for k, v in count.items())


def main():
    from concurrent.futures import ThreadPoolExecutor
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f'card: {card}', flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda', 0)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(compile_variant, VARIANTS)))
    libs = {name: lib for name, (lib, _, _) in built.items()}
    for name, (_, path, nvcc_log) in built.items():
        if name != 'kept' and name in CLUSTER_VARIANTS:
            continue
        shape = run_variant(name, libs, lambda: jc.launch_shape(N))
        print(f'{name}: tier {shape[:3]} (threads per row, columns, rows '
              f'per thread), {shape[3]} threads; '
              f'{_instantiation(path, nvcc_log, *shape[:3])}')

    times = {}
    tiers = [v for v in VARIANTS if v == 'kept' or
             v not in CLUSTER_VARIANTS]
    for n_envs in ENV_COUNTS:
        args = system(dev, n_envs, N, seed=n_envs)
        ref = jc.jacobi_solve_plain(*args, SWEEPS)
        for name in tiers + tiers[::-1]:  # two passes
            sweeps = VARIANTS[name][1]

            def launch():
                return jc.jacobi_solve_cuda(*args, sweeps)

            def measure():
                err = float((launch() - ref).abs().max())
                return err, kernel_device_ms(launch)
            err, ms = run_variant(name, libs, measure)
            times.setdefault((name, n_envs), [err]).append(ms)
        cargs = system(dev, n_envs, N_CLUSTER, seed=n_envs)
        cref = jc.jacobi_solve_plain(*cargs, SWEEPS)
        for name in CLUSTER_VARIANTS + CLUSTER_VARIANTS[::-1]:

            def measure():
                def launch():
                    return jc.jacobi_solve_cluster(*cargs, SWEEPS)
                err = float((launch() - cref).abs().max())
                return err, kernel_device_ms(launch)
            shape = jc.cluster_shape
            if name == 'cluster_c8':
                jc.cluster_shape = lambda n, e, sms: shape(n, e, 0)
            try:
                err, ms = run_variant(name, libs, measure)
            finally:
                jc.cluster_shape = shape
            times.setdefault((name + '@cluster', n_envs), [err]).append(ms)
            print(f'{name}@cluster E={n_envs}: {ms:.5f} ms', flush=True)
    for (name, n_envs), (err, *ms) in times.items():
        n = N_CLUSTER if name.endswith('@cluster') else N
        print(f'{name:15s} E={n_envs:3d} N={n} {SWEEPS} sweeps: '
              f'device ms per launch {" ".join(f"{m:.5f}" for m in ms)} '
              f'(max_abs_err vs 60 plain sweeps {err:.2e})')


if __name__ == '__main__':
    main()
