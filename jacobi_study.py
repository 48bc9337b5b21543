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

The cluster kernel (N > 224) is timed at the blocks env's N = 988 on four
systems: the blocks env's contact systems (5 envs, ~4 live rows an env),
random SPD systems (every row live) for 5 and 512 envs, and structured
systems with 99 % of the rows dead for 512 envs; as it is (`kept`) and as:

  cluster_small_floor   the one-block path with no row products: each
                  sweep still reads f, sums across a row's lanes, writes the
                  new f and meets the block barrier (the floor of that
                  path's chain)
  cluster_dense_floor   the dense path with no row products: each sweep
                  still sums across a warp, pushes the new f to every block
                  of the cluster and waits for the whole f on its mbarrier
                  (the floor of that path's chain)
  cluster_dense   every row taken as live, so the blocks systems run the
                  dense path (the design without the live-row scan), and
  cluster_dense_floor_all  that path's floor on them
  cluster_barrier the dense path's f pushed by plain stores to distributed
                  shared memory and one cluster barrier a sweep, instead
                  of st.async stores that complete on each block's
                  mbarrier, and
  cluster_barrier_floor  that path's floor
  cluster_no_bulk the scan reads every row by plain 16-byte loads (no
                  bulk copies into shared memory; the dense path gathers
                  its held rows from L2 after the scan), and
  cluster_no_bulk_scan_only  the same for 0 sweeps
  cluster_c8      clusters of 8 blocks (the kept launch takes 16 where the
                  card holds a cluster of 16)
  cluster_streamed  no rows of A held on chip: every row streamed from L2
                  each sweep (the kept plan holds 55 of a block's 62 rows
                  at N = 988 in shared memory and 7 in registers)
  cluster_shared_only  no rows in registers: those beyond shared memory
                  streamed
  cluster_scan_only  launched for 0 sweeps: the scan, the live list and
                  the set-up of either path

Variants that change the arithmetic (handshake_only, no_barrier,
prologue_only and the floors) compute wrong results and are timed only.
The substitutions match the kernel's text exactly, so an edit of a line
they match makes this script raise until they follow it. Prints the card
(name, power limit) first, then per variant the registers and spills of
the instantiation it launches and its counts of shared loads, shuffles,
FMAs and barriers in the SASS, then one line per variant and system.
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
_SMALL_PRODUCT = ('''        if (r < m)
          for (int k = part; k < m; k += G)
            sum = fmaf(As[r * ld + k], fc[k], sum);
''', '''        if (r < m) sum = fc[r];
''')
_DENSE_PRODUCT = ('''    for (int i = warp; i < hd; i += 2 * n_warps) {
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
''', '''    for (int i = warp; i < mo; i += n_warps) finish(i, fc[c0 + i]);
''')
_ALL_LIVE = ('flag[i] = nonzero || bj != 0.f;', 'flag[i] = 1;')
_NO_BULK = [
    ('  const int staged = bulk ? min(held, mine) : 0;',
     '  const int staged = 0;'),
    ('  const bool as_scanned = bulk && m == n;',
     '  const bool as_scanned = false;')]
_CLUSTER_BARRIER = [
    ('      if (lane < C) push(f_peer + 4 * (nxt * n4 + c), v, bar_peer + 8 * '
     'nxt);',
     '      if (lane < C) *cluster.map_shared_rank(fbuf + nxt * n4 + c, '
     'lane) = v;'),
    ('    if (tid == 0) mbar_expect_tx(bar + 16 + 8 * nxt, 4 * m);\n', ''),
    ('    mbar_wait(bar + 16 + 8 * nxt, (s >> 1) & 1);  // all m values of f',
     '    cluster.sync();')]
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
    'cluster_small_floor': ([_SMALL_PRODUCT], SWEEPS, jc.TIERS),
    'cluster_dense_floor': ([_DENSE_PRODUCT], SWEEPS, jc.TIERS),
    'cluster_dense': ([_ALL_LIVE], SWEEPS, jc.TIERS),
    'cluster_dense_floor_all': ([_ALL_LIVE, _DENSE_PRODUCT], SWEEPS,
                                jc.TIERS),
    'cluster_barrier': (_CLUSTER_BARRIER, SWEEPS, jc.TIERS),
    'cluster_barrier_floor': (_CLUSTER_BARRIER + [_DENSE_PRODUCT], SWEEPS,
                              jc.TIERS),
    'cluster_no_bulk': (_NO_BULK, SWEEPS, jc.TIERS),
    'cluster_no_bulk_scan_only': (_NO_BULK, 0, jc.TIERS),
    'cluster_c8': ([], SWEEPS, jc.TIERS),
    'cluster_streamed': ([], SWEEPS, jc.TIERS),
    'cluster_shared_only': ([], SWEEPS, jc.TIERS),
    'cluster_scan_only': ([], 0, jc.TIERS),
}
#: the variant whose time is the floor of the sweep chain
FLOOR = 'handshake_only'
#: the same for the cluster kernel's one-block path (few live rows) and
#: its dense path
SMALL_FLOOR, DENSE_FLOOR = 'cluster_small_floor', 'cluster_dense_floor'
#: variants timed through the cluster kernel at N_CLUSTER rows
CLUSTER_VARIANTS = ('kept', 'cluster_scan_only', SMALL_FLOOR, DENSE_FLOOR,
                    'cluster_dense', 'cluster_dense_floor_all',
                    'cluster_barrier', 'cluster_barrier_floor',
                    'cluster_no_bulk', 'cluster_no_bulk_scan_only',
                    'cluster_c8',
                    'cluster_streamed', 'cluster_shared_only')


def variant_source(name):
    text = (build.CSRC / 'jacobi.cu').read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise RuntimeError(f'study: source changed, no {old[:50]!r}')
        text = text.replace(old, new)  # every occurrence
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
    """Call fn() with the kernel wrapper bound to variant `name`'s build,
    tiers and cluster plan (clusters of 8 for cluster_c8, no held rows for
    cluster_streamed); restores them."""
    lib, tiers = build._LIBS.get('jacobi'), jc.TIERS
    size, shape = jc.cluster_size, jc.cluster_shape
    build._LIBS['jacobi'], jc.TIERS = libs[name], VARIANTS[name][2]
    if name == 'cluster_c8':
        jc.cluster_size = lambda n, device: 8
    elif name in ('cluster_streamed', 'cluster_shared_only'):
        def streamed(n, cluster=16):
            plan = shape(n, cluster)
            held = 0 if name == 'cluster_streamed' else plan.held
            return plan._replace(held=held, in_registers=0,
                                 streamed=plan.rows - held)
        jc.cluster_shape = streamed
    try:
        return fn()
    finally:
        build._LIBS.pop('jacobi')
        if lib is not None:
            build._LIBS['jacobi'] = lib
        jc.TIERS = tiers
        jc.cluster_size, jc.cluster_shape = size, shape


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


def dead_system(dev, n_envs, n, n_live, seed, symmetric=True):
    """Random SPD systems (as `system`) with all but n_live rows an env,
    drawn at random, dead as the engine leaves an inactive contact: row and
    column zeroed (the row only, symmetric=False), diagonal 1, b = 0; omega
    from the row-sum bound."""
    a, b, _, _ = system(dev, n_envs, n, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    order = torch.argsort(torch.rand((n_envs, n), generator=gen, device=dev))
    dead = torch.zeros((n_envs, n), dtype=torch.bool, device=dev).scatter_(
        1, order[:, n_live:], True)
    a = a.masked_fill(dead[:, :, None], 0)
    if symmetric:
        a = a.masked_fill(dead[:, None, :], 0)
    a = a + torch.diag_embed(dead.float())
    b = b.masked_fill(dead, 0)
    aii_inv = 1.0 / torch.diagonal(a, dim1=-2, dim2=-1)
    rho = torch.amax(a.abs().sum(-1) * aii_inv, dim=-1)
    return a, b, aii_inv, torch.clamp(1.8 / rho, max=1.0)


def contact_systems(dev, cls_name='HalfCheetahEnv', task='cripple',
                    n_envs=5):
    """The Jacobi inputs (A, b, aii_inv, omega, n_sweeps) of one real
    physics step of an env for n_envs envs, taken after 30 random-action
    steps (HalfCheetah's feet on the floor, or on the blocks), the task
    drawn (episode 1)."""
    from learning_to_adapt_torch import envs
    from learning_to_adapt_torch.physics import engine
    env = envs.normalize(getattr(envs, cls_name)(
        task=task, reset_every_episode=True, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = env.reset(n_envs, 1, gen)

    def random_step(state):
        act = 2 * torch.rand((n_envs, env.act_dim), generator=gen,
                             device=dev) - 1
        return env.step(state, act)[0]

    for _ in range(30):
        state = random_step(state)
    captured = []
    solve = engine.jacobi_solve

    def capture(*args):
        captured.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return solve(*args)

    engine.jacobi_solve = capture
    try:
        random_step(state)
    finally:
        engine.jacobi_solve = solve
    return captured[0]


def cluster_cases(dev):
    """{label: (A, b, aii_inv, omega)} of the cluster kernel's timed
    systems at N_CLUSTER rows: the blocks env's contact systems (5 envs),
    random SPD (every row live) for 5 and 512 envs, and 99 % of the rows
    dead for 512 envs."""
    A, b, aii_inv, omega, _ = contact_systems(dev, 'HalfCheetahBlocksEnv',
                                              'damping')
    return {'blocks 5': (A, b, aii_inv, omega),
            'dense 5': system(dev, 5, N_CLUSTER, seed=5),
            'dense 512': system(dev, 512, N_CLUSTER, seed=512),
            '99% dead 512': dead_system(dev, 512, N_CLUSTER, 10, seed=512)}


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


def _instantiation(path, nvcc_log, tag):
    """Registers, spills and SASS instruction counts of the kernel whose
    mangled name holds `tag`."""
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
             for k in ('LDS', 'LDS.128', 'SHFL', 'FFMA', 'BAR', 'UCGABAR')}
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
        if name in CLUSTER_VARIANTS:
            print(f'{name}: jacobi_cluster_kernel; '
                  f'{_instantiation(path, nvcc_log, "jacobi_cluster_kernel")}')
        if name != 'kept' and name in CLUSTER_VARIANTS:
            continue
        shape = run_variant(name, libs, lambda: jc.launch_shape(N))
        tag = 'jacobi_kernelILi{}ELi{}ELi{}E'.format(*shape[:3])
        print(f'{name}: tier {shape[:3]} (threads per row, columns, rows '
              f'per thread), {shape[3]} threads; '
              f'{_instantiation(path, nvcc_log, tag)}')

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
            times.setdefault((name, f'E={n_envs:3d} N={N}'), [err]).append(ms)
    for label, cargs in cluster_cases(dev).items():
        cref = jc.jacobi_solve_plain(*cargs, SWEEPS)
        live = jc.live_rows(*cargs).sum(-1)
        print(f'cluster {label}: N = {N_CLUSTER}, live rows an env '
              f'{int(live.min())}-{int(live.max())}', flush=True)
        iters = 10 if cargs[1].shape[0] > 100 else 100
        for name in CLUSTER_VARIANTS + CLUSTER_VARIANTS[::-1]:

            def measure():
                def launch():
                    return jc.jacobi_solve_cluster(*cargs,
                                                   VARIANTS[name][1])
                err = float((launch() - cref).abs().max())
                return err, kernel_device_ms(launch, iters)
            err, ms = run_variant(name, libs, measure)
            times.setdefault((name, label), [err]).append(ms)
            print(f'{name} {label}: {ms:.5f} ms', flush=True)
    for (name, label), (err, *ms) in times.items():
        print(f'{name:23s} {label:12s} {SWEEPS} sweeps: device ms per '
              f'launch {" ".join(f"{m:.5f}" for m in ms)} (max_abs_err vs '
              f'60 plain sweeps {err:.2e})')


if __name__ == '__main__':
    main()
