"""Smoke run of the PyTorch port (learning_to_adapt_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
  1. print the card (nvidia-smi name, power limit); build both CUDA kernels
     from learning_to_adapt_torch/csrc with nvcc for sm_90a, in parallel;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, with the tolerance printed, and time kernel, plain
     version and (for the MLP) one library call with CUDA events, the host
     queued ahead so the times are the card's. The MLP kernel runs on
     weights packed once (pack_weights, timed on its own), with L2 warm
     and flushed; the library call's device time also comes from a
     torch.profiler window;
  3. drive the main path: GrBAL adaptive-MPC sampling on HalfCheetah
     (cripple task) at the full width of run_scripts/run_grbal.py — 5 envs,
     500 candidates x horizon 10, a (512,512,512) ReLU meta-MLP, adaptation
     on the last 16 transitions at inner lr 1e-3 — through Sampler: one
     random-action call, Normalizer.fit on its paths, one policy call
     (episode 1, so cripple tasks are drawn); paths of 100 steps, so
     adaptation is active from step 18. The launch counters are set to 0
     before the policy call and must show 10 fused-MLP launches and 1
     weight pack per env step and 1 Jacobi launch per physics step;
  4. profile one more policy sampling call of 30 steps with torch.profiler:
     wall and device time per step, the device's busy share, host time of
     each labelled part of a step (rollout.adapt / .pack / .plan /
     .env_step), the device time per launch of both kernels and the pack's
     device time per step;
  5. watch one more policy sampling call for the host waiting on the card
     (the profiler's CUDA runtime sync calls and CUDA's sync-debug mode) and
     fail if anything waits once a step or more;
  6. print the card line again, one JSON line describing every kernel,
     then the contract line {"ok": true, "device": {...}} last.

Imports nothing of JAX or of the JAX package. Without a card it exits 2
before printing any result.
"""
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# published H100 SXM peaks (NVIDIA data sheet, dense): the bounds below
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

MLP_DIMS = (26, 512, 512, 512, 20)    # obs 20 + act 6 -> 20
N_ENVS, N_CANDIDATES, HORIZON = 5, 500, 10
ADAPT_BATCH, INNER_LR = 16, 1e-3
PATH_LEN = 100
PROFILE_LEN = 30
JACOBI_SWEEPS = 60                    # 2 * OptionSpec.iterations

SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize')

MLP_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 roundings of hidden units flip
JACOBI_TOL = dict(rtol=1e-4, atol=1e-5)  # f32, other summation order


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def queue_ahead():
    """Hold the card for ~0.1 s so that the host enqueues the timed calls
    before the card starts on them: event times are then the card's, not
    the host's dispatch (a wrapper's host time can exceed its kernel's)."""
    import torch
    torch.cuda._sleep(200_000_000)


def cuda_ms(fn, warmup=5, iters=50, before=None):
    """Mean time per call of fn on the card, by CUDA events around each
    call. `before`, when given, runs ahead of each call, outside the timed
    span (the L2 flush)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    queue_ahead()
    for start, end in marks:
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def device_ms(fn, iters=20):
    """Sum of the card's activity (kernels, copies) per call of fn, from a
    torch.profiler window: gaps between the kernels are not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, 'is_user_annotation', False))
    return us / iters / 1e3


def bound_ms(n_bytes, flops, peak_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def build_kernels():
    from learning_to_adapt_torch.ops import build
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=2) as pool:
        paths = list(pool.map(build.build, ['fused_mlp', 'jacobi']))
    log(f'built {[p.name for p in paths]} in {time.time() - t0:.1f} s '
        '(parallel nvcc, -gencode arch=compute_90a,code=sm_90a)')
    for name, nvcc_log in build.BUILD_LOGS.items():
        for line in nvcc_log.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  {name}: {line.strip()}')


def check_fused_mlp(dev):
    import torch
    from learning_to_adapt_torch.ops import fused_mlp as fm
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g, r = N_ENVS, N_CANDIDATES
    x = torch.randn((g, r, MLP_DIMS[0]), generator=gen, device=dev)
    ws, bs = [], []
    for k, n in zip(MLP_DIMS[:-1], MLP_DIMS[1:]):
        lim = (6.0 / (k + n)) ** 0.5
        ws.append((torch.rand((g, k, n), generator=gen, device=dev) * 2 - 1)
                  * lim)
        bs.append(0.1 * torch.randn((g, n), generator=gen, device=dev))
    shared_w = [w[:1].expand_as(w) for w in ws]   # group stride 0
    shared_b = [b[:1].expand_as(b) for b in bs]

    errs = []
    for label, w_set, b_set in (('per-group', ws, bs),
                                ('stride-0', shared_w, shared_b)):
        packed = fm.pack_weights(w_set, b_set)
        ref = fm.fused_mlp_plain(x, w_set, b_set, 'relu')
        out = fm.fused_mlp_cuda(x, packed, None, 'relu')
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        errs.append(err)
        log(f'fused_mlp {label}, packed weights {tuple(x.shape)} -> '
            f'{tuple(out.shape)}: max_abs_err {err:.3e} (tolerance '
            f'{MLP_TOL}, max|ref| {float(ref.abs().max()):.3f})')
        torch.testing.assert_close(out, ref, **MLP_TOL)

    packed = fm.pack_weights(ws, bs)
    w16 = [w.to(torch.bfloat16) for w in ws]       # cast once, not timed
    b16 = [b.to(torch.bfloat16)[:, None, :] for b in bs]

    def library():
        h = x.to(torch.bfloat16)
        for i, (w, b) in enumerate(zip(w16, b16)):
            h = torch.baddbmm(b, h, w)
            if i < len(w16) - 1:
                h = torch.relu(h)
        return h.float()

    def kernel():
        return fm.fused_mlp_cuda(x, packed, None, 'relu')

    flush = torch.empty(16 * 2 ** 20, device=dev)  # 64 MB > the 50 MB L2
    ms = cuda_ms(kernel)
    ms_cold = cuda_ms(kernel, iters=20, before=flush.zero_)
    plain_ms = cuda_ms(lambda: fm.fused_mlp_plain(x, ws, bs, 'relu'))
    library_ms = cuda_ms(library)
    library_device_ms = device_ms(library)
    pack_ms = cuda_ms(lambda: fm.pack_weights(ws, bs))
    macs = sum(k * n for k, n in zip(MLP_DIMS[:-1], MLP_DIMS[1:]))
    n_bytes = (4 * (x.numel() + g * r * MLP_DIMS[-1] +
                    sum(b.numel() for b in bs)) +
               2 * sum(w.numel() for w in ws))     # weights read as bf16
    b_ms, b_by = bound_ms(n_bytes, 2.0 * g * r * macs, BF16_FLOP_PER_S)
    # the pack reads the f32 weights once and writes the bf16 tile stream
    pack_bound, _ = bound_ms(4 * sum(w.numel() for w in ws) +
                             2 * packed.w.numel(), 0, BF16_FLOP_PER_S)
    log(f'fused_mlp per launch: kernel {ms:.4f} ms; L2 flushed '
        f'{ms_cold:.4f} ms; plain {plain_ms:.4f} ms; bf16 baddbmm chain '
        f'{library_ms:.4f} ms (device {library_device_ms:.4f} ms); bound '
        f'{b_ms:.4f} ms ({b_by})')
    log(f'pack_weights per call: {pack_ms:.4f} ms, bound {pack_bound:.4f} ms '
        f'(bytes: {4 * sum(w.numel() for w in ws) / 1e6:.1f} MB of f32 read, '
        f'{2 * packed.w.numel() / 1e6:.1f} MB of bf16 tiles written)')
    return dict(name='fused_mlp', route='cuda',
                source='learning_to_adapt_torch/csrc/fused_mlp.cu',
                replaces='learning_to_adapt_tpu/ops/fused_mlp.py:102',
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                ms_cold=ms_cold, library_device_ms=library_device_ms)


def contact_systems(dev):
    """The Jacobi inputs of one real HalfCheetah physics step for 5 envs,
    taken after 30 random-action steps (feet on the floor)."""
    import torch
    from learning_to_adapt_torch.envs import HalfCheetahEnv, normalize
    from learning_to_adapt_torch.physics import engine
    env = normalize(HalfCheetahEnv(task='cripple', device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = env.reset(N_ENVS, 0, gen)

    def random_step(state):
        act = 2 * torch.rand((N_ENVS, env.act_dim), generator=gen,
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


def check_jacobi(dev):
    import torch
    from learning_to_adapt_torch.ops import jacobi as jc
    A, b, ainv, omega, n_sweeps = contact_systems(dev)
    n = A.shape[-1]
    n_active = int((b != 0).sum())
    log(f'jacobi: HalfCheetah contact systems {tuple(A.shape)}, '
        f'{n_sweeps} sweeps, {n_active} active rows over {N_ENVS} envs, '
        f'omega {[round(float(w), 4) for w in omega]}')
    if n_sweeps != JACOBI_SWEEPS or n_active == 0:
        raise AssertionError('expected 60 sweeps over an active contact set')

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    m = torch.randn((N_ENVS, n, n), generator=gen, device=dev)
    A_r = m @ m.transpose(-1, -2) + n * torch.eye(n, device=dev)
    b_r = torch.randn((N_ENVS, n), generator=gen, device=dev)
    ainv_r = 1.0 / torch.diagonal(A_r, dim1=-2, dim2=-1)
    rho = torch.amax(A_r.abs().sum(-1) * ainv_r, dim=-1)
    omega_r = torch.clamp(1.8 / rho, max=1.0)

    errs = []
    for label, args in (('contact', (A, b, ainv, omega)),
                        ('random SPD', (A_r, b_r, ainv_r, omega_r))):
        out = jc.jacobi_solve_cuda(*args, n_sweeps)
        ref = jc.jacobi_solve_plain(*args, n_sweeps)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        errs.append(err)
        log(f'jacobi {label}: max_abs_err {err:.3e} (tolerance {JACOBI_TOL}, '
            f'max|ref| {float(ref.abs().max()):.3e})')
        torch.testing.assert_close(out, ref, **JACOBI_TOL)
        if not bool((out >= 0).all()):
            raise AssertionError('projected Jacobi returned a negative force')

    ms = cuda_ms(lambda: jc.jacobi_solve_cuda(A, b, ainv, omega, n_sweeps))
    plain_ms = cuda_ms(lambda: jc.jacobi_solve_plain(A, b, ainv, omega,
                                                     n_sweeps))
    n_bytes = 4 * (A.numel() + 3 * b.numel() + omega.numel())
    flops = n_sweeps * N_ENVS * n * (2 * n + 5)
    b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOP_PER_S)
    log(f'jacobi per launch: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
        f'bound {b_ms:.6f} ms ({b_by}); chain of {n_sweeps} dependent sweeps')
    return dict(name='jacobi_solve', route='cuda',
                source='learning_to_adapt_torch/csrc/jacobi.cu',
                replaces='learning_to_adapt_tpu/ops/pallas_jacobi.py:73',
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, ms_cold=None,
                library_device_ms=None)


def main_path(dev, card):
    import numpy as np
    import torch
    from learning_to_adapt_torch.envs import HalfCheetahEnv, normalize
    from learning_to_adapt_torch.models import (
        MetaMLPDynamicsModel, Normalizer)
    from learning_to_adapt_torch.ops import fused_mlp, jacobi
    from learning_to_adapt_torch.policies import MPCController
    from learning_to_adapt_torch.samplers import Sampler

    env = normalize(HalfCheetahEnv(task='cripple', reset_every_episode=True,
                                   device=dev))
    model = MetaMLPDynamicsModel(
        'dyn_model', env, hidden_sizes=MLP_DIMS[1:-1], meta_batch_size=10,
        inner_learning_rate=INNER_LR, learning_rate=1e-3,
        hidden_nonlinearity='relu', batch_size=ADAPT_BATCH, seed=0,
        device=dev)
    policy = MPCController('policy', env, model, discount=1.0,
                           n_candidates=N_CANDIDATES, horizon=HORIZON)
    sampler = Sampler(env, policy, num_rollouts=N_ENVS,
                      max_path_length=PATH_LEN, adapt_batch_size=ADAPT_BATCH,
                      seed=0, device=dev)

    paths = sampler.obtain_samples(random=True)
    log(f'random sampling: {N_ENVS}x{PATH_LEN} env steps in '
        f'{sampler.last_seconds:.2f} s')
    obs, act, nxt = (torch.as_tensor(paths[k], device=dev) for k in
                     ('observations', 'actions', 'next_observations'))
    model.normalizer = Normalizer.fit(obs, act, nxt - obs)

    fused_mlp.fused_mlp_forward.launches = 0
    fused_mlp.pack_weights.calls = 0
    jacobi.jacobi_solve.launches = 0
    paths = sampler.obtain_samples()
    launches = dict(fused_mlp=fused_mlp.fused_mlp_forward.launches,
                    jacobi_solve=jacobi.jacobi_solve.launches)
    packs = fused_mlp.pack_weights.calls
    seconds = sampler.last_seconds

    for k, shape in (('observations', (N_ENVS, PATH_LEN, env.obs_dim)),
                     ('next_observations', (N_ENVS, PATH_LEN, env.obs_dim)),
                     ('actions', (N_ENVS, PATH_LEN, env.act_dim)),
                     ('rewards', (N_ENVS, PATH_LEN)),
                     ('qpos', (N_ENVS, PATH_LEN, env.model.nq)),
                     ('qvel', (N_ENVS, PATH_LEN, env.model.nv))):
        if paths[k].shape != shape:
            raise AssertionError(f'{k}: shape {paths[k].shape} != {shape}')
        if not np.isfinite(paths[k]).all():
            raise AssertionError(f'{k}: non-finite values')
    if not np.array_equal(paths['next_observations'][:, :-1],
                          paths['observations'][:, 1:]):
        raise AssertionError('observation chain broken')
    if np.abs(paths['actions']).max() > 1.0:
        raise AssertionError('planner actions outside [-1, 1]')
    want = dict(fused_mlp=HORIZON * PATH_LEN,
                jacobi_solve=env.frame_skip * PATH_LEN)
    log(f'policy sampling launches {launches}, expected {want}; weight '
        f'packs {packs}, expected {PATH_LEN}')
    if launches != want:
        raise AssertionError(f'launch counts {launches} != {want}')
    if packs != PATH_LEN:
        raise AssertionError(f'{packs} weight packs != one per env step')
    returns = paths['rewards'].sum(axis=1)
    log(f'policy sampling (episode 1, cripple tasks drawn): '
        f'{N_ENVS}x{PATH_LEN} env steps in {seconds:.2f} s = '
        f'{N_ENVS * PATH_LEN / seconds:.1f} env-steps/s on {card}; '
        f'returns {np.round(returns, 2).tolist()}')
    return launches, sampler


def profile_policy_steps(dev, sampler):
    """torch.profiler over one policy sampling call of PROFILE_LEN steps
    (adaptation on from step 18): host time of each labelled part of a step,
    device kernel time and kernel launches per step, the busiest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from learning_to_adapt_torch.samplers import Sampler
    prof_sampler = Sampler(sampler.env, sampler.policy, N_ENVS, PROFILE_LEN,
                           adapt_batch_size=ADAPT_BATCH, seed=1, device=dev)
    prof_sampler.obtain_samples()                  # warm-up
    prof_sampler.obtain_samples()
    plain_s = prof_sampler.last_seconds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_sampler.obtain_samples()
    prof_s = prof_sampler.last_seconds
    # device activity: kernels and copies, not the annotation spans that
    # mirror the 'rollout.*' labels on the device timeline
    events = prof.events()
    on_device = [e for e in events
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith('rollout.')
                 and not getattr(e, 'is_user_annotation', False)]
    device_us = sum(e.time_range.elapsed_us() for e in on_device)
    by_name = {}  # keyed by the printed (shortened) kernel name
    for e in on_device:
        by_name[e.name[:70]] = (by_name.get(e.name[:70], 0) +
                                e.time_range.elapsed_us())
    parts = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith('rollout.'):
            calls, us = parts.get(e.name, (0, 0.0))
            parts[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    parts = {k: dict(calls=c, host_ms_per_call=round(us / c / 1e3, 3))
             for k, (c, us) in parts.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f'profile, {N_ENVS}x{PROFILE_LEN} policy steps: wall '
        f'{plain_s * 1e3 / PROFILE_LEN:.2f} ms/step unprofiled, '
        f'{prof_s * 1e3 / PROFILE_LEN:.2f} ms/step profiled; device time '
        f'{device_us / 1e3 / PROFILE_LEN:.3f} ms/step, busy share '
        f'{device_us / 1e6 / prof_s:.3f} of the profiled wall, '
        f'{device_us / 1e6 / plain_s:.3f} of the unprofiled wall; '
        f'{len(on_device) / PROFILE_LEN:.0f} device activities/step')
    log('profile parts (host, profiled) ' + json.dumps(parts))
    pack_us = [e.device_time_total for e in events
               if e.device_type == DeviceType.CPU and e.name == 'rollout.pack']
    log(f'profile rollout.pack: {len(pack_us)} packs, device time '
        f'{sum(pack_us) / 1e3 / PROFILE_LEN:.4f} ms per step')
    for kernel in ('fused_mlp_kernel', 'jacobi_kernel'):
        runs = [e.time_range.elapsed_us() for e in on_device
                if kernel in e.name]
        log(f'profile {kernel}: {len(runs)} launches, device time '
            f'{sum(runs) / max(len(runs), 1) / 1e3:.4f} ms per launch')
    log('profile top device activities (ms/step): ' + json.dumps(
        {k: round(us / 1e3 / PROFILE_LEN, 4) for k, us in top}))


def check_host_syncs(dev, sampler):
    """One policy sampling call of PROFILE_LEN steps, watched two ways for
    the host waiting on the card: torch.profiler's record of the CUDA
    runtime's sync calls, grouped by the operator that made them, and CUDA's
    sync-debug mode, grouped by Python call site. Only once-per-call work
    (the reset, the final copy to the host) may wait; anything that waits
    once a step or more fails the run."""
    import os
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    from learning_to_adapt_torch.samplers import Sampler
    sync_sampler = Sampler(sampler.env, sampler.policy, N_ENVS, PROFILE_LEN,
                           adapt_batch_size=ADAPT_BATCH, seed=2, device=dev)
    sync_sampler.obtain_samples()                  # warm-up, not counted
    with warnings.catch_warnings(record=True) as caught, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            sync_sampler.obtain_samples()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    by_op = {}
    for e in prof.events():
        if e.name in SYNC_CALLS:
            op = e.cpu_parent.name if e.cpu_parent is not None else 'python'
            by_op[f'{e.name} in {op}'] = by_op.get(
                f'{e.name} in {op}', 0) + 1
    sites = {}
    for w in caught:
        if 'synchronizing' in str(w.message):
            site = f'{os.path.relpath(w.filename)}:{w.lineno}'
            sites[site] = sites.get(site, 0) + 1
    log(f'host waits in one {PROFILE_LEN}-step policy sampling call: '
        f'runtime sync calls by operator {json.dumps(by_op)}; '
        f'sync-debug mode by call site {json.dumps(sites)}')
    per_step = {k: n for counts in (by_op, sites) for k, n in counts.items()
                if n >= PROFILE_LEN}
    if per_step:
        raise AssertionError(f'host waits once a step or more: {per_step}')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'needs an NVIDIA card', file=sys.stderr)
        return 2
    try:
        import learning_to_adapt_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port package is missing ({e}); run from the '
              'repository root', file=sys.stderr)
        return 3
    t_start = time.time()
    card = card_line()
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'device {torch.cuda.get_device_name(0)}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)

    build_kernels()
    kernels = [check_fused_mlp(dev), check_jacobi(dev)]
    launches, sampler = main_path(dev, card)
    profile_policy_steps(dev, sampler)
    check_host_syncs(dev, sampler)
    for k in kernels:
        k['launches'] = launches[k['name']]
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'ms_cold',
            'library_device_ms')
    log(f'total {time.time() - t_start:.1f} s')
    log(card_line())
    log(json.dumps({'kernels': [{k: kern[k] for k in keys}
                                for kern in kernels]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
