"""Smoke run of the PyTorch port (learning_to_adapt_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
  1. print the card (nvidia-smi name, power limit); build the four CUDA
     kernel sources of learning_to_adapt_torch/csrc with nvcc for sm_90a,
     and
     the floor variants of the Jacobi kernels' sweep chains
     (jacobi_study.py: the tiers' handshake only, the cluster kernel's two
     paths without row products), in parallel;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, with the tolerance printed, and time kernel, plain
     version and (for the MLP) one library call with CUDA events, the host
     queued ahead so the times are the card's. The MLP kernel runs on
     weights packed once (pack_weights, timed on its own), with L2 warm
     and flushed; the library call's device time also comes from a
     torch.profiler window. The Jacobi kernel is held on real HalfCheetah
     contact systems and on random SPD systems for 5 and 512 envs; its
     launch tier is printed, and its device time is set beside the floor
     of its sweep chain (the handshake-only variant on the same inputs).
     The clip-and-Adam kernel is held bit for bit against its plain chain
     at both models' leaf shapes (MB-MPC's and GrBAL's MLPs) over four
     unclipped steps, and timed eagerly and as a replayed CUDA graph (as
     the fits run it) beside the chain timed the same two ways. Every fit
     on the card must launch it twice a train step (counted_calls). The
     smooth-dynamics kernel (both variants: a dynamics pass, the env's
     forward) is held against the engine's plain tensor code on
     HalfCheetah (10 and 512 envs) and Ant (5 envs) states after 30
     random steps, and timed warm, L2-flushed and as a replayed graph,
     beside the plain code eager and as a graph, the kernels the plain
     code launches and an empty launch; every sampling call must launch it
     once a dynamics pass, once a step's forward and once for its reset
     (physics_launches);
  3. drive the main path: GrBAL adaptive-MPC sampling on HalfCheetah
     (cripple task) at the full width of run_scripts/run_grbal.py — 5 envs,
     500 candidates x horizon 10, a (512,512,512) ReLU meta-MLP, adaptation
     on the last 16 transitions at inner lr 1e-3 — through Sampler: one
     random-action call, Normalizer.fit on its paths, one policy call
     (episode 1, so cripple tasks are drawn); paths of 100 steps, so
     adaptation is active from step 18. Every sampling call on the card
     replays its step captured as CUDA graphs (samplers/rollout.py
     CompiledRollout, one graph for each side of the adaptation gate,
     captured in its first call): the policy call must replay one a step.
     The launch counters, which count a captured launch once a replay, are
     set to 0 before the policy call and must show 10 fused-MLP launches
     and 1 weight pack per env step and 1 Jacobi launch per physics step;
  4. four more policy calls of 100 steps from one generator state, eager
     and captured in turns (e c c e; env-steps/s of both), each with the
     counts set to 0 just before it: the paths, the generator's state
     after the call and the launches must be the first call's, bit for
     bit; then one eager and one captured call of 30 steps, each timed and
     profiled with torch.profiler: wall and device time per step, device
     activities and replays per step, the device's busy share, the device
     time per launch of both kernels, the busiest activities, and for the
     eager call the host and device time of each labelled part of a step
     (rollout.adapt / .pack / .plan / .env_step);
  5. watch one more captured policy sampling call (after a warm-up, so its
     capture's synchronize is not in it) for the host waiting on the card
     (the profiler's CUDA runtime sync calls and CUDA's sync-debug mode) and
     fail if anything waits once a step or more;
  6. the trainer: run_grbal.run_experiment in a temporary directory at
     the same width with --task cripple, seed 0, max_path_length 100 and
     n_itr 3 (one random, then two policy iterations; 100 epochs per fit),
     then --resume with n_itr 4. progress.csv must carry the header of
     results/grbal_halfcheetah_tpu_r3.csv letter for letter and finite
     losses and returns, params.pkl must load and re-create its env, the
     resumed run must start at itr 3, and the launch counters (set to 0
     before each run) must show, per iteration, 10 fused-MLP launches and
     1 pack per policy env step, 1 Jacobi launch per physics step, and
     from the fit only the clip-and-Adam kernel's two a train replay;
  7. time the meta fit at full width on a dataset of the size the
     canonical run holds by iteration 16 (64 train paths x 1000 steps: 256
     meta-train steps an epoch; 16 valid paths: 64 steps), drawn from a
     seeded generator around the sampled paths' statistics, for timing
     only: 1 warm-up and 3 timed epochs (CUDA events, host clock), one
     epoch under torch.profiler (device time, device activities and host
     time per step, busy share), and one epoch watched for host waits as
     in phase 5, failing on any wait once per train step or more;
  8. MB-MPC: run_mb_mpc.run_experiment at its full config (10 envs x 100
     steps, 2000 candidates x horizon 20, a (512,512) ReLU model, batch
     128, 100 epochs a fit) with --task cripple, 2 iterations (one random,
     one policy; cut from 3 to keep the script near 600 s) and a resume
     to 3, checked as in phase 6 against results/mb_mpc_halfcheetah_tpu_r3.csv;
     per policy iteration 20 fused-MLP launches a step over 20,000 rows
     (2000), one weight pack for the whole call, 1 Jacobi launch per
     physics step, from the fit only clip and Adam's; then policy
     sampling calls as in phases 4 and 5: eager against captured at 100
     steps (e c c e), one eager and one captured call of 30 steps
     profiled, one captured call watched for host waits. The
     kernel phase also holds and times the MLP kernel at this shape (1 x
     20,000 rows, 26->512->512->20, beside a bf16 addmm chain);
  9. ReBAL: run_rebal.run_experiment (5 envs, 500 candidates x horizon 10,
     an LSTM (256,), batch 10, 100-step TBPTT chunks, 50 epochs a fit) with
     paths cut 1000 -> 100, --task cripple, 3 iterations and a resume,
     checked against results/rebal_halfcheetah_tpu_r3.csv; per policy
     iteration no fused-MLP launch or pack (the recurrent planner runs f32
     cell equations), 1 Jacobi launch per physics step; policy sampling
     calls as in phase 8;
 10. time the MB-MPC fit's epoch on 15,300 train rows (its dataset at
     iteration 16: 128 steps an epoch) and 11. the ReBAL fit's on 68 train
     paths x 1000 steps (8 steps of 10 TBPTT chunks an epoch), each as in
     phase 7;
 12. the cluster Jacobi kernel (N > 224), in the kernel phase: its plan
     printed (cluster size, rows held in shared memory and in registers,
     occupancy); held against the plain version, one launch each, dead
     rows exactly 0 and live rows an env printed, on real
     HalfCheetahBlocksEnv contact systems (5 envs x 988 rows after 30
     random-action steps), random SPD systems at N = 225, 988, 1024 and
     2048 for 1 and 5 envs and at N = 988 for 512 envs, and systems built
     as the engine leaves inactive contacts (jacobi_study.dead_system: 90 %
     and 99 % of 988 rows dead at 5 and 512 envs, 224 and 225 live, none
     live, a non-symmetric A); CUDA-event and device times on the blocks
     systems (warm and with L2 flushed), dense 5 x 988, dense 512 x 988
     and 99 %-dead 512 x 988, beside the plain version, the bound (one
     read of A against the live rows' operations) and the floors of the
     one-block and dense chains. The MLP kernel is also held and timed at
     the arm's widths (5 x 500 rows, 30->512x3->23) beside the bf16
     baddbmm chain;
 13. the new envs: run_grbal from its command line (--env, --task) for
     HalfCheetahHFieldEnv --task hfield, HalfCheetahBlocksEnv --task
     damping and Arm7DofEnv --task force, full width, seed 0, paths of
     100 steps, 2 iterations (one random, one policy), in a temporary
     directory: per policy iteration 1000 fused-MLP launches, 100 packs
     and 1 Jacobi launch per physics step (the cluster kernel for the
     blocks env, the tiers for the others), from the fits only clip and
     Adam's; finite
     losses and returns, progress.csv's header letter for letter that of
     results/grbal_cheetah_hfield_tpu_r3.csv, grbal_blocks_tpu_r5.csv and
     grbal_arm7dof_force_tpu_r4.csv, params.pkl re-creating its env, every
     sampling call captured; then policy sampling calls on the blocks env
     as in phase 8;
 14. the Ant (free joint, RK4: 4 constraint solves a physics step): in
     the kernel phase, the tier Jacobi kernel on Ant contact systems (5
     envs x 116 rows, after 30 random-action steps) and the MLP kernel at
     the Ant's widths (5 x 500 rows, 49->512x3->41, beside the bf16
     baddbmm chain), each against its plain version, timed warm and with
     L2 flushed and by profiler device time; run_grbal --env AntEnv --task
     cripple as in phase 13 (per policy iteration 1000 fused-MLP launches,
     100 packs and 4 x 100 Jacobi launches; header of
     results/grbal_ant_cripple_tpu_r4.csv), policy sampling calls as in
     phase 8, and one iteration of run_mb_mpc --env AntEnv --task cripple
     (header of results/mb_mpc_ant_cripple_tpu_r4.csv; 4 x 100 Jacobi
     launches in its random call);
 15. print the card line again, one JSON line describing every kernel
     (with its launches on each algorithm's and env's path, on the
     meta-test's and on the multi-rank path's), then the contract line
     {"ok": true, "device": {...}} last, after phase 18;
 16. the meta-test protocol and host tools, on the snapshots phases 6, 8,
     9 and 14 wrote (copied from their temporary directories): (a)
     meta_test.main on the Ant GrBAL snapshot (trained on legs 0, 1, 2)
     with --eval_set 3 --seeds 0 --num_rollouts 5 --max_path_length 100,
     from a temporary working directory, once with eager sampling and
     once captured (each rollout a new Sampler that captures its own
     graphs; both walls printed, the results, launches and adapted steps
     identical): the JSON has the keys of
     results/meta_test_ant_leg3_grbal_s0.json plus ablate_warmup and
     set_kind, both modes are finite, the counts (set to 0 just before the
     run) show per mode 1000 fused-MLP launches, 100 packs and 400 Jacobi
     launches, and adaptation runs in the adapted mode only (82 steps:
     rollout.adapt calls eager, replays of the adapted graph captured);
     the gap is printed; (b) meta_test.main on the ReBAL snapshot (modes
     rebal, rebal_hidden_zero, rebal_hidden_frozen: no MLP launch, 100
     Jacobi launches each, three different returns) and on the MB-MPC
     snapshot (mode mb_mpc: 2000 MLP launches, 1 pack); (c) sim_policy on
     the HalfCheetah GrBAL snapshot (2 x 100 steps; replay.npz carries the
     JAX replay's keys), then nominal replays (task None) of the
     HalfCheetah and Ant GrBAL snapshots held step by step against the
     float64 C++ oracle over 99 steps: the worst one-step qpos deviation is
     printed and must stay below 1e-2; (d) the vectorized executor on
     HalfCheetah cripple, 5 envs x 120 random-action steps with
     max_path_length 50: every env auto-resets at steps 50 and 100 and
     its episode counter reads 2; (e) entry()'s fn(*example_args) once:
     exactly 1 fused-MLP launch, held against the plain version;
 17. the multi-rank path (parallel/mesh.py): (a) run_grbal_multihost at
     world size 1 over nccl on the card, at the width of phase 6 with --task
     cripple, 2 iterations of 100-step paths: per policy iteration 1000
     fused-MLP launches, 100 packs and 100 Jacobi launches, every sampling
     call captured, one all_gather a sampling call and no collective in its
     steps, per fit one broadcast and one all_reduce a meta-train step, a
     validation step and an epoch; then one sharded fit epoch (64 + 16 steps
     on timing data) watched for host waits as in phase 7; (b) two ranks
     sharing the card over gloo (processes started by spawn; sampling eager)
     against one rank, GrBAL at full width with 6 envs x 40 steps over the
     ranks: the random call's paths to 1e-5, a 3-epoch sharded meta fit on
     the gathered paths bit for bit (both ranks alike, as rank 0's unsharded
     twin on the same paths, and as the 1-rank job's where the two jobs
     gathered the same paths bit for bit), the policy call's candidate
     returns and paths step for step up to the first step where the paths
     part, which passes only as a near tie (after step 0, in one env, the
     best two returns within twice the two jobs' return difference), and its
     reward sum to rtol 2e-3 where nothing parts; 10 fused-MLP launches a
     policy step on every rank; the phase's seconds and each job's policy
     env-steps/s are printed;
 18. the port's renderer on the card (learning_to_adapt_torch/
     render_trajectory.py, interactive_viewer.py) on phase 16 (c)'s replay
     (HalfCheetah, 2 x 100 steps): render_frames of each rollout at the
     HTML viewer's stride 4 on the card against the same call on the CPU
     (atol 1e-5), and the HTML viewer exported from the card to a
     temporary directory; the frame count and the seconds are printed.

Profiler windows are read from their raw kineto events (Trace): building
the profiler's FunctionEvents takes tens of seconds a window. A sampling
call's window that recorded fewer launches of our kernels than the
counters saw is run again (complete_trace).

Imports nothing of JAX or of the JAX package. Without a card it exits 2
before printing any result.
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# published H100 SXM peaks (NVIDIA data sheet, dense): the bounds below
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

MLP_DIMS = (26, 512, 512, 512, 20)    # obs 20 + act 6 -> 20
ARM_DIMS = (30, 512, 512, 512, 23)    # the arm: obs 23 + act 7 -> 23
ANT_DIMS = (49, 512, 512, 512, 41)    # the Ant: obs 41 + act 8 -> 41
ANT_ROWS = 116                        # 16 limit rows + 25 contacts x 4
N_ENVS, N_CANDIDATES, HORIZON = 5, 500, 10
# MB-MPC (run_scripts/run_mb_mpc.py): 10 envs x 2000 candidates x horizon
# 20 through a (512, 512) model, one weight set for every row
MB_DIMS = (26, 512, 512, 20)
MB_ENVS, MB_CANDIDATES, MB_HORIZON = 10, 2000, 20
# the fits' dataset sizes at iteration 16 (17 fits): MB-MPC 900 train + 100
# valid rows a fit; ReBAL 4 train + 1 valid paths of 1000 steps a fit
MB_FIT_ROWS, MB_FIT_VALID_ROWS = 17 * 900, 17 * 100
RB_FIT_PATHS, RB_FIT_VALID_PATHS = 17 * 4, 17 * 1
ADAPT_BATCH, INNER_LR = 16, 1e-3
PATH_LEN = 100
PROFILE_LEN = 30
TRAIN_ITR = 3                         # one random, two policy iterations
MB_TRAIN_ITR = 2                      # MB-MPC: one random, one policy
FIT_PATHS, FIT_VALID_PATHS, FIT_T = 64, 16, 1000
FIT_TIMED_EPOCHS = 3
REPO = os.path.dirname(os.path.abspath(__file__))
HEADER_CSV = os.path.join(REPO, 'results', 'grbal_halfcheetah_tpu_r3.csv')
MB_HEADER_CSV = os.path.join(REPO, 'results', 'mb_mpc_halfcheetah_tpu_r3.csv')
RB_HEADER_CSV = os.path.join(REPO, 'results', 'rebal_halfcheetah_tpu_r3.csv')
JACOBI_SWEEPS = 60                    # 2 * OptionSpec.iterations
JACOBI_WIDE_ENVS = 512                # bench.py bench_saturated's env count
BLOCKS_ROWS = 988                     # HalfCheetahBlocksEnv's system
CLUSTER_NS = (225, 988, 1024, 2048)   # the cluster kernel's random systems
CLUSTER_ENVS = (1, 5)
# the new envs' GrBAL runs: (env class, task, the JAX run's progress.csv,
# the counter of the Jacobi kernel its system size takes)
NEW_ENVS = (
    ('HalfCheetahHFieldEnv', 'hfield', 'grbal_cheetah_hfield_tpu_r3.csv',
     'jacobi_solve'),
    ('HalfCheetahBlocksEnv', 'damping', 'grbal_blocks_tpu_r5.csv',
     'jacobi_solve_cluster'),
    ('Arm7DofEnv', 'force', 'grbal_arm7dof_force_tpu_r4.csv',
     'jacobi_solve'),
    ('AntEnv', 'cripple', 'grbal_ant_cripple_tpu_r4.csv', 'jacobi_solve'))
ANT_MB_HEADER = 'mb_mpc_ant_cripple_tpu_r4.csv'
NEW_ENV_ITR = 2                       # one random, one policy iteration

SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize')

MLP_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 roundings of hidden units flip
# the captured fit epoch against the eager one, after FIT_CHECK_STEPS train
# steps and the validation: the same kernels from one state on one draw
FIT_CHECK_STEPS = 8
FIT_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_LOSS_RTOL = 1e-5
JACOBI_TOL = dict(rtol=1e-4, atol=1e-5)  # f32, other summation order
# the smooth-dynamics kernel against its plain code, largest difference over
# the largest magnitude: f32, other summation order and fused multiply-adds
# (tests/test_torch_smooth_kernel.py TOL)
SMOOTH_TOL = 1e-5
RENDER_STRIDE = 4                     # the HTML viewer's default stride
RENDER_ATOL = 1e-5                    # FK at f32, card against the CPU


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


class Trace:
    """The events of a torch.profiler window, read from its raw kineto
    results: building the profiler's FunctionEvents takes tens of seconds
    for a sampling call's few hundred thousand events, this about one.
    `device`: the card's activities (kernels, copies; not the annotations
    that mirror the 'rollout.*' / 'fit.*' labels) as (name, ns, correlation
    id); `host`: the CPU side (operators, labels, CUDA runtime calls) as
    (name, start ns, end ns, thread, correlation id)."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        self.device, self.host = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not (e.is_user_annotation() or
                        name.startswith(('rollout.', 'fit.'))):
                    self.device.append((name, e.duration_ns(),
                                        e.correlation_id()))
            else:
                self.host.append((name, e.start_ns(), e.end_ns(),
                                  e.start_thread_id(), e.correlation_id()))

    def device_us(self, kernel=''):
        """Device time of the activities whose name holds `kernel`."""
        return sum(ns for name, ns, _ in self.device if kernel in name) / 1e3

    def launches(self, kernel):
        return sum(kernel in name for name, _, _ in self.device)

    def parts(self, prefix):
        """{label: (calls, host us)} of the host ranges named prefix*."""
        out = {}
        for name, start, end, _, _ in self.host:
            if name.startswith(prefix):
                calls, us = out.get(name, (0, 0.0))
                out[name] = (calls + 1, us + (end - start) / 1e3)
        return out

    def device_us_under(self, label):
        """Device time of the activities launched (by a CUDA runtime call)
        inside a host range named `label`."""
        import bisect
        ranges = {}
        for name, start, end, tid, _ in self.host:
            if name == label:
                ranges.setdefault(tid, []).append((start, end))
        for r in ranges.values():
            r.sort()
        launch = {corr: (start, tid) for name, start, _, tid, corr
                  in self.host if corr and name.startswith('cu')}
        ns, linked = 0, 0
        for _, dur, corr in self.device:
            if corr not in launch:
                continue
            linked += 1
            start, tid = launch[corr]
            r = ranges.get(tid, [])
            i = bisect.bisect_right(r, (start, float('inf'))) - 1
            if i >= 0 and r[i][0] <= start <= r[i][1]:
                ns += dur
        if ranges and not linked:
            raise AssertionError('no device activity linked to a runtime '
                                 'call in the trace')
        return ns / 1e3

    def calls_by_parent(self, names):
        """{'<call> in <innermost enclosing host range>': count} of the host
        events named in `names` ('python' where nothing encloses one): one
        sweep a thread over the events in start order with a stack of the
        open ranges, as the profiler's own tree is built."""
        out = {}
        order = sorted(range(len(self.host)), key=lambda i: (
            self.host[i][3], self.host[i][1], -self.host[i][2]))
        stack = []
        for i in order:
            name, start, end, tid, _ = self.host[i]
            while stack and not (self.host[stack[-1]][3] == tid and
                                 self.host[stack[-1]][2] >= end):
                stack.pop()
            if name in names:
                parent = self.host[stack[-1]][0] if stack else 'python'
                key = f'{name} in {parent}'
                out[key] = out.get(key, 0) + 1
            stack.append(i)
        return out


def profiled(fn, cpu=True, tries=3):
    """The Trace of fn() run under torch.profiler (the card's activity, and
    the host's unless cpu=False). A window whose trace holds no device
    activity at all, which the profiler has given once in a kernel's
    device timing, is run again, up to `tries` times; then the phase fails
    rather than report a time of 0."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    for attempt in range(1, tries + 1):
        with profile(activities=activities) as prof:
            fn()
        trace = Trace(prof)
        if trace.device:
            return trace
        log(f'profiler window {attempt} of {tries} recorded no device '
            'activity')
    raise AssertionError(f'{tries} profiler windows recorded no device '
                         'activity')


def device_ms(fn, iters=20):
    """Sum of the card's activity (kernels, copies) per call of fn, from a
    torch.profiler window: gaps between the kernels are not counted."""
    import torch
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return profiled(window, cpu=False).device_us() / iters / 1e3


def bound_ms(n_bytes, flops, peak_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def build_kernels():
    """Build the kernel sources and the Jacobi kernels' floor variants
    (one nvcc each, all at once); returns the variants' libraries (tiers,
    the cluster kernel's one-block path, its dense path)."""
    import jacobi_study
    from learning_to_adapt_torch.ops import build
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=5) as pool:
        floors = [pool.submit(jacobi_study.compile_variant, name) for name
                  in (jacobi_study.FLOOR, jacobi_study.SMALL_FLOOR,
                      jacobi_study.DENSE_FLOOR)]
        paths = list(pool.map(build.build, ['fused_mlp', 'jacobi',
                                            'clip_adam', 'smooth_dynamics']))
        floors = [f.result() for f in floors]
    log(f'built {[p.name for p in paths + [f[1] for f in floors]]} in '
        f'{time.time() - t0:.1f} s (parallel nvcc, -gencode '
        'arch=compute_90a,code=sm_90a)')
    for name, nvcc_log in build.BUILD_LOGS.items():
        for line in nvcc_log.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  {name}: {line.strip()}')
    return tuple(f[0] for f in floors)


def check_fused_mlp(dev, dims=MLP_DIMS, what='GrBAL'):
    """The kernel at GrBAL's planner shape (5 envs x 500 rows) for the
    widths `dims`: per-group and stride-0 weights, packed, against the
    plain version; timed warm and L2-flushed beside the bf16 baddbmm
    chain, the pack timed on its own."""
    import torch
    from learning_to_adapt_torch.ops import fused_mlp as fm
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g, r = N_ENVS, N_CANDIDATES
    x = torch.randn((g, r, dims[0]), generator=gen, device=dev)
    ws, bs = [], []
    for k, n in zip(dims[:-1], dims[1:]):
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
        log(f'fused_mlp {what} widths {dims}, {label}, packed weights '
            f'{tuple(x.shape)} -> {tuple(out.shape)}: max_abs_err '
            f'{err:.3e} (tolerance {MLP_TOL}, max|ref| '
            f'{float(ref.abs().max()):.3f})')
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
    macs = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    n_bytes = (4 * (x.numel() + g * r * dims[-1] +
                    sum(b.numel() for b in bs)) +
               2 * sum(w.numel() for w in ws))     # weights read as bf16
    b_ms, b_by = bound_ms(n_bytes, 2.0 * g * r * macs, BF16_FLOP_PER_S)
    # the pack reads the f32 weights once and writes the bf16 tile stream
    pack_bound, _ = bound_ms(4 * sum(w.numel() for w in ws) +
                             2 * packed.w.numel(), 0, BF16_FLOP_PER_S)
    log(f'fused_mlp per launch, {what} widths: kernel {ms:.4f} ms; L2 '
        f'flushed {ms_cold:.4f} ms; plain {plain_ms:.4f} ms; bf16 baddbmm '
        f'chain {library_ms:.4f} ms (device {library_device_ms:.4f} ms); '
        f'bound {b_ms:.4f} ms ({b_by})')
    log(f'pack_weights per call: {pack_ms:.4f} ms, bound {pack_bound:.4f} ms '
        f'(bytes: {4 * sum(w.numel() for w in ws) / 1e6:.1f} MB of f32 read, '
        f'{2 * packed.w.numel() / 1e6:.1f} MB of bf16 tiles written)')
    return dict(name='fused_mlp', route='cuda',
                source='learning_to_adapt_torch/csrc/fused_mlp.cu',
                replaces='learning_to_adapt_tpu/ops/fused_mlp.py:102',
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                ms_cold=ms_cold, library_device_ms=library_device_ms,
                device_ms=device_ms(kernel), floor_ms=None, ms_512=None)


def check_fused_mlp_arm(dev):
    """The kernel at the arm's widths (30->512x3->23) on GrBAL's planner
    shape; returns the keys it adds to the fused_mlp entry."""
    got = check_fused_mlp(dev, ARM_DIMS, 'Arm')
    return {f'arm_{k}': got[k] for k in (
        'max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms',
        'library_ms', 'library_device_ms')}


def check_fused_mlp_ant(dev):
    """The kernel at the Ant's widths (49->512x3->41) on GrBAL's planner
    shape; returns the keys it adds to the fused_mlp entry."""
    got = check_fused_mlp(dev, ANT_DIMS, 'Ant')
    return {f'ant_{k}': got[k] for k in (
        'max_abs_err', 'ms', 'ms_cold', 'device_ms', 'plain_ms', 'bound_ms',
        'library_ms', 'library_device_ms')}


def check_fused_mlp_mb_mpc(dev):
    """The kernel at MB-MPC's planner shape: 1 group x 20,000 rows,
    26->512->512->20, one weight set packed once; held against the plain
    version and timed beside one bf16 matmul chain (addmm) at that shape.
    Returns the keys it adds to the fused_mlp entry."""
    import torch
    from learning_to_adapt_torch.ops import fused_mlp as fm
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    r = MB_ENVS * MB_CANDIDATES
    x = torch.randn((1, r, MB_DIMS[0]), generator=gen, device=dev)
    ws, bs = [], []
    for k, n in zip(MB_DIMS[:-1], MB_DIMS[1:]):
        lim = (6.0 / (k + n)) ** 0.5
        ws.append((torch.rand((1, k, n), generator=gen, device=dev) * 2 - 1)
                  * lim)
        bs.append(0.1 * torch.randn((1, n), generator=gen, device=dev))
    packed = fm.pack_weights(ws, bs)
    ref = fm.fused_mlp_plain(x, ws, bs, 'relu')
    out = fm.fused_mlp_cuda(x, packed, None, 'relu')
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    log(f'fused_mlp MB-MPC shape {tuple(x.shape)} -> {tuple(out.shape)}, '
        f'widths {MB_DIMS}, one packed set: max_abs_err {err:.3e} '
        f'(tolerance {MLP_TOL}, max|ref| {float(ref.abs().max()):.3f})')
    torch.testing.assert_close(out, ref, **MLP_TOL)
    w16 = [w[0].to(torch.bfloat16) for w in ws]     # cast once, not timed
    b16 = [b[0].to(torch.bfloat16) for b in bs]

    def library():
        h = x[0].to(torch.bfloat16)
        for i, (w, b) in enumerate(zip(w16, b16)):
            h = torch.addmm(b, h, w)
            if i < len(w16) - 1:
                h = torch.relu(h)
        return h.float()

    def kernel():
        return fm.fused_mlp_cuda(x, packed, None, 'relu')
    ms = cuda_ms(kernel)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_ms(lambda: fm.fused_mlp_plain(x, ws, bs, 'relu'))
    library_ms = cuda_ms(library)
    library_device_ms = device_ms(library)
    macs = sum(k * n for k, n in zip(MB_DIMS[:-1], MB_DIMS[1:]))
    n_bytes = (4 * (x.numel() + r * MB_DIMS[-1] +
                    sum(b.numel() for b in bs)) +
               2 * sum(w.numel() for w in ws))
    b_ms, b_by = bound_ms(n_bytes, 2.0 * r * macs, BF16_FLOP_PER_S)
    log(f'fused_mlp per launch at the MB-MPC shape: kernel {ms:.4f} ms '
        f'(device {dev_ms:.4f} ms); plain {plain_ms:.4f} ms; bf16 addmm '
        f'chain {library_ms:.4f} ms (device {library_device_ms:.4f} ms); '
        f'bound {b_ms:.4f} ms ({b_by}: {2.0 * r * macs / 1e9:.2f} GFLOP)')
    return dict(mb_mpc_max_abs_err=err, mb_mpc_ms=ms, mb_mpc_device_ms=dev_ms,
                mb_mpc_plain_ms=plain_ms, mb_mpc_bound_ms=b_ms,
                mb_mpc_library_ms=library_ms,
                mb_mpc_library_device_ms=library_device_ms)


def graphed(fn, dev):
    """fn captured once as a CUDA graph (after one call on a side stream);
    returns the graph's replay."""
    import torch
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def check_clip_adam(dev):
    """The clip-and-Adam kernel at both models' leaf shapes (MB-MPC's
    (512, 512) MLP, GrBAL's (512, 512, 512) meta-MLP; JAX's leaf order):
    four steps from one state held bit for bit against the plain chain,
    the global norm under max_norm; then a step timed eagerly (the host
    queued ahead) and as a replayed CUDA graph, as the fits run it, beside
    the plain chain timed the same two ways, and its device time from a
    profiler window. Bound: each parameter's p, g, mu and nu read once and
    p, mu and nu written once, 28 bytes over 3.35 TB/s (the ~16 f32
    operations a parameter are far under the f32 peak)."""
    import math
    import torch
    from learning_to_adapt_torch.ops import clip_adam as ca
    hyper = (1e-3, 100.0, 0.9, 0.999, 1e-8)
    out = {}
    for what, dims in (('MB-MPC', MB_DIMS), ('GrBAL', MLP_DIMS)):
        shapes = [(n,) for n in dims[1:]] + list(zip(dims[:-1], dims[1:]))
        n = sum(math.prod(s) for s in shapes)
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)

        def leaves(scale):
            return [torch.randn(s, generator=gen, device=dev) * scale
                    for s in shapes]
        state = (leaves(0.1), torch.zeros((), dtype=torch.int32, device=dev),
                 leaves(1e-3), [x.abs() for x in leaves(1e-6)])
        plain = ([x.clone() for x in state[0]], state[1].clone(),
                 [x.clone() for x in state[2]], [x.clone() for x in state[3]])
        for _ in range(4):
            g = leaves(50.0 / n ** 0.5)
            ca.clip_adam_cuda(state[0], g, *state[1:], *hyper)
            ca.clip_adam_plain(plain[0], [x.clone() for x in g], *plain[1:],
                               *hyper)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for xs, ys in zip(state, plain)
                   for a, b in (zip(xs, ys) if isinstance(xs, list)
                                else [(xs, ys)]))
        log(f'clip_adam {what} leaves ({len(shapes)} leaves, {n} '
            f'parameters): 4 unclipped steps against the plain chain, bit for '
            f'bit {same}')
        if not same:
            raise AssertionError(f'clip_adam {what}: the kernel parts from '
                                 'the plain chain on an unclipped step')
        g = leaves(50.0 / n ** 0.5)
        g_plain = [x.clone() for x in g]   # kept, so g / 1 * 1 in place

        def kernel():
            ca.clip_adam_cuda(state[0], g, *state[1:], *hyper)

        def chain():
            ca.clip_adam_plain(plain[0], g_plain, *plain[1:], *hyper)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(chain)
        graph_ms = cuda_ms(graphed(kernel, dev))
        plain_graph_ms = cuda_ms(graphed(chain, dev))
        dev_ms = device_ms(kernel)
        b_ms, b_by = bound_ms(28 * n, 16 * n, F32_FLOP_PER_S)
        log(f'clip_adam per step, {what} leaves: kernel {ms:.4f} ms, as a '
            f'replayed graph {graph_ms:.4f} ms (device {dev_ms:.4f} ms); '
            f'plain chain {plain_ms:.4f} ms, as a replayed graph '
            f'{plain_graph_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: '
            f'{28 * n / 1e6:.1f} MB)')
        key = '' if what == 'GrBAL' else 'mb_mpc_'
        out.update({f'{key}ms': ms, f'{key}device_ms': dev_ms,
                    f'{key}graph_ms': graph_ms, f'{key}plain_ms': plain_ms,
                    f'{key}plain_graph_ms': plain_graph_ms,
                    f'{key}bound_ms': b_ms, f'{key}max_abs_err': 0.0})
    return dict(out, name='clip_adam', route='cuda',
                source='learning_to_adapt_torch/csrc/clip_adam.cu',
                replaces=None, bound_by=b_by, library_ms=None, floor_ms=None)


def check_jacobi(dev, floor_lib):
    import torch
    import jacobi_study
    from learning_to_adapt_torch.ops import jacobi as jc
    A, b, ainv, omega, n_sweeps = jacobi_study.contact_systems(dev)
    n = A.shape[-1]
    n_active = int((b != 0).sum())
    per_row, cols, rows, threads = jc.launch_shape(n)
    log(f'jacobi: HalfCheetah contact systems {tuple(A.shape)}, '
        f'{n_sweeps} sweeps, {n_active} active rows over {N_ENVS} envs, '
        f'omega {[round(float(w), 4) for w in omega]}; launch tier: '
        f'{per_row} threads per row, {cols} columns and {rows} rows per '
        f'thread, {N_ENVS} blocks x {threads} threads')
    if n_sweeps != JACOBI_SWEEPS or n_active == 0:
        raise AssertionError('expected 60 sweeps over an active contact set')

    spd = jacobi_study.system(dev, N_ENVS, n, seed=2)
    wide = jacobi_study.system(dev, JACOBI_WIDE_ENVS, n, seed=3)
    errs = []
    for label, args in (('contact', (A, b, ainv, omega)),
                        ('random SPD', spd),
                        (f'random SPD, {JACOBI_WIDE_ENVS} envs', wide)):
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

    def kernel(args=(A, b, ainv, omega)):
        return jc.jacobi_solve_cuda(*args, n_sweeps)
    ms = cuda_ms(kernel)
    ms_512 = cuda_ms(lambda: kernel(wide))
    plain_ms = cuda_ms(lambda: jc.jacobi_solve_plain(A, b, ainv, omega,
                                                     n_sweeps))
    dev_ms = device_ms(kernel)
    dev_ms_512 = device_ms(lambda: kernel(wide))

    def floor_device_ms(args):
        return jacobi_study.run_variant(
            jacobi_study.FLOOR, {jacobi_study.FLOOR: floor_lib},
            lambda: device_ms(lambda: kernel(args)))
    floor_ms = floor_device_ms((A, b, ainv, omega))
    floor_ms_512 = floor_device_ms(wide)
    n_bytes = 4 * (A.numel() + 3 * b.numel() + omega.numel())
    flops = n_sweeps * N_ENVS * n * (2 * n + 5)
    b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOP_PER_S)
    log(f'jacobi per launch, {N_ENVS} envs: kernel {ms:.4f} ms (device '
        f'{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms '
        f'({b_by}); floor of the chain of {n_sweeps} dependent sweeps '
        f'(handshake only, device) {floor_ms:.4f} ms, kernel/floor '
        f'{dev_ms / floor_ms:.2f}')
    log(f'jacobi per launch, {JACOBI_WIDE_ENVS} envs: kernel {ms_512:.4f} ms '
        f'(device {dev_ms_512:.4f} ms), floor (device) {floor_ms_512:.4f} ms')
    return dict(name='jacobi_solve', route='cuda',
                source='learning_to_adapt_torch/csrc/jacobi.cu',
                replaces='learning_to_adapt_tpu/ops/pallas_jacobi.py:73',
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, ms_cold=None,
                library_device_ms=None, device_ms=dev_ms, floor_ms=floor_ms,
                ms_512=ms_512)


def check_jacobi_ant(dev):
    """The tier kernel on the Ant's contact systems (5 envs x 116 rows: the
    first of a physics step's four RK4 solves, after 30 random-action
    steps) against its plain version; timed with CUDA events, warm and
    with L2 flushed, and by profiler device time. Returns the keys it adds
    to the jacobi_solve entry."""
    import torch
    import jacobi_study
    from learning_to_adapt_torch.ops import jacobi as jc
    A, b, ainv, omega, n_sweeps = jacobi_study.contact_systems(
        dev, 'AntEnv', 'cripple')
    n = A.shape[-1]
    n_active = int((b != 0).sum())
    per_row, cols, rows, threads = jc.launch_shape(n)
    log(f'jacobi: Ant contact systems {tuple(A.shape)} (N = {n}), '
        f'{n_sweeps} sweeps, {n_active} active rows over {N_ENVS} envs, '
        f'omega {[round(float(w), 4) for w in omega]}; launch tier: '
        f'{per_row} threads per row, {cols} columns and {rows} rows per '
        f'thread, {N_ENVS} blocks x {threads} threads')
    if n != ANT_ROWS or n_sweeps != JACOBI_SWEEPS or n_active == 0:
        raise AssertionError(f'expected {ANT_ROWS} rows, 60 sweeps and an '
                             'active contact set')
    out = jc.jacobi_solve_cuda(A, b, ainv, omega, n_sweeps)
    ref = jc.jacobi_solve_plain(A, b, ainv, omega, n_sweeps)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    log(f'jacobi Ant contact: max_abs_err {err:.3e} (tolerance {JACOBI_TOL}, '
        f'max|ref| {float(ref.abs().max()):.3e})')
    torch.testing.assert_close(out, ref, **JACOBI_TOL)
    if not bool((out >= 0).all()):
        raise AssertionError('projected Jacobi returned a negative force')

    def kernel():
        return jc.jacobi_solve_cuda(A, b, ainv, omega, n_sweeps)
    flush = torch.empty(16 * 2 ** 20, device=dev)  # 64 MB > the 50 MB L2
    ms = cuda_ms(kernel)
    ms_cold = cuda_ms(kernel, iters=20, before=flush.zero_)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_ms(lambda: jc.jacobi_solve_plain(A, b, ainv, omega,
                                                     n_sweeps))
    n_bytes = 4 * (A.numel() + 3 * b.numel() + omega.numel())
    flops = n_sweeps * N_ENVS * n * (2 * n + 5)
    b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOP_PER_S)
    log(f'jacobi per launch, Ant, {N_ENVS} envs x {n} rows: kernel '
        f'{ms:.4f} ms, L2 flushed {ms_cold:.4f} ms (device {dev_ms:.4f} ms), '
        f'plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})')
    return dict(ant_max_abs_err=err, ant_ms=ms, ant_ms_cold=ms_cold,
                ant_device_ms=dev_ms, ant_plain_ms=plain_ms,
                ant_bound_ms=b_ms, ant_rows=n)


def smooth_states(dev, cls_name, n_envs, n_steps=30):
    """n_envs cripple-task envs of cls_name after n_steps steps of random
    actions: (env, env state, the last action)."""
    import torch
    from learning_to_adapt_torch import envs
    env = getattr(envs, cls_name)(task='cripple', device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    state = env.reset(n_envs, episode_idx=1, generator=gen)
    for _ in range(n_steps):
        action = 2 * torch.rand((n_envs, env.act_dim), generator=gen,
                                device=dev) - 1
        state = env.step(state, action)[0]
    return env, state, action


def smooth_bytes(env, state, ctrl, outs):
    """The bytes a dynamics pass's launch moves at the least: each input as
    the kernel reads it (one row where the envs share it, stride 0), the
    model's table, and each of outs written once, at their element sizes."""
    from learning_to_adapt_torch.ops import smooth_dynamics as smooth_kernel
    from learning_to_adapt_torch.physics import engine
    mm, phys = state.mm, state.phys
    mt = engine.model_tensors(env.model, phys.qpos.device, phys.qpos.dtype)
    n_bytes = smooth_kernel.table(env.model, mt).numel()
    for x in (phys.qpos, phys.qvel, ctrl, mm.body_mass, mm.dof_damping,
              mm.xfrc_applied):
        rows = 1 if x.stride(0) == 0 else x.shape[0]
        n_bytes += rows * x[0].numel() * x.element_size()
    return n_bytes + sum(x.numel() * x.element_size() for x in outs)


def check_smooth_dynamics(dev):
    """The smooth-dynamics kernel, both variants, against the plain tensor
    code on the states the main paths reach (HalfCheetah at MB-MPC's 10
    envs, the Ant at GrBAL's 5, after 30 random steps), largest difference
    over the largest magnitude of each output within SMOOTH_TOL; timed with
    CUDA events (warm, L2 flushed, as a replayed graph), by profiler device
    time, beside the plain code's time eager and as a graph, the kernels
    the plain code launches, an empty launch's time (`floor_ms`, the floor
    of any launch: the bound that holds for this latency-bound kernel) and
    the bytes' bound (`bound_ms`, far below it); HalfCheetah also at 512
    envs."""
    import torch
    from learning_to_adapt_torch.physics import engine
    out = dict(name='smooth_dynamics', route='cuda',
               source='csrc/smooth_dynamics.cu',
               replaces='none: engine.smooth_dynamics and engine.forward '
                        'tensor code (XLA in the JAX package)')
    flush = torch.empty(16 * 2 ** 20, device=dev)  # 64 MB > the 50 MB L2
    out['floor_ms'] = cuda_ms(lambda: torch.cuda._sleep(1))
    for cls_name, n_envs, key in (('HalfCheetahEnv', MB_ENVS, ''),
                                  ('AntEnv', N_ENVS, 'ant_'),
                                  ('HalfCheetahEnv', JACOBI_WIDE_ENVS,
                                   'wide_')):
        env, state, ctrl = smooth_states(dev, cls_name, n_envs)
        args = (env.model, state.mm, state.phys, ctrl)
        errs = {}
        got, want = engine.smooth_dynamics(*args), engine._smooth_plain(*args)
        pairs = [('mass_mat', got[0], want[0]), ('qfrc_smooth', got[1],
                                                 want[1])]
        pairs += [(k, got[2][k], want[2][k]) for k in want[2]]
        fwd, fwd_ref = (engine.forward(*args), engine._forward_plain(*args))
        pairs += [('fwd.' + f.name, getattr(fwd, f.name),
                   getattr(fwd_ref, f.name))
                  for f in dataclasses.fields(fwd_ref)]
        torch.cuda.synchronize()
        for name, a, b in pairs:
            errs[name] = float((a - b).abs().max() /
                               b.abs().max().clamp(min=1.0))
        worst = max(errs, key=errs.get)
        log(f'smooth_dynamics {cls_name} x {n_envs}: worst relative '
            f'difference {worst} {errs[worst]:.3e} (tolerance {SMOOTH_TOL})'
            f'; all {json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()})}')
        if not errs[worst] <= SMOOTH_TOL:
            raise AssertionError(f'smooth_dynamics {cls_name}: {worst} '
                                 f'{errs[worst]}')

        def kernel():
            return engine.smooth_dynamics(*args)

        def plain():
            return engine._smooth_plain(*args)
        res = dict(max_rel_err=errs[worst], ms=cuda_ms(kernel),
                   device_ms=device_ms(kernel))
        if key != 'wide_':
            forward = (lambda: engine.forward(*args))
            res.update(
                ms_cold=cuda_ms(kernel, iters=20, before=flush.zero_),
                graph_ms=cuda_ms(graphed(kernel, dev)),
                forward_ms=cuda_ms(forward),
                forward_device_ms=device_ms(forward),
                plain_ms=cuda_ms(plain, warmup=2, iters=10),
                plain_graph_ms=cuda_ms(graphed(plain, dev)),
                plain_launches=len(profiled(plain, cpu=False).device),
                forward_plain_launches=len(profiled(
                    lambda: engine._forward_plain(*args), cpu=False).device))
            res['bound_ms'], res['bound_by'] = bound_ms(
                smooth_bytes(env, state, ctrl, [x for name, x, _ in pairs
                                                if not name.startswith(
                                                    'fwd.')]), 0, 1.0)
        out.update({key + k: v for k, v in res.items()})
        log(f'smooth_dynamics per launch, {cls_name} x {n_envs} (f32): '
            + json.dumps({k: (float(f'{v:.4g}') if isinstance(v, float)
                              else v) for k, v in res.items()})
            + f'; an empty launch (its bound: the kernel is latency-bound)'
            f' {out["floor_ms"]:.5f} ms')
    return out


def cluster_bound_ms(A, b, live, n_sweeps):
    """The least time of a cluster solve: the larger of one read of A, b,
    aii_inv and omega and one write of f at the card's memory rate, and the
    sweeps over each env's live rows (2 m + 5 operations a row a sweep for m
    live rows) at its f32 rate: what these inputs need, so a kernel that
    skips the dead rows never reads above it."""
    m = live.sum(-1).double()
    n_bytes = 4 * (A.numel() + 3 * b.numel() + b.shape[0])
    flops = float((n_sweeps * m * (2 * m + 5)).sum())
    return bound_ms(n_bytes, flops, F32_FLOP_PER_S) + (n_bytes, flops)


def check_jacobi_cluster(dev, small_floor_lib, dense_floor_lib):
    """The cluster kernel (N > 224): held against the plain version on real
    blocks contact systems, random SPD systems (every row live) from N =
    225 to 2048 at 1 and 5 envs and at N = 988 for 512 envs, and systems
    built as the engine leaves inactive contacts (90 % and 99 % dead at 5
    and 512 envs, 224 and 225 live rows, none live, a non-symmetric A), one
    launch each, dead rows exactly 0; timed (CUDA events and profiler
    device time) on the blocks systems warm and with L2 flushed, dense 5 x
    988, dense 512 x 988 and 99 %-dead 512 x 988, beside the plain version,
    the bound and the floors of its two paths' sweep chains."""
    import torch
    import jacobi_study
    from learning_to_adapt_torch.ops import jacobi as jc
    A, b, ainv, omega, n_sweeps = jacobi_study.contact_systems(
        dev, 'HalfCheetahBlocksEnv', 'damping')
    n = A.shape[-1]
    cluster = jc.cluster_size(n, dev)
    plan = jc.cluster_shape(n, cluster)
    log(f'jacobi cluster plan, N = {n}: clusters of {cluster} blocks x '
        f'{plan.threads} threads (16 where the card holds one: '
        f'{jc.cluster_occupancy(n, 16, dev)} clusters of 16 at once, '
        f'{jc.cluster_occupancy(n, 8, dev)} of 8), {plan.rows} rows scanned '
        f'a block, {plan.held} held in shared memory, {plan.in_registers} in '
        f'registers and {plan.streamed} streamed when every row is live, up '
        f'to {plan.small} live rows in one block, {plan.smem} bytes of '
        'shared memory a block')
    if n != BLOCKS_ROWS or n_sweeps != JACOBI_SWEEPS:
        raise AssertionError(f'expected {BLOCKS_ROWS} rows and 60 sweeps')
    blocks = (A, b, ainv, omega)
    cases = [('blocks contact', blocks)]
    for rows_n in CLUSTER_NS:
        for envs in CLUSTER_ENVS:
            cases.append((f'random SPD {envs} x {rows_n}',
                          jacobi_study.system(dev, envs, rows_n,
                                              seed=rows_n + envs)))
    wide = jacobi_study.system(dev, JACOBI_WIDE_ENVS, n, seed=3)
    cases.append((f'random SPD {JACOBI_WIDE_ENVS} x {n}', wide))
    dead = {}
    for envs, n_live, symmetric in (
            (N_ENVS, 99, True), (N_ENVS, 10, True),
            (JACOBI_WIDE_ENVS, 99, True), (JACOBI_WIDE_ENVS, 10, True),
            (N_ENVS, 224, True), (N_ENVS, 225, True), (N_ENVS, 0, True),
            (N_ENVS, 99, False)):
        label = (f'{n_live} of {n} rows live, {envs} envs' +
                 ('' if symmetric else ', A not symmetric'))
        dead[(envs, n_live, symmetric)] = jacobi_study.dead_system(
            dev, envs, n, n_live, seed=n_live + envs, symmetric=symmetric)
        cases.append((label, dead[(envs, n_live, symmetric)]))
    errs, n_live_blocks = [], None
    for label, args in cases:
        live = jc.live_rows(*args)
        counts = live.sum(-1).tolist()
        before = jc.jacobi_solve_cluster.launches
        out = jc.jacobi_solve_cuda(*args, n_sweeps)
        ref = jc.jacobi_solve_plain(*args, n_sweeps)
        torch.cuda.synchronize()
        if jc.jacobi_solve_cluster.launches != before + 1:
            raise AssertionError(f'{label}: not one cluster kernel launch')
        err = float((out - ref).abs().max())
        errs.append(err)
        shown = counts if len(counts) <= N_ENVS else \
            f'{min(counts)}-{max(counts)}'
        log(f'jacobi cluster {label}: live rows an env {shown}; max_abs_err '
            f'{err:.3e} (tolerance {JACOBI_TOL}, max|ref| '
            f'{float(ref.abs().max()):.3e})')
        torch.testing.assert_close(out, ref, **JACOBI_TOL)
        if not bool((out >= 0).all()):
            raise AssertionError('projected Jacobi returned a negative force')
        if not bool((out[~live] == 0).all()):
            raise AssertionError(f'{label}: a dead row is not exactly 0')
        if label == 'blocks contact':
            n_live_blocks = counts
    if not 0 < max(n_live_blocks) <= plan.small:
        raise AssertionError(f'blocks contact systems: {n_live_blocks} live '
                             'rows an env, expected the one-block path')

    def kernel(args=blocks):
        return jc.jacobi_solve_cluster(*args, n_sweeps)
    flush = torch.empty(16 * 2 ** 20, device=dev)  # 64 MB > the 50 MB L2
    dead512 = dead[(JACOBI_WIDE_ENVS, 10, True)]
    dense5 = dict(cases)[f'random SPD {N_ENVS} x {n}']
    ms = cuda_ms(kernel)
    ms_cold = cuda_ms(kernel, iters=20, before=flush.zero_)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_ms(lambda: jc.jacobi_solve_plain(*blocks, n_sweeps))
    dense_ms = cuda_ms(lambda: kernel(dense5))
    dense_dev_ms = device_ms(lambda: kernel(dense5))
    ms_512 = cuda_ms(lambda: kernel(wide), warmup=2, iters=5)
    dev_ms_512 = device_ms(lambda: kernel(wide), iters=3)
    dead_ms = cuda_ms(lambda: kernel(dead512), warmup=2, iters=10)
    dead_dev_ms = device_ms(lambda: kernel(dead512), iters=5)

    def floor_device_ms(name, lib, args, iters):
        return jacobi_study.run_variant(
            name, {name: lib},
            lambda: device_ms(lambda: kernel(args), iters=iters))
    floor_ms = floor_device_ms(jacobi_study.SMALL_FLOOR, small_floor_lib,
                               blocks, 20)
    dense_floor_ms = floor_device_ms(jacobi_study.DENSE_FLOOR,
                                     dense_floor_lib, dense5, 20)
    floor_ms_512 = floor_device_ms(jacobi_study.DENSE_FLOOR, dense_floor_lib,
                                   wide, 3)
    bounds = {}
    for key, args in (('blocks', blocks), ('dense', dense5),
                      ('dense_512', wide), ('dead_512', dead512)):
        bounds[key] = cluster_bound_ms(args[0], args[1],
                                       jc.live_rows(*args), n_sweeps)
    b_ms, b_by, n_bytes, flops = bounds['blocks']
    log(f'jacobi cluster per launch, blocks contact {N_ENVS} x {n} '
        f'({n_live_blocks} live rows an env): kernel {ms:.4f} ms, L2 flushed '
        f'{ms_cold:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} '
        f'ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB read once; '
        f'{flops / 1e6:.3f} MFLOP over the live rows), floor of the one-block '
        f'chain of {n_sweeps} sweeps (no row products, device) '
        f'{floor_ms:.4f} ms, kernel/floor {dev_ms / floor_ms:.2f}, '
        f'kernel/bound {dev_ms / b_ms:.2f}')
    for what, k_ms, k_dev, fl, key in (
            (f'dense {N_ENVS} x {n}', dense_ms, dense_dev_ms, dense_floor_ms,
             'dense'),
            (f'dense {JACOBI_WIDE_ENVS} x {n}', ms_512, dev_ms_512,
             floor_ms_512, 'dense_512'),
            (f'99 % dead {JACOBI_WIDE_ENVS} x {n}', dead_ms, dead_dev_ms,
             None, 'dead_512')):
        k_b, k_by, k_bytes, k_flops = bounds[key]
        log(f'jacobi cluster per launch, {what}: kernel {k_ms:.4f} ms '
            f'(device {k_dev:.4f} ms), bound {k_b:.4f} ms ({k_by}: '
            f'{k_bytes / 1e6:.1f} MB, {k_flops / 1e6:.1f} MFLOP), '
            f'kernel/bound {k_dev / k_b:.2f}' +
            ('' if fl is None else f', floor of the dense chain (device) '
             f'{fl:.4f} ms, kernel/floor {k_dev / fl:.2f}'))
    return dict(name='jacobi_solve_cluster', route='cuda',
                source='learning_to_adapt_torch/csrc/jacobi.cu',
                replaces='learning_to_adapt_tpu/ops/pallas_jacobi.py:73',
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                ms_cold=ms_cold, library_device_ms=None, device_ms=dev_ms,
                floor_ms=floor_ms, ms_512=ms_512, device_ms_512=dev_ms_512,
                floor_ms_512=floor_ms_512, n_live=n_live_blocks,
                dense_ms=dense_ms, dense_device_ms=dense_dev_ms,
                dense_floor_ms=dense_floor_ms,
                dense_bound_ms=bounds['dense'][0],
                bound_ms_512=bounds['dense_512'][0],
                dead_512_ms=dead_ms, dead_512_device_ms=dead_dev_ms,
                dead_512_bound_ms=bounds['dead_512'][0])


def main_path(dev, card):
    import numpy as np
    import torch
    from learning_to_adapt_torch.envs import HalfCheetahEnv, normalize
    from learning_to_adapt_torch.models import (
        MetaMLPDynamicsModel, Normalizer)
    from learning_to_adapt_torch.policies import MPCController
    from learning_to_adapt_torch.samplers import Sampler
    from learning_to_adapt_torch.samplers.rollout import CompiledRollout

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

    zero_counters()
    paths = sampler.obtain_samples()
    launches = counters()
    packs = launches.pop('pack')
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
    want = dict(fused_mlp=HORIZON * PATH_LEN, fused_mlp_wgmma=0,
                jacobi_solve_cluster=0, clip_adam=0,
                **physics_launches(solves_per_env_step(env), PATH_LEN))
    log(f'policy sampling launches {launches}, expected {want}; weight '
        f'packs {packs}, expected {PATH_LEN}')
    if launches != want:
        raise AssertionError(f'launch counts {launches} != {want}')
    if packs != PATH_LEN:
        raise AssertionError(f'{packs} weight packs != one per env step')
    fn = sampler._rollout_fn(False)
    if not isinstance(fn, CompiledRollout) or fn.replays != PATH_LEN:
        raise AssertionError('the policy sampling call did not replay one '
                             'captured graph a step')
    returns = paths['rewards'].sum(axis=1)
    log(f'policy sampling (episode 1, cripple tasks drawn, captured): '
        f'{N_ENVS}x{PATH_LEN} env steps in {seconds:.2f} s = '
        f'{N_ENVS * PATH_LEN / seconds:.1f} env-steps/s on {card}, the '
        f'capture of {len(fn.graphs)} graphs included ({fn.capture_s:.3f} '
        f's); {fn.replays} replays; returns '
        f'{np.round(returns, 2).tolist()}')
    return launches, sampler


def watch_host_syncs(fn, n_steps, what, most=None):
    """Runs fn once, watched two ways for the host waiting on the card:
    torch.profiler's record of the CUDA runtime's sync calls, grouped by the
    operator that made them, and CUDA's sync-debug mode, grouped by Python
    call site. Anything that waits n_steps times or more (once a step) fails
    the run, and so do more than `most` waits in all by either record,
    where `most` is given: fn runs inside a 'watched' range, so the
    profiler's own synchronize when its window closes ('... in python')
    is not counted."""
    import warnings
    import torch
    from torch.profiler import record_function

    def watched():
        caught.clear()              # the warnings of this window only
        torch.cuda.set_sync_debug_mode('warn')
        try:
            with record_function('watched'):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        trace = profiled(watched)
    by_op = trace.calls_by_parent(SYNC_CALLS)
    sites = {}
    for w in caught:
        if 'synchronizing' in str(w.message):
            site = f'{os.path.relpath(w.filename)}:{w.lineno}'
            sites[site] = sites.get(site, 0) + 1
    log(f'host waits in {what}: runtime sync calls by operator '
        f'{json.dumps(by_op)}; sync-debug mode by call site '
        f'{json.dumps(sites)}')
    per_step = {k: n for counts in (by_op, sites) for k, n in counts.items()
                if n >= n_steps}
    if per_step:
        raise AssertionError(f'host waits once a step or more: {per_step}')
    waits = max(sum(n for k, n in by_op.items()
                    if not k.endswith(' in python')), sum(sites.values()))
    if most is not None and waits > most:
        raise AssertionError(f'{waits} host waits in {what}, more than '
                             f'{most}')
    return waits


def counters():
    """The kernel counters (a captured launch counts once a replay)."""
    from learning_to_adapt_torch.models import captured
    return captured.kernel_counts()


def check_captured(sampler, what):
    """Fails unless each of the sampler's calls so far (random and policy)
    replayed one captured graph a step."""
    from learning_to_adapt_torch.samplers.rollout import CompiledRollout
    for random, fn in sampler._fns.items():
        if not isinstance(fn, CompiledRollout) or not fn.replays or \
                fn.replays % sampler.max_path_length:
            kind = 'random' if random else 'policy'
            raise AssertionError(f'{what}: the {kind} sampling calls did '
                                 'not replay one captured graph a step')


def zero_counters():
    from learning_to_adapt_torch.models import captured
    captured.count_kernels({k: -n for k, n in counters().items()})


#: the kernels' names in a profiler trace
KERNEL_NAMES = ('fused_mlp_kernel', 'jacobi_kernel', 'jacobi_cluster_kernel',
                'smooth_dynamics_kernel')
NO_LAUNCH = dict(fused_mlp=0, fused_mlp_wgmma=0, pack=0, jacobi_solve=0,
                 jacobi_solve_cluster=0, clip_adam=0, smooth_dynamics=0)


def train_replays(model):
    """Train-step replays of all the model's compiled epochs so far."""
    return sum(pair[0].replays for e in model._epoch_cache.values()
               for pair in e.graphs.values())


def check_fit_launches(counts, steps, what):
    """A fit launches the clip-and-Adam kernel LAUNCHES_PER_STEP times at
    each of its `steps` train replays, and nothing else of ours."""
    from learning_to_adapt_torch.ops import clip_adam
    want = dict(NO_LAUNCH, clip_adam=clip_adam.LAUNCHES_PER_STEP * steps)
    if not steps or counts != want:
        raise AssertionError(f'{what}: launches {counts} != {want} for '
                             f'{steps} train steps')


def but_optimizer(what, counts):
    """A call's launches, but for a fit's clip-and-Adam ones, which
    counted_calls holds to the fit's train replays."""
    return dict(counts, clip_adam=0) if what == 'fit' else counts


@contextlib.contextmanager
def counted_calls(record):
    """Appends (what, launches made inside the call) to record for every
    Sampler.obtain_samples call and every fit of the three models; a fit's
    clip-and-Adam launches are held to its train replays here."""
    from learning_to_adapt_torch.models import (
        MetaMLPDynamicsModel, MLPDynamicsModel, RNNDynamicsModel)
    from learning_to_adapt_torch.samplers import Sampler
    fits = (MetaMLPDynamicsModel, MLPDynamicsModel, RNNDynamicsModel)
    originals = (Sampler.obtain_samples,) + tuple(c.fit for c in fits)

    def counted(what, fn):
        def wrapped(*args, **kwargs):
            before = counters()
            replays = train_replays(args[0]) if what == 'fit' else 0
            out = fn(*args, **kwargs)
            after = counters()
            label = what
            if what == 'sample':
                label = 'random' if kwargs.get('random') else 'policy'
            counts = {k: after[k] - before[k] for k in after}
            if what == 'fit':
                check_fit_launches(counts, train_replays(args[0]) - replays,
                                   f'{type(args[0]).__name__}.fit')
            record.append((label, counts))
            return out
        return wrapped
    Sampler.obtain_samples = counted('sample', originals[0])
    for c, fit in zip(fits, originals[1:]):
        c.fit = counted('fit', fit)
    try:
        yield record
    finally:
        Sampler.obtain_samples = originals[0]
        for c, fit in zip(fits, originals[1:]):
            c.fit = fit


def run_trainer(entry, cfg, record):
    """entry.run_experiment with the counts set to 0 just before it; its
    log (an epoch line each epoch) is kept and printed only on failure."""
    from learning_to_adapt_torch.utils import logging as logger
    out = io.StringIO()
    zero_counters()
    try:
        with counted_calls(record), contextlib.redirect_stdout(out):
            trainer = entry.run_experiment(cfg)
    except BaseException:
        print(out.getvalue()[-8000:], file=sys.stderr)
        raise
    finally:
        logger.Logger.CURRENT.close()
    return trainer, counters()


def read_progress(exp_dir):
    import csv
    with open(os.path.join(exp_dir, 'progress.csv')) as f:
        header = f.readline()
        f.seek(0)
        return header, list(csv.DictReader(f))


def check_trainer_launches(policy_itr, record, total, resume_record,
                           resume_total, n_itr):
    """Per call of the trainer runs: policy_itr's launches in every policy
    sampling call, only the Jacobi launches in the random one, from the
    fit only clip and Adam's (held to its train replays by counted_calls),
    and no launch outside those calls."""
    want = {'random': dict(policy_itr, fused_mlp=0, fused_mlp_wgmma=0,
                           pack=0),
            'policy': policy_itr, 'fit': NO_LAUNCH}
    labels = ['random', 'fit'] + ['policy', 'fit'] * (n_itr - 1)
    for name, rec, tot, want_labels in (
            ('run', record, total, labels),
            ('resumed run', resume_record, resume_total, ['policy', 'fit'])):
        got = [what for what, _ in rec]
        if got != want_labels:
            raise AssertionError(f'{name}: calls {got} != {want_labels}')
        for what, counts in rec:
            if but_optimizer(what, counts) != want[what]:
                raise AssertionError(f'{name}, {what}: launches {counts} != '
                                     f'{want[what]}')
        summed = {k: sum(c[k] for _, c in rec) for k in tot}
        if tot != summed:
            raise AssertionError(f'{name}: launches outside sampling and '
                                 f'fit: {tot} != {summed}')


def trainer_phase(dev, card, entry, cfg, header_csv, loss_keys, policy_itr,
                  keep):
    """The training loop through a port entry point in a temporary
    directory (cfg['n_itr'] iterations), then a resume to one more.
    policy_itr(solves) gives the launches of one policy sampling call, for
    `solves` Jacobi launches an env step. The experiment directory is
    copied to `keep` for the meta-test phase.
    Returns (per policy iteration launches, whole-run launches, the
    trainer)."""
    import math
    import pickle
    from learning_to_adapt_torch.envs import HalfCheetahEnv
    n_itr = cfg['n_itr']
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.time()
            record = []
            trainer, total = run_trainer(entry, cfg, record)
            run_s = time.time() - t0
            exp_dir = entry.experiment_dir(cfg)
            header, rows = read_progress(exp_dir)
            with open(os.path.join(exp_dir, 'params.pkl'), 'rb') as f:
                snap = pickle.load(f)
            t0 = time.time()
            resume_record = []
            resumed, resume_total = run_trainer(
                entry, dict(cfg, n_itr=n_itr + 1, resume=True),
                resume_record)
            resume_s = time.time() - t0
            _, resumed_rows = read_progress(exp_dir)
            shutil.copytree(exp_dir, keep)
        finally:
            os.chdir(cwd)

    with open(header_csv) as f:
        want_header = f.readline()
    if header != want_header:
        raise AssertionError(f'progress.csv header {header!r} != the JAX '
                             f'run\'s {want_header!r}')
    for r in rows + resumed_rows:
        for k in loss_keys + ('EnvTrajs-AverageReturn',):
            if not math.isfinite(float(r[k])):
                raise AssertionError(f'itr {r["Itr"]}: {k} = {r[k]}')
    if [int(r['Itr']) for r in rows] != list(range(n_itr)):
        raise AssertionError(f'itrs {[r["Itr"] for r in rows]}')
    env = snap['env'].wrapped_env
    if not (isinstance(env, HalfCheetahEnv) and env.task == 'cripple'
            and snap['itr'] == n_itr - 1):
        raise AssertionError('params.pkl did not re-create its env')
    # the logger, like the JAX package's, starts progress.csv anew on
    # configure: the resumed run's file holds its own iteration
    if resumed.start_itr != n_itr or [
            int(r['Itr']) for r in resumed_rows] != [n_itr]:
        raise AssertionError(f'resume started at {resumed.start_itr}, '
                             f'wrote itrs {[r["Itr"] for r in resumed_rows]}')

    per_itr = policy_itr(solves_per_env_step(trainer.env.wrapped_env))
    check_captured(trainer.sampler, entry.module)
    check_captured(resumed.sampler, f'{entry.module} (resumed)')
    check_trainer_launches(per_itr, record, total, resume_record,
                           resume_total, n_itr)
    log(f'trainer ({entry.module}.run_experiment, --task cripple, seed 0, '
        f'{cfg["num_rollouts"]} envs x {cfg["max_path_length"]} steps, '
        f'{n_itr} itrs, {cfg["dynamic_model_epochs"]} epochs max) on '
        f'{card}: {run_s:.1f} s; resume to itr {n_itr} {resume_s:.1f} s')
    for r in rows + resumed_rows:
        losses = ', '.join(f'{k} {float(r[k]):.5f}' for k in loss_keys)
        log(f'  itr {r["Itr"]}: Time-EnvSampling '
            f'{float(r["Time-EnvSampling"]):.3f} s, Time-ModelFit '
            f'{float(r["Time-ModelFit"]):.3f} s, Epochs {r["Epochs"]}, '
            f'{losses}, AverageReturn '
            f'{float(r["EnvTrajs-AverageReturn"]):.2f}')
    log(f'trainer launches per call: {json.dumps(record)}; whole run '
        f'{json.dumps(total)}; resumed run {json.dumps(resume_total)}')
    return per_itr, total, resumed


def grbal_trainer_phase(dev, card, keep):
    """Phase 6: the GrBAL meta-training loop through run_grbal, 10
    fused-MLP launches and 1 pack per policy env step."""
    from learning_to_adapt_torch import run_grbal
    cfg = dict(run_grbal.config, task='cripple', seed=0, device=str(dev),
               exp_name='chip_smoke', n_itr=TRAIN_ITR,
               max_path_length=PATH_LEN, resume=False, profile=False)
    return trainer_phase(
        dev, card, run_grbal.ENTRY, cfg, HEADER_CSV,
        ('Pre-Loss', 'Post-Loss'),
        lambda solves: dict(NO_LAUNCH, fused_mlp=HORIZON * PATH_LEN,
                            pack=PATH_LEN,
                            **physics_launches(solves, PATH_LEN)),
        keep)


def mb_mpc_trainer_phase(dev, card, keep):
    """Phase 8: MB-MPC through run_mb_mpc at its full config (100-step
    paths are canonical): per policy sampling call 20 fused-MLP launches a
    step over 10 x 2000 rows, one pack for the whole call; then a policy
    sampling call watched for host waits."""
    from learning_to_adapt_torch import run_mb_mpc
    cfg = dict(run_mb_mpc.config, task='cripple', seed=0, device=str(dev),
               exp_name='chip_smoke', n_itr=MB_TRAIN_ITR, resume=False,
               profile=False)
    t_len = cfg['max_path_length']
    per_itr, total, trainer = trainer_phase(
        dev, card, run_mb_mpc.ENTRY, cfg, MB_HEADER_CSV,
        ('TrainLoss', 'ValidLoss'),
        lambda solves: dict(NO_LAUNCH, fused_mlp=MB_HORIZON * t_len,
                            fused_mlp_wgmma=MB_HORIZON * t_len, pack=1,
                            **physics_launches(solves, t_len)), keep)
    sampling_profile(trainer.sampler, 'MB-MPC', card)
    return per_itr, total, trainer


def rebal_trainer_phase(dev, card, keep):
    """Phase 9: ReBAL through run_rebal, paths cut 1000 -> 100 (one
    100-step TBPTT chunk): no fused-MLP launch (the LSTM planner runs f32
    cell equations); then a policy sampling call watched for host
    waits."""
    from learning_to_adapt_torch import run_rebal
    cfg = dict(run_rebal.config, task='cripple', seed=0, device=str(dev),
               exp_name='chip_smoke', n_itr=TRAIN_ITR,
               max_path_length=PATH_LEN, resume=False, profile=False)
    per_itr, total, trainer = trainer_phase(
        dev, card, run_rebal.ENTRY, cfg, RB_HEADER_CSV, ('TrainLoss',),
        lambda solves: dict(NO_LAUNCH, **physics_launches(solves, PATH_LEN)),
        keep)
    sampling_profile(trainer.sampler, 'ReBAL', card)
    return per_itr, total, trainer


@contextlib.contextmanager
def eager_sampling(sampler):
    """The sampler's policy calls run the eager rollout (fn.eager) while
    the context lasts: the same Sampler.obtain_samples, so both modes are
    timed alike."""
    fn = sampler._rollout_fn(False)
    sampler._fns[False] = fn.eager
    try:
        yield
    finally:
        sampler._fns[False] = fn


def eager_against_captured(sampler, what, card):
    """Four policy sampling calls of the sampler's own length from one
    generator state and episode, eager and captured in turns (e c c e),
    each with the counts set to 0 just before it. Fails unless every call
    gives the first one's paths bit for bit, leaves the generator in the
    same state and makes the same launches, and unless a captured call
    replays one graph a step. Returns (captured launches of a call, env-
    steps/s of the eager and of the steady captured calls)."""
    import numpy as np
    import torch
    from learning_to_adapt_torch.samplers.rollout import CompiledRollout
    fn = sampler._rollout_fn(False)
    if not isinstance(fn, CompiledRollout):
        raise AssertionError(f'{what}: the sampling call is not captured')
    m, t_len = sampler.num_rollouts, sampler.max_path_length
    state, episode = sampler._generator.get_state(), sampler._episode_idx
    runs = []
    for mode in 'ecce':
        sampler._generator.set_state(state)
        sampler._episode_idx = episode
        replays = fn.replays
        zero_counters()
        if mode == 'e':
            with eager_sampling(sampler):
                paths = sampler.obtain_samples()
        else:
            paths = sampler.obtain_samples()
        runs.append(dict(mode=mode, s=sampler.last_seconds,
                         launches=counters(), replays=fn.replays - replays,
                         paths=paths, rng=sampler._generator.get_state()))
    ref = runs[0]
    for r in runs[1:]:
        bad = [k for k in ref['paths'] if not np.array_equal(
            r['paths'][k], ref['paths'][k])]
        if bad:
            raise AssertionError(f'{what}: a {r["mode"]} call\'s {bad} '
                                 'differ from the eager call\'s')
        if not torch.equal(r['rng'], ref['rng']):
            raise AssertionError(f'{what}: the generator state after a '
                                 f'{r["mode"]} call differs')
        if r['launches'] != ref['launches']:
            raise AssertionError(f'{what}: launches {r["launches"]} in a '
                                 f'{r["mode"]} call != {ref["launches"]}')
        want = t_len if r['mode'] == 'c' else 0
        if r['replays'] != want:
            raise AssertionError(f'{what}: {r["replays"]} replays in a '
                                 f'{r["mode"]} call of {t_len} steps')
    rates = {mode: [round(m * t_len / r['s'], 1) for r in runs
                    if r['mode'] == mode] for mode in 'ec'}
    log(f'{what} policy sampling, eager against captured (e c c e) from one '
        f'generator state, {m}x{t_len} steps on {card}: env-steps/s eager '
        f'{rates["e"]}, captured {rates["c"]} (ms/step '
        f'{[round(r["s"] * 1e3 / t_len, 3) for r in runs]}); paths and '
        'generator state identical, launches '
        f'{json.dumps(ref["launches"])} in each; {len(fn.graphs)} graphs '
        f'{[list(k) for k in fn.graphs]}, 1 replay a step, capture '
        f'{fn.capture_s:.3f} s')
    return ref['launches'], rates


def complete_trace(fn, what, tries=3):
    """The Trace of fn() (profiled) from a window that recorded every
    launch of our kernels that the counters saw in it; a window that lost
    some, which the profiler has given once in an eager sampling call, is
    run again, up to `tries` times, then the phase fails."""
    names = dict(fused_mlp='fused_mlp_kernel', jacobi_solve='jacobi_kernel',
                 jacobi_solve_cluster='jacobi_cluster_kernel',
                 smooth_dynamics='smooth_dynamics_kernel')
    for attempt in range(1, tries + 1):
        before = counters()
        trace = profiled(fn)
        launched = diff(counters(), before)
        seen = {k: trace.launches(kernel) for k, kernel in names.items()}
        if all(seen[k] == launched[k] for k in names):
            return trace
        log(f'{what}: profiler window {attempt} of {tries} recorded '
            f'{json.dumps(seen)} of the launches {json.dumps(launched)}')
    raise AssertionError(f'{what}: {tries} profiler windows lost kernel '
                         'launches')


def sampling_profile(sampler, what, card):
    """A trained run's policy sampling: eager against captured at the run's
    own length (eager_against_captured), then, after a warm-up (which
    captures), calls of PROFILE_LEN steps (more than the 17 waits a call
    makes once, in its reset and its copy to the host): one eager and one
    captured call each timed, then under torch.profiler (device time and
    activities a step, busy share, device time a launch of both kernels,
    the busiest activities; the eager call's host time and device time of
    each labelled part of a step; each window holding every launch the
    counters saw), and one captured call watched for host waits,
    which fails on any wait once a step or more. Returns the captured
    launches of a run-length call."""
    from learning_to_adapt_torch.samplers import Sampler
    launches, rates = eager_against_captured(sampler, what, card)
    m, n = sampler.num_rollouts, PROFILE_LEN
    short = Sampler(sampler.env, sampler.policy, m, n,
                    adapt_batch_size=sampler.adapt_batch_size, seed=1,
                    device=sampler.device)
    short.obtain_samples()                          # warm-up: captures
    fn = short._rollout_fn(False)
    res = {}
    for mode in ('eager', 'captured'):
        with (eager_sampling(short) if mode == 'eager'
              else contextlib.nullcontext()):
            short.obtain_samples()
            wall = short.last_seconds
            replays = fn.replays
            trace = complete_trace(short.obtain_samples, what)
            replays = fn.replays - replays
        per_kernel = {}
        for kernel in KERNEL_NAMES:
            n_launch = trace.launches(kernel)
            per_kernel[kernel] = dict(
                launches=n_launch, device_ms_per_launch=round(
                    trace.device_us(kernel) / max(n_launch, 1) / 1e3, 4))
        device_ms = trace.device_us() / 1e3 / n
        parts = {k: dict(calls=c, host_ms_per_call=round(us / c / 1e3, 3))
                 for k, (c, us) in trace.parts('rollout.').items()}
        res[mode] = dict(
            ms_step=round(wall * 1e3 / n, 3),
            profiled_ms_step=round(short.last_seconds * 1e3 / n, 3),
            device_ms_step=round(device_ms, 4),
            activities_step=round(len(trace.device) / n),
            busy=round(device_ms * n / 1e3 / wall, 3),
            replays_step=replays / n, kernels=per_kernel)
        log(f'{what} profile, {m}x{n} policy steps, {mode}, on {card}: '
            f'wall {res[mode]["ms_step"]} ms/step unprofiled, '
            f'{res[mode]["profiled_ms_step"]} profiled; device time '
            f'{res[mode]["device_ms_step"]} ms/step, busy share '
            f'{res[mode]["busy"]} of the unprofiled wall; '
            f'{res[mode]["activities_step"]} device activities/step; '
            f'{res[mode]["replays_step"]} replays/step; kernels '
            f'{json.dumps(per_kernel)}; parts (host, profiled) '
            f'{json.dumps(parts)}')
        by_name = {}  # keyed by the printed (shortened) activity name
        for name, ns, _ in trace.device:
            by_name[name[:70]] = by_name.get(name[:70], 0) + ns / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f'{what} profile top device activities, {mode} (ms/step): '
            + json.dumps({k: round(us / 1e3 / n, 4) for k, us in top}))
        if mode == 'eager':
            # device time launched under each label (rollout.plan holds
            # rollout.adapt and rollout.pack)
            log(f'{what} profile device ms/step by part (eager): '
                + json.dumps({k: round(trace.device_us_under(k) / 1e3 / n,
                                       4) for k in sorted(parts)}))
    log(f'{what} sampling summary on {card}: ' + json.dumps(dict(
        env_steps_s=rates, capture_s=round(fn.capture_s, 3), **res)))
    watch_host_syncs(short.obtain_samples, n,
                     f'one {n}-step {what} policy sampling call (captured)')
    return launches


def solves_per_env_step(env):
    """Jacobi launches per env step: frame_skip physics steps, each with
    one constraint solve per dynamics pass of its integrator (RK4: 4)."""
    from learning_to_adapt_torch.physics import engine
    return env.frame_skip * engine.PASSES[env.model.integrator]


def physics_launches(solves, t_len, jacobi_key='jacobi_solve'):
    """The physics' launches in a sampling call of t_len env steps with
    `solves` dynamics passes a step: a Jacobi launch (of the kernel
    `jacobi_key`) and a smooth-dynamics launch a pass, a smooth-dynamics
    launch for each step's forward pass and one for the reset's."""
    return {jacobi_key: solves * t_len,
            'smooth_dynamics': (solves + 1) * t_len + 1}


def new_env_phase(dev, card, cls_name, task, header_name, jacobi_key,
                  module='run_grbal', n_itr=NEW_ENV_ITR, keep=None):
    """Phase 13, one env: an entry point (run_grbal, or run_mb_mpc) from its
    command line (--env, --task) at full width, paths of 100 steps, n_itr
    iterations (the first one random), in a temporary directory, copied to
    `keep` when given. Returns (launches of a policy sampling call, the
    trainer)."""
    import importlib
    import math
    import pickle
    entry = importlib.import_module(f'learning_to_adapt_torch.{module}')
    loss_keys, mlp, packs = {
        'run_grbal': (('Pre-Loss', 'Post-Loss'), HORIZON * PATH_LEN,
                      PATH_LEN),
        'run_mb_mpc': (('TrainLoss', 'ValidLoss'), MB_HORIZON * PATH_LEN, 1),
    }[module]
    cfg = entry.config_from_args(entry.parse_args(
        ['--env', cls_name, '--task', task, '--n_itr', str(n_itr),
         '--seed', '0', '--exp_name', 'chip_smoke', '--device', str(dev)]))
    cfg['max_path_length'] = PATH_LEN
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.time()
            record = []
            trainer, total = run_trainer(entry.ENTRY, cfg, record)
            run_s = time.time() - t0
            exp_dir = entry.ENTRY.experiment_dir(cfg)
            header, rows = read_progress(exp_dir)
            with open(os.path.join(exp_dir, 'params.pkl'), 'rb') as f:
                snap = pickle.load(f)
            if keep:
                shutil.copytree(exp_dir, keep)
        finally:
            os.chdir(cwd)
    with open(os.path.join(REPO, 'results', header_name)) as f:
        want_header = f.readline()
    if header != want_header:
        raise AssertionError(f'{cls_name}: progress.csv header {header!r} != '
                             f'the JAX run\'s {want_header!r}')
    for r in rows:
        for k in loss_keys + ('EnvTrajs-AverageReturn',):
            if not math.isfinite(float(r[k])):
                raise AssertionError(f'{cls_name} itr {r["Itr"]}: {k} = '
                                     f'{r[k]}')
    if [int(r['Itr']) for r in rows] != list(range(n_itr)):
        raise AssertionError(f'itrs {[r["Itr"] for r in rows]}')
    env = snap['env'].wrapped_env
    if not (type(env).__name__ == cls_name and env.task == task
            and snap['itr'] == n_itr - 1):
        raise AssertionError(f'{cls_name}: params.pkl did not re-create its '
                             'env')
    physics = physics_launches(solves_per_env_step(trainer.env.wrapped_env),
                               PATH_LEN, jacobi_key)
    check_captured(trainer.sampler, f'{module} --env {cls_name}')
    # MB-MPC's 20,000 rows a launch take the warpgroup-MMA kernel
    policy = dict(NO_LAUNCH, fused_mlp=mlp, pack=packs,
                  fused_mlp_wgmma=mlp if module == 'run_mb_mpc' else 0,
                  **physics)
    want = {'random': dict(policy, fused_mlp=0, fused_mlp_wgmma=0, pack=0),
            'policy': policy,
            'fit': NO_LAUNCH}
    got = [what for what, _ in record]
    if got != ['random', 'fit'] + ['policy', 'fit'] * (n_itr - 1):
        raise AssertionError(f'{cls_name}: calls {got}')
    for what, counts in record:
        if but_optimizer(what, counts) != want[what]:
            raise AssertionError(f'{cls_name}, {what}: launches {counts} != '
                                 f'{want[what]}')
    if total != {k: sum(c[k] for _, c in record) for k in total}:
        raise AssertionError(f'{cls_name}: launches outside sampling and fit')
    log(f'new env: {module} --env {cls_name} --task {task} (seed 0, '
        f'{cfg["num_rollouts"]} envs x {PATH_LEN} steps, {n_itr} itrs, '
        f'{cfg["dynamic_model_epochs"]} epochs max) on {card}: '
        f'{run_s:.1f} s; launches per call {json.dumps(record)}')
    for r in rows:
        diag = {k: round(float(r[k]), 4) for k in r
                if k.startswith('EnvTrajs-') and 'Return' not in k}
        losses = ', '.join(f'{k} {float(r[k]):.5f}' for k in loss_keys)
        log(f'  itr {r["Itr"]}: Time-EnvSampling '
            f'{float(r["Time-EnvSampling"]):.3f} s, Time-ModelFit '
            f'{float(r["Time-ModelFit"]):.3f} s, Epochs {r["Epochs"]}, '
            f'{losses}, AverageReturn '
            f'{float(r["EnvTrajs-AverageReturn"]):.2f}, {json.dumps(diag)}')
    return (policy if n_itr > 1 else record[0][1]), trainer


def fit_data(model, n_paths, gen):
    """n_paths staged paths of FIT_T steps (obs, act, delta), for timing
    only (gauss_rows, around the statistics of the sampled paths),
    zero-padded to the fit's path capacity, as fit stages them."""
    import torch
    from learning_to_adapt_torch.models.meta_mlp import PATH_CHUNK
    cap = -(-n_paths // PATH_CHUNK) * PATH_CHUNK
    data = torch.zeros((cap, FIT_T, 2 * model.obs_dim + model.act_dim),
                       device=model.device)
    data[:n_paths] = gauss_rows(model.normalizer, (n_paths, FIT_T), gen)
    return data


class FitEpochs:
    """A model's fit epoch on staged timing data, run two ways: eagerly
    (epoch_fn, from the params and optimizer state it is handed) and
    compiled (the model's CompiledEpoch: its train and validation steps
    captured once as CUDA graphs and replayed), as fit runs it: through
    the shared loop's epoch (models/fitting.py `_fit_epoch`). args(steps)
    gives the model's epoch counts for `steps` train steps (None: the
    whole epoch's)."""

    def __init__(self, model, train, test, args):
        self.model, self.train, self.test, self.args = (model, train, test,
                                                        args)
        self.eager_state = (model.params, model.opt_state)
        self.compiled = model.compiled_epoch(train, test)
        # MB-MPC's timing data has the shape key of its trainer's fits
        self.reused = self.compiled.captured
        self.load(*self.eager_state)
        if not self.compiled.captured:
            raise AssertionError('the compiled epoch did not capture')
        # both steps' warm-ups and captures, when this key was first fitted
        self.capture_s = self.compiled.capture_s

    def load(self, params, opt_state):
        m = self.model
        self.compiled.prepare(lambda st: m._load_state(
            st, params, opt_state, m.normalizer, self.train, self.test))

    def eager(self, gen, steps=None, state=None):
        """One eager epoch from `state` (default: where the last eager
        epoch ended); returns its losses (device tensors)."""
        m = self.model
        params, opt_state = state or self.eager_state
        out = m.epoch_fn(params, opt_state, m.normalizer, self.train,
                         self.test, *self.args(steps), gen)
        self.eager_state = out[:2]
        return list(out[2:])

    def captured(self, gen, steps=None):
        """One compiled epoch from the compiled state; returns its losses."""
        return list(self.model._fit_epoch(self.compiled, gen,
                                          self.args(steps)))

    def captured_params(self):
        return self.model._state_out(self.compiled.state, clone=True)[0]


def fit_diffs(fe, steps, what):
    """The compiled epoch against the eager one from the model's state on
    the same draws (one generator seed): after FIT_CHECK_STEPS train steps
    and the validation, parameters within FIT_PARAM_TOL and losses within
    FIT_LOSS_RTOL, or the phase fails; after the whole epoch of `steps`
    train steps the largest differences are returned (and printed)."""
    import torch
    from learning_to_adapt_torch.models.optim import tree_leaves
    m = fe.model
    start = (m.params, m.opt_state)
    gen = torch.Generator(device=m.device)
    out = {}
    for n in (FIT_CHECK_STEPS, None):
        gen.manual_seed(11)
        eager = torch.stack(fe.eager(gen, n, state=start))
        fe.load(*start)
        gen.manual_seed(11)
        cap = torch.stack(fe.captured(gen, n))
        pairs = list(zip(tree_leaves(fe.captured_params()),
                         tree_leaves(fe.eager_state[0])))
        p_abs = max((a - b).abs().max().item() for a, b in pairs)
        l_rel = ((cap - eager).abs() /
                 eager.abs().clamp(min=1e-30)).max().item()
        key = 'check' if n else 'epoch'
        out[key] = dict(steps=n or steps, max_param_abs=p_abs,
                        max_loss_rel=l_rel)
        if n:
            for a, b in pairs:
                torch.testing.assert_close(a, b, **FIT_PARAM_TOL)
            if not l_rel <= FIT_LOSS_RTOL:
                raise AssertionError(f'{what}: losses captured {cap.tolist()} '
                                     f'eager {eager.tolist()}')
    fe.load(*start)
    fe.eager_state = start
    log(f'{what}: captured vs eager from one state on the same draws: '
        f'{json.dumps(out)} (held after {FIT_CHECK_STEPS} train steps and '
        f'the validation: params {FIT_PARAM_TOL}, losses rtol '
        f'{FIT_LOSS_RTOL})')
    return out


def time_fit_epochs(fe, steps, steps_valid, what, card):
    """Times a fit's epoch, eager and captured in turns in one call (the
    host's speed varies between calls): after one warm-up epoch of each,
    FIT_TIMED_EPOCHS epochs of each in the order e c c e e c (CUDA events,
    host clock; the captured ones must replay the train step `steps` times
    and the validation step `steps_valid` times an epoch); one epoch of
    each under torch.profiler (device time and activities per train step,
    busy share; host time of each 'fit.*' label, the eager sub-labels from
    the eager epoch); and one epoch of each watched for host waits, the
    eager one failing on a wait once per train step or more, the captured
    one on more than one wait. Each epoch reads its losses once, as fit
    does. Returns {mode: numbers}."""
    import math
    import torch
    gen = torch.Generator(device=fe.model.device)
    gen.manual_seed(12)
    runs = {'eager': lambda: fe.eager(gen),
            'captured': lambda: fe.captured(gen)}

    def epoch(mode):
        return torch.stack(runs[mode]()).tolist()
    res = {}
    for mode in runs:
        t0 = time.time()
        epoch(mode)                                  # warm-up
        res[mode] = dict(warm_s=time.time() - t0, walls=[], events=[])
    ce = fe.compiled
    for mode in ('eager', 'captured', 'captured', 'eager', 'eager',
                 'captured')[:2 * FIT_TIMED_EPOCHS]:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        replays = (ce.train.replays, ce.valid.replays)
        torch.cuda.synchronize()
        t0 = time.time()
        start.record()
        losses = epoch(mode)
        end.record()
        torch.cuda.synchronize()
        res[mode]['walls'].append(time.time() - t0)
        res[mode]['events'].append(start.elapsed_time(end))
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f'{mode} fit losses {losses}')
        done = (ce.train.replays - replays[0], ce.valid.replays - replays[1])
        want = (steps, steps_valid) if mode == 'captured' else (0, 0)
        if done != want:
            raise AssertionError(f'{mode} epoch: {done} train and valid step '
                                 f'replays, not {want}')
    for mode, r in res.items():
        timed = {}

        def window():
            t0 = time.time()
            epoch(mode)
            torch.cuda.synchronize()
            timed['s'] = time.time() - t0
        trace = profiled(window)
        device_us = trace.device_us()
        parts = trace.parts('fit.')
        n_train = parts.get('fit.train_step', (0,))[0]
        if n_train != steps:
            raise AssertionError(f'{mode}: {n_train} labelled train steps != '
                                 f'{steps}')
        r['ms_step'] = sum(r['events']) / len(r['events']) / steps
        r['s_epoch'] = sum(r['walls']) / len(r['walls'])
        r['device_ms_step'] = device_us / 1e3 / steps
        r['activities_step'] = len(trace.device) / steps
        r['busy_profiled'] = device_us / 1e6 / timed['s']
        r['busy'] = device_us / 1e6 / r['s_epoch']
        log(f'{what}, {mode}, on {card}: warm-up epoch {r["warm_s"]:.3f} s; '
            f'epochs {[round(w, 3) for w in r["walls"]]} s, CUDA events '
            f'{[round(e, 1) for e in r["events"]]} ms = {r["ms_step"]:.4f} '
            f'ms per train step (validation included); {r["s_epoch"]:.3f} s '
            'per epoch')
        log(f'  profile (one epoch): wall {timed["s"]:.3f} s profiled; device '
            f'time {r["device_ms_step"]:.4f} ms per train step (valid '
            f'included), {r["activities_step"]:.0f} device activities per '
            f'train step; busy share {r["busy_profiled"]:.3f} of the profiled '
            f'wall, {r["busy"]:.3f} of the unprofiled wall; parts (host, '
            'profiled) ' + json.dumps(
                {k: dict(calls=n, host_ms_per_call=round(h / n / 1e3, 4))
                 for k, (n, h) in parts.items()}))
        top = {}
        for name, ns, _ in trace.device:
            top[name[:60]] = top.get(name[:60], 0) + ns / 1e3
        log('  top device activities (ms per train step): ' + json.dumps(
            {k: round(us / 1e3 / steps, 4) for k, us in sorted(
                top.items(), key=lambda kv: -kv[1])[:8]}))
        r['host_waits'] = watch_host_syncs(
            lambda: epoch(mode), steps,
            f'one {mode} fit epoch of {steps} train steps',
            most=1 if mode == 'captured' else None)
    res['captured']['capture_s'] = fe.capture_s
    log(f'{what} on {card}: captured {res["captured"]["ms_step"]:.4f} '
        f'against eager {res["eager"]["ms_step"]:.4f} ms per train step '
        f'({res["eager"]["ms_step"] / res["captured"]["ms_step"]:.2f}x); '
        f'capture (both steps, warm-ups included) {fe.capture_s:.3f} s'
        + (', made by the trainer\'s fits of this shape key' if fe.reused
           else ''))
    return res


def fit_case(fe, steps, steps_valid, what, card):
    """fit_diffs, then time_fit_epochs: a fit phase's record."""
    diffs = fit_diffs(fe, steps, what)
    return dict(time_fit_epochs(fe, steps, steps_valid, what, card),
                diffs=diffs)


def fit_phase(model, card):
    """Phase 7: the meta fit's epoch at full width on a dataset of the size
    the canonical run holds by iteration 16, eager and captured."""
    import torch
    gen = torch.Generator(device=model.device)
    gen.manual_seed(7)
    train = fit_data(model, FIT_PATHS, gen)
    test = fit_data(model, FIT_VALID_PATHS, gen)
    _, _, steps, steps_test = model._fit_shapes(FIT_PATHS, FIT_VALID_PATHS,
                                                FIT_T)
    if (steps, steps_test) != (256, 64):
        raise AssertionError(f'steps per epoch {steps}, {steps_test}')
    fe = FitEpochs(model, train, test, lambda n: (
        FIT_PATHS, FIT_VALID_PATHS, n or steps, steps_test))
    return fit_case(fe, steps, steps_test,
                    f'GrBAL fit at {FIT_PATHS} train x {FIT_T} steps ({steps} '
                    f'meta-train steps + {steps_test} valid steps an epoch; '
                    'data drawn for timing only)', card)


def gauss_rows(norm, shape, gen):
    """Rows (obs, act, delta) of `shape` (leading dims), for timing only:
    obs and delta Gaussian around the normalizer's statistics, actions
    uniform in [-1, 1]."""
    import torch
    dev = norm.obs_mean.device

    def gauss(mean, std):
        return mean + std * torch.randn(shape + (mean.shape[0],),
                                        generator=gen, device=dev)
    return torch.cat([
        gauss(norm.obs_mean, norm.obs_std),
        2 * torch.rand(shape + (norm.act_mean.shape[0],), generator=gen,
                       device=dev) - 1,
        gauss(norm.delta_mean, norm.delta_std)], dim=-1)


def mb_mpc_fit_phase(model, card):
    """Phase 10: the MB-MPC fit's epoch at full width on a dataset of the
    size its run holds by iteration 16 (15,300 train rows: 128 steps of
    128 rows an epoch; validation over the padded 16,384-row test set),
    eager and captured."""
    import torch
    from learning_to_adapt_torch.models.fitting import _bucket_pow2
    from learning_to_adapt_torch.models.mlp import PAD_CHUNK
    gen = torch.Generator(device=model.device)
    gen.manual_seed(8)
    staged = []
    for n in (MB_FIT_ROWS, MB_FIT_VALID_ROWS):
        cap = max(PAD_CHUNK, -(-n // PAD_CHUNK) * PAD_CHUNK)
        rows = torch.zeros((cap, 2 * model.obs_dim + model.act_dim),
                           device=model.device)
        rows[:n] = gauss_rows(model.normalizer, (n,), gen)
        w = (torch.arange(cap, device=model.device) < n).float()
        staged.append((rows, w))
    steps = _bucket_pow2(max(MB_FIT_ROWS // model.batch_size, 1))
    if steps != 128:
        raise AssertionError(f'steps per epoch {steps}')
    fe = FitEpochs(model, *staged, lambda n: (n or steps,))
    return fit_case(fe, steps, 1,
                    f'MB-MPC fit at {MB_FIT_ROWS} train rows ({steps} steps '
                    f'of {model.batch_size} rows an epoch + the padded '
                    f'{staged[1][0].shape[0]}-row validation; data drawn for '
                    'timing only)', card)


def rebal_fit_phase(model, card):
    """Phase 11: the ReBAL fit's epoch at full width on a dataset of the
    size its run holds by iteration 16 (68 train paths x 1000 steps: 8
    steps of 10 paths an epoch, each 10 TBPTT chunks of 100 steps;
    validation over the padded 64-path test set), eager and captured."""
    import torch
    from learning_to_adapt_torch.models.fitting import _bucket_pow2
    from learning_to_adapt_torch.models.rnn import PATH_CHUNK
    gen = torch.Generator(device=model.device)
    gen.manual_seed(9)
    staged = []
    for n in (RB_FIT_PATHS, RB_FIT_VALID_PATHS):
        cap = -(-n // PATH_CHUNK) * PATH_CHUNK
        paths = torch.zeros((cap, FIT_T, 2 * model.obs_dim + model.act_dim),
                            device=model.device)
        paths[:n] = gauss_rows(model.normalizer, (n, FIT_T), gen)
        staged.append((paths, (torch.arange(cap, device=model.device)
                               < n).float()))
    steps = _bucket_pow2(max(RB_FIT_PATHS // model.batch_size, 1))
    if steps != 8 or FIT_T // model.backprop_steps != 10:
        raise AssertionError(f'steps per epoch {steps}')
    fe = FitEpochs(model, staged[0][0], staged[1],
                   lambda n: (RB_FIT_PATHS, n or steps))
    return fit_case(fe, steps, 1,
                    f'ReBAL fit at {RB_FIT_PATHS} train paths x {FIT_T} '
                    f'steps ({steps} steps of {model.batch_size} paths, '
                    f'{FIT_T // model.backprop_steps} TBPTT chunks each, + '
                    f'the padded {staged[1][0].shape[0]}-path validation; '
                    'data drawn for timing only)', card)


@contextlib.contextmanager
def no_weight_compaction(what):
    """Fails the phase when torch warns that the recurrent layer's weights
    are not part of one contiguous chunk of memory (cuDNN then compacts
    them at every call); other warnings are shown as usual."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        yield
    bad = [w for w in caught if 'contiguous chunk' in str(w.message)]
    for w in caught:
        if w not in bad:
            warnings.showwarning(w.message, w.category, w.filename,
                                 w.lineno)
    if bad:
        raise AssertionError(f'{what}: {len(bad)} warnings that the weights '
                             f'are compacted: {bad[0].message}')
    log(f'{what}: no weight-compaction warning')


def compiled_fits(model, what):
    """Prints the compiled epochs a trainer's fits made (shape key, capture
    seconds, replays) and fails if its fits ran none."""
    entries = {str(k): dict(capture_s=round(e.capture_s, 3),
                            train_replays=e.train.replays,
                            valid_replays=e.valid.replays)
               for k, e in model._epoch_cache.items()}
    if not entries or not all(e.captured for e in
                              model._epoch_cache.values()):
        raise AssertionError(f'{what}: the fits ran no captured epoch')
    log(f'{what}: captured fit epochs by shape key {json.dumps(entries)}')


#: the keys of the JAX package's replay.npz (experiment_utils/sim_policy.py)
REPLAY_KEYS = ('actions', 'dones', 'next_observations', 'observations',
               'qpos', 'qvel', 'rewards')
#: the keys of a JAX GrBAL meta-test file
#: (results/meta_test_ant_leg3_grbal_s0.json), with the ablate_warmup and
#: set_kind of the newer files after max_path_length
META_TEST_JSON = os.path.join(REPO, 'results',
                              'meta_test_ant_leg3_grbal_s0.json')
META_TEST_FLAGS = ['--seeds', '0', '--num_rollouts', str(N_ENVS),
                   '--max_path_length', str(PATH_LEN)]
EXECUTOR_ENVS, EXECUTOR_T, EXECUTOR_STEPS = 5, 50, 120


@contextlib.contextmanager
def per_rollout(record):
    """Appends, for every sim_policy.rollout call made through meta_test,
    (launches made inside it, its steps with adaptation on) to record: an
    eager rollout's rollout.adapt calls, a captured one's replays of its
    adapted graph (the adapt calls of its warm-ups and capture are not
    steps)."""
    from learning_to_adapt_torch import meta_test
    from learning_to_adapt_torch.models import MetaMLPDynamicsModel
    from learning_to_adapt_torch.samplers.rollout import CompiledRollout
    rollout, adapt_fn = meta_test.rollout, MetaMLPDynamicsModel.adapt_fn
    compiled_call = CompiledRollout.__call__
    adapts = [0]

    def counted_adapt(self, *args):
        adapts[0] += 1
        return adapt_fn(self, *args)

    def adapted_replays(fn):
        return sum(g.replays for k, g in fn.graphs.items() if k[0])

    def counted_call(self, *args):
        a0, r0 = adapts[0], adapted_replays(self)
        out = compiled_call(self, *args)
        adapts[0] = a0 + adapted_replays(self) - r0
        return out

    def counted(*args, **kwargs):
        before, a0 = counters(), adapts[0]
        out = rollout(*args, **kwargs)
        after = counters()
        record.append(({k: after[k] - before[k] for k in after},
                       adapts[0] - a0))
        return out
    meta_test.rollout = counted
    MetaMLPDynamicsModel.adapt_fn = counted_adapt
    CompiledRollout.__call__ = counted_call
    try:
        yield record
    finally:
        meta_test.rollout = rollout
        MetaMLPDynamicsModel.adapt_fn = adapt_fn
        CompiledRollout.__call__ = compiled_call


@contextlib.contextmanager
def eager_rollouts():
    """Every sampling call made while the context lasts runs eagerly (the
    device rule of models/captured.py patched to refuse the capture)."""
    from learning_to_adapt_torch.models import captured
    rule = captured.captures
    captured.captures = lambda device, mesh: False
    try:
        yield
    finally:
        captured.captures = rule


def run_meta_test(exp_dir, flags, dev):
    """meta_test.main on exp_dir from a temporary working directory, the
    counts set to 0 just before it. Returns (the written results,
    per-mode (launches, adapt calls), whole-run launches)."""
    from learning_to_adapt_torch import meta_test
    cwd = os.getcwd()
    record = []
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            zero_counters()
            with per_rollout(record):
                meta_test.main([exp_dir, '--tag', 'chip_smoke', '--device',
                                str(dev)] + META_TEST_FLAGS + flags)
            total = counters()
            with open(os.path.join('results',
                                   'meta_test_chip_smoke.json')) as f:
                results = json.load(f)
        finally:
            os.chdir(cwd)
    summed = {k: sum(c[k] for c, _ in record) for k in total}
    if total != summed:
        raise AssertionError(f'meta-test launches outside its rollouts: '
                             f'{total} != {summed}')
    return results, record, total


def check_modes(what, results, record, modes, want, adapts):
    """Every mode finite with N_ENVS returns and one rollout each, made
    with launches `want` and adapts[i] adapted steps."""
    import math
    for mode, (counts, n_adapt), n_want in zip(modes, record, adapts):
        r = results[mode]
        if not (math.isfinite(r['mean']) and r['n'] == N_ENVS):
            raise AssertionError(f'{what} {mode}: {r}')
        if counts != want or n_adapt != n_want:
            raise AssertionError(f'{what} {mode}: launches {counts} != '
                                 f'{want}, or {n_adapt} adapted steps != '
                                 f'{n_want}')
    if len(record) != len(modes):
        raise AssertionError(f'{what}: {len(record)} rollouts for modes '
                             f'{modes}')
    log(f'{what}: ' + ', '.join(
        f'{m} {results[m]["mean"]:.2f} +- {results[m]["sem"]:.2f}'
        for m in modes) + f'; launches per mode {json.dumps(want)}; '
        f'adapted steps per mode {adapts}')


def meta_test_phase(dev, card, snap):
    """Phase 16: the meta-test protocol, replay and host tools on the
    trainers' snapshots (snap: name -> experiment directory). Returns the
    launches of the GrBAL held-out meta-test."""
    import numpy as np
    import torch
    from learning_to_adapt_torch import entry, sim_policy
    from learning_to_adapt_torch.envs import AntEnv, HalfCheetahEnv, normalize
    from learning_to_adapt_torch.ops import fused_mlp
    from learning_to_adapt_torch.samplers.vectorized_env_executor import (
        IterativeEnvExecutor)

    # (a) GrBAL trained on the Ant's legs (0, 1, 2), on the held-out leg 3:
    # first with eager sampling, then captured (each rollout a new Sampler,
    # which captures its own graphs)
    t0 = time.time()
    with eager_rollouts():
        eager = run_meta_test(snap['grbal_ant'], ['--eval_set', '3'], dev)
    eager_s = time.time() - t0
    t0 = time.time()
    results, record, grbal_total = run_meta_test(
        snap['grbal_ant'], ['--eval_set', '3'], dev)
    captured_s = time.time() - t0
    if (results, record, grbal_total) != eager:
        raise AssertionError('the GrBAL meta-test with captured sampling '
                             'differs from the eager one: '
                             f'{(record, grbal_total)} != {eager[1:]}')
    log(f'GrBAL Ant meta-test (2 modes x 1 seed x {N_ENVS} x {PATH_LEN} '
        f'steps) on {card}: eager sampling {eager_s:.1f} s, captured '
        f'{captured_s:.1f} s; results, launches and adapted steps '
        'identical')
    with open(META_TEST_JSON) as f:
        jax_doc = json.load(f)
    keys = list(jax_doc)
    i = keys.index('max_path_length') + 1
    keys[i:i] = ['ablate_warmup', 'set_kind']
    if list(results) != keys or any(
            list(results[m]) != list(jax_doc[m])
            for m in ('adapted', 'pre-update', 'gap')):
        raise AssertionError(f'meta-test keys {list(results)} != {keys}')
    if (results['train_set'], results['eval_set'], results['set_kind']) != (
            [0, 1, 2], [3], 'discrete'):
        raise AssertionError(f'held-out sets {results["train_set"]} -> '
                             f'{results["eval_set"]}')
    grbal_want = dict(
        NO_LAUNCH, fused_mlp=HORIZON * PATH_LEN, pack=PATH_LEN,
        **physics_launches(solves_per_env_step(AntEnv(device=dev)),
                           PATH_LEN))
    # adaptation starts at step a_bs + 2 (rollout.py's gate t > a_bs + 1)
    check_modes('GrBAL Ant leg 3 (held out)', results, record,
                ('adapted', 'pre-update'), grbal_want,
                [PATH_LEN - ADAPT_BATCH - 2, 0])
    log(f'GrBAL held-out gap (adapted - pre-update, {N_ENVS} rollouts x '
        f'{PATH_LEN} steps, seed 0, 2-iteration snapshot): '
        f'{results["gap"]["mean"]:+.2f} +- {results["gap"]["sem"]:.2f} '
        f'on {card}')

    # (b) ReBAL and MB-MPC on their own task distribution
    t0 = time.time()
    results, record, _ = run_meta_test(snap['rebal'], [], dev)
    modes = ('rebal', 'rebal_hidden_zero', 'rebal_hidden_frozen')
    cheetah = physics_launches(
        solves_per_env_step(HalfCheetahEnv(device=dev)), PATH_LEN)
    check_modes('ReBAL', results, record, modes,
                dict(NO_LAUNCH, **cheetah), [0, 0, 0])
    means = [results[m]['mean'] for m in modes]
    if len(set(means)) != 3:
        raise AssertionError(f'ReBAL modes gave equal returns {means}')
    results, record, _ = run_meta_test(snap['mb_mpc'], [], dev)
    check_modes('MB-MPC', results, record, ('mb_mpc',),
                dict(NO_LAUNCH, fused_mlp=MB_HORIZON * PATH_LEN,
                     fused_mlp_wgmma=MB_HORIZON * PATH_LEN, pack=1,
                     **cheetah), [0])
    log(f'ReBAL and MB-MPC meta-tests: {time.time() - t0:.1f} s')

    # (c) replay, and the trajectory made on the card against the float64
    # C++ oracle under nominal dynamics
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'replay.npz')
        sim_policy.main([snap['grbal'], '--max_path_length', str(PATH_LEN),
                         '--num_rollouts', '2', '--device', str(dev),
                         '--out', out, '--check-native'])
        with np.load(out) as z:
            replay = {k: z[k] for k in z.files}
    if tuple(sorted(replay)) != REPLAY_KEYS or any(
            v.shape[:2] != (2, PATH_LEN) or not np.isfinite(v).all()
            for v in replay.values()):
        raise AssertionError(f'replay.npz: {sorted(replay)}, shapes '
                             f'{[v.shape for v in replay.values()]}')
    deviation = {}
    for name, cls in (('grbal', HalfCheetahEnv), ('grbal_ant', AntEnv)):
        env, model, policy, _, a_bs = sim_policy.load_experiment(
            snap[name], env_override=normalize(cls(task=None, device=dev)),
            device=dev)
        paths = sim_policy.rollout(env, policy, model,
                                   max_path_length=PATH_LEN, num_rollouts=1,
                                   adapt_batch_size=a_bs)
        deviation[cls.__name__] = sim_policy.check_native(
            env, paths, PATH_LEN - 1)
    log(f'oracle: worst one-step qpos deviation over {PATH_LEN - 1} steps '
        f'of a GrBAL replay made on {card} (float32) from the float64 C++ '
        f'physics: {json.dumps(deviation)}, bound {sim_policy.NATIVE_TOL}; '
        f'{time.time() - t0:.1f} s')
    if not all(0.0 <= d < sim_policy.NATIVE_TOL
               for d in deviation.values()):
        raise AssertionError(f'oracle deviation {deviation}')

    # (d) the vectorized executor: auto-reset at max_path_length
    t0 = time.time()
    env = normalize(HalfCheetahEnv(task='cripple', reset_every_episode=True,
                                   device=dev))
    ex = IterativeEnvExecutor(env, EXECUTOR_ENVS, EXECUTOR_T, seed=0)
    obs = ex.reset()
    rng = np.random.RandomState(0)
    resets = []
    for i in range(EXECUTOR_STEPS):
        obs, rew, dones, _ = ex.step(rng.uniform(
            -1, 1, (EXECUTOR_ENVS, env.act_dim)))
        if not (np.isfinite(obs).all() and np.isfinite(rew).all()):
            raise AssertionError(f'executor step {i + 1}: non-finite')
        if dones.any():
            resets.append((i + 1, int(dones.sum())))
    want = [(EXECUTOR_T, EXECUTOR_ENVS), (2 * EXECUTOR_T, EXECUTOR_ENVS)]
    if resets != want or ex._episode.tolist() != [2] * EXECUTOR_ENVS:
        raise AssertionError(f'executor resets {resets} != {want}, '
                             f'episodes {ex._episode.tolist()}')
    log(f'executor: {EXECUTOR_ENVS} envs x {EXECUTOR_STEPS} steps, resets '
        f'at steps {[s for s, _ in resets]}, episodes '
        f'{ex._episode.tolist()}, {time.time() - t0:.1f} s')

    # (e) entry(): one fused-MLP launch, held against the plain version
    fn, args = entry.entry(device=dev)
    zero_counters()
    got = fn(*args)
    launched = counters()
    params, norm, obs, act = args
    x = torch.cat([norm.norm_obs(obs), norm.norm_act(act)], dim=-1)
    plain = obs + norm.denorm_delta(fused_mlp.fused_mlp_plain(
        x[None], [w[None] for w in params['w']],
        [b[None] for b in params['b']])[0])
    err = (got - plain).abs().max().item()
    log(f'entry(): fn(*example_args) {tuple(got.shape)}, launches '
        f'{json.dumps(launched)}, max |kernel - plain| {err:.3e} '
        f'(rtol {MLP_TOL["rtol"]}, atol {MLP_TOL["atol"]})')
    if launched != dict(NO_LAUNCH, fused_mlp=1, pack=1):
        raise AssertionError(f'entry(): launches {launched}')
    if not torch.allclose(got, plain, **MLP_TOL):
        raise AssertionError(f'entry(): kernel vs plain {err}')
    return grbal_total, replay


# phase 17: the multi-rank path. (a) one rank over nccl, at full width:
# run_grbal_multihost for NEW_ENV_ITR iterations, then one sharded fit epoch
# watched for host waits on timing data of MH_WATCH_PATHS x FIT_T steps (64
# meta-train + 16 validation steps); (b) two ranks sharing the card over
# gloo against one rank, at full width with MH_ENVS envs x MH_T steps
MH_ENVS, MH_T, MH_FIT_EPOCHS = 6, 40, 3
MH_WATCH_PATHS, MH_WATCH_VALID = 16, 4
MH_TIMEOUT = 300                      # seconds a spawned job may take
MH_STEP_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_infra.py:124-127
MH_RETURN_RTOL = 2e-3                 # tests/test_multihost.py:95-98
# the planner's candidate returns, 2 ranks vs 1: the same model on other
# batch shapes, so f32 rounding apart (tests/test_torch_parallel.py)
MH_CANDIDATE_TOL = dict(rtol=1e-5, atol=1e-5)
MH_PATH_KEYS = ('observations', 'actions', 'rewards', 'next_observations')
# the counters a rank reports for its policy call
MH_LAUNCHES = ('fused_mlp', 'pack', 'jacobi_solve', 'smooth_dynamics')
NO_COLLECTIVE = dict(all_reduce=0, all_gather=0, broadcast=0)


def diff(after, before):
    return {k: after[k] - before[k] for k in after}


@contextlib.contextmanager
def counted_multihost_calls(record):
    """Appends, for every Sampler.obtain_samples and meta fit call, (label,
    kernel launches inside it, collectives inside it, extra) to record:
    a sampling call's extra holds the collectives it made before its
    gather, i.e. in its steps; a fit's, its epochs and step counts."""
    from learning_to_adapt_torch.models import MetaMLPDynamicsModel
    from learning_to_adapt_torch.parallel import mesh as par_mesh
    from learning_to_adapt_torch.samplers import Sampler
    originals = (Sampler.obtain_samples, MetaMLPDynamicsModel.fit,
                 par_mesh.gather)
    at_gather = []

    def gather(*args, **kwargs):
        at_gather.append(par_mesh.collective_counts())
        return originals[2](*args, **kwargs)

    def sample(self, *args, **kwargs):
        launches, coll = counters(), par_mesh.collective_counts()
        out = originals[0](self, *args, **kwargs)
        record.append(('random' if kwargs.get('random') else 'policy',
                       diff(counters(), launches),
                       diff(par_mesh.collective_counts(), coll),
                       diff(at_gather[-1], coll)))
        return out

    def fit(self, *args, **kwargs):
        launches, coll = counters(), par_mesh.collective_counts()
        out = originals[1](self, *args, **kwargs)
        shapes = self._fit_shapes(self._train['obs'].shape[0],
                                  self._test['obs'].shape[0],
                                  self._train['obs'].shape[1])
        record.append(('fit', diff(counters(), launches),
                       diff(par_mesh.collective_counts(), coll),
                       dict(epochs=out['epochs'] + 1, steps=shapes[2],
                            steps_test=shapes[3])))
        return out
    Sampler.obtain_samples, MetaMLPDynamicsModel.fit = sample, fit
    par_mesh.gather = gather
    try:
        yield record
    finally:
        (Sampler.obtain_samples, MetaMLPDynamicsModel.fit,
         par_mesh.gather) = originals


def multihost_nccl(dev, card):
    """Phase 17 (a): run_grbal_multihost at world size 1 over nccl on the
    card, full width, --task cripple, NEW_ENV_ITR iterations of PATH_LEN
    steps: per policy iteration 1000 fused-MLP launches, 100 packs and 100
    Jacobi launches; one all_gather a sampling call and none in its steps;
    per fit one broadcast and one all_reduce a meta-train and a validation
    step and one an epoch; then one sharded fit epoch on timing data
    watched for host waits. Returns the launches of a policy iteration."""
    import torch
    from learning_to_adapt_torch import run_grbal, run_grbal_multihost
    from learning_to_adapt_torch.parallel import mesh as par_mesh
    from learning_to_adapt_torch.utils import logging as logger
    mesh = par_mesh.make_mesh(device=str(dev))
    if (mesh.backend, mesh.world_size, mesh.device) != ('nccl', 1, dev):
        raise AssertionError(f'mesh {mesh.backend} x {mesh.world_size} on '
                             f'{mesh.device}')
    cfg = dict(run_grbal.config, task='cripple', seed=0, device=str(dev),
               exp_name='chip_smoke', n_itr=NEW_ENV_ITR,
               max_path_length=PATH_LEN)
    cwd = os.getcwd()
    out = io.StringIO()
    record = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            t0 = time.time()
            zero_counters()
            try:
                with counted_multihost_calls(record), \
                        contextlib.redirect_stdout(out):
                    trainer = run_grbal_multihost.run_experiment(cfg,
                                                                 mesh=mesh)
            except BaseException:
                print(out.getvalue()[-8000:], file=sys.stderr)
                raise
            finally:
                logger.Logger.CURRENT.close()
            run_s = time.time() - t0
            header, rows = read_progress(
                run_grbal_multihost.experiment_dir(cfg))
            os.chdir(cwd)
        with open(HEADER_CSV) as f:
            if header != f.readline():
                raise AssertionError(f'progress.csv header {header!r}')
        physics = physics_launches(1, PATH_LEN)
        policy = dict(NO_LAUNCH, fused_mlp=HORIZON * PATH_LEN, pack=PATH_LEN,
                      **physics)
        want = {'random': dict(NO_LAUNCH, **physics),
                'policy': policy, 'fit': NO_LAUNCH}
        gathered = dict(NO_COLLECTIVE, all_gather=1)
        labels = ['random', 'fit'] + ['policy', 'fit'] * (NEW_ENV_ITR - 1)
        if [r[0] for r in record] != labels:
            raise AssertionError(f'calls {[r[0] for r in record]}')
        for what, launches, coll, extra in record:
            if what == 'fit':
                check_fit_launches(launches, extra['epochs'] *
                                   extra['steps'], 'sharded meta fit')
            elif launches != want[what]:
                raise AssertionError(f'{what}: launches {launches} != '
                                     f'{want[what]}')
            if what == 'fit':
                per_epoch = extra['steps'] + extra['steps_test'] + 1
                need = dict(NO_COLLECTIVE, broadcast=1,
                            all_reduce=extra['epochs'] * per_epoch)
            else:
                need = gathered
                if extra != NO_COLLECTIVE:
                    raise AssertionError(f'{what}: collectives in its steps '
                                         f'{extra}')
            if coll != need:
                raise AssertionError(f'{what}: collectives {coll} != {need}')
        log(f'phase 17 (a) run_grbal_multihost, 1 rank over nccl on {card}: '
            f'{cfg["num_rollouts"]} envs x {PATH_LEN} steps, {NEW_ENV_ITR} '
            f'itrs in {run_s:.1f} s; per call (launches, collectives, '
            f'extra): {json.dumps(record)}')
        for r in rows:
            log(f'  itr {r["Itr"]}: Time-EnvSampling '
                f'{float(r["Time-EnvSampling"]):.3f} s, Time-ModelFit '
                f'{float(r["Time-ModelFit"]):.3f} s, Epochs {r["Epochs"]}, '
                f'Pre-Loss {float(r["Pre-Loss"]):.5f}, Post-Loss '
                f'{float(r["Post-Loss"]):.5f}')

        check_captured(trainer.sampler, 'phase 17 (a) run_grbal_multihost '
                       '(nccl)')
        model = trainer.dynamics_model
        compiled_fits(model, 'phase 17 (a) run_grbal_multihost (nccl)')
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        train = fit_data(model, MH_WATCH_PATHS, gen)
        test = fit_data(model, MH_WATCH_VALID, gen)
        _, _, steps, steps_test = model._fit_shapes(
            MH_WATCH_PATHS, MH_WATCH_VALID, FIT_T)
        fe = FitEpochs(model, train, test, lambda n: (
            MH_WATCH_PATHS, MH_WATCH_VALID, n or steps, steps_test))
        ce = fe.compiled

        def epoch():
            return torch.stack(fe.captured(gen)).tolist()
        epoch()                                      # warm-up
        before = par_mesh.collective_counts()
        replays = (ce.train.replays, ce.valid.replays)
        t0 = time.time()
        epoch()
        epoch_s = time.time() - t0
        coll = diff(par_mesh.collective_counts(), before)
        need = dict(NO_COLLECTIVE, all_reduce=steps + steps_test + 1)
        if coll != need:
            raise AssertionError(f'sharded epoch: collectives {coll} != '
                                 f'{need}')
        done = (ce.train.replays - replays[0], ce.valid.replays - replays[1])
        if done != (steps, steps_test):
            raise AssertionError(f'sharded epoch: replays {done}')
        log(f'phase 17 (a) sharded fit epoch (nccl, 1 rank, captured) on '
            f'{card}: {steps} meta-train + {steps_test} valid steps, '
            f'{epoch_s:.3f} s = {epoch_s * 1e3 / (steps + steps_test):.3f} '
            f'ms a step, collectives {json.dumps(coll)}; per replay train '
            f'{json.dumps(ce.train.collectives)}, valid '
            f'{json.dumps(ce.valid.collectives)}; made by the warm-ups (not '
            f'counted) train {json.dumps(ce.train.warmup_collectives)}, '
            f'valid {json.dumps(ce.valid.warmup_collectives)}; capture '
            f'{fe.capture_s:.3f} s')
        watch_host_syncs(epoch, steps, f'one sharded fit epoch of {steps} '
                         'meta-train steps (nccl all_reduce each, captured)',
                         most=1)
    finally:
        os.chdir(cwd)
        mesh.close()
    return record[2][1]


@contextlib.contextmanager
def planner_returns():
    """Collects the model-rollout returns of every candidate that random
    shooting scores (one (envs * candidates,) tensor a step, env-major)."""
    from learning_to_adapt_torch.policies import planners
    returns, record = planners._returns, []

    def spy(*args, **kwargs):
        out = returns(*args, **kwargs)
        record.append(out)
        return out
    planners._returns = spy
    try:
        yield record
    finally:
        planners._returns = returns


def check_policy_parting(a, b, ret_a, ret_b):
    """Holds the policy paths a (dict of (envs, T, ...)) of the 2-rank job
    to b of the 1-rank job, with their candidate returns ret_a, ret_b (T,
    envs, n): up to the first step where the paths part, every return to
    MH_CANDIDATE_TOL and every step to 1e-5. A parting passes only as a
    near tie: after step 0, in one env, whose best two returns lie within
    twice the two jobs' return difference. Returns (the parting step or
    None, the largest return difference before it)."""
    import numpy as np
    close = np.ones(MH_T, bool)
    for k in MH_PATH_KEYS:
        ok = np.isclose(a[k], b[k], **MH_STEP_TOL)
        close &= ok.reshape(ok.shape[0], MH_T, -1).all(axis=(0, 2))
    parted = np.flatnonzero(~close)
    step = int(parted[0]) if parted.size else None
    end = MH_T if step is None else step + 1
    if not np.allclose(ret_a[:end], ret_b[:end], **MH_CANDIDATE_TOL):
        raise AssertionError('policy call: candidate returns off by '
                             f'{np.abs(ret_a[:end] - ret_b[:end]).max()} '
                             f'up to step {end - 1}')
    worst = float(np.abs(ret_a[:end] - ret_b[:end]).max())
    if step is None:
        return None, worst
    acted = np.flatnonzero(~np.isclose(
        a['actions'][:, step], b['actions'][:, step],
        **MH_STEP_TOL).all(axis=-1))
    if step == 0 or acted.size != 1:
        raise AssertionError(f'policy call: the paths part at step {step} '
                             f'in envs {acted.tolist()}')
    e = int(acted[0])
    noise = np.abs(ret_a[step, e] - ret_b[step, e]).max()
    gap = min(float(np.diff(np.sort(r)[-2:])[0])
              for r in (ret_a[step, e], ret_b[step, e]))
    if gap > 2 * noise:
        raise AssertionError(f'policy call: env {e} parts at step {step} '
                             f'with its best two returns {gap} apart, '
                             f'more than twice their difference {noise}')
    return step, worst


def _multihost_rank(out_dir):
    """Phase 17 (b), one rank (started by parallel/mesh.py spawn): GrBAL at
    full width on cuda:0 over gloo with MH_ENVS envs x MH_T steps over the
    ranks: a random sampling call, a MH_FIT_EPOCHS-epoch sharded meta fit on
    the gathered paths (rank 0 also fits an unsharded twin on the same
    paths), a policy sampling call; writes its paths, parameters, counts
    and seconds to out_dir/rank<r>_of<W>.npz."""
    import numpy as np
    import torch
    from learning_to_adapt_torch.envs import HalfCheetahEnv, normalize
    from learning_to_adapt_torch.models import MetaMLPDynamicsModel
    from learning_to_adapt_torch.models.optim import tree_leaves
    from learning_to_adapt_torch.parallel import mesh as par_mesh
    from learning_to_adapt_torch.policies import MPCController
    from learning_to_adapt_torch.samplers import Sampler
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)   # the ranks share the host's cores
    mesh = par_mesh.make_mesh(device='cuda:0', backend='gloo')
    try:
        dev = mesh.device
        env = normalize(HalfCheetahEnv(task='cripple',
                                       reset_every_episode=True, device=dev))

        def model():
            return MetaMLPDynamicsModel(
                'dyn_model', env, hidden_sizes=MLP_DIMS[1:-1],
                meta_batch_size=10, inner_learning_rate=INNER_LR,
                learning_rate=1e-3, hidden_nonlinearity='relu',
                batch_size=ADAPT_BATCH, seed=0, device=dev)
        sharded = model()
        sharded.mesh = mesh
        policy = MPCController('policy', env, sharded, discount=1.0,
                               n_candidates=N_CANDIDATES, horizon=HORIZON)
        sampler = Sampler(env, policy, num_rollouts=MH_ENVS,
                          max_path_length=MH_T, adapt_batch_size=ADAPT_BATCH,
                          seed=0, device=dev, mesh=mesh)
        out = {}
        coll = par_mesh.collective_counts()
        rand = sampler.obtain_samples(random=True)
        out['random_s'] = sampler.last_seconds
        data = [rand[k] for k in ('observations', 'actions',
                                  'next_observations')]
        fit = sharded.fit(*data, epochs=MH_FIT_EPOCHS)
        out['fit_steps'] = np.array([fit['epochs'] + 1] + list(
            sharded._fit_shapes(sharded._train['obs'].shape[0],
                                sharded._test['obs'].shape[0], MH_T)[2:]))
        if mesh.rank == 0:
            twin = model()
            twin.fit(*data, epochs=MH_FIT_EPOCHS)
            for i, x in enumerate(tree_leaves(twin.params)):
                out[f'twin_{i}'] = x.cpu().numpy()
        for i, x in enumerate(tree_leaves(sharded.params)):
            out[f'params_{i}'] = x.cpu().numpy()
        zero_counters()
        with planner_returns() as returns:
            pol = sampler.obtain_samples()
        out['policy_s'] = sampler.last_seconds
        # (T, this rank's envs, candidates)
        out['policy_returns'] = torch.stack(returns).reshape(
            MH_T, MH_ENVS // mesh.world_size, -1).cpu().numpy()
        out['launches'] = np.array([counters()[k] for k in MH_LAUNCHES])
        out['collectives'] = np.array(list(diff(
            par_mesh.collective_counts(), coll).values()))
        for k in MH_PATH_KEYS:
            out[f'random_{k}'], out[f'policy_{k}'] = rand[k], pol[k]
        np.savez(os.path.join(out_dir, f'rank{mesh.rank}_of'
                              f'{mesh.world_size}.npz'), **out)
    finally:
        mesh.close()


def multihost_gloo(card):
    """Phase 17 (b): two ranks on the one card over gloo against one rank
    (each job's ranks started by spawn): the random call's paths to 1e-5,
    the sharded meta fit bit for bit (both ranks alike, and as its
    unsharded twin on the same paths; and as the 1-rank job's when both
    jobs gathered the same paths bit for bit), the policy call as
    check_policy_parting holds it and its reward sum to rtol 2e-3 where
    nothing parts, and 10 fused-MLP launches a policy step on every rank.
    Returns the launches of rank 0 of the 2-rank job."""
    import numpy as np
    from learning_to_adapt_torch.parallel import mesh as par_mesh
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world in (1, 2):
            t0 = time.time()
            par_mesh.spawn(_multihost_rank, world, args=(tmp,),
                           timeout=MH_TIMEOUT)
            runs[world] = [dict(np.load(os.path.join(
                tmp, f'rank{r}_of{world}.npz'))) for r in range(world)]
            rates = ', '.join(
                f'rank {r} {MH_ENVS * MH_T / float(x["policy_s"]):.1f}'
                for r, x in enumerate(runs[world]))
            log(f'phase 17 (b) {world}-rank job (gloo, cuda:0) on {card}: '
                f'{time.time() - t0:.1f} s with start-up; policy call '
                f'{rates} env-steps/s ({MH_ENVS} envs x {MH_T} steps over '
                'the job)')
    one, (r0, r1) = runs[1][0], runs[2]

    def leaves(x, prefix):
        return [x[f'{prefix}{i}'] for i in range(sum(
            k.startswith(prefix) for k in x))]
    want = np.array([HORIZON * MH_T, MH_T, MH_T, 2 * MH_T + 1])
    for r, x in enumerate(runs[2] + runs[1]):
        if not np.array_equal(x['launches'], want):
            raise AssertionError(f'rank {r}: policy call launches '
                                 f'{x["launches"]} != {want}')
        # 2 all_gathers; the fit's broadcast and its all_reduces
        epochs, steps, steps_test = x['fit_steps']
        need = [epochs * (steps + steps_test + 1), 2, 1]
        if x['collectives'].tolist() != need:
            raise AssertionError(f'rank {r}: collectives '
                                 f'{x["collectives"]} != {need}')
    for k in MH_PATH_KEYS:
        for call in ('random', 'policy'):
            if not np.array_equal(r0[f'{call}_{k}'], r1[f'{call}_{k}']):
                raise AssertionError(f'ranks gathered other {call} {k}')
        a, b = r0[f'random_{k}'], one[f'random_{k}']
        if not np.allclose(a, b, **MH_STEP_TOL):
            raise AssertionError(f'random call {k}: 2 ranks vs 1 off by '
                                 f'{np.abs(a - b).max()}')
    same_paths = all(np.array_equal(r0[f'random_{k}'], one[f'random_{k}'])
                     for k in MH_PATH_KEYS)
    worst = max(float(np.abs(r0[f'random_{k}'] - one[f'random_{k}']).max())
                for k in MH_PATH_KEYS)
    pairs = [('rank 0 vs rank 1', r1, 'params_'),
             ('sharded vs unsharded twin', r0, 'twin_')]
    if same_paths:
        pairs.append(('2 ranks vs 1 rank', one, 'params_'))
    for what, other, prefix in pairs:
        for a, b in zip(leaves(r0, 'params_'), leaves(other, prefix)):
            if not np.array_equal(a, b):
                raise AssertionError(f'meta fit {what}: not bit for bit '
                                     f'({np.abs(a - b).max()})')
    log(f'phase 17 (b) random call: 2 ranks vs 1 rank max |diff| {worst:.3g}'
        f' ({"bit for bit" if same_paths else "not bit for bit"}); meta fit '
        f'bit for bit: {", ".join(w for w, _, _ in pairs)}')

    step, worst = check_policy_parting(
        {k: r0[f'policy_{k}'] for k in MH_PATH_KEYS},
        {k: one[f'policy_{k}'] for k in MH_PATH_KEYS},
        np.concatenate([r0['policy_returns'], r1['policy_returns']], axis=1),
        one['policy_returns'])
    got, ref = r0['policy_rewards'].sum(), one['policy_rewards'].sum()
    if step is not None:
        log(f'phase 17 (b) policy call: a near tie parts the paths at step '
            f'{step} (candidate returns within {worst:.3g} and steps within '
            f'1e-5 up to it); reward sums {got:.5f} vs {ref:.5f}')
    elif not np.isclose(got, ref, rtol=MH_RETURN_RTOL):
        raise AssertionError(f'policy reward sum {got} vs {ref}')
    else:
        log(f'phase 17 (b) policy call: every step within 1e-5, candidate '
            f'returns within {worst:.3g}; reward sums {got:.5f} vs '
            f'{ref:.5f}')
    return dict(NO_LAUNCH, **{k: int(n) for k, n in
                              zip(MH_LAUNCHES, r0['launches'])})


def multihost_phase(dev, card):
    """Phase 17: (a), then (b). Returns the launches of a policy iteration
    of (a), the run at full path length."""
    t0 = time.time()
    launches = multihost_nccl(dev, card)
    gloo_launches = multihost_gloo(card)
    log(f'phase 17 took {time.time() - t0:.1f} s on {card}; 2-rank policy '
        f'call launches on rank 0: {json.dumps(gloo_launches)}')
    return launches


def render_phase(dev, card, replay):
    """Phase 18: the port's renderer on the card, on phase 16 (c)'s replay:
    render_frames of each rollout at the viewer's stride on the card against
    the same call on the CPU, and the HTML viewer exported from the card to
    a temporary directory."""
    import numpy as np
    from learning_to_adapt_torch import interactive_viewer
    from learning_to_adapt_torch.envs.model_defs import get_model
    from learning_to_adapt_torch.render_trajectory import render_frames

    t0 = time.time()
    model = get_model('half_cheetah')
    worst, n_frames = 0.0, 0
    for qpos in replay['qpos']:
        on_card = render_frames(qpos, model, stride=RENDER_STRIDE, device=dev)
        on_cpu = render_frames(qpos, model, stride=RENDER_STRIDE,
                               device='cpu')
        if len(on_card) != -(-len(qpos) // RENDER_STRIDE) or len(
                on_card) != len(on_cpu):
            raise AssertionError(f'render: {len(on_card)} frames on the '
                                 f'card, {len(on_cpu)} on the CPU')
        for (segs, spheres), (csegs, cspheres) in zip(on_card, on_cpu):
            if not segs or len(segs) != len(csegs) or len(spheres) != len(
                    cspheres):
                raise AssertionError('render: frames differ in their parts')
            for a, b in zip(segs + spheres, csegs + cspheres):
                for x, y in zip(a, b):
                    diff = np.abs(np.asarray(x) - np.asarray(y))
                    if not np.isfinite(diff).all():
                        raise AssertionError('render: non-finite frame')
                    worst = max(worst, float(diff.max()))
        n_frames += len(on_card)
    if worst > RENDER_ATOL:
        raise AssertionError(f'render: card vs CPU {worst} > {RENDER_ATOL}')
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, 'replay.npz')
        np.savez(npz, **replay)
        html = interactive_viewer.export_html(
            npz, 'half_cheetah', stride=RENDER_STRIDE,
            out=os.path.join(tmp, 'replay.html'), device=dev)
        size = os.path.getsize(html)
    log(f'phase 18 render on {card}: {n_frames} frames of '
        f'{replay["qpos"].shape[0]} x {replay["qpos"].shape[1]} replayed '
        f'steps (stride {RENDER_STRIDE}), card vs CPU max |diff| '
        f'{worst:.3e} (atol {RENDER_ATOL}), HTML {size} bytes, '
        f'{time.time() - t0:.1f} s')


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

    def stamp(what):
        log(f'elapsed {time.time() - t_start:.1f} s: {what}')

    floor_lib, small_floor_lib, dense_floor_lib = build_kernels()
    kernels = [check_fused_mlp(dev), check_jacobi(dev, floor_lib),
               check_jacobi_cluster(dev, small_floor_lib, dense_floor_lib)]
    kernels[0].update(check_fused_mlp_mb_mpc(dev))
    kernels[0].update(check_fused_mlp_arm(dev))
    kernels[0].update(check_fused_mlp_ant(dev))
    kernels[1].update(check_jacobi_ant(dev))
    kernels.append(check_clip_adam(dev))
    kernels.append(check_smooth_dynamics(dev))
    stamp('kernels')
    launches, sampler = main_path(dev, card)
    sampling_profile(sampler, 'GrBAL', card)
    stamp('GrBAL sampling')
    # the trainers' snapshots, for the meta-test phase; removed on exit
    snaps = tempfile.TemporaryDirectory(prefix='chip_smoke_snapshots_')
    snap = {k: os.path.join(snaps.name, k) for k in
            ('grbal', 'mb_mpc', 'rebal', 'grbal_ant')}
    per_policy_itr, trainer_total, trainer = grbal_trainer_phase(
        dev, card, snap['grbal'])
    for name in launches:
        if launches[name] != per_policy_itr[name]:
            raise AssertionError(f'{name}: sampling phase {launches[name]} '
                                 'launches, trainer policy iteration '
                                 f'{per_policy_itr[name]}')
    compiled_fits(trainer.dynamics_model, 'GrBAL trainer')
    fits = {'GrBAL': fit_phase(trainer.dynamics_model, card)}
    stamp('GrBAL trainer and fit')
    mb_itr, mb_total, mb_trainer = mb_mpc_trainer_phase(dev, card,
                                                        snap['mb_mpc'])
    compiled_fits(mb_trainer.dynamics_model, 'MB-MPC trainer')
    stamp('MB-MPC trainer')
    with no_weight_compaction('ReBAL trainer'):
        rb_itr, rb_total, rb_trainer = rebal_trainer_phase(dev, card,
                                                           snap['rebal'])
    compiled_fits(rb_trainer.dynamics_model, 'ReBAL trainer')
    stamp('ReBAL trainer')
    fits['MB-MPC'] = mb_mpc_fit_phase(mb_trainer.dynamics_model, card)
    with no_weight_compaction('ReBAL fit'):
        fits['ReBAL'] = rebal_fit_phase(rb_trainer.dynamics_model, card)
    log(f'fits on {card}, ms per train step (CUDA events): ' + json.dumps(
        {k: {m: dict(ms=round(r[m]['ms_step'], 4),
                     device_ms=round(r[m]['device_ms_step'], 4),
                     activities=round(r[m]['activities_step']),
                     busy=round(r[m]['busy'], 3),
                     host_waits=r[m]['host_waits'])
             for m in ('eager', 'captured')} for k, r in fits.items()}))
    stamp('MB-MPC and ReBAL fits')
    env_itr = {}
    for cls_name, task, header, jacobi_key in NEW_ENVS:
        env_itr[cls_name], env_trainer = new_env_phase(
            dev, card, cls_name, task, header, jacobi_key,
            keep=snap['grbal_ant'] if cls_name == 'AntEnv' else None)
        stamp(f'GrBAL on {cls_name}')
        if cls_name in ('HalfCheetahBlocksEnv', 'AntEnv'):
            what = {'HalfCheetahBlocksEnv': 'blocks', 'AntEnv': 'Ant'}
            sampling_profile(env_trainer.sampler,
                             f'GrBAL {what[cls_name]}', card)
            stamp(f'GrBAL {what[cls_name]} sampling profile')
    ant_mb_random, _ = new_env_phase(dev, card, 'AntEnv', 'cripple',
                                     ANT_MB_HEADER, 'jacobi_solve',
                                     module='run_mb_mpc', n_itr=1)
    stamp('MB-MPC on AntEnv')
    meta_test_launches, replay = meta_test_phase(dev, card, snap)
    snaps.cleanup()
    stamp('meta-test, replay, executor and entry()')
    multihost_launches = multihost_phase(dev, card)
    stamp('multi-rank path')
    render_phase(dev, card, replay)
    stamp('render')
    for k in kernels:
        # the cluster kernel's main path is the blocks env's; the
        # clip-and-Adam kernel's the GrBAL trainer's fits
        k['launches'] = (env_itr['HalfCheetahBlocksEnv'][k['name']]
                         if k['name'] == 'jacobi_solve_cluster'
                         else trainer_total[k['name']]
                         if k['name'] == 'clip_adam'
                         else per_policy_itr[k['name']])
        k['trainer_launches'] = trainer_total[k['name']]
        k['mb_mpc_launches'] = mb_itr[k['name']]
        k['rebal_launches'] = rb_itr[k['name']]
        k['mb_mpc_trainer_launches'] = mb_total[k['name']]
        k['rebal_trainer_launches'] = rb_total[k['name']]
        for cls_name, key in (('HalfCheetahHFieldEnv', 'hfield_launches'),
                              ('HalfCheetahBlocksEnv', 'blocks_launches'),
                              ('Arm7DofEnv', 'arm_launches'),
                              ('AntEnv', 'ant_launches')):
            k[key] = env_itr[cls_name][k['name']]
        k['ant_mb_mpc_random_launches'] = ant_mb_random[k['name']]
        k['meta_test_launches'] = meta_test_launches[k['name']]
        k['multihost_launches'] = multihost_launches[k['name']]
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'ms_cold',
            'library_device_ms', 'device_ms', 'floor_ms', 'ms_512',
            'device_ms_512', 'floor_ms_512', 'n_live', 'dense_ms',
            'dense_device_ms', 'dense_floor_ms', 'dense_bound_ms',
            'bound_ms_512', 'dead_512_ms', 'dead_512_device_ms',
            'dead_512_bound_ms',
            'trainer_launches', 'mb_mpc_launches', 'rebal_launches',
            'mb_mpc_trainer_launches', 'rebal_trainer_launches',
            'hfield_launches', 'blocks_launches', 'arm_launches',
            'ant_launches', 'ant_mb_mpc_random_launches',
            'meta_test_launches', 'multihost_launches',
            'mb_mpc_max_abs_err', 'mb_mpc_ms', 'mb_mpc_device_ms',
            'mb_mpc_plain_ms', 'mb_mpc_bound_ms', 'mb_mpc_library_ms',
            'mb_mpc_library_device_ms', 'arm_max_abs_err', 'arm_ms',
            'arm_device_ms', 'arm_plain_ms', 'arm_bound_ms',
            'arm_library_ms', 'arm_library_device_ms', 'ant_rows',
            'ant_max_abs_err', 'ant_ms', 'ant_ms_cold', 'ant_device_ms',
            'ant_plain_ms', 'ant_bound_ms', 'ant_library_ms',
            'ant_library_device_ms', 'graph_ms', 'plain_graph_ms',
            'mb_mpc_graph_ms', 'mb_mpc_plain_graph_ms', 'max_rel_err',
            'plain_launches', 'forward_ms', 'forward_device_ms',
            'forward_plain_launches', 'ant_max_rel_err', 'ant_graph_ms',
            'ant_plain_graph_ms', 'ant_plain_launches', 'ant_forward_ms',
            'ant_forward_device_ms', 'ant_forward_plain_launches',
            'wide_max_rel_err', 'wide_ms', 'wide_device_ms')
    log(f'total {time.time() - t_start:.1f} s')
    log(card_line())
    log(json.dumps({'kernels': [{k: kern.get(k) for k in keys}
                                for kern in kernels]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
