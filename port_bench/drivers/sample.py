"""Driver 'sample': whole policy calls of `Sampler.obtain_samples`
(random=False), the sampling an RL researcher's run makes every
iteration.

Set-up builds env, model, policy and sampler as the configuration's entry
point does, hands the model weights and normalizer statistics drawn from
the seed, and makes warm calls for the traffic's warm_seconds (the first
captures the step graphs). The window then makes whole calls, each from a
generator state drawn from the run's seed and the call's index (through
the sampler's own state_dict), until `seconds` have passed;
env_steps_per_s is the env steps of those calls over the wall time to
the end of the last. A traced run profiles the window's first call
(lib/trace.py) and measures `seconds` of unprofiled calls besides."""
import time

import torch

from port_bench.lib import program, trace
from port_bench.reference import sampling


def _state_dict(device, call_seed, episode_idx):
    gen = program.generator(device, call_seed)
    return dict(generator=gen.get_state().numpy(),
                device_type=torch.device(device).type,
                episode_idx=episode_idx, total_timesteps_sampled=0)


def setup(ctx):
    from learning_to_adapt_torch.models.normalizer import Normalizer
    from learning_to_adapt_torch.samplers import Sampler
    cfg, dev, hp = ctx.config, ctx.device, ctx.hp
    env, model, policy = program.build(cfg, dev)
    gen = program.generator(dev, program.sub_seed(ctx.seed, 0))
    ws, bs = program.weights(hp, gen, dev)
    stats = program.normalizer_stats(hp, gen, dev)
    model.params = {'w': [w.clone() for w in ws],
                    'b': [b.clone() for b in bs]}
    model.normalizer = Normalizer(**{k: v.clone() for k, v in stats.items()})
    sampler = Sampler(env=env, policy=policy, seed=0,
                      max_path_length=hp.t_len, num_rollouts=hp.envs,
                      adapt_batch_size=cfg['run_config'].get(
                          'adapt_batch_size'), device=dev)
    state = dict(sampler=sampler, weights=(ws, bs), stats=stats)
    # the first warm call captures; the card then runs the calls slower
    # (same clocks, less power) for the first 1-16 s of sustained load,
    # so set-up goes on calling for warm_seconds
    t0, k = time.perf_counter(), 0
    while k == 0 or time.perf_counter() - t0 < ctx.traffic['warm_seconds']:
        _call(state, program.sub_seed(ctx.seed, 1, k), k + 1)
        k += 1
    return state


def _call(state, call_seed, episode_idx):
    sampler = state['sampler']
    sampler.load_state_dict(_state_dict(sampler.device, call_seed,
                                        episode_idx))
    return sampler.obtain_samples(random=False)


def window(ctx, state):
    hp = ctx.hp
    calls, traced, traced_s, seconds = [], None, 0.0, []
    t0 = time.perf_counter()
    while True:
        t_call = time.perf_counter()
        k = len(calls)
        call_seed, episode_idx = program.sub_seed(ctx.seed, 2, k), k + 1
        if ctx.trace and traced is None:
            traced, paths = trace.profile(
                lambda: _call(state, call_seed, episode_idx))
            traced_s = time.perf_counter() - t_call
            traced.work = dict(env_steps=hp.envs * hp.t_len,
                               steps=hp.t_len)
        else:
            paths = _call(state, call_seed, episode_idx)
        calls.append((call_seed, episode_idx, paths))
        seconds.append(time.perf_counter() - t_call)
        wall = time.perf_counter() - t0
        # a traced run measures `seconds` of unprofiled calls besides
        if wall - traced_s >= ctx.seconds:
            break
    steps = hp.envs * hp.t_len
    untraced = len(calls) - (traced is not None)
    state['calls'] = calls
    return dict(
        attempted=len(calls), failed=0, call_seconds=seconds,
        end_to_end=dict(env_steps_per_s=steps * len(calls) / wall),
        trace=traced,
        # the wall time a step of the window's calls took with no profiler
        # on (the traced call's time left out), for the step's mfu
        wall_per_step=((wall - traced_s) / (untraced * hp.t_len)
                       if untraced else None))


def release(state):
    state.pop('sampler', None)


def readings(ctx, state, mode='program'):
    return sampling.readings(ctx.config, ctx.hp, state['calls'],
                             state['weights'], state['stats'], ctx.traffic,
                             ctx.seed, ctx.device, mode)
