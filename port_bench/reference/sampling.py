"""What decides a sampling cell's `correct`: the paths of whole policy
calls held, step by step, against the plain reference.

The reference follows the program step by step from the program's own
recorded state (the qpos and qvel each step leaves), as a chaotic
rollout cannot be followed from its start; the start itself, the reset's
observation, is checked on its own. For each call it draws again, from
the call's seed, what the program drew: the reset (crippled actuators,
pose perturbation) and each step's uniform candidate actions.

Two numbers, each the widest over the checked steps and envs:

physics_gap  |program - reference| / (1 + |reference|) of the reset's
             observation and, for each checked transition, of the next
             qpos, qvel, observation and reward, the reference stepping in
             f64 (its C++ physics, reference/oracle.py) from the
             program's state before the step with the program's action;
planner_gap  how far below the best of the step's candidates, by the
             reference's model returns, the program's chosen candidate
             lies, in units of the candidates' standard deviation: the
             reference adapts the meta-parameters on the path's trailing
             window (f32, GrBAL) and rolls every candidate through the
             model with bf16 products and f32 accumulation. A chosen
             action that is none of the step's candidates reads MISSING.

A control stands in the program's place for the lower precision: the
C++ physics with the operands of its dense products rounded to TF32's
10-bit mantissa, the planner's forward with fp8
(e4m3, one scale a tensor) products and the adaptation with TF32."""
import numpy as np
import torch

from port_bench.lib.precision import RoundedProducts
from port_bench.reference import models
from port_bench.reference.env import Cheetah
from port_bench.roofline.counts import adapting

MISSING = 1e6
CHUNK = 32          # planner checks a batch


def rel_gap(p, r):
    p, r = p.double(), r.double()
    return float((torch.abs(p - r) / (1 + torch.abs(r))).max())


def draws(env, hp, call_seed, episode_idx, steps, device):
    """The reset (qpos, qvel, mask) and {t: candidates (H, envs*n, A)} of
    the checked steps, drawn again from the call's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(call_seed)
    qpos, qvel, mask = env.reset_draws(gen, hp.envs, episode_idx)
    rows = hp.n_candidates * hp.envs
    want, cands = set(steps), {}
    for t in range(max(steps) + 1):
        u = torch.rand((hp.horizon, rows, hp.act_dim), generator=gen,
                       dtype=torch.float32, device=device)
        if t in want:
            cands[t] = -1.0 + 2.0 * u
    return qpos, qvel, mask, cands


def chosen_steps(hp, rng, n):
    """Steps to check in a call: the first, the gate's two sides, the
    last, and more drawn from rng, n in all."""
    fixed = {0, hp.t_len - 1}
    if hp.adapt_batch_size:
        fixed |= {hp.adapt_batch_size + 1, hp.adapt_batch_size + 2}
    rest = [t for t in range(hp.t_len) if t not in fixed]
    extra = rng.choice(rest, size=max(n - len(fixed), 0), replace=False)
    return sorted(fixed | {int(t) for t in extra})


def _physics(env, hp, paths, qpos0, qvel0, mask, steps, mode, device):
    """physics_gap of the checked transitions: the program's outputs
    (mode 'program') or the control's, against the f64 reference."""
    e = np.repeat(np.arange(hp.envs), len(steps))
    t = np.tile(np.asarray(steps), hp.envs)
    dev = torch.device(device)

    def path(key):
        return torch.as_tensor(paths[key], device=dev)
    qpos_p, qvel_p = path('qpos'), path('qvel')
    first = torch.as_tensor(t == 0, device=dev)[:, None]
    prev = torch.as_tensor(np.maximum(t - 1, 0), device=dev)
    ei = torch.as_tensor(e, device=dev)
    ti = torch.as_tensor(t, device=dev)
    qpos = torch.where(first, qpos0[ei], qpos_p[ei, prev])
    qvel = torch.where(first, qvel0[ei], qvel_p[ei, prev])
    act = path('actions')[ei, ti]
    ref = env.step(qpos, qvel, act, mask[ei])
    obs0_ref = env.observe(qpos0, qvel0)
    if mode == 'program':
        out = (qpos_p[ei, ti], qvel_p[ei, ti],
               path('next_observations')[ei, ti], path('rewards')[ei, ti])
        obs0 = path('observations')[:, 0]
    else:
        out = env.step(qpos, qvel, act, mask[ei], rounding='tf32')
        obs0 = env.observe(qpos0, qvel0)
    return max([rel_gap(obs0, obs0_ref)] +
               [rel_gap(o, r) for o, r in zip(out, ref)])


def _planner(env, hp, paths, cands, weights, stats, steps, mode, device):
    """planner_gap of the checked steps (every env at each)."""
    ws, bs = weights
    dev = torch.device(device)
    obs = torch.as_tensor(paths['observations'], device=dev)
    act = torch.as_tensor(paths['actions'], device=dev)
    n = hp.n_candidates
    checks = [(e, t) for t in steps for e in range(hp.envs)]
    worst = 0.0
    for i in range(0, len(checks), CHUNK):
        part = checks[i:i + CHUNK]
        cand = torch.stack([cands[t][:, e * n:(e + 1) * n]
                            for e, t in part], dim=1)       # (H, S, n, A)
        obs0 = torch.stack([obs[e, t] for e, t in part])
        returns = {}
        for which in (('reference', 'control') if mode == 'control'
                      else ('reference',)):
            product, inner = (('bf16', None) if which == 'reference'
                              else ('fp8', 'tf32'))
            pw, pb = _step_params(hp, part, ws, bs, stats, obs, act, inner)
            with RoundedProducts(product):
                returns[which] = models.planner_returns(
                    pw, pb, stats, obs0, cand, env.dt, hp.discount,
                    hp.nonlinearity)
        ref = returns['reference']
        if mode == 'control':
            pick = torch.argmax(returns['control'], dim=1)
        else:
            chosen = torch.stack([act[e, t] for e, t in part])
            hit = (cand[0] == chosen[:, None, :]).all(-1)       # (S, n)
            if not bool(hit.any(-1).all()):
                return MISSING
            pick = hit.int().argmax(-1)
        best = ref.max(dim=1).values
        got = ref.gather(1, pick[:, None])[:, 0]
        gap = (best - got) / ref.std(dim=1)
        worst = max(worst, float(gap.max()))
    return worst


def _step_params(hp, part, ws, bs, stats, obs, act, inner):
    """The parameters each checked step plans with, one set a check:
    GrBAL's adapted on the trailing window once adapting (`inner`, the
    adaptation's rounding, None for f32), else the meta-parameters."""
    s = len(part)
    pw = [w.unsqueeze(0).expand(s, *w.shape) for w in ws]
    pb = [b.unsqueeze(0).expand(s, *b.shape) for b in bs]
    todo = [i for i, (_, t) in enumerate(part) if adapting(hp, t)]
    if not todo:
        return pw, pb
    k = hp.adapt_batch_size
    o = torch.stack([obs[part[i][0], part[i][1] - k:part[i][1]]
                     for i in todo])
    a = torch.stack([act[part[i][0], part[i][1] - k:part[i][1]]
                     for i in todo])
    nx = torch.stack([obs[part[i][0], part[i][1] - k + 1:part[i][1] + 1]
                      for i in todo])
    if inner is None:
        aw, ab = models.adapt(ws, bs, stats, o, a, nx, hp.inner_lr,
                              hp.nonlinearity)
    else:
        with RoundedProducts(inner):
            aw, ab = models.adapt(ws, bs, stats, o, a, nx, hp.inner_lr,
                                  hp.nonlinearity)
    idx = torch.as_tensor(todo, device=obs.device)
    pw = [p.clone().index_copy_(0, idx, q) for p, q in zip(pw, aw)]
    pb = [p.clone().index_copy_(0, idx, q) for p, q in zip(pb, ab)]
    return pw, pb


def readings(config, hp, calls, weights, stats, traffic, seed, device,
             mode='program'):
    """{'physics_gap', 'planner_gap'} of the checked calls. calls: (call
    seed, episode index, paths) of each call the window finished; which of
    them, and which steps, are drawn from the run's seed. mode 'program'
    judges the program's paths; 'control' puts the control in its place."""
    env = Cheetah(config, device)
    rng = np.random.RandomState(seed % (2 ** 32))
    k = min(traffic['check']['calls'], len(calls))
    picked = sorted({len(calls) - 1} | set(
        rng.choice(len(calls), size=k, replace=False).tolist()))[-k:]
    phys = plan = 0.0
    for i in picked:
        call_seed, episode_idx, paths = calls[i]
        p_steps = chosen_steps(hp, rng, traffic['check']['physics_steps'])
        q_steps = chosen_steps(hp, rng, traffic['check']['planner_steps'])
        qpos0, qvel0, mask, cands = draws(env, hp, call_seed, episode_idx,
                                          q_steps, device)
        phys = max(phys, _physics(env, hp, paths, qpos0, qvel0, mask,
                                  p_steps, mode, device))
        plan = max(plan, _planner(env, hp, paths, cands, weights, stats,
                                  q_steps, mode, device))
    return dict(physics_gap=phys, planner_gap=plan)
