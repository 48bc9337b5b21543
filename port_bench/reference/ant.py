"""The crippled-leg Ant as the reference runs it, and what decides the
`correct` of a cell sampling it (GrBAL on AntEnv, task 'cripple').

The env follows its published definition (learning_to_adapt's
envs/ant_env.py, arXiv:1803.11347 §6) on the reference's C++ physics
(reference/oracle.py) in f64, RK4 as ant.xml asks:

obs      [qpos, qvel, torso rotation matrix (row-major), torso subtree
         COM]: 15 + 14 + 9 + 3 = 41
reward   torso subtree COM x velocity + 0.05 (no control or contact cost)
reset    with reset_every_episode from the second episode on, one leg
         drawn per env from the cripple set, then the pose perturbed from
         init_qpos by 0.01 (qpos) and 0.1 (qvel) standard normals, in
         that order from one generator
cripple  leg l (0-3): its hip and ankle actuators zeroed, its upper and
         lower geoms halved in radius and half-length and the lower one
         moved onto the upper one (collision only: the inertia stays)
planner  the model's reward along its predictions, (x_com' - x_com) / dt
         + 0.05, x_com the observation's third-last entry

`readings` gives the two numbers of reference/sampling.py, physics_gap
and planner_gap, with the same choice of calls and steps, this env in the
Cheetah's place and the Ant's planner returns; physics_gap takes, of
each env in each checked call, the median of its transitions' gaps, and
of those the widest, where the Cheetah's takes the widest transition's
gap (`statistic`). Besides 'program' and 'control' it has a mode
'fault', the reference with a fault in the program's place: each
crippled env stepped with the next leg crippled in place of its own, and
the planner choosing by the returns of the first half of its horizon (5
steps of 10)."""
import dataclasses

import numpy as np
import torch

from port_bench.lib.precision import RoundedProducts
from port_bench.reference import models, oracle, sampling
from port_bench.reference.physics import model_defs, spec

UNSTABLE_QVEL = 150.0
ALIVE_BONUS = 0.05
#: leg l of the task: its hip and ankle joints (each driven by the
#: actuator of its name) and its upper and lower leg geoms, by name in
#: ant.xml
LEGS = (('hip_1', 'ankle_1', 'left_leg_geom', 'left_ankle_geom'),
        ('hip_2', 'ankle_2', 'right_leg_geom', 'right_ankle_geom'),
        ('hip_3', 'ankle_3', 'back_leg_geom', 'third_ankle_geom'),
        ('hip_4', 'ankle_4', 'rightback_leg_geom', 'fourth_ankle_geom'))
#: no leg crippled (the first episode of reset_every_episode)
NONE = -1


class Ant:
    def __init__(self, config, device):
        self.model = m = model_defs.get_model(config['physics']['model'])
        self.native = oracle.Native(m)
        self.device = torch.device(device)
        self.task = config['run_config']['task']
        self.cripple_set = tuple(config['physics']['cripple_set'])
        self.reset_every_episode = config['physics']['reset_every_episode']
        self.frame_skip = m.frame_skip
        self.dt = m.timestep
        self.torso = m.body_id('torso')
        nominal = spec.default_mutable(m, np.float64)
        self.mms = {NONE: nominal}
        self.masks = {NONE: np.ones(m.nu)}
        for leg in range(len(LEGS)):
            self.mms[leg], self.masks[leg] = self.crippled(nominal, leg)

    def crippled(self, mm, leg):
        """(mutable model, actuator mask) of the Ant with leg `leg`
        crippled."""
        m = self.model
        hip, ankle, upper, lower = LEGS[leg]
        mask = np.ones(m.nu)
        mask[[m.actuator_names.index(hip),
              m.actuator_names.index(ankle)]] = 0.0
        size, pos = np.array(mm.geom_size), np.array(mm.geom_pos)
        up, lo = m.geom_id(upper), m.geom_id(lower)
        size[[up, lo], :2] *= 0.5
        pos[lo] = pos[up]
        return dataclasses.replace(mm, geom_size=size, geom_pos=pos), mask

    def reset_draws(self, generator, n, episode_idx):
        """(qpos, qvel, legs) of n envs: f32 states and the crippled leg
        of each (int64, NONE for none), drawn from generator in the task's
        order."""
        dev, f32 = self.device, torch.float32
        legs = torch.full((n,), NONE, dtype=torch.int64, device=dev)
        if self.task is not None and (not self.reset_every_episode or
                                      episode_idx > 0):
            pick = torch.randint(len(self.cripple_set), (n,),
                                 generator=generator, device=dev)
            legs = torch.as_tensor(self.cripple_set, device=dev)[pick]
        m = self.model
        noise = torch.randn((n, m.nq + m.nv), generator=generator,
                            dtype=f32, device=dev)
        qpos = torch.as_tensor(np.asarray(m.init_qpos), dtype=f32,
                               device=dev) + 0.01 * noise[:, :m.nq]
        return qpos, 0.1 * noise[:, m.nq:], legs

    def _forward(self, qpos, qvel, mm):
        """(torso rotation (3, 3), subtree COMs (nbody, 3), subtree COM
        velocities (nbody, 3)) of one state."""
        nb = self.model.nbody
        f64, ptr = oracle._f64, oracle._ptr
        xpos, ximat = np.empty((nb, 3)), np.empty((nb, 3, 3))
        com, comvel = np.empty((nb, 3)), np.empty((nb, 3))
        self.native.lib.ltao_forward(
            self.native.h, ptr(f64(qpos)), ptr(f64(qvel)),
            ptr(f64(mm.body_mass)), ptr(f64(mm.geom_pos)), ptr(xpos),
            ptr(ximat), ptr(com), ptr(comvel))
        return ximat[self.torso], com, comvel

    def _observe(self, qpos, qvel, mm):
        rot, com, comvel = self._forward(qpos, qvel, mm)
        return (np.concatenate([qpos, qvel, rot.reshape(-1),
                                com[self.torso]]), comvel[self.torso])

    def observe(self, qpos, qvel):
        """The observations (E, 41) of states (E, nq), (E, nv), f64 (the
        crippling changes no mass, so the nominal model serves)."""
        q, v = (x.detach().cpu().double().numpy() for x in (qpos, qvel))
        obs = np.stack([self._observe(a, b, self.mms[NONE])[0]
                        for a, b in zip(q, v)])
        return torch.as_tensor(obs, device=qpos.device)

    def step(self, qpos, qvel, action, legs, rounding=None):
        """One env step of each row from (qpos, qvel) with planner-space
        actions in [-1, 1] and the row's crippled leg: (qpos', qvel',
        obs', reward), f64 tensors on the inputs' device. rounding: None
        for f64 products, 'tf32' for the control's."""
        m = self.model
        q0, v0, a = (x.detach().cpu().double().numpy()
                     for x in (qpos, qvel, action))
        lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
        ctrl = np.clip(lo + (a + 1.0) * 0.5 * (hi - lo), lo, hi)
        rows = []
        for q, v, c, leg in zip(q0, v0, ctrl, legs.tolist()):
            mm = self.mms[leg]
            c = c * self.masks[leg]
            q1, v1 = q, v
            for _ in range(self.frame_skip):
                q1, v1 = self.native.step(q1, v1, c, mm, rounding)
            if (not (np.isfinite(q1).all() and np.isfinite(v1).all()) or
                    np.abs(v1).max() > UNSTABLE_QVEL):
                q1, v1 = q, np.zeros_like(v)
            obs, comvel = self._observe(q1, v1, mm)
            rows.append((q1, v1, obs, comvel[0] + ALIVE_BONUS))
        dev = qpos.device
        return tuple(torch.as_tensor(np.stack([r[i] for r in rows]),
                                     device=dev) for i in range(4))


def planner_returns(ws, bs, stats, obs0, cand, dt, discount, nonlinearity):
    """Random shooting's model returns on the Ant, as
    models.planner_returns with the Ant's model reward: (S, n), the sum
    over the horizon of discount^h ((x_com' - x_com) / dt + 0.05)."""
    o = obs0.unsqueeze(1).expand(-1, cand.shape[2], -1)
    ret = torch.zeros(o.shape[:2], dtype=o.dtype, device=o.device)
    for h in range(cand.shape[0]):
        a = cand[h]
        x = torch.cat([models.norm(o, stats, 'obs'),
                       models.norm(a, stats, 'act')], dim=-1)
        delta = models.mlp(ws, bs, x, nonlinearity)
        nxt = o + (delta * (stats['delta_std'] + models.EPS) +
                   stats['delta_mean'])
        ret = ret + (discount ** h) * (
            (nxt[..., -3] - o[..., -3]) / dt + ALIVE_BONUS)
        o = nxt
    return ret


def statistic(gaps):
    """physics_gap of one call's transitions, gaps (envs, steps): the
    widest over envs of the median of the env's gaps. A median, not the
    widest gap: a crippled leg rests on its ankle's joint limit, and where
    a limit (or contact) row sits at its activation edge the f32 program
    and the f64 reference can part on whether it acts in one of RK4's four
    stages, which moves that joint's velocity by ~1e-3 in that step alone
    (PERF.md §2); a lower precision or a wrong model moves most of an
    env's steps. Each env's own, so that a fault in one env alone counts
    in full."""
    return float(torch.quantile(gaps, 0.5, dim=1).max())


def transition_gaps(env, hp, paths, qpos0, qvel0, legs, steps, mode,
                    device):
    """(the reset's observation against the reference's, the gaps (envs,
    steps) of the checked transitions): each transition's the widest over
    its next qpos, qvel, observation and reward of |p - r| / (1 + |r|),
    the reference stepping in f64 from the program's state before the step
    with the program's action. In the program's place: its paths
    ('program'), the control's step ('control') or each crippled env
    stepped with the next leg crippled ('fault')."""
    dev = torch.device(device)
    e = torch.as_tensor(np.repeat(np.arange(hp.envs), len(steps)),
                        device=dev)
    t = np.tile(np.asarray(steps), hp.envs)
    first = torch.as_tensor(t == 0, device=dev)[:, None]
    prev = torch.as_tensor(np.maximum(t - 1, 0), device=dev)
    t = torch.as_tensor(t, device=dev)

    def path(key):
        return torch.as_tensor(paths[key], device=dev)
    qpos_p, qvel_p = path('qpos'), path('qvel')
    qpos = torch.where(first, qpos0[e], qpos_p[e, prev])
    qvel = torch.where(first, qvel0[e], qvel_p[e, prev])
    act = path('actions')[e, t]
    ref = env.step(qpos, qvel, act, legs[e])
    obs0_ref = env.observe(qpos0, qvel0)
    if mode == 'program':
        out = (qpos_p[e, t], qvel_p[e, t], path('next_observations')[e, t],
               path('rewards')[e, t])
        obs0 = path('observations')[:, 0]
    elif mode == 'control':
        out = env.step(qpos, qvel, act, legs[e], rounding='tf32')
        obs0 = obs0_ref
    else:
        wrong = torch.where(legs == NONE, legs, (legs + 1) % len(LEGS))
        out = env.step(qpos, qvel, act, wrong[e])
        obs0 = obs0_ref
    gaps = torch.stack([
        ((o.double() - r).abs() / (1 + r.abs())).reshape(len(r), -1).amax(1)
        for o, r in zip(out, ref)]).amax(0)
    return sampling.rel_gap(obs0, obs0_ref), gaps.reshape(hp.envs, -1)


def _planner(env, hp, paths, cands, weights, stats, steps, mode, device):
    """planner_gap of the checked steps (every env at each), as
    reference/sampling.py's with the Ant's returns; mode 'fault' picks by
    the returns of the horizon's first half."""
    ws, bs = weights
    dev = torch.device(device)
    obs = torch.as_tensor(paths['observations'], device=dev)
    act = torch.as_tensor(paths['actions'], device=dev)
    n = hp.n_candidates
    checks = [(e, t) for t in steps for e in range(hp.envs)]
    worst = 0.0
    for i in range(0, len(checks), sampling.CHUNK):
        part = checks[i:i + sampling.CHUNK]
        cand = torch.stack([cands[t][:, e * n:(e + 1) * n]
                            for e, t in part], dim=1)       # (H, S, n, A)
        obs0 = torch.stack([obs[e, t] for e, t in part])
        pw, pb = sampling._step_params(hp, part, ws, bs, stats, obs, act,
                                       None)
        with RoundedProducts('bf16'):
            ref = planner_returns(pw, pb, stats, obs0, cand, env.dt,
                                  hp.discount, hp.nonlinearity)
        if mode == 'program':
            chosen = torch.stack([act[e, t] for e, t in part])
            hit = (cand[0] == chosen[:, None, :]).all(-1)       # (S, n)
            if not bool(hit.any(-1).all()):
                return sampling.MISSING
            pick = hit.int().argmax(-1)
        else:
            product, horizon = 'bf16', (cand.shape[0] + 1) // 2
            if mode == 'control':
                pw, pb = sampling._step_params(hp, part, ws, bs, stats, obs,
                                               act, 'tf32')
                product, horizon = 'fp8', cand.shape[0]
            with RoundedProducts(product):
                pick = torch.argmax(planner_returns(
                    pw, pb, stats, obs0, cand[:horizon], env.dt, hp.discount,
                    hp.nonlinearity), dim=1)
        best = ref.max(dim=1).values
        got = ref.gather(1, pick[:, None])[:, 0]
        gap = (best - got) / ref.std(dim=1)
        worst = max(worst, float(gap.max()))
    return worst


def readings(config, hp, calls, weights, stats, traffic, seed, device,
             mode='program'):
    """{'physics_gap', 'planner_gap'} of the checked calls, the calls and
    steps picked from the run's seed as reference/sampling.py picks them.
    mode 'program' judges the program's paths; 'control' and 'fault' put
    the control or the fault in its place."""
    env = Ant(config, device)
    rng = np.random.RandomState(seed % (2 ** 32))
    k = min(traffic['check']['calls'], len(calls))
    picked = sorted({len(calls) - 1} | set(
        rng.choice(len(calls), size=k, replace=False).tolist()))[-k:]
    phys = plan = 0.0
    for i in picked:
        call_seed, episode_idx, paths = calls[i]
        p_steps = sampling.chosen_steps(hp, rng,
                                        traffic['check']['physics_steps'])
        q_steps = sampling.chosen_steps(hp, rng,
                                        traffic['check']['planner_steps'])
        qpos0, qvel0, legs, cands = sampling.draws(
            env, hp, call_seed, episode_idx, q_steps, device)
        reset, gaps = transition_gaps(env, hp, paths, qpos0, qvel0, legs,
                                      p_steps, mode, device)
        phys = max(phys, reset, statistic(gaps))
        plan = max(plan, _planner(env, hp, paths, cands, weights, stats,
                                  q_steps, mode, device))
    return dict(physics_gap=phys, planner_gap=plan)
