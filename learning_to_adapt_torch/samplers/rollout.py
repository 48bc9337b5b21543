"""Rollout engine (samplers/rollout.py make_rollout_fn), GrBAL and random
branches.

Per step, for all envs at once:
  [per-env fast adaptation on the trailing window (GrBAL)]
  -> MPC planner over the learned model (candidates x envs in one batch)
  -> batched physics step.

The time axis runs in segments (default <= 125 steps) as in the JAX
package, where a segment is the unit that compiles; here a segment is the
unit of Python loop whose outputs are stacked on the device. The carry
(env states, adaptation window, generator) stays on the device, and no step
reads a value back to the host: the step index and the adaptation gate are
host integers.

The planner's params (adapted, or the pre-update set broadcast to every env)
are packed for the fused-MLP kernel once per step, and the horizon's
predictions reuse the pack.

Each step's parts are labelled for torch.profiler: 'rollout.plan' (with
'rollout.adapt' inside it once adaptation is on, and 'rollout.pack') and
'rollout.env_step'.
"""
import torch
from torch.profiler import record_function

from learning_to_adapt_torch.models.meta_mlp import MetaMLPDynamicsModel
from learning_to_adapt_torch.ops.fused_mlp import pack_weights


def _segment_len(t_len, target=125):
    """Largest divisor of t_len that is <= target."""
    best = 1
    for d in range(1, min(target, t_len) + 1):
        if t_len % d == 0:
            best = d
    return best


def make_rollout_fn(env, policy, dynamics_model, num_rollouts,
                    max_path_length, adapt_batch_size=None, random=False):
    """Builds the rollout function.

    env: NormalizedEnv; policy: MPCController.
    Returns fn(params, normalizer, generator, episode_idx) -> paths dict of
    tensors [num_rollouts, T, ...]. fn.init_carry and fn.step_fn are exposed
    for tests.
    """
    m = num_rollouts
    t_len = max_path_length
    seg = _segment_len(t_len)
    n_segments = t_len // seg
    base_env = env.wrapped_env if hasattr(env, 'wrapped_env') else env
    obs_dim = base_env.obs_dim
    act_dim = base_env.act_dim
    is_meta = isinstance(dynamics_model, MetaMLPDynamicsModel)
    if not is_meta and not random:
        raise NotImplementedError('only the GrBAL meta-MLP model is ported')
    a_bs = adapt_batch_size

    def init_carry(generator, episode_idx):
        states = env.reset(m, episode_idx, generator)
        hist = None
        if a_bs:
            hist_obs = torch.zeros((m, a_bs + 1, obs_dim),
                                   dtype=states.obs.dtype,
                                   device=states.obs.device)
            hist_obs[:, -1] = states.obs
            hist_act = torch.zeros((m, a_bs, act_dim), dtype=states.obs.dtype,
                                   device=states.obs.device)
            hist = (hist_obs, hist_act)
        return states, hist

    def plan_actions(params, norm, obs, hist, t, generator, candidates):
        if random:
            u = torch.rand((m, act_dim), generator=generator,
                           dtype=obs.dtype, device=obs.device)
            return 2.0 * u - 1.0
        if a_bs is not None and t > a_bs + 1:
            # per-env fast adaptation on the trailing window: the last a_bs
            # transitions are (h_obs[:-1], h_act, h_obs[1:])
            h_obs, h_act = hist
            with record_function('rollout.adapt'):
                merged = dynamics_model.adapt_fn(
                    params, norm, h_obs[:, :-1], h_act, h_obs[:, 1:])
        else:
            # before the gate every env plans with the pre-update params
            merged = dynamics_model.broadcast_params(params, m)
        with record_function('rollout.pack'):
            packed = pack_weights(merged['w'], merged['b'])

        def predict(o_rows, a_rows):
            per = o_rows.shape[0] // m
            out = dynamics_model.predict_adapted_fn(
                packed, norm, o_rows.reshape(m, per, -1),
                a_rows.reshape(m, per, -1))
            return out.reshape(o_rows.shape[0], -1)
        return policy.plan_fn(predict, obs, generator, candidates=candidates)

    def step_fn(params, norm, carry, t, generator, candidates=None):
        """One step at global step t (a host int). Returns (carry, out)."""
        states, hist = carry
        obs_before = states.obs
        with record_function('rollout.plan'):
            actions = plan_actions(params, norm, obs_before, hist, t,
                                   generator, candidates)
        with record_function('rollout.env_step'):
            states, obs_after, rewards, dones, _ = env.step(states, actions)
        if a_bs:
            h_obs, h_act = hist
            h_obs = torch.cat([h_obs[:, 1:], obs_after[:, None]], dim=1)
            h_act = torch.cat([h_act[:, 1:], actions[:, None]], dim=1)
            hist = (h_obs, h_act)
        out = dict(observations=obs_before, actions=actions,
                   rewards=rewards, dones=dones,
                   next_observations=obs_after,
                   qpos=states.phys.qpos, qvel=states.phys.qvel)
        return (states, hist), out

    def segment(params, norm, carry, t0, generator):
        """`seg` steps from global step t0; outputs stacked [m, seg, ...]."""
        outs = []
        for t in range(t0, t0 + seg):
            carry, out = step_fn(params, norm, carry, t, generator)
            outs.append(out)
        return carry, {k: torch.stack([o[k] for o in outs], dim=1)
                       for k in outs[0]}

    @torch.no_grad()
    def rollout(params, norm, generator, episode_idx):
        carry = init_carry(generator, episode_idx)
        chunks = []
        for s in range(n_segments):
            carry, outs = segment(params, norm, carry, s * seg, generator)
            chunks.append(outs)
        return {k: torch.cat([c[k] for c in chunks], dim=1)
                for k in chunks[0]}

    rollout.init_carry = init_carry
    rollout.step_fn = step_fn
    return rollout
