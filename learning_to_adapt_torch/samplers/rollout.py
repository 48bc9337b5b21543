"""Rollout engine (samplers/rollout.py make_rollout_fn): the random,
GrBAL, MB-MPC and ReBAL branches.

Per step, for all envs at once:
  [per-env fast adaptation on the trailing window (GrBAL)]
  -> MPC planner over the learned model (candidates x envs in one batch),
     threading the recurrent model's hidden state (ReBAL)
  -> batched physics step.

The time axis runs in segments (default <= 125 steps) as in the JAX
package, where a segment is the unit that compiles; here a segment is the
unit of Python loop whose outputs are stacked on the device. The carry
(env states, then the GrBAL adaptation window or the ReBAL hidden state,
which starts at zero on every call) stays on the device, and no step reads
a value back to the host: the step index and the adaptation gate are host
integers.

The planner's MLP weights are packed for the fused-MLP kernel once per
step for GrBAL (adapted, or the pre-update set broadcast to every env), and
once per sampling call for MB-MPC, whose weights do not change within it;
the horizon's predictions reuse the pack.

With a mesh (parallel/mesh.py) each rank steps its share of the envs, the
rows [r*m/W, (r+1)*m/W) for rank r of W on the 'env' axis, and no step makes
a collective. Every random draw of a step (the reset and its tasks, the
random actions, the planner's candidates or normals, the action noise) is
made for all m envs from the sampler's generator, seeded alike on every
rank, in the order a 1-rank run makes it; each rank keeps its rows, so the
W-rank paths are the 1-rank paths.

Each step's parts are labelled for torch.profiler: 'rollout.plan' (with
'rollout.adapt' inside it once adaptation is on, and 'rollout.pack') and
'rollout.env_step'; MB-MPC's one pack per call is labelled 'rollout.pack'.
"""
import torch
from torch.profiler import record_function

from learning_to_adapt_torch.envs.base import state_rows
from learning_to_adapt_torch.models.meta_mlp import MetaMLPDynamicsModel
from learning_to_adapt_torch.models.mlp import MLPDynamicsModel
from learning_to_adapt_torch.models.rnn import RNNDynamicsModel
from learning_to_adapt_torch.ops.fused_mlp import pack_weights
from learning_to_adapt_torch.parallel import mesh as par_mesh


def _segment_len(t_len, target=125):
    """Largest divisor of t_len that is <= target."""
    best = 1
    for d in range(1, min(target, t_len) + 1):
        if t_len % d == 0:
            best = d
    return best


def make_rollout_fn(env, policy, dynamics_model, num_rollouts,
                    max_path_length, adapt_batch_size=None, random=False,
                    ablate_hidden=None, ablate_warmup=16, mesh=None):
    """Builds the rollout function.

    env: NormalizedEnv; policy: MPCController, or RNNMPCController for a
    recurrent model. Returns fn(params, normalizer, generator, episode_idx)
    -> paths dict of tensors [num_rollouts, T, ...], or with `mesh` this
    rank's share [num_rollouts / W, T, ...] (num_rollouts must divide over
    the mesh's 'env' axis). fn.init_carry and fn.step_fn are exposed for
    tests.

    ablate_hidden (recurrent models only) isolates ReBAL's adaptation, the
    hidden state's update by each real transition:
      'zero'    the model plans from the zero hidden state every step
      'frozen'  the hidden state advances for the first `ablate_warmup`
                steps, then stays as it is for the rest of the path
    """
    n_all = num_rollouts
    rows = par_mesh.shard_rows(mesh, n_all)
    m = rows.stop - rows.start
    t_len = max_path_length
    seg = _segment_len(t_len)
    n_segments = t_len // seg
    base_env = env.wrapped_env if hasattr(env, 'wrapped_env') else env
    obs_dim = base_env.obs_dim
    act_dim = base_env.act_dim
    is_meta = isinstance(dynamics_model, MetaMLPDynamicsModel)
    is_rnn = isinstance(dynamics_model, RNNDynamicsModel)
    is_mlp = isinstance(dynamics_model, MLPDynamicsModel)
    if ablate_hidden not in (None, 'zero', 'frozen'):
        raise ValueError(f'ablate_hidden {ablate_hidden!r} is not None, '
                         "'zero' or 'frozen'")
    if ablate_hidden and not is_rnn:
        raise ValueError('ablate_hidden applies to recurrent models only')
    # the GrBAL window; the recurrent model adapts by its hidden state
    a_bs = None if is_rnn else adapt_batch_size

    def init_carry(generator, episode_idx):
        """(env states, the GrBAL window (h_obs, h_act) or the recurrent
        model's zero hidden state or None)."""
        states = env.reset(n_all, episode_idx, generator)
        if mesh is not None:
            states = state_rows(states, rows)
        if is_rnn:
            return states, dynamics_model.get_initial_hidden(m)
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

    def plan_recurrent(params, norm, obs, hidden, t, generator, candidates,
                       normals):
        def predict_h(o, a, h):
            return dynamics_model.predict_fn(params, norm, o, a, h)
        h_in = (dynamics_model.get_initial_hidden(m)
                if ablate_hidden == 'zero' else hidden)
        actions, h_new = policy.plan_fn_recurrent(
            predict_h, obs, h_in, generator, candidates=candidates,
            normals=normals)
        if ablate_hidden == 'zero' or (ablate_hidden == 'frozen' and
                                       t >= ablate_warmup):
            h_new = hidden  # the carry stays as it was
        return actions, h_new

    def plan_actions(params, norm, obs, hist, t, generator, candidates,
                     normals):
        if is_mlp:
            def predict(o_rows, a_rows):
                return dynamics_model.predict_fn(params, norm, o_rows, a_rows)
            return policy.plan_fn(predict, obs, generator,
                                  candidates=candidates, normals=normals)
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
        return policy.plan_fn(predict, obs, generator, candidates=candidates,
                              normals=normals)

    def draw_rows(generator, like):
        """The planner's draws for all envs, cut to this rank's envs: the
        candidate rows are env-major (n_candidates a env), the normals'
        env axis is their third."""
        candidates, normals = policy.draw(generator, n_all, **like)
        if candidates is not None:
            n = policy.n_candidates
            return candidates[:, rows.start * n:rows.stop * n], None
        return None, normals[:, :, rows]

    def step_fn(params, norm, carry, t, generator, candidates=None,
                normals=None):
        """One step at global step t (a host int). candidates / normals:
        the planner's draws for this rank's envs, injected
        (policies/planners.py), or None to draw them here. Returns (carry,
        out)."""
        states, aux = carry
        obs_before = states.obs
        like = dict(dtype=obs_before.dtype, device=obs_before.device)
        with record_function('rollout.plan'):
            if random:
                u = torch.rand((n_all, act_dim), generator=generator,
                               **like)[rows]
                actions = 2.0 * u - 1.0
            else:
                if candidates is None and normals is None:
                    candidates, normals = draw_rows(generator, like)
                if is_rnn:
                    actions, aux = plan_recurrent(params, norm, obs_before,
                                                  aux, t, generator,
                                                  candidates, normals)
                else:
                    actions = plan_actions(params, norm, obs_before, aux, t,
                                           generator, candidates, normals)
        noise = None
        if base_env.action_noise > 0:
            noise = torch.randn((n_all, act_dim), generator=generator,
                                **like)[rows]
        with record_function('rollout.env_step'):
            states, obs_after, rewards, dones, _ = env.step(states, actions,
                                                            noise)
        if a_bs:
            h_obs, h_act = aux
            h_obs = torch.cat([h_obs[:, 1:], obs_after[:, None]], dim=1)
            h_act = torch.cat([h_act[:, 1:], actions[:, None]], dim=1)
            aux = (h_obs, h_act)
        out = dict(observations=obs_before, actions=actions,
                   rewards=rewards, dones=dones,
                   next_observations=obs_after,
                   qpos=states.phys.qpos, qvel=states.phys.qvel)
        return (states, aux), out

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
        if is_mlp and not random:
            # one weight stream for every prediction of the call
            with record_function('rollout.pack'):
                params = dynamics_model.pack(params)
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
