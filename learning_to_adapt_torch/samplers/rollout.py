"""Rollout engine (samplers/rollout.py make_rollout_fn): the random,
GrBAL, MB-MPC and ReBAL branches.

Per step, for all envs at once:
  [per-env fast adaptation on the trailing window (GrBAL)]
  -> MPC planner over the learned model (candidates x envs in one batch),
     threading the recurrent model's hidden state (ReBAL)
  -> batched physics step.

The carry (env states, then the GrBAL adaptation window or the ReBAL
hidden state, which starts at zero on every call) stays on the device, and
no step reads a value back to the host: the step index and the host
branches it decides (`branch`: the adaptation gate, the frozen hidden
state's warm-up) are host integers.

Two callers run the same step function:

  eager      `rollout` runs the time axis in segments (default <= 125
             steps) as the JAX package does, each a Python loop of steps
             whose outputs are stacked on the device;
  compiled   CompiledRollout, the counterpart of the JAX package's
             segment_jit: the step on a static carry, captured once as a
             CUDA graph for each side of the host branches
             (models/captured.py StepGraph) and replayed for every step.

The rule is the compiled fits' (models/captured.py `captures`): compiled on
a CUDA device without a mesh or with a mesh over nccl (no step makes a
collective), eager on the CPU (the tests) and over gloo. Nothing falls
back: a capture that fails raises from the sampling call.

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

A step's parts are spans (utils/tracing.py): 'rollout.plan' (with
'rollout.adapt' inside it once adaptation is on, and 'rollout.pack') and
'rollout.env_step' (the action noise and the physics, each of its
dynamics passes the span 'physics.qacc' inside it). Eagerly they are
timed by the host; in a CompiledRollout captured with tracing on they are
the step graph's device stamps, which fire at every replay, and the host
span 'rollout.step' is around each replay. A call's other phases are
'rollout.reset' and 'rollout.prepare' (MB-MPC's one pack per call,
'rollout.pack', inside it).
"""
import dataclasses
import functools

import torch

from learning_to_adapt_torch.envs.base import (
    load_state, state_rows, static_state)
from learning_to_adapt_torch.models import captured
from learning_to_adapt_torch.models.meta_mlp import MetaMLPDynamicsModel
from learning_to_adapt_torch.models.mlp import MLPDynamicsModel
from learning_to_adapt_torch.models.optim import tree_leaves, tree_map
from learning_to_adapt_torch.models.rnn import RNNDynamicsModel
from learning_to_adapt_torch.ops.fused_mlp import pack_weights
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.utils import tracing


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
    the mesh's 'env' axis): a CompiledRollout where `captured.captures`
    holds for the env's device and the mesh, else the eager rollout.
    fn.eager is the eager rollout; fn.init_carry, fn.step_fn and
    fn.branch are exposed for tests.

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

    def branch(t):
        """The host branches step t takes: (per-env adaptation is on, the
        recurrent hidden state is frozen)."""
        return (not random and is_meta and bool(a_bs) and t > a_bs + 1,
                not random and ablate_hidden == 'frozen' and
                t >= ablate_warmup)

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
        if ablate_hidden == 'zero' or branch(t)[1]:
            h_new = hidden  # the carry stays as it was
        return actions, h_new

    def plan_actions(params, norm, obs, hist, t, generator, candidates,
                     normals):
        if is_mlp:
            def predict(o_rows, a_rows):
                return dynamics_model.predict_fn(params, norm, o_rows, a_rows)
            return policy.plan_fn(predict, obs, generator,
                                  candidates=candidates, normals=normals)
        if branch(t)[0]:
            # per-env fast adaptation on the trailing window: the last a_bs
            # transitions are (h_obs[:-1], h_act, h_obs[1:])
            h_obs, h_act = hist
            with tracing.span('rollout.adapt'):
                merged = dynamics_model.adapt_fn(
                    params, norm, h_obs[:, :-1], h_act, h_obs[:, 1:])
        else:
            # before the gate every env plans with the pre-update params
            merged = dynamics_model.broadcast_params(params, m)
        with tracing.span('rollout.pack'):
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
        with tracing.span('rollout.plan'):
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
        with tracing.span('rollout.env_step'):
            noise = None
            if base_env.action_noise > 0:
                noise = torch.randn((n_all, act_dim), generator=generator,
                                    **like)[rows]
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
            with tracing.span('rollout.pack'):
                params = dynamics_model.pack(params)
        with tracing.span('rollout.reset'):
            carry = init_carry(generator, episode_idx)
        chunks = []
        for s in range(n_segments):
            carry, outs = segment(params, norm, carry, s * seg, generator)
            chunks.append(outs)
        return {k: torch.cat([c[k] for c in chunks], dim=1)
                for k in chunks[0]}

    rollout.init_carry = init_carry
    rollout.step_fn = step_fn
    rollout.branch = branch
    rollout.eager = rollout
    device = base_env.device
    if not captured.captures(device, mesh):
        return rollout
    return CompiledRollout(
        rollout, t_len, device,
        dynamics_model.pack if is_mlp and not random else None)


def _leaves(tree):
    return [] if tree is None else tree_leaves(tree)


class CompiledRollout:
    """A rollout whose step runs on a static carry, captured once as a CUDA
    graph (models/captured.py StepGraph) for each side of the host
    branches (`branch`: GrBAL before and after its adaptation gate, ReBAL's
    frozen ablation before and after its warm-up; one graph otherwise) and
    replayed for every step of every call. The graphs are kept by the
    tracing state at their capture (`by_tracing`: tracing on -> {branch key:
    StepGraph}; `graphs` is the dict of the tracing state now). On a CPU
    device (the tests) the step runs as a plain call.

    The static carry holds the env states (`static_state`), the GrBAL
    window or the recurrent hidden state, the params and normalizer the
    step reads (for MB-MPC their pack, packed again in place at each
    call), the paths [m, T, ...] written at a device step counter, and the
    counter. A call draws its reset eagerly (as the JAX package runs
    init_jit apart from segment_jit), copies it, the params and the
    normalizer in, replays T steps and returns copies of the paths, which
    the next call does not overwrite.

    The steps draw from this object's own generator, registered with its
    graphs: a call sets it to the caller's generator's state and hands its
    state back at the end, so the draws are the eager rollout's and the
    caller's generator ends where the eager rollout leaves it."""

    def __init__(self, eager, t_len, device, pack=None):
        self.eager = eager
        self.init_carry = eager.init_carry
        self.step_fn = eager.step_fn
        self.branch = eager.branch
        self.t_len = t_len
        self.device = torch.device(device)
        self.pack = pack
        self.generator = torch.Generator(device=self.device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == 'cuda' else None)
        self.by_tracing = {}
        self.states = self.aux = self.params = self.norm = None
        self.step_params = self.paths = self.counter = None

    @torch.no_grad()
    def load_carry(self, carry):
        """Copies a carry (env states, aux) into the static one (made on
        the first call) and sets the step counter to 0."""
        states, aux = carry
        if self.states is None:
            self.states = dataclasses.replace(static_state(states),
                                              rng=self.generator)
            self.aux = None if aux is None else tree_map(torch.clone, aux)
            self.counter = torch.zeros(1, dtype=torch.int64,
                                       device=self.device)
        load_state(self.states, states)
        for d, s in zip(_leaves(self.aux), _leaves(aux), strict=True):
            d.copy_(s)
        self.counter.zero_()

    @torch.no_grad()
    def prepare(self, params, norm, carry):
        """Copies params, the normalizer and a carry into the static
        buffers (made on the first call); packs MB-MPC's weights."""
        if self.params is None:
            self.params = tree_map(torch.clone, params)
            self.norm = captured.clone_normalizer(norm)
        for d, s in zip(tree_leaves(self.params), tree_leaves(params),
                        strict=True):
            d.copy_(s)
        for d, s in zip(vars(self.norm).values(), vars(norm).values(),
                        strict=True):
            d.copy_(s)
        if self.pack is None:
            self.step_params = self.params
        else:
            with tracing.span('rollout.pack'):
                self.step_params = self.pack(self.params,
                                             out=self.step_params)
        self.load_carry(carry)

    @torch.no_grad()
    def step(self, t, candidates=None, normals=None):
        """One step at global step t (a host int, read for the branches
        only) on the static carry: its outputs go to the paths at the step
        counter, the next carry back into the static one. candidates /
        normals: injected draws, as for step_fn."""
        (states, aux), out = self.step_fn(
            self.step_params, self.norm, (self.states, self.aux), t,
            self.generator, candidates=candidates, normals=normals)
        if self.paths is None:
            self.paths = {k: torch.empty(
                (v.shape[0], self.t_len) + tuple(v.shape[1:]),
                dtype=v.dtype, device=v.device) for k, v in out.items()}
        for k, v in out.items():
            self.paths[k].index_copy_(1, self.counter, v.unsqueeze(1))
        self.counter += 1
        load_state(self.states, states)
        for d, s in zip(_leaves(self.aux), _leaves(aux), strict=True):
            d.copy_(s)

    @property
    def graphs(self):
        return self.by_tracing.setdefault(tracing.enabled(), {})

    @torch.no_grad()
    def __call__(self, params, norm, generator, episode_idx):
        gen = self.generator
        gen.set_state(generator.get_state())
        with tracing.span('rollout.reset'):
            carry = self.init_carry(gen, episode_idx)
        with tracing.span('rollout.prepare'):
            self.prepare(params, norm, carry)
        graphs = self.graphs
        first = {}
        for t in range(self.t_len):
            first.setdefault(self.branch(t), t)
        missing = [(k, t) for k, t in first.items() if k not in graphs]
        for key, t in missing:
            graph = captured.StepGraph(functools.partial(self.step, t),
                                       self.device, gen, self.pool,
                                       name='rollout.step')
            if self.device.type == 'cuda':
                graph.capture(lambda: self.load_carry(carry))
            graphs[key] = graph
        if missing:
            self.load_carry(carry)
        for t in range(self.t_len):
            with tracing.span('rollout.step'):
                graphs[self.branch(t)]()
        generator.set_state(gen.get_state())
        return {k: v.clone() for k, v in self.paths.items()}

    @property
    def capture_s(self):
        """Seconds of every capture so far, warm-ups included."""
        return sum(g.capture_s for graphs in self.by_tracing.values()
                   for g in graphs.values())

    @property
    def replays(self):
        return sum(g.replays for graphs in self.by_tracing.values()
                   for g in graphs.values())
