"""The captured sampling step of the port (learning_to_adapt_torch/samplers/
rollout.py CompiledRollout), its counterpart of the JAX rollout's
segment_jit, on the CPU: the static-carry step with the draws injected
against one step of the JAX segment_jit (GrBAL on both sides of its
adaptation gate, MB-MPC, ReBAL in each hidden-state mode on both sides of
the frozen mode's warm-up, random actions); the static carry's layout
against the reset's in a physics step, on every env; the compiled rollout
(the device rule patched to take it on the CPU, where its graphs run as
plain calls) against the eager rollout, bit for bit with the generator's
state, over two calls with new params between; the isolation of the paths
a call returns; the counters of a captured step. One test, marked cuda,
holds the captured rollout against the eager one on a card.
"""
import contextlib
import gc
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import t
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.envs.base import (
    EnvState, load_state, static_state)
from learning_to_adapt_torch.models import (
    MetaMLPDynamicsModel, MLPDynamicsModel, Normalizer, RNNDynamicsModel,
    captured)
from learning_to_adapt_torch.models.optim import tree_leaves, tree_map
from learning_to_adapt_torch.ops import (
    clip_adam, fused_mlp, jacobi, smooth_dynamics)
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_torch.policies import MPCController, RNNMPCController
from learning_to_adapt_torch.samplers import Sampler
from learning_to_adapt_torch.samplers.rollout import (
    CompiledRollout, make_rollout_fn)
from learning_to_adapt_torch.utils import tracing

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

A_BS = 4                  # the GrBAL window of the parity files
STEP_TOL = dict(rtol=1e-4, atol=1e-4)   # one f32 physics step, as the
#                                         parity files hold a rollout step
F32_TOL = dict(rtol=1e-5, atol=1e-5)    # the recurrent planner's f32 actions


@pytest.fixture(scope='module')
def jx():
    """JAX, the JAX package's rollout and planners and the parity files'
    helpers, imported by the tests that hold the port against the JAX
    package (the cuda-marked case runs where JAX is not installed)."""
    mods = {name: importlib.import_module(module) for name, module in (
        ('jax', 'jax'), ('jnp', 'jax.numpy'),
        ('envs', 'learning_to_adapt_tpu.envs'),
        ('policies', 'learning_to_adapt_tpu.policies'),
        ('planners', 'learning_to_adapt_tpu.policies.planners'),
        ('rollout', 'learning_to_adapt_tpu.samplers.rollout'),
        ('grbal', 'test_torch_rollout'), ('mbmpc', 'test_torch_mbmpc'),
        ('rebal', 'test_torch_rebal'))}
    return SimpleNamespace(**mods)


@pytest.fixture
def compiled_on_cpu(monkeypatch):
    """The device rule patched to take the compiled rollout on the CPU."""
    monkeypatch.setattr(captured, 'captures', lambda device, mesh: True)


# ------------------------------------------------------- parity with JAX
def _case(jx, algo):
    """(JAX env, port env, JAX model, port model, JAX policy, port policy,
    rollout keyword arguments, ablation) for one parity case."""
    n, h = 16, 3
    if algo in ('grbal', 'random'):
        jenv, env, jm, pm = jx.grbal._pair(task='cripple')
        kw = dict(adapt_batch_size=A_BS, random=algo == 'random')
    elif algo == 'mbmpc':
        jenv, env = jx.rebal._env_pair('cripple')
        jm, pm = jx.mbmpc._models(2)
        kw = {}
    else:
        jenv, env = jx.rebal._env_pair('cripple')
        jm, pm = jx.rebal._models('lstm', hidden=(16,), env=jenv.wrapped_env)
        ablate = algo.split('-')[1]
        kw = dict(ablate_hidden=None if ablate == 'none' else ablate,
                  ablate_warmup=2)
        return (jenv, env, jm, pm,
                jx.policies.RNNMPCController('p', jenv, jm, n_candidates=n,
                                             horizon=h),
                RNNMPCController('p', env, pm, n_candidates=n, horizon=h),
                kw)
    return (jenv, env, jm, pm,
            jx.policies.MPCController('p', jenv, jm, n_candidates=n,
                                      horizon=h),
            MPCController('p', env, pm, n_candidates=n, horizon=h), kw)


def _port_states(states, env, m):
    """The port's EnvState of a JAX reset (its cripple masks; the nominal
    MutableModel, broadcast over the envs as a reset makes it)."""
    return EnvState(
        phys=port_engine.PhysicsState(t(states.phys.qpos),
                                      t(states.phys.qvel)),
        mm=port_spec.batched_mutable(env.wrapped_env.mm0, m, 'cpu',
                                     torch.float32),
        task={'cripple_mask': t(states.task['cripple_mask'])},
        obs=t(states.obs), t=torch.zeros(m, dtype=torch.int32),
        episode=torch.ones(m, dtype=torch.int32))


@pytest.mark.parametrize('algo,steps', [
    ('grbal', (A_BS + 2, 1)), ('mbmpc', (2,)), ('rebal-none', (3,)),
    ('rebal-zero', (3,)), ('rebal-frozen', (1, 3)), ('random', (0,))])
def test_static_step_matches_jax_segment(algo, steps, jx, compiled_on_cpu,
                                         monkeypatch):
    """One step of the compiled rollout on its static carry, loaded from
    the JAX reset (with a random GrBAL window or ReBAL hidden state), the
    JAX draws injected, against jax_rollout_fn(..., segment_len=1)'s
    segment_jit from the same carry, at each step t0 given (GrBAL: past
    the adaptation gate and before it; ReBAL 'frozen', warm-up 2: before
    and after it): the paths at the step counter's slot and the carry the
    step leaves in the static buffers. Observations and actions equal on
    the envs whose best candidate wins by more than the returns'
    tolerance, the rest to STEP_TOL."""
    jax, jnp = jx.jax, jx.jnp
    jenv, env, jm, pm, jpol, ppol, kw = _case(jx, algo)
    m, n, h = 3, jpol.n_candidates, jpol.horizon
    jkw = dict(kw)
    jkw.pop('random', None)
    jfn = jx.rollout.make_rollout_fn(jenv, jpol, jm, m, 8, segment_len=1,
                                     random=algo == 'random', **jkw)
    states, _, _, key = jfn.init_jit(jax.random.PRNGKey(8), 1)
    _, k_plan = jax.random.split(key)
    rng = np.random.RandomState(9)
    j_aux = p_aux = None
    if algo in ('grbal', 'random'):
        h_obs = (np.asarray(states.obs)[:, None] +
                 0.1 * rng.randn(m, A_BS + 1, 20)).astype(np.float32)
        h_act = rng.uniform(-1, 1, (m, A_BS, 6)).astype(np.float32)
        j_aux = (jnp.asarray(h_obs), jnp.asarray(h_act))
        p_aux = (t(h_obs), t(h_act))
    elif algo.startswith('rebal'):
        j_aux, p_aux = jx.rebal._hidden(jm, m, 17)
    pfn = make_rollout_fn(env, ppol, pm, m, 8, **kw)
    assert isinstance(pfn, CompiledRollout)
    cand = jax.random.uniform(k_plan, (h, n * m, 6), jnp.float32, -1.0, 1.0)
    if algo == 'random':
        # the JAX step's uniform [-1, 1) actions are 2 u - 1 of these u
        u = t(jax.random.uniform(k_plan, (m, 6), jnp.float32))
        monkeypatch.setattr(torch, 'rand', lambda *a, **k: u)
    for t0 in steps:
        carry = ((states, j_aux, None, key) if not algo.startswith('rebal')
                 else (states, None, j_aux, key))
        (j_states, j_hist, j_hid, _), j_out = jfn.segment_jit(
            jm.params, jm.normalizer, carry, jnp.asarray(t0, jnp.int32))
        j_out = {k: np.asarray(v[:, 0]) for k, v in j_out.items()}
        j_next = j_hid if algo.startswith('rebal') else j_hist

        pfn.prepare(pm.params, pm.normalizer,
                    (_port_states(states, env, m), p_aux))
        pfn.step(t0, candidates=None if algo == 'random' else t(cand))
        assert int(pfn.counter) == 1
        out = {k: v[:, 0].numpy() for k, v in pfn.paths.items()}

        safe = np.arange(m)
        if algo in ('grbal', 'mbmpc'):
            if algo == 'grbal' and pfn.branch(t0)[0]:
                adapted = jm.adapt_fn(jm.params, jm.normalizer,
                                      j_aux[0][:, :-1], j_aux[1],
                                      j_aux[0][:, 1:])

                def predict(o, a):
                    return jm.predict_adapted_fn(
                        adapted, jm.normalizer, o.reshape(m, n, -1),
                        a.reshape(m, n, -1)).reshape(m * n, -1)
            else:
                def predict(o, a):
                    return jm.predict_fn(jm.params, jm.normalizer, o, a)
            _, j_ret = jx.planners.random_shooting(
                predict, jenv.reward, states.obs, k_plan, n_candidates=n,
                horizon=h, act_dim=6)
            safe = jx.grbal._safe_envs(np.asarray(j_ret))
            assert safe.size
        np.testing.assert_array_equal(out['observations'],
                                      j_out['observations'])
        if algo.startswith('rebal'):
            np.testing.assert_allclose(out['actions'], j_out['actions'],
                                       **F32_TOL)
        else:
            np.testing.assert_array_equal(out['actions'][safe],
                                          j_out['actions'][safe])
        for k in ('next_observations', 'rewards', 'qpos', 'qvel'):
            np.testing.assert_allclose(out[k][safe], j_out[k][safe],
                                       err_msg=f'{k} at t0 {t0}',
                                       **STEP_TOL)
        np.testing.assert_array_equal(out['dones'], j_out['dones'])
        # the carry the step leaves in the static buffers
        np.testing.assert_allclose(pfn.states.obs.numpy()[safe],
                                   np.asarray(j_states.obs)[safe], **STEP_TOL)
        np.testing.assert_array_equal(pfn.states.t.numpy(), 1)
        if j_next is None:
            assert pfn.aux is None
            continue
        for p, j in zip(tree_leaves(pfn.aux), jax.tree.leaves(j_next)):
            np.testing.assert_allclose(p.numpy()[safe], np.asarray(j)[safe],
                                       **STEP_TOL)
        if algo.startswith('rebal'):
            kept = algo == 'rebal-zero' or pfn.branch(t0)[1]
            assert kept == all(bool((a == b).all()) for a, b in
                               zip(tree_leaves(pfn.aux),
                                   tree_leaves(p_aux)))


# ------------------------------------------------------- the static carry
ENV_TASKS = [('HalfCheetahEnv', 'cripple'),
             ('HalfCheetahHFieldEnv', 'hfield'),
             ('HalfCheetahBlocksEnv', 'damping'), ('Arm7DofEnv', 'force'),
             ('AntEnv', 'cripple')]


@pytest.mark.parametrize('cls,task', ENV_TASKS)
def test_static_carry_layout_steps_bit_for_bit(cls, task):
    """A reset's MutableModel is broadcast (stride 0) where no task wrote
    it; the static carry writes it out per env. From either layout a
    physics step gives the same results bit for bit, and load_state brings
    any reset's values into the static carry."""
    env = port_envs.normalize(getattr(port_envs, cls)(
        task=task, reset_every_episode=True, device='cpu'))
    gen = torch.Generator()
    gen.manual_seed(4)
    first = env.reset(2, 0, gen)
    states = env.reset(2, 1, gen)
    mm = [getattr(states.mm, f) for f in vars(states.mm)]
    assert any(x.stride(0) == 0 for x in mm)
    static = static_state(first)
    assert all(x.is_contiguous() and x.stride(0) != 0 for x in
               vars(static.mm).values())
    load_state(static, states)
    act = torch.as_tensor(np.random.RandomState(5).uniform(
        -1, 1, (2, env.act_dim)), dtype=torch.float32)
    a = env.step(states, act)
    b = env.step(static, act)
    for x, y in zip(tree_leaves([a[0].phys.qpos, a[0].phys.qvel, *a[1:4]]),
                    tree_leaves([b[0].phys.qpos, b[0].phys.qvel, *b[1:4]])):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match='task fields'):
        load_state(static, EnvState(**dict(vars(states), task={})))


# ------------------------------------------------- compiled against eager
def _sampler_parts(algo, t_len=12, m=2):
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device='cpu'))
    kw = {}
    if algo in ('grbal', 'random'):
        model = MetaMLPDynamicsModel('d', env, hidden_sizes=(16,),
                                     batch_size=A_BS, inner_learning_rate=0.01,
                                     device='cpu')
        policy = MPCController('p', env, model, n_candidates=8, horizon=3)
        kw = dict(adapt_batch_size=A_BS, random=algo == 'random')
    elif algo == 'mbmpc':
        model = MLPDynamicsModel('d', env, hidden_sizes=(16,), n_members=2,
                                 device='cpu')
        policy = MPCController('p', env, model, n_candidates=8, horizon=3,
                               use_cem=True, num_cem_iters=2)
    else:
        model = RNNDynamicsModel('d', env, hidden_sizes=(8,), device='cpu')
        policy = RNNMPCController('p', env, model, n_candidates=8, horizon=3)
        kw = dict(ablate_hidden='frozen', ablate_warmup=5)
    return env, model, policy, kw, m, t_len


def _new_params(model, seed):
    """Fresh parameter tensors near the old ones, as a fit leaves them."""
    rng = np.random.RandomState(seed)
    model.params = tree_map(lambda x: x + torch.as_tensor(
        0.01 * rng.randn(*x.shape), dtype=x.dtype), model.params)
    rows = torch.as_tensor(rng.randn(40, 46), dtype=torch.float32)
    model.normalizer = Normalizer.fit(rows[:, :20], rows[:, 20:26],
                                      rows[:, 26:])


@pytest.mark.parametrize('algo', ['grbal', 'mbmpc', 'rebal-frozen',
                                  'random'])
def test_compiled_rollout_equals_eager(algo, compiled_on_cpu):
    """Two calls of the compiled rollout (the second after new params and
    normalizer, as after a fit) against the eager rollout from the same
    generator states: paths bit for bit, the generator's state equal after
    each call; the paths of the first call are unchanged by the second,
    and no path returned aliases the static buffers."""
    env, model, policy, kw, m, t_len = _sampler_parts(algo)
    fn = make_rollout_fn(env, policy, model, m, t_len, **kw)
    assert isinstance(fn, CompiledRollout) and fn.eager is not fn
    g_c, g_e = torch.Generator(), torch.Generator()
    g_c.manual_seed(3)
    g_e.manual_seed(3)
    kept = []
    for episode in (0, 1):
        if episode:
            _new_params(model, 7)
        got = fn(model.params, model.normalizer, g_c, episode)
        want = fn.eager(model.params, model.normalizer, g_e, episode)
        assert sorted(got) == sorted(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(g_c.get_state(), g_e.get_state())
        static = {x.untyped_storage().data_ptr() for x in fn.paths.values()}
        assert not static & {x.untyped_storage().data_ptr()
                             for x in got.values()}
        kept.append((got, {k: v.clone() for k, v in got.items()}))
    for got, copy in kept:
        for k in got:
            assert torch.equal(got[k], copy[k])
    assert not torch.equal(kept[0][0]['observations'],
                           kept[1][0]['observations'])
    # one graph for each side of the host branches the path crosses
    want_keys = {'grbal': [(False, False), (True, False)],
                 'rebal-frozen': [(False, False), (False, True)]}.get(
        algo, [(False, False)])
    assert sorted(fn.graphs) == want_keys


def test_sampler_takes_the_compiled_rollout(compiled_on_cpu):
    """Sampler.obtain_samples runs the compiled rollout where the rule
    holds, and its state_dict after a call is the eager sampler's."""
    env, model, policy, kw, m, t_len = _sampler_parts('grbal')
    kw.pop('random')
    samplers = [Sampler(env, policy, m, t_len, device='cpu', seed=5, **kw)
                for _ in range(2)]
    for random in (True, False):
        a = samplers[0].obtain_samples(random=random)
        fn = samplers[1]._rollout_fn(random)
        assert isinstance(fn, CompiledRollout)
        samplers[1]._fns[random] = fn.eager
        b = samplers[1].obtain_samples(random=random)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        sa, sb = (s.state_dict() for s in samplers)
        np.testing.assert_array_equal(sa.pop('generator'),
                                      sb.pop('generator'))
        assert sa == sb
    assert isinstance(samplers[0]._fns[False], CompiledRollout)


def test_eager_without_the_rule():
    """On the CPU the rule refuses the capture: the rollout is the eager
    one, which is its own `eager`."""
    env, model, policy, kw, m, t_len = _sampler_parts('grbal')
    fn = make_rollout_fn(env, policy, model, m, t_len, **kw)
    assert not isinstance(fn, CompiledRollout) and fn.eager is fn


def test_pack_in_place_keeps_its_addresses():
    """pack_weights(out=) writes the weight stream and biases of an
    existing pack in place, with the values of a new pack; it refuses a
    pack of other widths or groups."""
    rng = np.random.RandomState(2)
    ws = [torch.as_tensor(rng.randn(1, 26, 32), dtype=torch.float32),
          torch.as_tensor(rng.randn(1, 32, 20), dtype=torch.float32)]
    bs = [torch.as_tensor(rng.randn(1, 32), dtype=torch.float32),
          torch.as_tensor(rng.randn(1, 20), dtype=torch.float32)]
    packed = fused_mlp.pack_weights(ws, [b.clone() for b in bs])
    ptrs = [packed.w.data_ptr()] + [b.data_ptr() for b in packed.bs]
    ws2 = [w + 1.0 for w in ws]
    bs2 = [b - 1.0 for b in bs]
    before = fused_mlp.pack_weights.calls
    again = fused_mlp.pack_weights(ws2, bs2, out=packed)
    assert again is packed and fused_mlp.pack_weights.calls == before + 1
    assert [packed.w.data_ptr()] + [b.data_ptr() for b in packed.bs] == ptrs
    fresh = fused_mlp.pack_weights(ws2, bs2)
    assert torch.equal(packed.w, fresh.w)
    for a, b in zip(packed.bs, fresh.bs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='cannot pack'):
        fused_mlp.pack_weights([w.expand(2, -1, -1).clone() for w in ws2],
                               [b.expand(2, -1).clone() for b in bs2],
                               out=packed)


# ------------------------------------------------------------- counters
def test_kernel_counts_round_trip():
    before = captured.kernel_counts()
    captured.count_kernels(dict(fused_mlp=3, fused_mlp_wgmma=2, pack=1,
                                jacobi_solve=2, jacobi_solve_cluster=0,
                                clip_adam=4, smooth_dynamics=5))
    after = captured.kernel_counts()
    captured.count_kernels({k: before[k] - after[k] for k in after})
    assert {k: after[k] - before[k] for k in after} == dict(
        fused_mlp=3, fused_mlp_wgmma=2, pack=1, jacobi_solve=2,
        jacobi_solve_cluster=0, clip_adam=4, smooth_dynamics=5)
    assert captured.kernel_counts() == before


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a capture runs the Python (as a
    real capture does), a replay does not."""

    def __init__(self):
        self.generators = []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        pass


def test_step_graph_counts_replays(monkeypatch):
    """StepGraph's bookkeeping, with CUDA's stream and graph calls faked:
    the kernel counters count a captured step's launches once a replay,
    the warm-ups' and the capture's kept out (in the StepGraph); the
    generator is registered with the graph and left where it was before
    the warm-ups drew from it; the collector runs again after it."""
    fake_stream = SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: fake_stream)
    monkeypatch.setattr(torch.cuda, 'Stream', lambda device=None: fake_stream)
    monkeypatch.setattr(torch.cuda, 'stream',
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _FakeGraph)
    monkeypatch.setattr(torch.cuda, 'graph',
                        lambda graph, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda device=None: None)
    gen = torch.Generator()
    gen.manual_seed(1)

    def step():
        torch.rand(4, generator=gen)
        fused_mlp.fused_mlp_forward.launches += 10
        fused_mlp.fused_mlp_forward.wgmma_launches += 10
        fused_mlp.pack_weights.calls += 1
        jacobi.jacobi_solve.launches += 4
        clip_adam.clip_adam_.launches += clip_adam.LAUNCHES_PER_STEP
        smooth_dynamics.smooth_dynamics.launches += 5

    graph = captured.StepGraph(step, 'cuda', generator=gen)
    state = gen.get_state()
    before = captured.kernel_counts()
    resets = []
    graph.capture(lambda: resets.append(1))
    assert gc.isenabled()
    per_step = dict(fused_mlp=10, fused_mlp_wgmma=10, pack=1,
                    jacobi_solve=4, jacobi_solve_cluster=0,
                    clip_adam=clip_adam.LAUNCHES_PER_STEP, smooth_dynamics=5)
    traced = tracing.counters().get('fused_mlp.wgmma_launches', 0)
    assert captured.kernel_counts() == before and len(resets) == 4
    assert graph.kernels == per_step
    assert graph.warmup_kernels == {k: captured.WARMUP * n
                                    for k, n in per_step.items()}
    assert graph.graph.generators == [gen]
    assert torch.equal(gen.get_state(), state)
    for _ in range(5):
        graph()
    assert graph.replays == 5
    assert captured.kernel_counts() == {k: before[k] + 5 * n
                                        for k, n in per_step.items()}
    # the tracing counter counts the replays only, not warm-ups or capture
    assert tracing.counters()['fused_mlp.wgmma_launches'] == traced + 50
    assert torch.equal(gen.get_state(), state)   # a fake replay draws none
    captured.count_kernels({k: -5 * n for k, n in per_step.items()})


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize('algo', ['grbal', 'mbmpc', 'rebal-frozen',
                                  'random'])
def test_captured_rollout_matches_eager_on_the_card(algo):
    """On a card: the captured rollout (one replay a step, its graphs
    captured in the first call) against the eager one from the same
    generator state, twice (episodes 0 and 1): identical paths, identical
    generator state after the call and the eager call's launch counts."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: a CUDA graph has no CPU mode')
    dev = torch.device('cuda', 0)
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device=dev))
    m, t_len = 3, 24
    kw = {}
    if algo in ('grbal', 'random'):
        model = MetaMLPDynamicsModel('d', env, hidden_sizes=(64, 64),
                                     batch_size=A_BS, inner_learning_rate=0.01,
                                     device=dev)
        policy = MPCController('p', env, model, n_candidates=32, horizon=4)
        kw = dict(adapt_batch_size=A_BS, random=algo == 'random')
    elif algo == 'mbmpc':
        model = MLPDynamicsModel('d', env, hidden_sizes=(64, 64), device=dev)
        policy = MPCController('p', env, model, n_candidates=64, horizon=4)
    else:
        model = RNNDynamicsModel('d', env, hidden_sizes=(32,), device=dev)
        policy = RNNMPCController('p', env, model, n_candidates=32,
                                  horizon=4)
        kw = dict(ablate_hidden='frozen', ablate_warmup=8)
    fn = make_rollout_fn(env, policy, model, m, t_len, **kw)
    assert isinstance(fn, CompiledRollout)
    for episode in (0, 1):
        runs = []
        for call in (fn.eager, fn):
            gen = torch.Generator(device=dev)
            gen.manual_seed(11 + episode)
            before, replays = captured.kernel_counts(), fn.replays
            paths = call(model.params, model.normalizer, gen, episode)
            after = captured.kernel_counts()
            runs.append((paths, gen.get_state(),
                         {k: after[k] - before[k] for k in after},
                         fn.replays - replays))
        (pe, ge, ce, re), (pc, gc, cc, rc) = runs
        for k in pe:
            assert torch.equal(pe[k], pc[k]), k
        assert torch.equal(ge, gc) and ce == cc
        assert (re, rc) == (0, t_len)
        assert ce['jacobi_solve'] == t_len
        # a dynamics pass and the forward pass a step, the reset's forward
        assert ce['smooth_dynamics'] == 2 * t_len + 1
        if algo == 'grbal':
            assert (ce['fused_mlp'], ce['pack']) == (4 * t_len, t_len)
        if algo == 'mbmpc':
            assert (ce['fused_mlp'], ce['pack']) == (4 * t_len, 1)
