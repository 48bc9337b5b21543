"""Parity of the port's host tooling with the JAX package: utils/tensor_utils,
the GAE SampleProcessor, the vectorized env executor, the native oracle's
binding (and the port's float64 engine against the oracle), sim_policy's
loader, replay and oracle check, entry(), and the refusal of the new entry
points to run without a card when asked for one."""
import importlib.util
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_STEP_TOL, jax_params_numpy, t, tiny_snapshot
from learning_to_adapt_torch import entry as port_entry
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch import meta_test as port_meta_test
from learning_to_adapt_torch import native as port_native
from learning_to_adapt_torch import sim_policy as port_sim
from learning_to_adapt_torch.envs.model_defs import get_model as port_model
from learning_to_adapt_torch.models import (
    MetaMLPDynamicsModel, MLPDynamicsModel, RNNDynamicsModel,
    normalizer_from_numpy, params_from_numpy)
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_torch.policies import MPCController, RNNMPCController
from learning_to_adapt_torch.samplers import gae_processor as port_gae
from learning_to_adapt_torch.samplers.vectorized_env_executor import (
    IterativeEnvExecutor, ParallelEnvExecutor)
from learning_to_adapt_torch.utils import logging as port_log
from learning_to_adapt_torch.utils import tensor_utils as port_tu
from learning_to_adapt_tpu import envs as jax_envs
from learning_to_adapt_tpu import native as jax_native
from learning_to_adapt_tpu.models import MetaMLPDynamicsModel as JaxMetaMLP
from learning_to_adapt_tpu.policies import MPCController as JaxMPC
from learning_to_adapt_tpu.samplers import gae_processor as jax_gae
from learning_to_adapt_tpu.samplers.rollout import make_rollout_fn
from learning_to_adapt_tpu.samplers.vectorized_env_executor import (
    IterativeEnvExecutor as JaxExecutor)
from learning_to_adapt_tpu.utils import logging as jax_log
from learning_to_adapt_tpu.utils import tensor_utils as jax_tu

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bf16 products with f32 sums taken in another order (tests/test_torch_models)
BF16_TOL = dict(rtol=2e-3, atol=2e-3)


def _load_module(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def snapshots(tmp_path_factory):
    """Tiny port snapshots of the three algorithms (GrBAL trained on
    cripple_set (1, 2, 3))."""
    root = str(tmp_path_factory.mktemp('snapshots'))
    return dict(grbal=tiny_snapshot(root, 'grbal', cripple_set=(1, 2, 3)),
                mb_mpc=tiny_snapshot(root, 'mb_mpc'),
                rebal=tiny_snapshot(root, 'rebal'))


# ---------------------------------------------------------------- tensor_utils
def _tu_cases():
    rng = np.random.RandomState(0)
    x1, x2 = rng.randn(50), rng.randn(40, 3)
    dicts = [dict(a=rng.randn(4, 2), b=dict(c=rng.randn(3))) for _ in range(3)]
    seqs = [rng.randn(n, 2).astype(np.float32) for n in (3, 5, 1)]
    y = rng.randn(30)
    return {
        'discount_cumsum': lambda tu: (tu.discount_cumsum(x1, 0.99),
                                       tu.discount_cumsum(x2, 0.5)),
        'stack_tensor_list': lambda tu: tu.stack_tensor_list(
            [d['a'] for d in dicts]),
        'stack_tensor_dict_list': lambda tu: tu.stack_tensor_dict_list(dicts),
        'concat_tensor_list': lambda tu: (
            tu.concat_tensor_list([d['a'] for d in dicts]),
            tu.concat_tensor_list([d['a'] for d in dicts], recurrent=True)),
        'concat_tensor_dict_list': lambda tu: (
            tu.concat_tensor_dict_list(dicts),
            tu.concat_tensor_dict_list(dicts, recurrent=True)),
        'pad_tensor': lambda tu: (tu.pad_tensor(seqs[0], 6),
                                  tu.pad_tensor(seqs[0], 6, mode='last')),
        'pad_tensor_n': lambda tu: tu.pad_tensor_n(seqs, 7),
        'explained_variance_1d': lambda tu: (
            tu.explained_variance_1d(y + 0.1 * x1[:30], y),
            tu.explained_variance_1d(y, np.ones(30)),
            tu.explained_variance_1d(np.ones(30), np.ones(30))),
        'normalize_advantages': lambda tu: tu.normalize_advantages(y),
        'shift_advantages_to_positive':
            lambda tu: tu.shift_advantages_to_positive(y),
    }


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', sorted(_tu_cases()))
def test_tensor_utils_match_jax(name):
    """Every function of utils/tensor_utils, on the same inputs, exactly."""
    case = _tu_cases()[name]
    _assert_tree_equal(case(port_tu), case(jax_tu))


# ------------------------------------------------------------- GAE processor
def _logged(log_module):
    """The key-values logged since the last dump, cleared."""
    cur = log_module._current()
    out = dict(cur.name2val)
    cur.name2val.clear()
    return out


@pytest.mark.parametrize('form,opts', [
    ('dict', dict()),
    ('list', dict(discount=0.95, gae_lambda=0.9, normalize_adv=False,
                  positive_adv=True)),
])
def test_sample_processor_matches_jax(form, opts):
    """SampleProcessor.process_samples on the same paths (the Sampler's dict
    of [n_paths, T, ...] arrays, or a list of path dicts): returns and
    advantages to rtol 1e-12, the same logged keys and values."""
    rng = np.random.RandomState(3)
    paths = dict(observations=rng.randn(4, 30, 20),
                 actions=rng.uniform(-1, 1, (4, 30, 6)),
                 rewards=rng.randn(4, 30))

    def given():
        if form == 'dict':
            return {k: v.copy() for k, v in paths.items()}
        return [{k: v[i].copy() for k, v in paths.items()} for i in range(4)]
    _logged(port_log), _logged(jax_log)
    got = port_gae.SampleProcessor(**opts).process_samples(
        given(), log=True, log_prefix='Gae-')
    want = jax_gae.SampleProcessor(**opts).process_samples(
        given(), log=True, log_prefix='Gae-')
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
    got_log, want_log = _logged(port_log), _logged(jax_log)
    assert list(got_log) == list(want_log) == [
        f'Gae-{k}' for k in ('AverageReturn', 'MaxReturn', 'MinReturn',
                             'StdReturn', 'NumTrajs')]
    for k in want_log:
        assert got_log[k] == want_log[k], k


# ------------------------------------------------------------------ executor
def test_executor_matches_jax_then_resets_every_env():
    """IterativeEnvExecutor against the JAX package's on HalfCheetah cripple
    (3 envs, max_path_length 10), from the JAX reset state injected through
    env.reset_to: the same observations and rewards at the f32 step
    tolerance up to the first auto-reset; then the same reset steps and
    episode counters, fresh episodes (t = 0) with cripple tasks drawn."""
    n, t_max, steps = 3, 10, 25
    jenv = jax_envs.normalize(jax_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True))
    jex = JaxExecutor(jenv, n, t_max, seed=0)
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device='cpu'))
    ex = IterativeEnvExecutor(env, n, t_max, seed=0)
    assert ParallelEnvExecutor is IterativeEnvExecutor and ex.num_envs == n

    want_obs = jex.reset()
    js = jex._states
    states = env.wrapped_env.reset_to(
        port_engine.PhysicsState(t(js.phys.qpos), t(js.phys.qvel)),
        port_spec.mutable_from_numpy(js.mm, 'cpu', torch.float32),
        {'cripple_mask': t(js.task['cripple_mask'])}, 0)
    ex._states = states
    np.testing.assert_allclose(states.obs.numpy(), want_obs, **F32_STEP_TOL)

    acts = np.random.RandomState(1).uniform(
        -1, 1, (steps, n, 6)).astype(np.float32)
    for i in range(steps):
        obs, rew, dones, infos = ex.step(acts[i])
        j_obs, j_rew, j_dones, _ = jex.step(acts[i])
        assert obs.shape == (n, 20) and np.isfinite(obs).all()
        assert len(infos) == n
        np.testing.assert_array_equal(dones, j_dones)
        assert dones.all() == ((i + 1) % t_max == 0)
        if i < t_max:
            np.testing.assert_allclose(obs, j_obs, **F32_STEP_TOL)
            np.testing.assert_allclose(rew, j_rew, **F32_STEP_TOL)
        if i == t_max - 1:
            # the first auto-reset: fresh episodes with a task drawn
            st = ex._states
            assert (st.t == 0).all() and (st.episode == 1).all()
            assert ((st.task['cripple_mask'] == 0).sum(-1) == 1).all()
    np.testing.assert_array_equal(ex._episode, jex._episode)
    assert ex._episode.tolist() == [2, 2, 2]


def test_executor_reset_keeps_each_envs_episode():
    """reset() with envs at different episodes: the task gate is taken per
    env (episode 0 runs the nominal task), and each keeps its counter."""
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device='cpu'))
    ex = IterativeEnvExecutor(env, 3, 10, seed=4)
    ex._episode = np.array([0, 2, 0])
    obs = ex.reset()
    assert obs.shape == (3, 20) and np.isfinite(obs).all()
    zeros = (ex._states.task['cripple_mask'] == 0).sum(-1).tolist()
    assert zeros == [0, 1, 0]
    assert ex._states.episode.tolist() == [0, 2, 0]


# -------------------------------------------------------------- native oracle
MODELS = ('half_cheetah', 'half_cheetah_hfield', 'half_cheetah_blocks',
          'ant', 'arm_7dof')


def _random_state(model, seed):
    """The state tests/test_native_oracle.py starts from."""
    rng = np.random.RandomState(seed)
    qpos = np.array(model.qpos0 if model.init_qpos is None
                    else model.init_qpos, np.float64)
    qpos = qpos + rng.uniform(-0.01, 0.01, model.nq)
    for ji in range(model.njnt):
        if model.jnt_type[ji] == 0:  # free joint: renormalize the quaternion
            a = model.jnt_qposadr[ji] + 3
            qpos[a:a + 4] /= np.linalg.norm(qpos[a:a + 4])
    qvel = rng.uniform(-0.1, 0.1, model.nv)
    ctrl = rng.uniform(-1, 1, max(model.nu, 1))[:model.nu]
    return qpos, qvel, ctrl


def _bumpy(model):
    """A bumpy terrain profile (tests/test_native_oracle.py's hfield case)."""
    import dataclasses
    mm = port_spec.default_mutable(model, np.float64)
    if model.hfield_ncol <= 1:
        return mm
    rng = np.random.RandomState(3)
    row = np.clip(np.cumsum(rng.uniform(-.05, .05, mm.hfield_row.shape[0])),
                  0, 1)
    return dataclasses.replace(mm, hfield_row=row.astype(np.float64))


@pytest.mark.parametrize('name', MODELS)
def test_native_binding_matches_jax_binding(name):
    """The port's ctypes binding against the JAX package's: the same
    source and the same float64 inputs give step and forward bit for bit.
    The port's library lives under learning_to_adapt_torch/_build."""
    model = port_model(name)
    mm = _bumpy(model)
    ours, theirs = (port_native.NativePhysics(model),
                    jax_native.NativePhysics(model))
    qpos, qvel, ctrl = _random_state(model, 0)
    a = b = (qpos, qvel)
    for _ in range(5):
        a = ours.step(*a, ctrl, mm)
        b = theirs.step(*b, ctrl, mm)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    fa, fb = ours.forward(*a, mm), theirs.forward(*b, mm)
    assert list(fa) == list(fb)
    for k in fb:
        np.testing.assert_array_equal(fa[k], fb[k])
    built = os.path.join(_REPO, 'learning_to_adapt_torch', '_build',
                         'libltao_physics.so')
    assert os.path.exists(built) and os.path.exists(built + '.sha256')


#: name -> (steps, qpos tol, qvel tol), as tests/test_native_oracle.py
ORACLE_TOL = {'half_cheetah': (50, 1e-6, 1e-5), 'arm_7dof': (50, 1e-6, 1e-5),
              'ant': (25, 1e-5, 1e-4), 'half_cheetah_hfield': (40, 1e-6, 1e-5),
              'half_cheetah_blocks': (40, 1e-6, 1e-5)}


@pytest.mark.parametrize('name', MODELS)
def test_port_engine_float64_matches_oracle(name):
    """The port's engine.step at float64 against the oracle over a
    trajectory, and engine.forward on its last state (1e-7), at the
    tolerances tests/test_native_oracle.py holds the JAX engine to."""
    n_steps, tol_p, tol_v = ORACLE_TOL[name]
    model = port_model(name)
    mm = _bumpy(model)
    nat = port_native.NativePhysics(model)
    qpos, qvel, ctrl = _random_state(model, 0)
    f64 = torch.float64
    mm_t = port_spec.mutable_from_numpy(
        port_spec.MutableModel(**{k: np.asarray(v)[None]
                                  for k, v in vars(mm).items()}), 'cpu', f64)
    state = port_engine.PhysicsState(t(qpos[None], f64), t(qvel[None], f64))
    ctrl_t = t(ctrl[None], f64)
    qp, qv = qpos, qvel
    for _ in range(n_steps):
        state = port_engine.step(model, mm_t, state, ctrl_t)
        qp, qv = nat.step(qp, qv, ctrl, mm)
    np.testing.assert_allclose(state.qpos[0].numpy(), qp, atol=tol_p)
    np.testing.assert_allclose(state.qvel[0].numpy(), qv, atol=tol_v)
    got = port_engine.forward(model, mm_t, state)
    want = nat.forward(state.qpos[0].numpy(), state.qvel[0].numpy(), mm)
    for k in ('xpos', 'ximat', 'subtree_com', 'subtree_comvel'):
        np.testing.assert_allclose(getattr(got, k)[0].numpy(), want[k],
                                   atol=1e-7, err_msg=k)


# ----------------------------------------------------------------- sim_policy
@pytest.mark.parametrize('algo,model_cls,policy_cls,adapt_bs', [
    ('grbal', MetaMLPDynamicsModel, MPCController, 4),
    ('mb_mpc', MLPDynamicsModel, MPCController, None),
    ('rebal', RNNDynamicsModel, RNNMPCController, None),
])
def test_load_experiment_rebuilds_model_and_policy(snapshots, algo,
                                                   model_cls, policy_cls,
                                                   adapt_bs):
    """load_experiment picks the model by the config's keys, loads the
    snapshot's parameters and builds the matching policy on the device."""
    env, model, policy, config, a_bs = port_sim.load_experiment(
        snapshots[algo], device='cpu')
    assert type(model) is model_cls and type(policy) is policy_cls
    assert a_bs == adapt_bs and policy.dynamics_model is model
    assert isinstance(env.wrapped_env, port_envs.HalfCheetahEnv)
    assert env.wrapped_env.device.type == 'cpu'
    with open(os.path.join(snapshots[algo], 'params.pkl'), 'rb') as f:
        saved = pickle.load(f)['dynamics_model']['params']
    got = model.state_dict()['params']
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(saved)):
        np.testing.assert_array_equal(a, b)


def test_load_experiment_rebuilds_env_from_config(snapshots, tmp_path):
    """A snapshot without its env: the env comes back from params.json with
    its task-distribution keys (cripple_set)."""
    exp = str(tmp_path / 'noenv')
    shutil.copytree(snapshots['grbal'], exp)
    path = os.path.join(exp, 'params.pkl')
    with open(path, 'rb') as f:
        snap = pickle.load(f)
    del snap['env']
    with open(path, 'wb') as f:
        pickle.dump(snap, f)
    env, *_ = port_sim.load_experiment(exp, device='cpu')
    base = env.wrapped_env
    assert type(base) is port_envs.HalfCheetahEnv
    assert base.cripple_set == (1, 2, 3) and base.reset_every_episode


def test_replay_npz_has_the_jax_replays_keys_and_shapes(snapshots, tmp_path,
                                                        capsys):
    """sim_policy.main writes replay.npz with the keys, shapes and dtypes of
    the JAX replay at the same config (its rollout program's outputs, by
    jax.eval_shape), and skips --check-native on a task-perturbed run."""
    out = str(tmp_path / 'replay.npz')
    port_sim.main([snapshots['grbal'], '--max_path_length', '20',
                   '--num_rollouts', '2', '--device', 'cpu', '--out', out,
                   '--check-native'])
    assert 'check-native skipped' in capsys.readouterr().out
    got = dict(np.load(out))

    jenv = jax_envs.normalize(jax_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True))
    jm = JaxMetaMLP('dyn_model', jenv, hidden_sizes=(32, 32), batch_size=4,
                    meta_batch_size=4)
    jp = JaxMPC('policy', jenv, jm, n_candidates=8, horizon=3)
    fn = make_rollout_fn(jenv, jp, jm, 2, 20, adapt_batch_size=4)
    want = jax.eval_shape(fn, jm.params, jm.normalizer,
                          jax.random.PRNGKey(0), np.int32(1))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k


def test_check_native_on_a_nominal_replay(snapshots):
    """A replay under nominal dynamics (env_override: task None) agrees with
    the float64 oracle step by step, well inside sim_policy's bound."""
    env = port_envs.normalize(port_envs.HalfCheetahEnv(task=None,
                                                       device='cpu'))
    env, model, policy, _, a_bs = port_sim.load_experiment(
        snapshots['grbal'], env_override=env, device='cpu')
    paths = port_sim.rollout(env, policy, model, max_path_length=20,
                             num_rollouts=1, adapt_batch_size=a_bs)
    worst = port_sim.check_native(env, paths, n_steps=19)
    assert 0.0 < worst < port_sim.NATIVE_TOL


# ---------------------------------------------------------------------- entry
def test_entry_matches_jax_entry():
    """entry()'s fn against the JAX package's entry() fn, with the JAX
    parameters and normalizer carried across and the same numpy inputs, at
    the planner's bf16 tolerance; the example args come from a seeded
    generator."""
    graft = _load_module('__graft_entry__.py', 'graft_entry_mod')
    jfn, (jparams, jnorm, jobs, jact) = graft.entry()
    fn, (params, norm, obs, act) = port_entry.entry(device='cpu')
    assert obs.shape == jobs.shape == (port_entry.BATCH, 20)
    assert act.shape == jact.shape == (port_entry.BATCH, 6)
    assert [p.shape for p in params['w']] == [
        tuple(p.shape) for p in jparams['w']]
    _, (_, _, obs2, act2) = port_entry.entry(device='cpu')
    assert torch.equal(obs, obs2) and torch.equal(act, act2)

    rng = np.random.RandomState(7)
    x = rng.randn(port_entry.BATCH, 20).astype(np.float32)
    a = rng.uniform(-1, 1, (port_entry.BATCH, 6)).astype(np.float32)
    want = jfn(jparams, jnorm, jnp.asarray(x), jnp.asarray(a))
    got = fn(params_from_numpy(jax_params_numpy(jparams), 'cpu'),
             normalizer_from_numpy(jax.device_get(jnorm), 'cpu'), t(x), t(a))
    assert got.shape == (port_entry.BATCH, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)


@pytest.mark.parametrize('which', ['meta_test', 'sim_policy', 'entry'])
def test_new_entry_points_refuse_a_missing_card(snapshots, which):
    """Asked for the card (the default), without one, each raises before
    doing any work; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    call = {
        'meta_test': lambda: port_meta_test.main(
            [snapshots['grbal'], '--device', 'cuda']),
        'sim_policy': lambda: port_sim.main([snapshots['grbal']]),
        'entry': port_entry.entry,
    }[which]
    with pytest.raises(RuntimeError, match='torch.cuda.is_available'):
        call()
