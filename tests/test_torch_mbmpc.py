"""Parity of the port's MB-MPC slice with the JAX package: the feed-forward
model (planner prediction, ensembles included; training loss and gradient;
epochs on an injected permutation of a padded dataset; the host RNG stream
and split; the early stop and its logged keys; state dicts), CEM, a
non-meta rollout step, and the run_mb_mpc entry point on the CPU (resume
included). Also the loading of snapshots across devices, for every entry
point."""
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch import run_grbal as port_grbal
from learning_to_adapt_torch import run_mb_mpc as port_run
from learning_to_adapt_torch.envs.base import EnvState
from learning_to_adapt_torch.models import MLPDynamicsModel as PortMLP
from learning_to_adapt_torch.models import MetaMLPDynamicsModel as PortMetaMLP
from learning_to_adapt_torch.models import RNNDynamicsModel as PortRNN
from learning_to_adapt_torch.models import mlp as port_mlp
from learning_to_adapt_torch.models.optim import tree_leaves
from learning_to_adapt_torch.ops import fused_mlp as port_fused
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_torch.policies import MPCController as PortMPC
from learning_to_adapt_torch.policies import planners as port_planners
from learning_to_adapt_torch.samplers import Sampler as PortSampler
from learning_to_adapt_torch.samplers.rollout import (
    make_rollout_fn as port_rollout_fn)
from learning_to_adapt_torch.utils.checkpoint import load_snapshot
from learning_to_adapt_tpu import envs as jax_envs
from learning_to_adapt_tpu.models import MLPDynamicsModel as JaxMLP
from learning_to_adapt_tpu.models import MetaMLPDynamicsModel as JaxMetaMLP
from learning_to_adapt_tpu.models import RNNDynamicsModel as JaxRNN
from learning_to_adapt_tpu.models import mlp as jax_mlp
from learning_to_adapt_tpu.models.normalizer import Normalizer as JaxNorm
from learning_to_adapt_tpu.policies import MPCController as JaxMPC
from learning_to_adapt_tpu.policies import planners as jax_planners
from learning_to_adapt_tpu.samplers.rollout import (
    make_rollout_fn as jax_rollout_fn)

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 products with f32 sums taken in another order (tests/test_torch_models)
BF16_TOL = dict(rtol=2e-3, atol=2e-3)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)   # one f32 loss, other op order
EPOCH_TOL = dict(rtol=1e-4, atol=1e-6)  # a few f32 Adam steps
RET_TOL = dict(rtol=1e-3, atol=5e-2)    # returns of bf16 model predictions
HEADER_CSV = os.path.join(REPO, 'results', 'mb_mpc_halfcheetah_tpu_r3.csv')


class FakeEnv:
    obs_dim, act_dim = 20, 6


def _models(n_members=1, hidden=(32, 32), bs=16, out_nl=None, seed=0):
    """A JAX and a port MLP model in the same state, the port's loaded from
    the JAX state_dict through mlp_state_from_numpy."""
    kw = dict(hidden_sizes=hidden, batch_size=bs, n_members=n_members,
              output_nonlinearity=out_nl, learning_rate=1e-3, seed=seed)
    jm = JaxMLP('dyn', FakeEnv(), **kw)
    pm = PortMLP('dyn', FakeEnv(), device='cpu', **kw)
    rng = np.random.RandomState(11)
    obs, act, delta = (rng.randn(200, d).astype(np.float32)
                       for d in (20, 6, 20))
    jm.normalizer = JaxNorm.fit(jnp.asarray(obs), jnp.asarray(act),
                                jnp.asarray(delta))
    pm.load_state_dict(port_mlp.mlp_state_from_numpy(
        jax.device_get(jm.state_dict())))
    return jm, pm


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    obs = rng.randn(n, 20).astype(np.float32)
    act = rng.uniform(-1, 1, (n, 6)).astype(np.float32)
    nxt = obs + 0.1 * rng.randn(n, 20).astype(np.float32)
    return obs, act, nxt


def _assert_leaves(port_tree, jax_tree, **tol):
    for a, b in zip(tree_leaves(port_tree), jax.tree.leaves(jax_tree)):
        assert tuple(a.shape) == np.shape(b)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize('n_members,out_nl', [(1, None), (3, None),
                                              (1, 'tanh')])
def test_predict_fn_planner_path_matches_jax(n_members, out_nl):
    """The bf16 planner prediction, an ensemble's member mean included,
    from the parameter dict and from its pack."""
    jm, pm = _models(n_members, out_nl=out_nl)
    obs, act, _ = _rows(50, 1)
    want = np.asarray(jm.predict_fn(jm.params, jm.normalizer,
                                    jnp.asarray(obs), jnp.asarray(act)))
    for params in (pm.params, pm.pack(pm.params)):
        got = pm.predict_fn(params, pm.normalizer, t(obs), t(act))
        np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
    np.testing.assert_allclose(pm.predict(obs, act), jm.predict(obs, act),
                               **BF16_TOL)
    assert pm.pack(pm.params).groups == n_members
    assert port_fused.fused_mlp_forward.launches == 0


def test_meta_mlp_output_nonlinearity_matches_jax():
    """The meta-MLP applies an output nonlinearity to the planner kernel's
    f32 output, as the JAX model applies it after its last layer."""
    from learning_to_adapt_torch.models import MetaMLPDynamicsModel
    from learning_to_adapt_torch.models import meta_mlp as port_meta
    from learning_to_adapt_tpu.models import MetaMLPDynamicsModel as JaxMeta
    kw = dict(hidden_sizes=(32,), output_nonlinearity='tanh')
    jm = JaxMeta('dyn', FakeEnv(), **kw)
    pm = MetaMLPDynamicsModel('dyn', FakeEnv(), device='cpu', **kw)
    pm.load_state_dict(port_meta.meta_state_from_numpy(
        jax.device_get(jm.state_dict())))
    obs, act, _ = _rows(30, 16)
    want = jm.predict_fn(jm.params, jm.normalizer, jnp.asarray(obs),
                         jnp.asarray(act))
    got = pm.predict_fn(pm.params, pm.normalizer, t(obs), t(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)
    assert float((got - t(obs)).abs().max()) <= 1.0 + 1e-6


def _jax_loss(jm, params, norm, rows, w):
    """The JAX epoch's loss_fn (models/mlp.py:199-203) on split rows."""
    o, a, d = rows[:, :20], rows[:, 20:26], rows[:, 26:]
    pred = jm._forward_normalized(params, norm, o, a)
    err = jnp.square(pred - norm.norm_delta(d))
    return jnp.sum(jnp.mean(err, axis=-1) * w) / jnp.maximum(jnp.sum(w), 1.0)


@pytest.mark.parametrize('n_members', [1, 3])
def test_loss_and_gradient_match_jax(n_members):
    jm, pm = _models(n_members)
    obs, act, nxt = _rows(24, 2)
    rows = np.concatenate([obs, act, nxt - obs], -1)
    w = (np.arange(24) < 17).astype(np.float32)   # 7 padding rows
    j_loss, j_grad = jax.value_and_grad(_jax_loss, argnums=1)(
        jm, jm.params, jm.normalizer, jnp.asarray(rows), jnp.asarray(w))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(pm.params)]
    params = dict(w=leaves[len(leaves) // 2:], b=leaves[:len(leaves) // 2])
    loss = pm.loss_fn(params, pm.normalizer, t(rows), t(w))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               **LOSS_TOL)
    for g, jg in zip(grads, jax.tree.leaves(j_grad)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **LOSS_TOL)


def _padded(n, cap, seed):
    obs, act, nxt = _rows(n, seed)
    (o, a, d), w = jax_mlp._pad_rows([obs, act, nxt - obs], n, chunk=cap)
    return (o, a, d, w), (t(np.concatenate([o, a, d], -1)), t(w))


@pytest.mark.parametrize('n_members', [1, 3])
def test_epoch_on_injected_permutation_matches_jax(n_members):
    """Four Adam steps on minibatches of a permutation of a padded train
    set (50 real rows in 64), then the loss on a padded test set: the JAX
    epoch with its permutation injected into the port."""
    jm, pm = _models(n_members)
    j_train, p_train = _padded(50, 64, 3)
    j_test, p_test = _padded(10, 64, 4)
    n_batches = 4
    key = jax.random.PRNGKey(5)
    j_params, j_opt, j_train_loss, j_valid = jm._get_epoch_fn(
        64, 64, n_batches)(jm.params, jm.opt_state, jm.normalizer,
                           tuple(map(jnp.asarray, j_train)),
                           tuple(map(jnp.asarray, j_test)), key)
    perm = torch.as_tensor(np.array(jax.random.permutation(key, 64)))
    p_params, p_opt, p_train_loss, p_valid = pm.epoch_fn(
        pm.params, pm.opt_state, pm.normalizer, p_train, p_test, n_batches,
        None, perm=perm)
    np.testing.assert_allclose([float(p_train_loss), float(p_valid)],
                               [float(j_train_loss), float(j_valid)],
                               **EPOCH_TOL)
    _assert_leaves(p_params, j_params, **EPOCH_TOL)
    adam = j_opt[1][0]
    assert int(p_opt['count']) == int(adam.count) == n_batches
    _assert_leaves(p_opt['mu'], adam.mu, **EPOCH_TOL)


def _mlp_key(st, counts):
    """The JAX MLP's epoch key (train and test capacities, batches) of what
    the port's fit hands its epoch."""
    return (st.train[0].shape[0], st.test[0].shape[0]) + tuple(counts)


def _stub_epochs(jm, pm, script, key=_mlp_key):
    """Replace both models' epochs (the port's at the shared loop's seam,
    `_fit_epoch`) by one that returns the scripted losses in turn and
    records the shapes it was handed (the port's as `key` makes the JAX
    key of them)."""
    seen = dict(jax=[], port=[])
    j_iter, p_iter = iter(script), iter(script)

    def jax_get_epoch_fn(*ck):
        seen['jax'].append(ck)

        def fn(params, opt_state, *_):
            return (params, opt_state, *next(j_iter))
        return fn
    jm._get_epoch_fn = jax_get_epoch_fn

    def port_fit_epoch(compiled, generator, counts):
        seen['port'].append(key(compiled.state, counts))
        return [torch.tensor(x) for x in next(p_iter)]
    pm._fit_epoch = port_fit_epoch
    return seen


@pytest.mark.parametrize('n_rows,bs', [(1000, 128), (90, 16), (17000, 128)])
def test_fit_split_and_rng_stream_match_jax(n_rows, bs):
    """Successive fits with the epochs stubbed out (the port's at the
    shared loop's seam, `_fit_epoch`): the capacities and batch counts
    handed to each epoch, the aggregated train/valid buffers
    and the host RNG state equal the JAX package's bit for bit."""
    jm = JaxMLP('dyn', FakeEnv(), hidden_sizes=(8,), batch_size=bs,
                valid_split_ratio=0.1, seed=3)
    pm = PortMLP('dyn', FakeEnv(), hidden_sizes=(8,), batch_size=bs,
                 valid_split_ratio=0.1, seed=3, device='cpu')
    n_fits = 3 if n_rows > 10000 else 6
    seen = _stub_epochs(jm, pm, [(0.0, 1.0)] * n_fits)
    for i in range(n_fits):
        rows = _rows(n_rows, 100 + i)
        jm.fit(*rows, epochs=1)
        pm.fit(*rows, epochs=1)
    assert seen['port'] == seen['jax']
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(pm._train[k], jm._train[k])
        np.testing.assert_array_equal(pm._test[k], jm._test[k])
    assert pm._rng.randint(1 << 30) == jm._rng.randint(1 << 30)


class _Logger:
    def __init__(self):
        self.kvs = {}

    def logkv(self, k, v):
        self.kvs[k] = v

    def log(self, msg):
        pass


def _twins(algo):
    """(JAX model, port model, fit data, the key of the JAX epoch that
    the port's fit hands its epoch, the logged keys) of MB-MPC's MLP,
    GrBAL's meta-MLP or ReBAL's recurrent model."""
    if algo == 'mbmpc':
        kw = dict(hidden_sizes=(8,), batch_size=16)
        return (JaxMLP('dyn', FakeEnv(), **kw),
                PortMLP('dyn', FakeEnv(), device='cpu', **kw), _rows(100, 7),
                _mlp_key, ['Epochs', 'TrainLoss', 'ValidLoss'])
    paths = tuple(x.reshape(5, 20, -1) for x in _rows(100, 7))
    if algo == 'grbal':
        kw = dict(hidden_sizes=(8,), meta_batch_size=2, batch_size=4)
        jax_cls, port_cls = JaxMetaMLP, PortMetaMLP

        def key(st, counts):
            return (st.train.shape[0], st.test.shape[0],
                    st.train.shape[1]) + tuple(counts[2:])
        keys = ['Epochs', 'Pre-Loss', 'Post-Loss']
    else:
        kw = dict(hidden_sizes=(8,), batch_size=2, backprop_steps=10)
        jax_cls, port_cls = JaxRNN, PortRNN

        def key(st, counts):
            return (st.train.shape[0], st.test[0].shape[0], st.train.shape[1],
                    counts[1])
        keys = ['Epochs', 'TrainLoss']
    return (jax_cls('dyn', FakeEnv(), **kw),
            port_cls('dyn', FakeEnv(), device='cpu', **kw), paths, key, keys)


@pytest.mark.parametrize('algo', ['mbmpc', 'grbal', 'rebal'])
def test_early_stop_and_logged_keys_match_jax(algo):
    """A scripted validation curve: the rolling-average stop fires at the
    same epoch, and the progress.csv columns (MB-MPC's Epochs, TrainLoss
    and ValidLoss, the rolling average, not the last loss; GrBAL's Epochs,
    Pre-Loss and Post-Loss; ReBAL's Epochs and TrainLoss) are logged as
    the JAX model logs them. The losses at the stop are exact in f32."""
    jm, pm, data, key, keys = _twins(algo)
    script = [(0.5, 1.0), (0.4, 0.5), (0.3, 0.4), (0.25, 5.0), (0.2, 0.1)]
    if algo == 'grbal':  # (post, pre, valid)
        script = [(tr, 1.5 * tr, va) for tr, va in script]
    seen = _stub_epochs(jm, pm, script, key)
    logs = _Logger(), _Logger()
    out_j = jm.fit(*data, epochs=10, rolling_average_persitency=0.5,
                   log_tabular=True, logger=logs[0], verbose=True)
    out_p = pm.fit(*data, epochs=10, rolling_average_persitency=0.5,
                   log_tabular=True, logger=logs[1], verbose=True)
    assert out_p == out_j and out_p['epochs'] == 3
    assert seen['port'] == seen['jax'] * 4
    assert list(logs[1].kvs) == list(logs[0].kvs) == keys
    np.testing.assert_allclose(list(logs[1].kvs.values()),
                               list(logs[0].kvs.values()), rtol=1e-6)
    assert logs[1].kvs.get('ValidLoss') != 5.0


def test_state_dicts_across_packages_and_round_trip():
    """A JAX ensemble after a real fit, carried into a port model built
    from another seed (member axis, optax state, buffers and host RNG
    included), predicts as the JAX one does; the port's own state dict,
    pickled, continues a fit bit for bit."""
    jm, _ = _models(3)
    jm.fit(*_rows(300, 8), epochs=2)
    pm = PortMLP('dyn', FakeEnv(), hidden_sizes=(32, 32), batch_size=16,
                 n_members=3, seed=9, device='cpu')
    pm.load_state_dict(port_mlp.mlp_state_from_numpy(
        jax.device_get(jm.state_dict(include_data=True))))
    assert tuple(pm.params['w'][0].shape) == (3, 26, 32)
    _assert_leaves(pm.params, jm.params, rtol=0, atol=0)
    adam = jm.opt_state[1][0]
    assert int(pm.opt_state['count']) == int(adam.count)
    _assert_leaves(pm.opt_state['nu'], adam.nu, rtol=0, atol=0)
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(pm._train[k], jm._train[k])
    obs, act, _ = _rows(40, 9)
    np.testing.assert_allclose(pm.predict(obs, act), jm.predict(obs, act),
                               **BF16_TOL)

    other = PortMLP('dyn', FakeEnv(), hidden_sizes=(32, 32), batch_size=16,
                    n_members=3, seed=4, device='cpu')
    other.load_state_dict(pickle.loads(pickle.dumps(
        pm.state_dict(include_data=True))))
    rows = _rows(300, 10)
    assert pm.fit(*rows, epochs=2) == other.fit(*rows, epochs=2)
    for a, b in zip(tree_leaves(pm.params), tree_leaves(other.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert pm._rng.randint(1 << 30) == other._rng.randint(1 << 30)


# ------------------------------------------------------------------- CEM
W_PRED = np.random.RandomState(12).randn(6, 20).astype(np.float32) * 0.3


def _jax_predict(o, a):
    return o + 0.1 * jnp.tanh(a @ W_PRED)


def _port_predict(o, a):
    return o + 0.1 * torch.tanh(a @ t(W_PRED))


def _jax_cem_refit(jenv, obs, z, n, h, k, alpha, clip_rollout):
    """One CEM iteration from mean 0, std 1, transcribed from
    planners.cem's iter_body (:86-106) in JAX ops: the refit mean and std."""
    m = obs.shape[0]
    a_flat = z
    a_clip = jnp.clip(a_flat, -1.0, 1.0)
    a_exec = a_clip if clip_rollout else a_flat
    a_seq = jnp.transpose(a_exec.reshape(n, m, h, 6), (2, 1, 0, 3)).reshape(
        h, m * n, 6)
    o = jnp.repeat(obs, n, axis=0)
    ret = jnp.zeros(m * n)
    for i in range(h):
        nxt = _jax_predict(o, a_seq[i])
        ret = ret + jenv.reward(o, a_seq[i], nxt)
        o = nxt
    _, idx = jax.lax.top_k(ret.reshape(m, n), k)
    elites = jnp.take_along_axis(jnp.swapaxes(a_clip, 0, 1), idx[:, :, None],
                                 axis=1)
    return (alpha * 0.0 + (1 - alpha) * jnp.mean(elites, axis=1),
            jnp.std(elites, axis=1))


@pytest.mark.parametrize('clip_rollout', [True, False])
@pytest.mark.parametrize('iters', [1, 3])
def test_cem_matches_jax(clip_rollout, iters):
    """planners.cem against the JAX one on its own normals: the first
    actions of the last iteration; after one iteration also the elite
    refit (smoothed mean, population std of the clipped elites)."""
    jenv = jax_envs.normalize(jax_envs.HalfCheetahEnv(task=None))
    env = port_envs.normalize(port_envs.HalfCheetahEnv(task=None,
                                                       device='cpu'))
    m, n, h = 3, 40, 4
    obs = np.random.RandomState(13).randn(m, 20).astype(np.float32)
    key = jax.random.PRNGKey(14)
    j_act, _ = jax_planners.cem(
        _jax_predict, jenv.reward, jnp.asarray(obs), key, n_candidates=n,
        horizon=h, act_dim=6, num_cem_iters=iters, percent_elites=0.1,
        alpha=0.1, clip_rollout=clip_rollout)
    normals = np.stack([np.asarray(jax.random.normal(k, (n, m, h * 6)))
                        for k in jax.random.split(key, iters)])
    p_act, (mean, std) = port_planners.cem(
        _port_predict, env.reward, t(obs), None, n_candidates=n, horizon=h,
        act_dim=6, num_cem_iters=iters, percent_elites=0.1, alpha=0.1,
        clip_rollout=clip_rollout, normals=t(normals))
    np.testing.assert_allclose(p_act.numpy(), np.asarray(j_act), **F32_TOL)
    if iters == 1:
        if not clip_rollout:
            assert np.abs(np.asarray(j_act)).max() > 1.0  # unclipped draws
        j_mean, j_std = _jax_cem_refit(jenv, jnp.asarray(obs),
                                       jnp.asarray(normals[0]), n, h, 4, 0.1,
                                       clip_rollout)
        np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean),
                                   **F32_TOL)
        np.testing.assert_allclose(std.numpy(), np.asarray(j_std), **F32_TOL)


def test_controller_host_api_and_cem_option():
    """get_action(s) and get_random_action on the host, for random
    shooting and CEM, with actions in [-1, 1] and one row per env."""
    env = port_envs.normalize(port_envs.HalfCheetahEnv(task=None,
                                                       device='cpu'))
    pm = PortMLP('dyn', env, hidden_sizes=(16,), device='cpu')
    obs = np.random.RandomState(15).randn(2, 20).astype(np.float32)
    for use_cem in (False, True):
        pol = PortMPC('p', env, pm, n_candidates=16, horizon=3,
                      use_cem=use_cem, num_cem_iters=2)
        acts, info = pol.get_actions(obs)
        assert acts.shape == (2, 6) and info == {}
        assert np.abs(acts).max() <= 1.0
        assert pol.get_action(obs[0])[0].shape == (6,)
        rand = pol.get_random_action(5)
        assert rand.shape == (5, 6) and np.abs(rand).max() <= 1.0
        assert pol.vectorized and not pol.recurrent


# --------------------------------------------------------------- rollout
def test_rollout_step_matches_jax():
    """One MB-MPC rollout step (cripple tasks drawn) from an identical
    carry, with the planner's candidates drawn by JAX; the port's rollout
    packs the weights once."""
    jenv = jax_envs.normalize(jax_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True))
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device='cpu'))
    jm, pm = _models(2)
    m, n, h = 3, 16, 3
    jfn = jax_rollout_fn(jenv, JaxMPC('p', jenv, jm, n_candidates=n,
                                      horizon=h), jm, m, 4, segment_len=1)
    states, _, _, key = jfn.init_jit(jax.random.PRNGKey(8), 1)
    (j_states, _, _, _), j_out = jfn.segment_jit(
        jm.params, jm.normalizer, (states, None, None, key),
        jnp.asarray(2, jnp.int32))
    _, k_plan = jax.random.split(key)
    cand = jax.random.uniform(k_plan, (h, n * m, 6), jnp.float32, -1.0, 1.0)
    _, j_ret = jax_planners.random_shooting(
        lambda o, a: jm.predict_fn(jm.params, jm.normalizer, o, a),
        jenv.reward, states.obs, k_plan, n_candidates=n, horizon=h,
        act_dim=6)
    top2 = np.sort(np.asarray(j_ret), axis=1)[:, -2:]
    safe = np.nonzero(top2[:, 1] - top2[:, 0] > 2 * (
        RET_TOL['atol'] + RET_TOL['rtol'] * np.abs(top2[:, 1])))[0]
    assert safe.size

    p_states = EnvState(
        phys=port_engine.PhysicsState(t(states.phys.qpos),
                                      t(states.phys.qvel)),
        mm=port_spec.batched_mutable(env.wrapped_env.mm0, m, 'cpu',
                                     torch.float32),
        task={'cripple_mask': t(states.task['cripple_mask'])},
        obs=t(states.obs), t=torch.zeros(m, dtype=torch.int32),
        episode=torch.ones(m, dtype=torch.int32))
    pfn = port_rollout_fn(env, PortMPC('p', env, pm, n_candidates=n,
                                       horizon=h), pm, m, 4)
    before = port_fused.pack_weights.calls
    (p_states, aux), p_out = pfn.step_fn(
        pm.pack(pm.params), pm.normalizer, (p_states, None), 2, None,
        candidates=t(cand))
    assert aux is None and port_fused.pack_weights.calls == before + 1
    np.testing.assert_array_equal(p_out['actions'].numpy()[safe],
                                  np.asarray(j_out['actions'][safe, 0]))
    for k in ('next_observations', 'rewards', 'qpos', 'qvel'):
        np.testing.assert_allclose(p_out[k].numpy()[safe],
                                   np.asarray(j_out[k][safe, 0]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_sampler_packs_once_per_policy_call():
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device='cpu'))
    pm = PortMLP('dyn', env, hidden_sizes=(16,), device='cpu')
    sampler = PortSampler(env, PortMPC('p', env, pm, n_candidates=8,
                                       horizon=2), 2, 10, device='cpu')
    for random, packs in ((True, 0), (False, 1)):
        before = port_fused.pack_weights.calls
        paths = sampler.obtain_samples(random=random)
        assert port_fused.pack_weights.calls - before == packs
        assert paths['observations'].shape == (2, 10, 20)
        assert np.isfinite(paths['rewards']).all()


# ------------------------------------------------------- the entry point
def _tiny_config(exp_name, n_itr, **kw):
    """run_mb_mpc's config at test size: 2 envs x 20 steps, 8 candidates x
    horizon 3, hidden (32,), batch 16, 3 epochs per fit."""
    return dict(port_run.config, task='cripple', device='cpu',
                exp_name=exp_name, n_itr=n_itr, max_path_length=20,
                num_rollouts=2, n_candidates=8, horizon=3,
                hidden_sizes=(32,), batch_size=16, dynamic_model_epochs=3,
                **kw)


def _check_run(exp_dir, header_csv, keys_finite, n_rows):
    with open(header_csv) as f:
        want = f.readline()
    lines = (exp_dir / 'progress.csv').read_text().splitlines(True)
    assert lines[0] == want and len(lines) == n_rows + 1
    keys = want.strip().split(',')
    for row in lines[1:]:
        vals = dict(zip(keys, row.strip().split(',')))
        for k in keys_finite:
            assert np.isfinite(float(vals[k])), k
    return pickle.loads((exp_dir / 'params.pkl').read_bytes())


def test_entry_point_run_writes_jax_header(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = port_run.run_experiment(_tiny_config('e2e', 3))
    snap = _check_run(tmp_path / 'data' / 'mb_mpc_torch' / 'e2e', HEADER_CSV,
                      ('TrainLoss', 'ValidLoss', 'EnvTrajs-AverageReturn'), 3)
    assert snap['itr'] == 2
    env = snap['env'].wrapped_env
    assert isinstance(env, port_envs.HalfCheetahEnv) and env.task == 'cripple'
    # flattened rows, split 90/10 per fit
    assert snap['dynamics_model']['train']['obs'].shape == (3 * 36, 20)
    assert trainer.sampler.total_timesteps_sampled == 3 * 2 * 20


def test_resume_equivalence(tmp_path, monkeypatch):
    """train(4) == train(2) + resume(2) through the entry point."""
    monkeypatch.chdir(tmp_path)
    straight = port_run.run_experiment(_tiny_config('a', 4))
    port_run.run_experiment(_tiny_config('b', 2))
    resumed = port_run.run_experiment(_tiny_config('b', 4, resume=True))
    assert resumed.start_itr == 2
    ma, mb = straight.dynamics_model, resumed.dynamics_model
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(ma._train[k], mb._train[k])
        np.testing.assert_array_equal(ma._test[k], mb._test[k])
    torch.testing.assert_close(straight.sampler._generator.get_state(),
                               resumed.sampler._generator.get_state(),
                               rtol=0, atol=0)
    for pa, pb in zip(tree_leaves(ma.params), tree_leaves(mb.params)):
        np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _jax_run_script(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'run_scripts', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_point_config_and_default_device(tmp_path, monkeypatch):
    """The config dict equals the JAX run script's; the flags parse as
    run_grbal's; the default device is the card, and without one the run
    raises before writing anything."""
    jax_cfg = _jax_run_script('run_mb_mpc').config
    assert set(port_run.config) == set(jax_cfg)
    for k, v in jax_cfg.items():
        if k != 'env':
            assert port_run.config[k] == v, k
    cfg = port_run.config_from_args(port_run.parse_args(
        ['--task', 'cripple', '--n_itr', '3', '--seed', '2']))
    assert (cfg['device'], cfg['task'], cfg['n_itr'], cfg['seed']) == (
        'cuda', 'cripple', 3, 2)
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='cuda'):
        port_run.main(['--task', 'cripple', '--n_itr', '1'])
    assert not (tmp_path / 'data').exists()


# ------------------------------------------- snapshots across devices
def _record_cuda(env):
    """The env as a card-written snapshot records it: the same
    constructor arguments with device 'cuda'."""
    env.wrapped_env._Serializable__kwargs['device'] = 'cuda'
    return env


def test_env_recorded_on_cuda_loads_on_the_cpu(tmp_path):
    env = _record_cuda(port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device='cpu')))
    path = tmp_path / 'params.pkl'
    path.write_bytes(pickle.dumps(dict(itr=0, env=env)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            load_snapshot(str(path))
    back = load_snapshot(str(path), device='cpu')['env'].wrapped_env
    assert back.device == torch.device('cpu') and back.task == 'cripple'
    # the override holds only while loading
    assert pickle.loads(pickle.dumps(back)).device == torch.device('cpu')


def test_cuda_generator_state_is_refused_on_the_cpu():
    env = port_envs.normalize(port_envs.HalfCheetahEnv(task=None,
                                                       device='cpu'))
    pm = PortMLP('dyn', env, hidden_sizes=(8,), device='cpu')
    sampler = PortSampler(env, PortMPC('p', env, pm, n_candidates=4,
                                       horizon=2), 1, 5, device='cpu')
    sd = sampler.state_dict()
    assert sd['device_type'] == 'cpu'
    sampler.load_state_dict(sd)
    card = dict(sd, generator=np.zeros(16, np.uint8), device_type='cuda')
    with pytest.raises(ValueError, match='recorded from a cuda generator'):
        sampler.load_state_dict(card)


@pytest.mark.parametrize('entry', ['mb_mpc', 'grbal'])
def test_resume_on_the_cpu_from_env_recorded_on_cuda(tmp_path, monkeypatch,
                                                     entry):
    """A snapshot whose env recorded device 'cuda' resumes under --device
    cpu through each entry point's loader, with its env re-created on the
    CPU."""
    monkeypatch.chdir(tmp_path)
    if entry == 'grbal':
        run = port_grbal
        cfg = dict(port_grbal.config, task='cripple', device='cpu',
                   exp_name='r', max_path_length=30, num_rollouts=2,
                   n_candidates=8, horizon=3, hidden_sizes_model=(16,),
                   adapt_batch_size=4, meta_batch_size=4,
                   dynamic_model_epochs=2)
    else:
        run, cfg = port_run, _tiny_config('r', 2)
    run.run_experiment(dict(cfg, n_itr=2))
    path = tmp_path / 'data' / run.EXP_NAME / 'r' / 'params.pkl'
    snap = pickle.loads(path.read_bytes())
    snap['env'] = _record_cuda(snap['env'])
    path.write_bytes(pickle.dumps(snap))
    resumed = run.run_experiment(dict(cfg, n_itr=3, resume=True))
    assert resumed.start_itr == 2
    assert resumed.sampler._episode_idx == 3
    snap = pickle.loads(path.read_bytes())
    assert snap['itr'] == 2
    assert snap['env'].wrapped_env.device == torch.device('cpu')
