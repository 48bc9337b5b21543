"""Parity of the port's meta-training slice with the JAX package: the
second-order meta loss and its gradient, the clip + Adam step, epochs with
injected windows, the fit's bookkeeping (step counts, capacities, the
train/valid split and the host RNG stream), state dicts across packages,
the host adapt/predict API, the logger and config helpers, and small CPU
runs of the Trainer through the port's entry point (resume included)."""
import importlib.util
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import t
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch import run_grbal as port_run
from learning_to_adapt_torch.models import MetaMLPDynamicsModel as PortMetaMLP
from learning_to_adapt_torch.models import meta_mlp as port_meta
from learning_to_adapt_torch.samplers import (
    ModelSampleProcessor as PortProcessor)
from learning_to_adapt_torch.utils import config as port_config
from learning_to_adapt_torch.utils import logging as port_log
from learning_to_adapt_torch.utils.checkpoint import (
    load_snapshot, resume_trainer, save_snapshot)
from learning_to_adapt_tpu import envs as jax_envs
from learning_to_adapt_tpu.models import MetaMLPDynamicsModel as JaxMetaMLP
from learning_to_adapt_tpu.models import meta_mlp as jax_meta
from learning_to_adapt_tpu.models.normalizer import Normalizer as JaxNorm
from learning_to_adapt_tpu.samplers import (
    ModelSampleProcessor as JaxProcessor)
from learning_to_adapt_tpu.utils import config as jax_config
from learning_to_adapt_tpu.utils import logging as jax_log

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)   # one f32 meta loss, other op order
EPOCH_TOL = dict(rtol=1e-4, atol=1e-6)  # eight f32 Adam steps
HEADER_CSV = os.path.join(REPO, 'results', 'grbal_halfcheetah_tpu_r3.csv')


class FakeEnv:
    def __init__(self, obs_dim=20, act_dim=6):
        self.obs_dim = obs_dim
        self.act_dim = act_dim


def _leaves(tree):
    return list(tree['w']) + list(tree['b'])


def _models(hidden=(64, 64), mbs=4, bs=8, env=None, **kw):
    """A JAX model and a port model in the same state (params, optimizer
    state, normalizer), the port's loaded from the JAX state_dict."""
    env = env or FakeEnv()
    kw = dict(hidden_sizes=hidden, meta_batch_size=mbs, batch_size=bs,
              inner_learning_rate=0.01, learning_rate=1e-3, **kw)
    jm = JaxMetaMLP('dyn', env, **kw)
    pm = PortMetaMLP('dyn', env, device='cpu', **kw)
    rng = np.random.RandomState(11)
    obs, act, delta = (rng.randn(6, 40, d).astype(np.float32)
                       for d in (env.obs_dim, env.act_dim, env.obs_dim))
    jm.normalizer = JaxNorm.fit(jnp.asarray(obs), jnp.asarray(act),
                                jnp.asarray(delta))
    pm.load_state_dict(port_meta.meta_state_from_numpy(
        jax.device_get(jm.state_dict())))
    return jm, pm


def _paths(n_paths, t_len, seed, env=None):
    env = env or FakeEnv()
    rng = np.random.RandomState(seed)
    obs = rng.randn(n_paths, t_len, env.obs_dim).astype(np.float32)
    act = rng.uniform(-1, 1, (n_paths, t_len, env.act_dim)).astype(
        np.float32)
    nxt = obs + 0.1 * rng.randn(*obs.shape).astype(np.float32)
    return obs, act, nxt


def _assert_trees(port_tree, jax_tree, **tol):
    for a, b in zip(_leaves(port_tree), _leaves(jax_tree)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def _jax_loss_and_grad(jm):
    """jit of value_and_grad of the JAX model's meta_loss_fn, as its epoch
    takes it: (params, norm, obs, act, delta) -> ((post, pre), grads)."""
    return jax.jit(jax.value_and_grad(jm.meta_loss_fn, has_aux=True))


def _jax_windows(data, pidx, offs, bs):
    """(meta_bs, 2*bs, d) windows of numpy paths data, as the JAX epoch's
    sample_windows slices them."""
    return np.stack([data[p, o - bs:o + bs] for p, o in zip(pidx, offs)])


def test_meta_loss_value_and_grad_match_jax():
    jm, pm = _models()
    rng = np.random.RandomState(0)
    o, a, d = (rng.randn(4, 16, k).astype(np.float32) for k in (20, 6, 20))
    (j_post, j_pre), j_grad = _jax_loss_and_grad(jm)(
        jm.params, jm.normalizer, jnp.asarray(o), jnp.asarray(a),
        jnp.asarray(d))
    leaves = [p.detach().requires_grad_(True) for p in _leaves(pm.params)]
    n_w = len(pm.params['w'])
    post, pre = pm.meta_loss_fn({'w': leaves[:n_w], 'b': leaves[n_w:]},
                                pm.normalizer, t(o), t(a), t(d))
    grads = torch.autograd.grad(post, leaves)
    np.testing.assert_allclose(float(post.detach()), float(j_post),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(pre.detach()), float(j_pre), **LOSS_TOL)
    _assert_trees({'w': grads[:n_w], 'b': grads[n_w:]}, j_grad, **LOSS_TOL)


@pytest.mark.parametrize('scale', [1e-2, 1e3])
def test_clip_adam_steps_match_optax(scale):
    """Two clip + Adam steps from optax's initial state; scale 1e3 puts the
    global norm above 100, where the clip rescales."""
    jm, pm = _models(hidden=(16,))
    rng = np.random.RandomState(1)
    grads = [{k: [rng.randn(*np.shape(p)).astype(np.float32) * scale
                  for p in jm.params[k]] for k in ('w', 'b')}
             for _ in range(2)]
    norm = np.sqrt(sum(np.sum(np.square(g)) for g in _leaves(grads[0])))
    assert (norm > 100) == (scale > 1)
    j_params, j_state = jm.params, jm.opt_state
    p_params, p_state = pm.params, pm.opt_state
    for g in grads:
        upd, j_state = jm.optimizer.update(
            jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        p_params, p_state = pm.optimizer.update(
            {k: [t(x) for x in v] for k, v in g.items()}, p_state, p_params)
    _assert_trees(p_params, j_params, rtol=1e-5, atol=1e-7)
    adam = j_state[1][0]
    assert int(p_state['count']) == int(adam.count) == 2
    _assert_trees(p_state['mu'], adam.mu, rtol=1e-5, atol=1e-7)
    _assert_trees(p_state['nu'], adam.nu, rtol=1e-5, atol=1e-7)


def _jax_epoch(jm, params, opt_state, train, test, windows, n_train):
    """The JAX epoch recomposed step by step (meta_loss_fn + optimizer
    update over the given windows, then the plain pre-update validation
    loss); train/test: (obs, act, delta) numpy paths."""
    bs, norm = jm.batch_size, jm.normalizer
    loss_and_grad = _jax_loss_and_grad(jm)
    posts, pres, valids = [], [], []
    for i, (pidx, offs) in enumerate(windows):
        data = train if i < n_train else test
        o, a, d = (jnp.asarray(_jax_windows(x, pidx, offs, bs)) for x in data)
        if i < n_train:
            (post, pre), g = loss_and_grad(params, norm, o, a, d)
            upd, opt_state = jm.optimizer.update(g, opt_state, params)
            params = optax.apply_updates(params, upd)
            posts.append(float(post))
            pres.append(float(pre))
        else:
            valids.append(float(jm._mse(params, norm.norm_obs(o),
                                        norm.norm_act(a),
                                        norm.norm_delta(d))))
    return params, opt_state, np.mean(posts), np.mean(pres), np.mean(valids)


def _port_epoch(pm, train, test, windows, n_train):
    n_tr, n_te = train[0].shape[0], test[0].shape[0]
    cap = port_meta.PATH_CHUNK
    staged = [pm.stage(dict(obs=o, act=a, delta=d), cap)
              for o, a, d in (train, test)]
    win = [(torch.as_tensor(p), torch.as_tensor(o)) for p, o in windows]
    params, state, post, pre, valid = pm.epoch_fn(
        pm.params, pm.opt_state, pm.normalizer, staged[0], staged[1], n_tr,
        n_te, n_train, len(windows) - n_train, None, windows=win)
    return params, state, float(post), float(pre), float(valid)


def _draw_windows(rng, n_steps, n_paths, t_len, mbs, bs):
    return [(rng.randint(0, n_paths, mbs), rng.randint(bs, t_len - bs, mbs))
            for _ in range(n_steps)]


def test_epoch_with_injected_windows_matches_jax():
    """Eight meta-train steps and two validation steps on the same windows:
    losses and final params held to the JAX math step for step."""
    jm, pm = _models()
    train, test = _paths(6, 40, 2), _paths(2, 40, 3)
    train = (train[0], train[1], train[2] - train[0])
    test = (test[0], test[1], test[2] - test[0])
    rng = np.random.RandomState(4)
    windows = (_draw_windows(rng, 8, 6, 40, 4, 8) +
               _draw_windows(rng, 2, 2, 40, 4, 8))
    j_params, j_state, *j_losses = _jax_epoch(
        jm, jm.params, jm.opt_state, train, test, windows, 8)
    p_params, p_state, *p_losses = _port_epoch(pm, train, test, windows, 8)
    np.testing.assert_allclose(p_losses, j_losses, **EPOCH_TOL)
    _assert_trees(p_params, j_params, **EPOCH_TOL)
    assert int(p_state['count']) == int(j_state[1][0].count) == 8


def test_bucket_pow2_matches_jax():
    got = [port_meta._bucket_pow2(n) for n in range(4097)]
    assert got == [jax_meta._bucket_pow2(n) for n in range(4097)]


@pytest.mark.parametrize('n_paths,t_len,mbs,bs', [
    (5, 100, 10, 16), (3, 64, 4, 8), (12, 40, 2, 4), (1, 30, 10, 8)])
def test_fit_shapes_and_split_match_jax(n_paths, t_len, mbs, bs):
    """Twenty successive fits with the epochs stubbed out on both sides
    (the port's at the shared loop's seam, `_fit_epoch`): the capacities
    and step counts every fit hands its epoch, and the aggregated
    train/valid buffers, equal the JAX package's."""
    env = FakeEnv()
    jm = JaxMetaMLP('dyn', env, hidden_sizes=(8,), meta_batch_size=mbs,
                    batch_size=bs, valid_split_ratio=0.1, seed=3)
    pm = PortMetaMLP('dyn', env, hidden_sizes=(8,), meta_batch_size=mbs,
                     batch_size=bs, valid_split_ratio=0.1, seed=3,
                     device='cpu')
    j_seen, p_seen = [], []

    def jax_get_epoch_fn(*ck):
        j_seen.append(ck)
        return lambda params, opt_state, *_: (params, opt_state, 0., 0., 0.)
    jm._get_epoch_fn = jax_get_epoch_fn

    def port_fit_epoch(compiled, generator, counts):
        train, test = compiled.state.train, compiled.state.test
        _, _, steps_per_epoch, steps_test = counts
        p_seen.append((train.shape[0], test.shape[0], train.shape[1],
                       steps_per_epoch, steps_test))
        return [torch.zeros(())] * 3
    pm._fit_epoch = port_fit_epoch
    for i in range(20):
        paths = _paths(n_paths, t_len, 100 + i, env)
        jm.fit(*paths, epochs=1)
        pm.fit(*paths, epochs=1)
    assert p_seen == j_seen
    p_tr, p_te = pm._train['obs'].shape[0], pm._test['obs'].shape[0]
    assert pm._fit_shapes(p_tr, p_te, t_len) == j_seen[-1][:2] + j_seen[-1][3:]
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(pm._train[k], jm._train[k])
        np.testing.assert_array_equal(pm._test[k], jm._test[k])


def _fit_twice(jm, pm):
    for seed in (20, 21):
        paths = _paths(4, 30, seed)
        jm.fit(*paths, epochs=2)
        pm.fit(*paths, epochs=2)


def test_two_fits_split_and_state_match_jax():
    """Two real fits with one seed: the aggregated buffers are bitwise the
    JAX package's and the normalizer agrees; then the JAX state_dict with
    data, loaded into a fresh port model, carries params, optimizer state,
    buffers and the host RNG, and one more injected step agrees."""
    jm, pm = _models(hidden=(32,))
    _fit_twice(jm, pm)
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(pm._train[k], jm._train[k])
        np.testing.assert_array_equal(pm._test[k], jm._test[k])
    for f in ('obs_mean', 'obs_std', 'delta_mean', 'delta_std'):
        np.testing.assert_allclose(getattr(pm.normalizer, f).numpy(),
                                   np.asarray(getattr(jm.normalizer, f)),
                                   rtol=1e-5, atol=1e-6)

    fresh = PortMetaMLP('dyn', FakeEnv(), hidden_sizes=(32,),
                        meta_batch_size=4, batch_size=8, seed=9,
                        inner_learning_rate=0.01, device='cpu')
    fresh.load_state_dict(port_meta.meta_state_from_numpy(
        jax.device_get(jm.state_dict(include_data=True))))
    _assert_trees(fresh.params, jm.params, rtol=0, atol=0)
    adam = jm.opt_state[1][0]
    assert int(fresh.opt_state['count']) == int(adam.count)
    _assert_trees(fresh.opt_state['nu'], adam.nu, rtol=0, atol=0)
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(fresh._train[k], jm._train[k])
    assert fresh._rng.randint(1 << 30) == jm._rng.randint(1 << 30)

    train = tuple(jm._train[k] for k in ('obs', 'act', 'delta'))
    test = tuple(jm._test[k] for k in ('obs', 'act', 'delta'))
    rng = np.random.RandomState(5)
    windows = (_draw_windows(rng, 1, train[0].shape[0], 30, 4, 8) +
               _draw_windows(rng, 1, test[0].shape[0], 30, 4, 8))
    j_params, _, *j_losses = _jax_epoch(jm, jm.params, jm.opt_state, train,
                                        test, windows, 1)
    p_params, _, *p_losses = _port_epoch(fresh, train, test, windows, 1)
    np.testing.assert_allclose(p_losses, j_losses, **LOSS_TOL)
    _assert_trees(p_params, j_params, **LOSS_TOL)


def test_port_state_dict_round_trip():
    """The port's own state_dict(include_data=True), pickled and loaded into
    a model built from another seed, continues bit for bit: the next fit
    gives the same params, buffers and host RNG state."""
    _, pm = _models(hidden=(32,))
    pm.fit(*_paths(4, 30, 30), epochs=2)
    other = PortMetaMLP('dyn', FakeEnv(), hidden_sizes=(32,),
                        meta_batch_size=4, batch_size=8, seed=7,
                        inner_learning_rate=0.01, device='cpu')
    other.load_state_dict(pickle.loads(pickle.dumps(
        pm.state_dict(include_data=True))))
    paths = _paths(4, 30, 31)
    out_a = pm.fit(*paths, epochs=3)
    out_b = other.fit(*paths, epochs=3)
    assert out_a == out_b
    for a, b in zip(_leaves(pm.params), _leaves(other.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(pm._train[k], other._train[k])
    assert pm._rng.randint(1 << 30) == other._rng.randint(1 << 30)


def test_checkpoint_helpers(tmp_path):
    """save_snapshot / load_snapshot carry a model into another seed's
    model; resume_trainer finds nothing in an empty directory."""
    _, pm = _models(hidden=(16,))
    pm.fit(*_paths(4, 30, 40), epochs=2)
    path = str(tmp_path / 'snap.pkl')
    save_snapshot(path, 7, pm, config={'a': 1}, extra={'note': 'x'})
    snap = load_snapshot(path)
    assert (snap['itr'], snap['config'], snap['note']) == (7, {'a': 1}, 'x')
    other = PortMetaMLP('dyn', FakeEnv(), hidden_sizes=(16,), seed=5,
                        device='cpu')
    other.load_state_dict(snap['dynamics_model'])
    obs, act, _ = _paths(1, 8, 41)
    np.testing.assert_array_equal(other.predict(obs[0], act[0]),
                                  pm.predict(obs[0], act[0]))
    assert resume_trainer(str(tmp_path), other) == 0


def test_host_adapt_predict_and_restore():
    """Host API, as tests/test_models.py holds the JAX model: adaptation
    changes the predictions, switch_to_pre_adapt restores them, and both
    agree with the JAX model's at the planner's bf16 tolerance."""
    env = FakeEnv(obs_dim=4, act_dim=2)
    jm, pm = _models(env=env)
    obs, act, nxt = _paths(2, 32, 6, env)
    pm.fit(obs, act, nxt, epochs=3)
    jm.load_state_dict(dict(params=jax.tree.map(jnp.asarray, {
        k: [p.numpy() for p in v] for k, v in pm.params.items()}),
        opt_state=jm.opt_state, normalizer=JaxNorm(**{
            f: jnp.asarray(getattr(pm.normalizer, f).numpy())
            for f in ('obs_mean', 'obs_std', 'act_mean', 'act_std',
                      'delta_mean', 'delta_std')})))
    before = pm.predict(obs[0, :8], act[0, :8])
    rows_o = obs[:, 8:16].reshape(16, -1)
    rows_a = act[:, 8:16].reshape(16, -1)
    pre_rows = pm.predict(rows_o, rows_a)
    assert not pm.adapted and not pm.recurrent
    pm.adapt(list(obs[:, :8]), list(act[:, :8]), list(nxt[:, :8]))
    jm.adapt(list(obs[:, :8]), list(act[:, :8]), list(nxt[:, :8]))
    assert pm.adapted
    after = pm.predict(rows_o, rows_a)
    assert after.shape == (16, 4)
    assert not np.allclose(after, pre_rows)
    np.testing.assert_allclose(after, jm.predict(rows_o, rows_a), rtol=2e-3,
                               atol=2e-3)
    pm.switch_to_pre_adapt()
    assert not pm.adapted
    np.testing.assert_allclose(pm.predict(obs[0, :8], act[0, :8]), before,
                               rtol=1e-5)


def _log_sequence(lib, exp_dir, paths, env, proc):
    """One sequence of logger calls, as a trainer iteration makes them,
    against either package's logger."""
    lg = lib.configure(dir=exp_dir, format_strs=['csv', 'log'])
    lib.logkv('EnvSampler-TimeStepsCtr', 60)
    lib.logkv('EnvSampler-EnvExecTime', 0.0)
    proc.process_samples(paths, log=True, log_prefix='EnvTrajs-')
    env.log_diagnostics(paths, prefix='EnvTrajs-')
    lib.logkv('Epochs', 3)
    lib.logkv('Pre-Loss', 0.125)
    lib.logkv_mean('Profile-x', 1.0)
    lib.logkv_mean('Profile-x', 4.0)
    first = lib.dumpkvs()
    lib.logkv('EnvSampler-TimeStepsCtr', 120)
    lib.logkv('Post-Loss', None)
    lib.logkv('Itr', 1)
    second = lib.dumpkvs()
    lg.close()
    return first, second


def test_logger_csv_and_diagnostics_match_jax(tmp_path):
    rng = np.random.RandomState(7)
    paths = dict(observations=rng.randn(2, 30, 20).astype(np.float32),
                 next_observations=rng.randn(2, 30, 20).astype(np.float32),
                 actions=rng.uniform(-1, 1, (2, 30, 6)).astype(np.float32),
                 rewards=rng.randn(2, 30).astype(np.float32))
    jenv = jax_envs.HalfCheetahEnv(task=None)
    penv = port_envs.HalfCheetahEnv(task=None, device='cpu')
    j = _log_sequence(jax_log, str(tmp_path / 'j'), paths, jenv,
                      JaxProcessor(recurrent=True))
    p = _log_sequence(port_log, str(tmp_path / 'p'), paths, penv,
                      PortProcessor(recurrent=True))
    assert p == j
    for name in ('progress.csv', 'log.txt'):
        assert ((tmp_path / 'p' / name).read_bytes() ==
                (tmp_path / 'j' / name).read_bytes())
    lines = (tmp_path / 'p' / 'progress.csv').read_text().splitlines()
    assert lines[0].endswith('Post-Loss,Itr') and lines[1].endswith(',,')


@pytest.mark.parametrize('mode', ['all', 'last', 'gap', 'last_gap', 'none'])
def test_snapshot_modes_match_jax(tmp_path, mode):
    for name, lib in (('j', jax_log), ('p', port_log)):
        lg = lib.configure(dir=str(tmp_path / name), format_strs=[],
                           snapshot_mode=mode, snapshot_gap=2)
        for itr in range(4):
            lg.save_itr_params(itr, {'itr': itr})
    assert (sorted(os.listdir(tmp_path / 'p')) ==
            sorted(os.listdir(tmp_path / 'j')))
    if mode in ('last', 'last_gap'):
        snap = pickle.loads((tmp_path / 'p' / 'params.pkl').read_bytes())
        assert snap['itr'] == (3 if mode == 'last' else 2)
    if mode == 'gap':
        assert not (tmp_path / 'p' / 'itr_1.pkl').exists()


def test_resume_config_guard_and_class_encoder(tmp_path):
    """check_resume_config refuses a changed task distribution and accepts
    the same one, on either package's params.json; the port's ClassEncoder
    writes the env by name as the JAX one does."""
    cfg = dict(port_run.config, task='cripple', cripple_set=(1, 2, 3),
               seed=0)
    with open(tmp_path / 'params.json', 'w') as f:
        json.dump(cfg, f, cls=port_config.ClassEncoder)
    saved = json.loads((tmp_path / 'params.json').read_text())
    assert saved['env'] == {
        '$class': 'learning_to_adapt_torch.envs.half_cheetah.HalfCheetahEnv'}
    for check in (port_config.check_resume_config,
                  jax_config.check_resume_config):
        check(str(tmp_path), cfg)
        check(str(tmp_path), dict(cfg, env=jax_envs.HalfCheetahEnv,
                                  cripple_set=[1, 2, 3]))
        for bad in (dict(cfg, cripple_set=(1, 2)), dict(cfg, seed=1),
                    dict(cfg, task=None)):
            with pytest.raises(ValueError, match='--resume config mismatch'):
                check(str(tmp_path), bad)
    assert (port_config.RESUME_IDENTITY_KEYS ==
            jax_config.RESUME_IDENTITY_KEYS)
    assert (set(port_config.TASK_DISTRIBUTION_KEYS) ==
            set(jax_config.TASK_DISTRIBUTION_KEYS))


def test_env_pickles_by_constructor_replay():
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, cripple_set=(2, 4),
        device='cpu'))
    back = pickle.loads(pickle.dumps(env))
    assert isinstance(back, port_envs.NormalizedEnv)
    inner = back.wrapped_env
    assert isinstance(inner, port_envs.HalfCheetahEnv)
    assert (inner.task, inner.cripple_set, inner.reset_every_episode,
            inner.device) == ('cripple', (2, 4), True, torch.device('cpu'))
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    s1, s2 = (e.reset(3, 1, g) for e, g in zip((env, back), gens))
    torch.testing.assert_close(s1.obs, s2.obs, rtol=0, atol=0)
    torch.testing.assert_close(s1.task['cripple_mask'],
                               s2.task['cripple_mask'], rtol=0, atol=0)
    clone = port_envs.HalfCheetahEnv.clone(inner, task=None)
    assert clone.task is None and clone.cripple_set == (2, 4)


def _tiny_config(exp_name, n_itr, **kw):
    """The entry point's config at test size: 2 envs x 30 steps, 8
    candidates x horizon 3, hidden (32,), windows of 2 x 4 steps, meta
    batch 4, 3 epochs per fit."""
    return dict(port_run.config, task='cripple', device='cpu',
                exp_name=exp_name, n_itr=n_itr, max_path_length=30,
                num_rollouts=2, n_candidates=8, horizon=3,
                hidden_sizes_model=(32,), adapt_batch_size=4,
                meta_batch_size=4, dynamic_model_epochs=3, **kw)


def test_trainer_run_writes_jax_header_and_snapshot(tmp_path, monkeypatch):
    """Three iterations through run_experiment on the CPU: progress.csv has
    the header of the JAX package's canonical run letter for letter, the
    losses are finite, params.pkl loads with its env re-created, and
    --profile leaves a trace of one sampling pass and one fit."""
    monkeypatch.chdir(tmp_path)
    trainer = port_run.run_experiment(_tiny_config('e2e', 3, profile=True))
    exp_dir = tmp_path / 'data' / 'grbal_torch' / 'e2e'
    with open(HEADER_CSV) as f:
        want = f.readline()
    lines = (exp_dir / 'progress.csv').read_text().splitlines(True)
    assert lines[0] == want and len(lines) == 4
    keys = want.strip().split(',')
    for row in lines[1:]:
        vals = dict(zip(keys, row.strip().split(',')))
        for k in ('Pre-Loss', 'Post-Loss', 'EnvTrajs-AverageReturn'):
            assert np.isfinite(float(vals[k])), k
    assert [int(r.split(',')[keys.index('Itr')]) for r in lines[1:]] == [
        0, 1, 2]
    snap = pickle.loads((exp_dir / 'params.pkl').read_bytes())
    assert snap['itr'] == 2 and snap['config']['exp_name'] == 'e2e'
    env = snap['env'].wrapped_env
    assert isinstance(env, port_envs.HalfCheetahEnv) and env.task == 'cripple'
    assert snap['dynamics_model']['train']['obs'].shape == (3, 30, 20)
    assert trainer.sampler.total_timesteps_sampled == 3 * 2 * 30
    for sub in ('sampling', 'fit'):
        assert (exp_dir / 'profile' / sub / 'trace.json').stat().st_size > 0
    saved = json.loads((exp_dir / 'params.json').read_text())
    assert saved['device'] == 'cpu' and saved['hidden_sizes_model'] == [32]


def test_resume_equivalence(tmp_path, monkeypatch):
    """train(4) == train(2) + resume(2) through the entry point: the same
    aggregated dataset, sampler generator state and counters, and params,
    as tests/test_replay_e2e.py holds the JAX package."""
    monkeypatch.chdir(tmp_path)
    straight = port_run.run_experiment(_tiny_config('a', 4))
    port_run.run_experiment(_tiny_config('b', 2))
    resumed = port_run.run_experiment(_tiny_config('b', 4, resume=True))
    assert resumed.start_itr == 2
    ma, mb = straight.dynamics_model, resumed.dynamics_model
    sa, sb = straight.sampler, resumed.sampler
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(ma._train[k], mb._train[k])
        np.testing.assert_array_equal(ma._test[k], mb._test[k])
    torch.testing.assert_close(sa._generator.get_state(),
                               sb._generator.get_state(), rtol=0, atol=0)
    assert sa._episode_idx == sb._episode_idx == 4
    assert sa.total_timesteps_sampled == sb.total_timesteps_sampled
    for pa, pb in zip(_leaves(ma.params), _leaves(mb.params)):
        np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=1e-5,
                                   atol=1e-6)
    snap = pickle.loads((tmp_path / 'data' / 'grbal_torch' / 'b' /
                         'params.pkl').read_bytes())
    assert snap['itr'] == 3 and snap['sampler'] is not None
    assert snap['dynamics_model']['train'] is not None
    with pytest.raises(ValueError, match='--resume config mismatch'):
        port_run.run_experiment(_tiny_config('b', 5, resume=True, seed=1))


def _jax_run_script():
    spec = importlib.util.spec_from_file_location(
        'jax_run_grbal', os.path.join(REPO, 'run_scripts', 'run_grbal.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_point_config_and_flags_match_run_script():
    jax_cfg = _jax_run_script().config
    assert set(port_run.config) == set(jax_cfg)
    for k, v in jax_cfg.items():
        if k != 'env':
            assert port_run.config[k] == v, k
    assert port_run.config['env'] is port_envs.HalfCheetahEnv
    assert jax_cfg['env'].__name__ == 'HalfCheetahEnv'
    cfg = port_run.config_from_args(port_run.parse_args(
        ['--task', 'cripple', '--n_itr', '3', '--seed', '2', '--resume',
         '--cripple_set', '1,2', '--exp_name', 'x', '--profile']))
    assert cfg['device'] == 'cuda'
    assert (cfg['task'], cfg['n_itr'], cfg['seed'], cfg['resume'],
            cfg['cripple_set'], cfg['exp_name'], cfg['profile']) == (
        'cripple', 3, 2, True, (1, 2), 'x', True)
    assert port_run.config['n_itr'] == 50   # the module's dict is untouched
    ant = port_run.config_from_args(port_run.parse_args(['--env', 'AntEnv']))
    assert ant['env'] is port_envs.AntEnv
    with pytest.raises(ValueError, match='HalfCheetahEnv'):
        port_run.config_from_args(port_run.parse_args(['--env', 'Humanoid']))


def test_entry_point_defaults_to_cuda_and_never_falls_back(tmp_path,
                                                          monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is usable')
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='cuda'):
        port_run.main(['--task', 'cripple', '--n_itr', '1'])
    assert not (tmp_path / 'data').exists()
