"""Parity of the port's ReBAL slice with the JAX package: the recurrent
cells, the recurrent model's sequence and single-step forwards, TBPTT
gradients, train steps and the masked validation loss on injected path
indices, the split and host RNG stream, state dicts, the recurrent
planners, the controller's reset, one rollout step for each hidden-state
ablation, and the run_rebal entry point on the CPU (resume included)."""
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
from learning_to_adapt_torch import run_rebal as port_run
from learning_to_adapt_torch.envs.base import EnvState
from learning_to_adapt_torch.models import RNNDynamicsModel as PortRNN
from learning_to_adapt_torch.models import core as port_core
from learning_to_adapt_torch.models import rnn as port_rnn
from learning_to_adapt_torch.models.optim import tree_leaves, tree_map
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_torch.policies import RNNMPCController as PortRNNMPC
from learning_to_adapt_torch.policies import planners as port_planners
from learning_to_adapt_torch.utils import tracing
from learning_to_adapt_torch.samplers.rollout import (
    make_rollout_fn as port_rollout_fn)
from learning_to_adapt_tpu import envs as jax_envs
from learning_to_adapt_tpu.models import RNNDynamicsModel as JaxRNN
from learning_to_adapt_tpu.models import core as jax_core
from learning_to_adapt_tpu.models.normalizer import Normalizer as JaxNorm
from learning_to_adapt_tpu.policies import RNNMPCController as JaxRNNMPC
from learning_to_adapt_tpu.policies import planners as jax_planners
from learning_to_adapt_tpu.samplers.rollout import (
    make_rollout_fn as jax_rollout_fn)

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=1e-5)
SEQ_TOL = dict(rtol=1e-4, atol=1e-5)    # 40 f32 recurrent steps
EPOCH_TOL = dict(rtol=1e-4, atol=1e-6)  # a few f32 Adam steps
HEADER_CSV = os.path.join(REPO, 'results', 'rebal_halfcheetah_tpu_r3.csv')
CELL_TYPES = ('lstm', 'gru', 'rnn')


class FakeEnv:
    obs_dim, act_dim = 20, 6


def _assert_trees(port_tree, jax_tree, **tol):
    p, j = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(p) == len(j)
    for a, b in zip(p, j):
        assert tuple(a.shape) == np.shape(b)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def _models(cell='lstm', hidden=(32,), env=None, **kw):
    """A JAX and a port recurrent model in the same state, the port's
    loaded from the JAX state_dict through rnn_state_from_numpy."""
    env = env or FakeEnv()
    kw = dict(hidden_sizes=hidden, cell_type=cell, learning_rate=1e-3,
              batch_size=3, backprop_steps=10, **kw)
    jm = JaxRNN('dyn', env, **kw)
    pm = PortRNN('dyn', env, device='cpu', **kw)
    rng = np.random.RandomState(21)
    obs, act, delta = (rng.randn(4, 30, d).astype(np.float32)
                       for d in (20, 6, 20))
    jm.normalizer = JaxNorm.fit(jnp.asarray(obs), jnp.asarray(act),
                                jnp.asarray(delta))
    pm.load_state_dict(port_rnn.rnn_state_from_numpy(
        jax.device_get(jm.state_dict())))
    return jm, pm


def _hidden(jm, batch, seed):
    """A random non-zero hidden state of the model's layout, as JAX arrays
    and as port tensors."""
    rng = np.random.RandomState(seed)
    h = jax.tree.map(lambda z: rng.randn(*z.shape).astype(np.float32) * 0.5,
                     jm.get_initial_hidden(batch))
    return jax.tree.map(jnp.asarray, h), tree_map(t, h)


def _paths(n, t_len, seed):
    rng = np.random.RandomState(seed)
    obs = rng.randn(n, t_len, 20).astype(np.float32)
    act = rng.uniform(-1, 1, (n, t_len, 6)).astype(np.float32)
    nxt = obs + 0.1 * rng.randn(n, t_len, 20).astype(np.float32)
    return obs, act, nxt


@pytest.mark.parametrize('cell', CELL_TYPES)
def test_cell_step_matches_jax(cell):
    """Each cell step from a non-zero carry, with the JAX cell's params."""
    init, step, zero = jax_core.CELLS[cell]
    jp = init(jax.random.PRNGKey(1), 26, 16)
    rng = np.random.RandomState(2)
    x = rng.randn(5, 26).astype(np.float32)
    carry = jax.tree.map(lambda z: rng.randn(*z.shape).astype(np.float32),
                         zero(5, 16, jnp.float32))
    j_carry, j_out = step(jp, jax.tree.map(jnp.asarray, carry),
                          jnp.asarray(x))
    _, p_step, p_zero = port_core.CELLS[cell]
    p_carry, p_out = p_step(tree_map(t, jax.device_get(jp)),
                            tree_map(t, carry), t(x))
    _assert_trees(p_carry, j_carry, **F32_TOL)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), **F32_TOL)
    # the port's init: the JAX layout and Xavier limit, zero bias
    pp = port_core.CELLS[cell][0](torch.Generator().manual_seed(0), 26, 16)
    assert {k: tuple(v.shape) for k, v in pp.items()} == {
        k: v.shape for k, v in jp.items()}
    k = {'lstm': 4, 'gru': 3, 'rnn': 1}[cell]
    assert float(pp['wi'].abs().max()) <= np.sqrt(6.0 / (26 + 16 + k * 16))
    assert float(pp['b'].abs().max()) == 0
    assert tree_leaves(p_zero(2, 16, torch.float32, 'cpu'))[0].shape == (2, 16)


@pytest.mark.parametrize('cell', CELL_TYPES)
def test_forward_seq_and_predict_fn_match_jax(cell):
    """Two stacked layers of different widths: the sequence forward
    (torch's recurrent layers) and the single-step prediction (the cell
    equations) from a non-zero hidden state."""
    jm, pm = _models(cell, hidden=(16, 12))
    obs, act, _ = _paths(3, 40, 3)
    j_h, p_h = _hidden(jm, 3, 4)
    j_pred, j_hid = jm.forward_seq(jm.params, jm.normalizer,
                                   jnp.asarray(obs), jnp.asarray(act), j_h)
    p_pred, p_hid = pm.forward_seq(pm.params, pm.normalizer, t(obs), t(act),
                                   p_h)
    np.testing.assert_allclose(p_pred.numpy(), np.asarray(j_pred), **SEQ_TOL)
    _assert_trees(p_hid, j_hid, **SEQ_TOL)
    j_next, j_hid1 = jm.predict_fn(jm.params, jm.normalizer,
                                   jnp.asarray(obs[:, 0]),
                                   jnp.asarray(act[:, 0]), j_h)
    p_next, p_hid1 = pm.predict_fn(pm.params, pm.normalizer, t(obs[:, 0]),
                                   t(act[:, 0]), p_h)
    np.testing.assert_allclose(p_next.numpy(), np.asarray(j_next), **F32_TOL)
    _assert_trees(p_hid1, j_hid1, **F32_TOL)
    got, hid = pm.predict(obs[:, 0], act[:, 0], p_h)
    np.testing.assert_allclose(got, p_next.numpy(), rtol=0, atol=0)


def _staged(n, cap, t_len, seed):
    """(JAX train tuple (obs, act, delta, w), port staged paths, port
    (paths, w)) for n real paths padded to cap."""
    obs, act, nxt = _paths(n, t_len, seed)
    out = []
    for a in (obs, act, nxt - obs):
        p = np.zeros((cap,) + a.shape[1:], np.float32)
        p[:n] = a
        out.append(p)
    w = (np.arange(cap) < n).astype(np.float32)
    paths = t(np.concatenate(out, -1))
    return tuple(out) + (w,), paths, (paths, t(w))


def _epochs(cell, n_batches, t_len=40):
    """One JAX epoch of n_batches TBPTT steps (t_len a multiple of
    backprop_steps: 4 chunks) and the port's on the JAX path indices."""
    jm, pm = _models(cell, hidden=(24,))
    j_tr, p_tr, _ = _staged(6, 8, t_len, 5)
    j_te, _, p_te = _staged(3, 8, t_len, 6)
    key = jax.random.PRNGKey(7)
    j_out = jm._get_epoch_fn(8, 8, t_len, n_batches)(
        jm.params, jm.opt_state, jm.normalizer,
        tuple(map(jnp.asarray, j_tr)), tuple(map(jnp.asarray, j_te)),
        jnp.asarray(6), key)
    # the path indices the JAX epoch drew (models/rnn.py:264, 272)
    pidx = [torch.as_tensor(np.array(jax.random.randint(k, (3,), 0, 6)))
            for k in jax.random.split(key, n_batches)]
    p_out = pm.epoch_fn(pm.params, pm.opt_state, pm.normalizer, p_tr, p_te,
                        6, n_batches, None, path_idx=pidx)
    return j_out, p_out


@pytest.mark.parametrize('cell', ['lstm', 'gru'])
def test_tbptt_gradient_matches_jax(cell):
    """One step: Adam's first moment after it is 0.1 x the (clipped)
    gradient, so the moments hold the TBPTT gradient of each package."""
    (_, j_opt, j_loss, _), (_, p_opt, p_loss, _) = _epochs(cell, 1)
    np.testing.assert_allclose(float(p_loss), float(j_loss), **SEQ_TOL)
    adam = j_opt[1][0]
    _assert_trees(p_opt['mu'], adam.mu, rtol=1e-4, atol=1e-7)
    _assert_trees(p_opt['nu'], adam.nu, rtol=1e-3, atol=1e-10)


def _summed_tbptt_grad(pm, st, obs, act, delta, scale):
    """The TBPTT loss as one sum over the chunks (the hidden state detached
    between them), scaled, and autograd.grad of it over the fit state's
    leaves."""
    bp = pm.backprop_steps
    n_chunks = obs.shape[1] // bp
    hidden = pm.get_initial_hidden(obs.shape[0])
    total = 0.0
    for c in range(n_chunks):
        span = slice(c * bp, (c + 1) * bp)
        pred, hidden = pm._seq(st.layers, st.out, st.norm, obs[:, span],
                               act[:, span], hidden)
        total = total + torch.mean(torch.square(
            pred - st.norm.norm_delta(delta[:, span])))
        hidden = tree_map(torch.Tensor.detach, hidden)
    loss = total / n_chunks * scale
    return loss, torch.autograd.grad(loss, st.leaves)


@pytest.mark.parametrize('n_chunks', [1, 2, 10])
@pytest.mark.parametrize('cell', CELL_TYPES)
def test_chunk_gradients_sum_to_the_tbptt_gradient(cell, n_chunks):
    """Each chunk's gradient taken as its forward ends (tbptt_chunks),
    summed in chunk order and scaled by a rank's share (chunk_grads),
    against autograd.grad of the summed TBPTT loss, on the fit state's two
    stacked layers; on the CPU nothing forks and 'rnn.chunk_streams'
    adds 0."""
    _, pm = _models(cell, hidden=(16, 12))
    _, paths, test = _staged(3, 3, pm.backprop_steps * n_chunks, 9)
    st = pm._fit_state(pm.params, pm.opt_state, pm.normalizer, paths, test,
                       1)
    obs, act, delta = pm._split(paths)
    want_loss, want = _summed_tbptt_grad(pm, st, obs, act, delta, 0.5)
    before = tracing.counters().get('rnn.chunk_streams', 0)
    loss, grads, streams = pm.tbptt_chunks(st.layers, st.out, st.norm, obs,
                                           act, delta, st.leaves)
    assert streams == [None] * n_chunks and len(grads) == n_chunks
    assert tracing.counters()['rnn.chunk_streams'] == before
    got = pm.chunk_grads(grads, streams, 0.5)
    torch.testing.assert_close(loss * 0.5, want_loss.detach(), **F32_TOL)
    assert len(got) == len(want) == len(st.leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_train_steps_and_masked_validation_match_jax():
    """Three TBPTT train steps, then the masked loss over the padded test
    set (3 real paths in 8)."""
    (j_params, j_opt, j_loss, j_valid), (p_params, p_opt, p_loss,
                                         p_valid) = _epochs('lstm', 3)
    np.testing.assert_allclose([float(p_loss), float(p_valid)],
                               [float(j_loss), float(j_valid)], **EPOCH_TOL)
    _assert_trees(p_params, j_params, **EPOCH_TOL)
    assert int(p_opt['count']) == int(j_opt[1][0].count) == 3


@pytest.mark.parametrize('n_paths', [1, 5])
def test_fit_split_and_rng_stream_match_jax(n_paths):
    """Successive fits with the epochs stubbed out (the port's at the
    shared loop's seam, `_fit_epoch`): capacities, path counts, batch
    counts, the aggregated buffers (with one path, the split
    takes it and the test set is idx[-1:]) and the host RNG state equal
    the JAX package's."""
    env = FakeEnv()
    kw = dict(hidden_sizes=(8,), batch_size=2, backprop_steps=10,
              valid_split_ratio=0.1, seed=3)
    jm = JaxRNN('dyn', env, **kw)
    pm = PortRNN('dyn', env, device='cpu', **kw)
    seen = dict(jax=[], port=[])

    def jax_get_epoch_fn(*ck):
        seen['jax'].append(ck)
        return lambda params, opt_state, *_: (params, opt_state, 0., 1.)
    jm._get_epoch_fn = jax_get_epoch_fn

    def port_fit_epoch(compiled, generator, counts):
        train, test = compiled.state.train, compiled.state.test
        _, n_batches = counts
        seen['port'].append((train.shape[0], test[0].shape[0],
                             train.shape[1], n_batches))
        return torch.tensor(0.), torch.tensor(1.)
    pm._fit_epoch = port_fit_epoch
    for i in range(6):
        paths = _paths(n_paths, 20, 100 + i)
        jm.fit(*paths, epochs=1)
        pm.fit(*paths, epochs=1)
    assert seen['port'] == seen['jax']
    for k in ('obs', 'act', 'delta'):
        np.testing.assert_array_equal(pm._train[k], jm._train[k])
        np.testing.assert_array_equal(pm._test[k], jm._test[k])
    assert pm._rng.randint(1 << 30) == jm._rng.randint(1 << 30)


def test_state_dicts_across_packages_and_round_trip():
    """A JAX model after a real fit, carried into a port model built from
    another seed, predicts as the JAX one does; the port's own state dict,
    pickled, continues a fit bit for bit."""
    jm, _ = _models('gru', hidden=(16,))
    jm.fit(*_paths(4, 20, 8), epochs=2)
    pm = PortRNN('dyn', FakeEnv(), hidden_sizes=(16,), cell_type='gru',
                 batch_size=3, backprop_steps=10, seed=5, device='cpu')
    pm.load_state_dict(port_rnn.rnn_state_from_numpy(
        jax.device_get(jm.state_dict(include_data=True))))
    _assert_trees(pm.params, jm.params, rtol=0, atol=0)
    assert sorted(pm.params) == ['cells', 'out']
    adam = jm.opt_state[1][0]
    assert int(pm.opt_state['count']) == int(adam.count)
    _assert_trees(pm.opt_state['mu'], adam.mu, rtol=0, atol=0)
    obs, act, _ = _paths(2, 1, 9)
    j_h, p_h = _hidden(jm, 2, 10)
    want, _ = jm.predict(obs[:, 0], act[:, 0], j_h)
    got, _ = pm.predict(obs[:, 0], act[:, 0], p_h)
    np.testing.assert_allclose(got, want, **F32_TOL)

    other = PortRNN('dyn', FakeEnv(), hidden_sizes=(16,), cell_type='gru',
                    batch_size=3, backprop_steps=10, seed=6, device='cpu')
    other.load_state_dict(pickle.loads(pickle.dumps(
        pm.state_dict(include_data=True))))
    paths = _paths(4, 20, 11)
    assert pm.fit(*paths, epochs=2) == other.fit(*paths, epochs=2)
    for a, b in zip(tree_leaves(pm.params), tree_leaves(other.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------- planners
def _env_pair(task=None):
    jenv = jax_envs.normalize(jax_envs.HalfCheetahEnv(
        task=task, reset_every_episode=True))
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task=task, reset_every_episode=True, device='cpu'))
    return jenv, env


@pytest.mark.parametrize('use_cem', [False, True])
def test_recurrent_planners_match_jax(use_cem):
    """random_shooting_recurrent and cem_recurrent on the JAX draws: the
    actions, and the real hidden state advanced by them."""
    jenv, env = _env_pair()
    jm, pm = _models('lstm', hidden=(16,), env=jenv.wrapped_env)
    m, n, h, iters = 3, 40, 3, 2
    obs = np.random.RandomState(12).randn(m, 20).astype(np.float32)
    j_h, p_h = _hidden(jm, m, 13)
    key = jax.random.PRNGKey(14)

    def j_pred(o, a, hh):
        return jm.predict_fn(jm.params, jm.normalizer, o, a, hh)

    def p_pred(o, a, hh):
        return pm.predict_fn(pm.params, pm.normalizer, o, a, hh)
    kw = dict(n_candidates=n, horizon=h, act_dim=6)
    if use_cem:
        j_act, j_new = jax_planners.cem_recurrent(
            j_pred, jenv.reward, jnp.asarray(obs), j_h, key,
            num_cem_iters=iters, **kw)
        normals = np.stack([np.asarray(jax.random.normal(k, (n, m, h * 6)))
                            for k in jax.random.split(key, iters)])
        p_act, p_new = port_planners.cem_recurrent(
            p_pred, env.reward, t(obs), p_h, None, num_cem_iters=iters,
            normals=t(normals), **kw)
    else:
        j_act, j_new = jax_planners.random_shooting_recurrent(
            j_pred, jenv.reward, jnp.asarray(obs), j_h, key, **kw)
        cand = jax.random.uniform(key, (h, n * m, 6), jnp.float32, -1.0, 1.0)
        p_act, p_new = port_planners.random_shooting_recurrent(
            p_pred, env.reward, t(obs), p_h, None, candidates=t(cand), **kw)
    np.testing.assert_allclose(p_act.numpy(), np.asarray(j_act), **F32_TOL)
    _assert_trees(p_new, j_new, **F32_TOL)


def test_controller_reset_and_host_api_match_jax():
    """reset(dones) zeroes the hidden state of each done env only; reset()
    forgets it; get_actions threads it on the host."""
    jenv, env = _env_pair()
    jm, pm = _models('lstm', hidden=(16,), env=jenv.wrapped_env)
    jpol = JaxRNNMPC('p', jenv, jm, n_candidates=8, horizon=2)
    ppol = PortRNNMPC('p', env, pm, n_candidates=8, horizon=2)
    j_h, p_h = _hidden(jm, 3, 15)
    jpol._hidden, ppol._hidden = j_h, p_h
    dones = [True, False, True]
    jpol.reset(dones)
    ppol.reset(dones)
    _assert_trees(ppol._hidden, jpol._hidden, rtol=0, atol=0)
    assert float(ppol._hidden[0][0][1].abs().sum()) > 0
    assert float(ppol._hidden[0][1][0].abs().sum()) == 0
    ppol.reset()
    assert ppol._hidden is None
    ppol.reset(dones)
    _assert_trees(ppol._hidden, jm.get_initial_hidden(3), rtol=0, atol=0)
    obs = np.random.RandomState(16).randn(3, 20).astype(np.float32)
    acts, _ = ppol.get_actions(obs)
    assert acts.shape == (3, 6) and np.abs(acts).max() <= 1.0
    assert float(tree_leaves(ppol._hidden)[0].abs().sum()) > 0
    assert ppol.recurrent and ppol.percent_elites == 0.05


# ---------------------------------------------------------------- rollout
@pytest.mark.parametrize('ablate,t0', [(None, 3), ('zero', 3),
                                       ('frozen', 1), ('frozen', 3)])
def test_rollout_step_matches_jax(ablate, t0):
    """One ReBAL rollout step from an identical carry with a non-zero
    hidden state (cripple tasks drawn), the planner's candidates drawn by
    JAX: the step's outputs and the hidden state it carries on, for each
    ablation mode (warm-up 2: 'frozen' advances at step 1, not at 3)."""
    jenv, env = _env_pair('cripple')
    jm, pm = _models('lstm', hidden=(16,), env=jenv.wrapped_env)
    m, n, h = 3, 16, 3
    jpol = JaxRNNMPC('p', jenv, jm, n_candidates=n, horizon=h)
    ppol = PortRNNMPC('p', env, pm, n_candidates=n, horizon=h)
    jfn = jax_rollout_fn(jenv, jpol, jm, m, t0 + 1, segment_len=1,
                         ablate_hidden=ablate, ablate_warmup=2)
    states, _, _, key = jfn.init_jit(jax.random.PRNGKey(8), 1)
    j_h, p_h = _hidden(jm, m, 17)
    (_, _, j_hid, _), j_out = jfn.segment_jit(
        jm.params, jm.normalizer, (states, None, j_h, key),
        jnp.asarray(t0, jnp.int32))
    _, k_plan = jax.random.split(key)
    cand = jax.random.uniform(k_plan, (h, n * m, 6), jnp.float32, -1.0, 1.0)

    p_states = EnvState(
        phys=port_engine.PhysicsState(t(states.phys.qpos),
                                      t(states.phys.qvel)),
        mm=port_spec.batched_mutable(env.wrapped_env.mm0, m, 'cpu',
                                     torch.float32),
        task={'cripple_mask': t(states.task['cripple_mask'])},
        obs=t(states.obs), t=torch.zeros(m, dtype=torch.int32),
        episode=torch.ones(m, dtype=torch.int32))
    pfn = port_rollout_fn(env, ppol, pm, m, t0 + 1, ablate_hidden=ablate,
                          ablate_warmup=2)
    (_, p_hid), p_out = pfn.step_fn(pm.params, pm.normalizer,
                                    (p_states, p_h), t0, None,
                                    candidates=t(cand))
    np.testing.assert_allclose(p_out['actions'].numpy(),
                               np.asarray(j_out['actions'][:, 0]), **F32_TOL)
    for k in ('next_observations', 'rewards', 'qpos', 'qvel'):
        np.testing.assert_allclose(p_out[k].numpy(),
                                   np.asarray(j_out[k][:, 0]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    _assert_trees(p_hid, j_hid, **F32_TOL)
    kept = ablate == 'zero' or (ablate == 'frozen' and t0 >= 2)
    assert kept == all(bool((a == b).all()) for a, b in
                       zip(tree_leaves(p_hid), tree_leaves(p_h)))


def test_rollout_refuses_ablation_without_recurrent_model():
    from learning_to_adapt_torch.models import MLPDynamicsModel
    from learning_to_adapt_torch.policies import MPCController
    _, env = _env_pair()
    mlp = MLPDynamicsModel('dyn', env, hidden_sizes=(8,), device='cpu')
    with pytest.raises(ValueError, match='recurrent models only'):
        port_rollout_fn(env, MPCController('p', env, mlp), mlp, 2, 5,
                        ablate_hidden='zero')
    with pytest.raises(ValueError, match="'zero' or 'frozen'"):
        port_rollout_fn(env, MPCController('p', env, mlp), mlp, 2, 5,
                        ablate_hidden='warm')


# ------------------------------------------------------- the entry point
def _tiny_config(exp_name, n_itr, **kw):
    """run_rebal's config at test size: 2 envs x 20 steps, 8 candidates x
    horizon 3, an LSTM (16,), batch 2, 10-step TBPTT chunks, 3 epochs."""
    return dict(port_run.config, task='cripple', device='cpu',
                exp_name=exp_name, n_itr=n_itr, max_path_length=20,
                num_rollouts=2, n_candidates=8, horizon=3,
                hidden_sizes=(16,), batch_size=2, backprop_steps=10,
                dynamic_model_epochs=3, **kw)


def test_entry_point_run_writes_jax_header(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = port_run.run_experiment(_tiny_config('e2e', 3))
    exp_dir = tmp_path / 'data' / 'rebal_torch' / 'e2e'
    with open(HEADER_CSV) as f:
        want = f.readline()
    lines = (exp_dir / 'progress.csv').read_text().splitlines(True)
    assert lines[0] == want and len(lines) == 4
    keys = want.strip().split(',')
    for row in lines[1:]:
        vals = dict(zip(keys, row.strip().split(',')))
        for k in ('TrainLoss', 'EnvTrajs-AverageReturn'):
            assert np.isfinite(float(vals[k])), k
    snap = pickle.loads((exp_dir / 'params.pkl').read_bytes())
    assert snap['itr'] == 2 and snap['config']['exp_name'] == 'e2e'
    assert isinstance(snap['env'].wrapped_env, port_envs.HalfCheetahEnv)
    # each 2-path fit keeps 1 train path (split = max(int(2 * 0.9), 1))
    assert snap['dynamics_model']['train']['obs'].shape == (3, 20, 20)
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


def test_entry_point_config_and_default_device(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        'jax_run_rebal', os.path.join(REPO, 'run_scripts', 'run_rebal.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(port_run.config) == set(mod.config)
    for k, v in mod.config.items():
        if k != 'env':
            assert port_run.config[k] == v, k
    cfg = port_run.config_from_args(port_run.parse_args(
        ['--task', 'cripple', '--n_itr', '3', '--resume', '--exp_name', 'x']))
    assert (cfg['device'], cfg['task'], cfg['n_itr'], cfg['resume'],
            cfg['exp_name']) == ('cuda', 'cripple', 3, True, 'x')
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='cuda'):
        port_run.main(['--task', 'cripple', '--n_itr', '1'])
    assert not (tmp_path / 'data').exists()
