"""The compiled fit epoch of the port (learning_to_adapt_torch/models/
captured.py), its counterpart of the JAX models' _get_epoch_fn, on the CPU:
the in-place clip + Adam step against optax, on CPU tensors the plain
chain, and the kernel wrapper's refusals; each model's train and
validation steps on a compiled epoch's static state (its graphs run as
plain calls on the CPU) against the JAX _get_epoch_fn epoch on the same
injected windows, permutation or path indices; the per-epoch draws'
bounds; the fit (one path on the CPU, over gloo and on the card) against
the loop of epoch_fn calls on the same draws, the isolation of what a fit
hands out from the buffers the next fit overwrites, the shape-key cache
and the capture rule. Two tests, marked cuda, hold the captured epoch
against the eager one on a card, and ReBAL's concurrent TBPTT chunks.
"""
from types import SimpleNamespace

import importlib
import json

import numpy as np
import pytest
import torch

from _torch_parity import t
from learning_to_adapt_torch.models import (
    MetaMLPDynamicsModel, MLPDynamicsModel, RNNDynamicsModel, captured)
from learning_to_adapt_torch.models.optim import ClipAdam, tree_leaves
from learning_to_adapt_torch.ops import clip_adam
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.utils import tracing

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

# f32, each product and sum rounded on its own as optax rounds it; only the
# global norm sums its squares in another order, so a clipped step's
# gradients may differ by an ulp, which a moment that cancels to near 0
# keeps at the scale of its terms: rtol 1e-6 of each value and of its
# leaf's largest magnitude
ADAM_RTOL = 1e-6
EPOCH_TOL = dict(rtol=1e-4, atol=1e-6)  # a few f32 Adam steps, as the
#                                         parity files hold their epochs
CUDA_TOL = dict(rtol=1e-5, atol=1e-6)   # the same kernels, replayed


class FakeEnv:
    obs_dim, act_dim = 20, 6


@pytest.fixture(scope='module')
def jx():
    """JAX, optax and the parity files' helpers, imported by the tests that
    hold the port against the JAX package (the cuda-marked case runs where
    JAX is not installed)."""
    return SimpleNamespace(**{name: importlib.import_module(module)
                              for name, module in (
                                  ('jax', 'jax'), ('jnp', 'jax.numpy'),
                                  ('optax', 'optax'),
                                  ('meta', 'test_torch_train'),
                                  ('mbmpc', 'test_torch_mbmpc'),
                                  ('rebal', 'test_torch_rebal'))})


def _paths(n_paths, t_len, seed):
    rng = np.random.RandomState(seed)
    obs = rng.randn(n_paths, t_len, 20).astype(np.float32)
    act = rng.uniform(-1, 1, (n_paths, t_len, 6)).astype(np.float32)
    nxt = obs + 0.1 * rng.randn(*obs.shape).astype(np.float32)
    return obs, act, nxt


# ------------------------------------------------------------- optimizer
def test_in_place_clip_adam_matches_optax(jx):
    """Six in-place steps (ClipAdam.step_ on leaf lists) against
    optax.chain(clip_by_global_norm(100), adam(1e-3)), the gradients
    scaled so that the global norm falls below 100 in some steps and above
    it (the clip rescales) in others."""
    jax, jnp, optax = jx.jax, jx.jnp, jx.optax
    rng = np.random.RandomState(0)
    params = {'w': [rng.randn(16, 8).astype(np.float32),
                    rng.randn(8, 4).astype(np.float32)],
              'b': [rng.randn(8).astype(np.float32),
                    rng.randn(4).astype(np.float32)]}
    opt = optax.chain(optax.clip_by_global_norm(100.0), optax.adam(1e-3))
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = opt.init(j_params)
    adam = ClipAdam(1e-3, max_norm=100.0)
    leaves = [t(x) for x in jax.tree.leaves(params)]
    count = torch.zeros((), dtype=torch.int32)
    mu = [torch.zeros_like(x) for x in leaves]
    nu = [torch.zeros_like(x) for x in leaves]
    clipped = []
    for scale in (1e-2, 1e3, 1.0, 3e2, 1e-1, 2e3):
        grads = jax.tree.map(
            lambda p: (rng.randn(*p.shape) * scale).astype(np.float32),
            params)
        g = jax.tree.leaves(grads)
        clipped.append(np.sqrt(sum(np.sum(np.square(x)) for x in g)) > 100)
        upd, j_state = opt.update(jax.tree.map(jnp.asarray, grads), j_state,
                                  j_params)
        j_params = optax.apply_updates(j_params, upd)
        adam.step_(leaves, [t(x) for x in g], count, mu, nu)
    assert set(clipped) == {False, True}
    j_adam = j_state[1][0]
    assert int(count) == int(j_adam.count) == 6
    for got, want in ((leaves, j_params), (mu, j_adam.mu), (nu, j_adam.nu)):
        for a, b in zip(got, jax.tree.leaves(want)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=ADAM_RTOL,
                                       atol=ADAM_RTOL * np.abs(b).max())


def test_functional_update_is_the_in_place_step_on_copies():
    """ClipAdam.update gives step_'s result bit for bit and leaves the
    params, gradients and state it was handed as they were."""
    rng = np.random.RandomState(1)
    params = {'w': [t(rng.randn(6, 5))], 'b': [t(rng.randn(5))]}
    grads = {'w': [t(rng.randn(6, 5) * 300)], 'b': [t(rng.randn(5))]}
    adam = ClipAdam(1e-3)
    state = adam.init(params)
    before = [x.clone() for x in tree_leaves((params, grads, state))]
    new, new_state = adam.update(grads, state, params)
    for a, b in zip(tree_leaves((params, grads, state)), before):
        assert torch.equal(a, b)
    leaves = [x.clone() for x in tree_leaves(params)]
    count, mu, nu = (state['count'].clone(),
                     [x.clone() for x in tree_leaves(state['mu'])],
                     [x.clone() for x in tree_leaves(state['nu'])])
    adam.step_(leaves, [x.clone() for x in tree_leaves(grads)], count, mu,
               nu)
    for a, b in zip(tree_leaves(new), leaves):
        assert torch.equal(a, b)
    assert int(new_state['count']) == int(count) == 1
    for a, b in zip(tree_leaves(new_state['nu']), nu):
        assert torch.equal(a, b)


def _no_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('the CUDA kernel was reached')
    monkeypatch.setattr(clip_adam, '_lib', refuse)
    monkeypatch.setattr(clip_adam, 'clip_adam_cuda', refuse)


@pytest.mark.parametrize('scale', [1.0, 300.0], ids=['kept', 'clipped'])
def test_cpu_step_takes_the_plain_chain(monkeypatch, scale):
    """On CPU tensors ClipAdam.step_ is clip_adam_plain bit for bit, with
    no launch counted and nothing of the kernel reached."""
    _no_kernel(monkeypatch)
    rng = np.random.RandomState(2)
    shapes = [(5,), (3, 5), (4,)]
    leaves = [t(rng.randn(*s)) for s in shapes]
    grads = [t(rng.randn(*s) * scale) for s in shapes]
    mu = [t(rng.randn(*s) * 0.1) for s in shapes]
    nu = [t(rng.rand(*s) * 0.1) for s in shapes]
    count = torch.tensor(4, dtype=torch.int32)
    copies = [[x.clone() for x in xs] for xs in (leaves, grads, mu, nu)]
    want_count = count.clone()
    launches = clip_adam.clip_adam_.launches
    ClipAdam(1e-3).step_(leaves, grads, count, mu, nu)
    norm = clip_adam.clip_adam_plain(*copies[:2], want_count, *copies[2:],
                                     1e-3, 100.0, 0.9, 0.999, 1e-8)
    assert (float(norm) >= 100.0) == (scale > 1.0)
    assert clip_adam.clip_adam_.launches == launches
    assert torch.equal(count, want_count)
    for got, want in zip((leaves, grads, mu, nu), copies):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _refused(case):
    """Leaves on the meta device (shapes, dtypes and strides without
    storage) that the kernel does not take, but for the 'meta' case, which
    it takes in all but the device; the error each raises."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device='meta')
    params, grads = [z(4, 3), z(2)], [z(4, 3), z(2)]
    mu, nu = [z(4, 3), z(2)], [z(4, 3), z(2)]
    count = z(dtype=torch.int32)
    err = ValueError
    if case == 'float64':
        grads[1], err = z(2, dtype=torch.float64), TypeError
    elif case == 'transposed':
        nu[0] = z(3, 4).T
    elif case == 'shape':
        mu[1] = z(3)
    elif case == 'device':
        count = torch.zeros((), dtype=torch.int32)
    elif case == 'count_int64':
        count, err = z(dtype=torch.int64), TypeError
    elif case == 'count_shape':
        count, err = z(1, dtype=torch.int32), TypeError
    elif case == 'lengths':
        nu = nu[:1]
    elif case == 'too_many':
        n = clip_adam.MAX_LEAVES + 1
        params, grads, mu, nu = ([z(2)] * n for _ in range(4))
    return (params, grads, count, mu, nu), err


@pytest.mark.parametrize('case', [
    'float64', 'transposed', 'shape', 'device', 'count_int64', 'count_shape',
    'lengths', 'too_many', 'meta'])
def test_kernel_wrapper_refuses_what_it_does_not_take(monkeypatch, case):
    """clip_adam_cuda checks every leaf and the count before it builds or
    launches anything, and raises on what the kernel does not take; its
    rules do not depend on the device, so meta tensors show them here."""
    monkeypatch.setattr(clip_adam, '_lib', lambda: pytest.fail('built'))
    tensors, err = _refused(case)
    with pytest.raises(err, match='clip_adam'):
        clip_adam.clip_adam_cuda(*tensors, 1e-3, 100.0, 0.9, 0.999, 1e-8)
    if case == 'meta':
        with pytest.raises(ValueError, match='unsupported device'):
            clip_adam.clip_adam_(*tensors, 1e-3, 100.0, 0.9, 0.999, 1e-8)


# --------------------------------------- the static-state steps vs JAX
def _compiled(pm, train, test):
    """pm's compiled epoch for staged train/test, loaded with pm's state
    (its steps run as plain calls on the CPU)."""
    ce = pm.compiled_epoch(train, test)
    ce.prepare(lambda st: pm._load_state(st, pm.params, pm.opt_state,
                                         pm.normalizer, train, test))
    return ce


def _pad(arrays, cap):
    out = []
    for a in arrays:
        p = np.zeros((cap,) + a.shape[1:], np.float32)
        p[:a.shape[0]] = a
        out.append(p)
    return tuple(out)


def test_meta_static_steps_match_jax_epoch(jx):
    """Eight meta-train steps and two validation steps of the compiled
    epoch's state against the JAX _get_epoch_fn epoch, on the windows that
    epoch draws from its key (sample_windows, models/meta_mlp.py)."""
    jax, jnp, meta = jx.jax, jx.jnp, jx.meta
    jm, pm = meta._models()
    mbs, bs, t_len, steps, steps_test = 4, 8, 40, 8, 2
    data = []
    for n, seed in ((6, 2), (2, 3)):
        obs, act, nxt = meta._paths(n, t_len, seed)
        data.append((obs, act, nxt - obs))
    key = jax.random.PRNGKey(5)
    j_params, j_opt, *j_losses = jm._get_epoch_fn(
        64, 64, t_len, steps, steps_test)(
        jm.params, jm.opt_state, jm.normalizer,
        *(tuple(map(jnp.asarray, _pad(d, 64))) for d in data), 6, 2, key)
    windows = []
    for i, k in enumerate(jax.random.split(key, steps + steps_test + 1)[:-1]):
        kp, ko = jax.random.split(k)
        n = 6 if i < steps else 2
        windows.append(tuple(torch.as_tensor(np.array(x)) for x in (
            jax.random.randint(kp, (mbs,), 0, n),
            jax.random.randint(ko, (mbs,), bs, t_len - bs))))
    staged = [pm.stage(dict(obs=o, act=a, delta=d), 64) for o, a, d in data]
    ce = _compiled(pm, *staged)
    losses = pm._epoch(ce.state, 6, 2, steps, steps_test, None, windows,
                       ce.train, ce.valid)
    params, opt = pm._state_out(ce.state, clone=True)
    np.testing.assert_allclose(losses.numpy(), np.array(j_losses),
                               **EPOCH_TOL)
    meta._assert_trees(params, j_params, **EPOCH_TOL)
    assert int(opt['count']) == int(j_opt[1][0].count) == steps


@pytest.mark.parametrize('n_members', [1, 3])
def test_mlp_static_steps_match_jax_epoch(n_members, jx):
    """Four train steps and the validation of the compiled epoch's state
    against the JAX _get_epoch_fn epoch on its permutation (50 real rows
    padded to 64)."""
    jax, jnp, mbmpc = jx.jax, jx.jnp, jx.mbmpc
    jm, pm = mbmpc._models(n_members)
    j_train, p_train = mbmpc._padded(50, 64, 3)
    j_test, p_test = mbmpc._padded(10, 64, 4)
    key = jax.random.PRNGKey(5)
    j_params, j_opt, j_train_loss, j_valid = jm._get_epoch_fn(64, 64, 4)(
        jm.params, jm.opt_state, jm.normalizer,
        tuple(map(jnp.asarray, j_train)), tuple(map(jnp.asarray, j_test)),
        key)
    perm = torch.as_tensor(np.array(jax.random.permutation(key, 64)))
    ce = _compiled(pm, p_train, p_test)
    losses = pm._epoch(ce.state, 4, None, perm, ce.train, ce.valid)
    params, opt = pm._state_out(ce.state, clone=True)
    np.testing.assert_allclose([float(x) for x in losses],
                               [float(j_train_loss), float(j_valid)],
                               **EPOCH_TOL)
    mbmpc._assert_leaves(params, j_params, **EPOCH_TOL)
    mbmpc._assert_leaves(opt['mu'], j_opt[1][0].mu, **EPOCH_TOL)
    assert int(opt['count']) == int(j_opt[1][0].count) == 4


@pytest.mark.parametrize('cell', ['lstm', 'gru'])
def test_rnn_static_steps_match_jax_epoch(cell, jx):
    """Two TBPTT train steps (4 chunks each) and the masked validation of
    the compiled epoch's state, whose layers hold their weights in cuDNN's
    layout, against the JAX _get_epoch_fn epoch on the path indices it
    draws (models/rnn.py)."""
    jax, jnp, rebal = jx.jax, jx.jnp, jx.rebal
    jm, pm = rebal._models(cell, hidden=(24,))
    j_tr, p_tr, _ = rebal._staged(6, 8, 40, 5)
    j_te, _, p_te = rebal._staged(3, 8, 40, 6)
    key = jax.random.PRNGKey(7)
    j_params, j_opt, j_loss, j_valid = jm._get_epoch_fn(8, 8, 40, 2)(
        jm.params, jm.opt_state, jm.normalizer,
        tuple(map(jnp.asarray, j_tr)), tuple(map(jnp.asarray, j_te)),
        jnp.asarray(6), key)
    pidx = [torch.as_tensor(np.array(jax.random.randint(k, (3,), 0, 6)))
            for k in jax.random.split(key, 2)]
    ce = _compiled(pm, p_tr, p_te)
    layers = ce.state.layers
    assert all(w.untyped_storage().data_ptr() ==
               layer[0].untyped_storage().data_ptr()
               for layer in layers for w in layer)
    losses = pm._epoch(ce.state, 6, 2, None, pidx, ce.train, ce.valid)
    params, opt = pm._state_out(ce.state, clone=True)
    np.testing.assert_allclose([float(x) for x in losses],
                               [float(j_loss), float(j_valid)], **EPOCH_TOL)
    rebal._assert_trees(params, j_params, **EPOCH_TOL)
    rebal._assert_trees(opt['mu'], j_opt[1][0].mu, rtol=1e-4, atol=1e-7)
    assert all(x.is_contiguous() for x in tree_leaves(params))


# ------------------------------------------------------ the epoch's draws
def test_meta_window_draws_fall_in_their_bounds():
    """An epoch's pre-drawn windows: path indices in [0, n_tr) for the
    train steps and [0, n_te) for the validation steps, offsets in [bs,
    T - bs); paths of exactly 2 * bs steps take the one offset bs."""
    pm = MetaMLPDynamicsModel('dyn', FakeEnv(), hidden_sizes=(8,),
                              meta_batch_size=4, batch_size=8, device='cpu')
    gen = torch.Generator().manual_seed(0)
    for t_len, n_tr, n_te, steps, steps_test in ((40, 5, 3, 32, 8),
                                                 (16, 7, 2, 16, 8)):
        staged = [pm.stage(dict(obs=o, act=a, delta=n - o), 64)
                  for o, a, n in (_paths(n_tr, t_len, 1),
                                  _paths(n_te, t_len, 2))]
        ce = _compiled(pm, *staged)
        pm._epoch(ce.state, n_tr, n_te, steps, steps_test, gen, None,
                  ce.train, ce.valid)
        rows = steps + steps_test
        pidx, offs = ce.state.pidx[:rows], ce.state.offs[:rows]
        assert pidx[:steps].min() == 0 and pidx[:steps].max() == n_tr - 1
        assert pidx[steps:].min() == 0 and pidx[steps:].max() == n_te - 1
        if t_len == 16:
            assert (offs == 8).all()
        else:
            assert offs.min() == 8 and offs.max() == t_len - 8 - 1


def test_mlp_and_rnn_draws_fall_in_their_bounds(jx):
    """The MLP epoch's minibatches: n_batches * batch_size distinct rows of
    the padded capacity (a permutation's prefix); the RNN epoch's path
    indices in [0, n_tr), drawn with replacement."""
    mbmpc, rebal = jx.mbmpc, jx.rebal
    gen = torch.Generator().manual_seed(1)
    mlp = MLPDynamicsModel('dyn', FakeEnv(), hidden_sizes=(8,),
                           batch_size=16, device='cpu')
    _, train = mbmpc._padded(50, 64, 3)
    _, test = mbmpc._padded(10, 64, 4)
    ce = _compiled(mlp, train, test)
    mlp._epoch(ce.state, 4, gen, None, ce.train, ce.valid)
    sel = ce.state.sel[:4].reshape(-1)
    assert len(set(sel.tolist())) == 64 and sel.min() == 0
    assert sel.max() == 63
    pm = RNNDynamicsModel('dyn', FakeEnv(), hidden_sizes=(8,),
                          batch_size=4, backprop_steps=10, device='cpu')
    _, p_tr, _ = rebal._staged(50, 64, 20, 5)
    _, _, p_te = rebal._staged(3, 64, 20, 6)
    ce = _compiled(pm, p_tr, p_te)
    pm._epoch(ce.state, 9, 16, gen, None, ce.train, ce.valid)
    idx = ce.state.path_idx[:16]
    assert idx.min() == 0 and idx.max() == 8


# ------------------------------------------------------- the compiled fit
def _model(algo, **kw):
    if algo == 'meta':
        return MetaMLPDynamicsModel('dyn', FakeEnv(), hidden_sizes=(16, 16),
                                    meta_batch_size=2, batch_size=4,
                                    device='cpu', **kw)
    if algo == 'mlp':
        return MLPDynamicsModel('dyn', FakeEnv(), hidden_sizes=(16,),
                                batch_size=32, device='cpu', **kw)
    return RNNDynamicsModel('dyn', FakeEnv(), hidden_sizes=(8,),
                            batch_size=2, backprop_steps=10, device='cpu',
                            **kw)


def _fit_data(algo, n_paths, seed, t_len=20):
    obs, act, nxt = _paths(n_paths, t_len, seed)
    if algo == 'mlp':
        return tuple(a.reshape(-1, a.shape[-1]) for a in (obs, act, nxt))
    return obs, act, nxt


def _epoch_fn_fits(model, data, epochs):
    """Fits of `model` whose epochs are epoch_fn calls: the shared loop's
    seam (`_fit_epoch`) replaced by epoch_fn on the data and normalizer
    the fit staged, from the params and optimizer state the last epoch
    handed back, with the fit's generator; those are the model's after
    each fit. Returns the fits' results."""
    held = {}

    def epoch(compiled, generator, counts):
        st = compiled.state
        params, opt_state, *losses = model.epoch_fn(
            held['params'], held['opt'], st.norm, st.train, st.test, *counts,
            generator)
        held.update(params=params, opt=opt_state)
        return losses
    model._fit_epoch = epoch
    outs = []
    for d in data:
        held.update(params=model.params, opt=model.opt_state)
        outs.append(model.fit(*d, epochs=epochs))
        model.params, model.opt_state = held['params'], held['opt']
    return outs


@pytest.mark.parametrize('algo', ['meta', 'mlp', 'rnn'])
def test_compiled_fit_equals_eager_fit(algo):
    """Two fits (the compiled epoch's static state; its steps plain calls
    on the CPU) give the parameters, optimizer state and losses of the
    same fits with each epoch an epoch_fn call, on the same draws, bit for
    bit: one fit path against the functional epoch the JAX parity tests
    pin."""
    data = [_fit_data(algo, 6, s) for s in (10, 11)]
    got = []
    for eager in (False, True):
        model = _model(algo, seed=3)
        outs = (_epoch_fn_fits(model, data, 3) if eager else
                [model.fit(*d, epochs=3) for d in data])
        got.append((outs, tree_leaves((model.params, model.opt_state))))
    assert got[0][0] == got[1][0]
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize('algo', ['meta', 'mlp', 'rnn'])
def test_fit_refuses_malformed_inputs(algo):
    """Every model's fit raises ValueError, before it draws or stages
    anything, for obs or act of the wrong rank or width."""
    model = _model(algo)
    obs, act, nxt = _fit_data(algo, 4, 50)
    state = model._rng.get_state()[1].copy()
    for bad in (lambda x: x[..., :-1], lambda x: x[None], lambda x: x[0]):
        for which in ('obs', 'act'):
            args = dict(obs=obs, act=act)
            args[which] = bad(args[which])
            with pytest.raises(ValueError, match=f'{which} must be'):
                model.fit(args['obs'], args['act'], nxt, epochs=1)
    assert model._train is None and not model._epoch_cache
    np.testing.assert_array_equal(model._rng.get_state()[1], state)


@pytest.mark.parametrize('algo', ['meta', 'mlp', 'rnn'])
def test_fit_output_does_not_alias_the_static_state(algo):
    """The params and the state_dict taken after one compiled fit are
    unchanged by a second fit of the same shape key, and no parameter the
    model holds shares storage with the compiled epoch's buffers."""
    model = _model(algo)
    model.fit(*_fit_data(algo, 6, 20), epochs=2)
    params = model.params
    kept = [x.clone() for x in tree_leaves(params)]
    sd = model.state_dict()
    sd_kept = [np.array(x) for x in tree_leaves(sd)]
    (ce,) = model._epoch_cache.values()
    static = {x.untyped_storage().data_ptr()
              for x in ce.state.leaves + ce.state.mu + ce.state.nu}
    held = tree_leaves((model.params, model.opt_state))
    assert not static & {x.untyped_storage().data_ptr() for x in held}
    model.fit(*_fit_data(algo, 2, 21), epochs=2)
    assert list(model._epoch_cache.values()) == [ce]
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(model.params), kept))
    for a, b in zip(tree_leaves(params), kept):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(sd), sd_kept):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('algo,n_paths,keys', [
    ('meta', (40, 20, 40), [(64, 64, 20, 2, 4), (128, 64, 20, 2, 4)]),
    ('rnn', (40, 20, 40), [(64, 64, 20, 2), (128, 64, 20, 2)]),
    ('mlp', (400, 200, 600), [(16384, 16384, 32), (32768, 16384, 32)])])
def test_compiled_epoch_cache_by_shape_key(algo, n_paths, keys):
    """Fits whose aggregated data stays within one capacity (PATH_CHUNK
    paths, PAD_CHUNK rows) reuse one compiled epoch, whatever their real
    path or row counts; the fit that crosses a bucket adds an entry."""
    model = _model(algo)
    seen = []
    for i, n in enumerate(n_paths):
        model.fit(*_fit_data(algo, n, 30 + i), epochs=1)
        seen.append(list(model._epoch_cache.items()))
    assert [k for k, _ in seen[1]] == keys[:1]
    assert seen[1][0][1] is seen[0][0][1]
    assert [k for k, _ in seen[2]] == keys
    assert seen[2][0][1] is seen[0][0][1]


@pytest.mark.parametrize('case', ['rule', 'gloo_epoch'])
def test_device_rule(case):
    """Captured on a CUDA device without a mesh or over nccl; called on
    the CPU and over gloo. A CompiledEpoch of CUDA tensors on a gloo mesh
    calls its steps and captures nothing (nothing of CUDA is reached:
    this machine may have no card), where over nccl it would capture."""
    nccl, gloo = (SimpleNamespace(backend=b) for b in ('nccl', 'gloo'))
    if case == 'rule':
        assert captured.captures('cuda', None)
        assert captured.captures(torch.device('cuda', 0), nccl)
        assert not captured.captures('cuda:0', gloo)
        assert not captured.captures('cpu', None)
        assert not captured.captures('cpu', gloo)
        return
    calls = []
    state = SimpleNamespace(counter=torch.zeros(1, dtype=torch.int64),
                            sel=torch.zeros((2, 3), dtype=torch.int64))
    ce = captured.CompiledEpoch(state, lambda st: calls.append('train'),
                                lambda st: calls.append('valid'), 'cuda:0',
                                gloo)
    ce.prepare(lambda st: calls.append('load'))
    ce.train()
    ce.train()
    ce.valid()
    assert calls == ['load', 'train', 'train', 'valid']
    assert not ce.captured and ce.capture_s == 0
    assert [(g.capturing, g.graph, g.replays) for g in (ce.train, ce.valid)
            ] == [(False, None, 0)] * 2
    over_nccl = captured.CompiledEpoch(state, None, None, 'cuda:0', nccl)
    assert over_nccl.train.capturing and over_nccl.valid.capturing


def test_count_collectives_adds_to_the_counters():
    before = par_mesh.collective_counts()
    par_mesh.count_collectives(dict(all_reduce=3, all_gather=0, broadcast=1))
    after = par_mesh.collective_counts()
    par_mesh.count_collectives({k: before[k] - after[k] for k in after})
    assert {k: after[k] - before[k] for k in after} == dict(
        all_reduce=3, all_gather=0, broadcast=1)
    assert par_mesh.collective_counts() == before


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize('algo', ['meta', 'mlp', 'rnn'])
def test_captured_epoch_matches_eager_on_the_card(algo):
    """On a card: the captured epoch (one replay a step) against the eager
    epoch from the same state on the same draws."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: a CUDA graph has no CPU mode')
    dev = torch.device('cuda', 0)
    cls, kw = {'meta': (MetaMLPDynamicsModel, dict(batch_size=16)),
               'mlp': (MLPDynamicsModel, dict(batch_size=128)),
               'rnn': (RNNDynamicsModel, {})}[algo]
    model = cls('dyn', FakeEnv(), device=dev, seed=0, **kw)
    model.fit(*_fit_data(algo, 12, 40, t_len=200), epochs=1)
    if algo == 'meta':
        train, test = (model.stage(d, 64) for d in (model._train,
                                                    model._test))
    else:
        train, test = model.stage(model._train), model.stage(model._test)
        if algo == 'rnn':
            train = train[0]
    p0, o0 = model.params, model.opt_state
    ce = model.compiled_epoch(train, test)
    ce.prepare(lambda st: model._load_state(st, p0, o0, model.normalizer,
                                            train, test))
    assert ce.captured
    n_tr, n_te = model._train['obs'].shape[0], model._test['obs'].shape[0]
    args, steps = {'meta': ((n_tr, n_te, 8, 2), (8, 2)),
                   'mlp': ((8,), (8, 1)), 'rnn': ((n_tr, 4), (4, 1))}[algo]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    eager = model.epoch_fn(p0, o0, model.normalizer, train, test, *args,
                           gen)
    gen.manual_seed(5)
    before = (ce.train.replays, ce.valid.replays)
    losses = model._epoch(ce.state, *args, gen, None, ce.train, ce.valid)
    params, _ = model._state_out(ce.state, clone=True)
    assert (ce.train.replays - before[0],
            ce.valid.replays - before[1]) == steps
    for a, b in zip(tree_leaves(params), tree_leaves(eager[0])):
        torch.testing.assert_close(a, b, **CUDA_TOL)
    torch.testing.assert_close(torch.stack(list(losses)),
                               torch.stack(list(eager[2:])), **CUDA_TOL)


def _kernels(prof, path):
    """(name, start, end, stream) of each kernel of a profiler's trace."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return [(e['name'], e['ts'], e['ts'] + e['dur'], e['args'].get('stream'))
            for e in events if e.get('cat') == 'kernel']


def _overlap(a, b):
    """True where some kernel of a runs while some kernel of b does."""
    return any(s1 < e2 and s2 < e1 for _, s1, e1, _ in a
               for _, s2, e2, _ in b)


def _captured_rebal_against_eager(dev, n_chunks):
    """ReBAL's captured epoch of 8 train steps of n_chunks TBPTT chunks
    against the eager epoch from one state on the same draws, bit for bit
    in parameters and losses; the capture's 'rnn.chunk_streams' count.
    Returns the compiled epoch."""
    model = RNNDynamicsModel('dyn', FakeEnv(), device=dev, seed=0)
    assert (model.cell_type, model.backprop_steps) == ('lstm', 50)
    before = tracing.counters().get('rnn.chunk_streams', 0)
    model.fit(*_fit_data('rnn', 12, 41, t_len=50 * n_chunks), epochs=1)
    assert tracing.counters()['rnn.chunk_streams'] - before == n_chunks
    train, test = model.stage(model._train)[0], model.stage(model._test)
    p0, o0 = model.params, model.opt_state
    ce = model.compiled_epoch(train, test)
    ce.prepare(lambda st: model._load_state(st, p0, o0, model.normalizer,
                                            train, test))
    n_tr = model._train['obs'].shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    eager = model.epoch_fn(p0, o0, model.normalizer, train, test, n_tr, 8,
                           gen)
    gen.manual_seed(6)
    replays = ce.train.replays
    losses = model._epoch(ce.state, n_tr, 8, gen, None, ce.train, ce.valid)
    params, _ = model._state_out(ce.state, clone=True)
    assert ce.train.replays - replays == 8
    for a, b in zip(tree_leaves(params), tree_leaves(eager[0])):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(list(losses)),
                       torch.stack(list(eager[2:])))
    return ce


@pytest.mark.cuda
def test_rebal_chunks_take_their_gradients_concurrently(tmp_path):
    """On a card: ReBAL's train step of 2, then of 4, TBPTT chunks forks
    each chunk onto a stream of its own ('rnn.chunk_streams' adds the
    chunks at the train step's capture), and its captured epoch of 8 steps
    gives the eager epoch's parameters and losses bit for bit from one
    state on the same draws. In a profiler trace of one replay of 4 chunks
    the chunks' backward cell kernels run while later chunks' forward cell
    kernels do (cuDNN runs the backwards on its own handle's stream, so
    they follow one another: printed)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: a CUDA graph has no CPU mode')
    dev = torch.device('cuda', 0)
    _captured_rebal_against_eager(dev, 2)
    ce = _captured_rebal_against_eager(dev, 4)

    ce.state.counter.zero_()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ce.train()
        torch.cuda.synchronize()
    kernels = _kernels(prof, tmp_path / 'replay.json')
    back = sorted((k for k in kernels if 'elementWise_bp1' in k[0]),
                  key=lambda k: k[1])
    fwd = [k for k in kernels if 'elemWiseRNNcell' in k[0]]
    print(f'replay: {len(back)} backward and {len(fwd)} forward cell '
          f'kernels, the backward ones on streams '
          f'{sorted({k[3] for k in back})}; backward kernels of two chunks '
          f'at once: {_overlap(back[:50], back[50:])}')
    assert len(back) == len(fwd) == 200
    assert _overlap(back, fwd)
