"""The port's ReBAL model (models/rnn.py, eager on the CPU) held against
the plain reference of port_bench/reference/rnn.py, which writes the
LSTM's gate equations out as matrix products and runs no recurrent layer
op: the TBPTT loss and its gradients by leaf, three clip + Adam steps,
the masked validation loss and a 40-step thread of predict_fn against
the reference's whole-sequence forward; each comparison also shown to
fail for the reference under TF32-rounded products, with a forget bias
of 0, and with the hidden state's gradient carried across chunks. Also
the 'rnn.seq' spans and the 'rnn.seq_steps' counter, and that the
reference loads nothing of the program or of JAX. Small widths: hidden
32, paths of 40 steps, TBPTT chunks of 10, batches of 4."""
import json
import os
import subprocess
import sys
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from learning_to_adapt_torch.models import RNNDynamicsModel
from learning_to_adapt_torch.models.normalizer import Normalizer
from learning_to_adapt_torch.utils import tracing
from port_bench.lib.precision import RoundedProducts
from port_bench.reference import models as ref_models
from port_bench.reference import rnn as ref

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, T_LEN, BP, BATCH, PATHS, LR = 32, 40, 10, 4, 8, 1e-2
# f32 throughout; the port's recurrent op and the reference sum in other
# orders, over 40 dependent steps: the loss, a mean of 3,200 squares,
# agrees to a few ulp of its value
LOSS_TOL = dict(rtol=1e-6, atol=0)
# the second and third steps' losses are differences of the f32 running
# sums a train step keeps, taken at parameters that Adam has moved apart
# by round-off
STEPS_LOSS_TOL = dict(rtol=5e-6, atol=0)
# each gradient element sums the chunks' 10-step backward recurrences in
# another order: a few hundred ulp of the leaf's largest element
GRAD_TOL = 2e-5
# a few Adam steps from equal gradients up to round-off: Adam divides by
# sqrt(v), so a gradient element near its eps moves by up to the rate on
# round-off; by the leaf's change, as the benchmark compares it
CHANGE_TOL = 1e-4
# predictions over 40 recurrent steps, denormalized (|delta| ~ 0.1)
PREDICT_TOL = dict(rtol=1e-5, atol=1e-6)


class FakeEnv:
    obs_dim, act_dim = 20, 6


def _weights(seed=0, hidden=HIDDEN):
    """The params tree, seeded: Xavier-like kernels and small biases."""
    g = torch.Generator().manual_seed(seed)

    def u(shape, limit):
        return (torch.rand(shape, generator=g) * 2 - 1) * limit
    lim = float(np.sqrt(6.0 / (26 + 5 * hidden)))
    return {'cells': [dict(wi=u((26, 4 * hidden), lim),
                           wh=u((hidden, 4 * hidden), lim),
                           b=u((4 * hidden,), 0.1))],
            'out': {'w': [u((hidden, 20), float(np.sqrt(6 / (hidden + 20))))],
                    'b': [u((20,), 0.1)]}}


def _data(seed=1):
    rng = np.random.RandomState(seed)
    obs = rng.randn(PATHS, T_LEN, 20).astype(np.float32)
    act = rng.uniform(-1, 1, (PATHS, T_LEN, 6)).astype(np.float32)
    nxt = obs + 0.1 * rng.randn(PATHS, T_LEN, 20).astype(np.float32)
    return obs, act, nxt


def _setup(**kw):
    """(model, weights, stats, staged train paths, staged test (paths,
    mask), raw (obs, act, next obs) tensors); the port's normalizer holds
    the reference's statistics."""
    model = RNNDynamicsModel('d', FakeEnv(), hidden_sizes=(HIDDEN,),
                             batch_size=BATCH, backprop_steps=BP,
                             learning_rate=LR, device='cpu', **kw)
    obs, act, nxt = _data()
    stats = ref_models.normalizer(*(torch.as_tensor(x) for x in
                                    (obs, act, nxt - obs)))
    model.normalizer = Normalizer(**stats)
    weights = _weights()
    model.params = weights
    train, _ = model.stage(dict(obs=obs, act=act, delta=nxt - obs))
    test = model.stage(dict(obs=obs[:5], act=act[:5], delta=(nxt - obs)[:5]))
    raw = tuple(torch.as_tensor(x) for x in (obs, act, nxt))
    return model, weights, stats, train, test, raw


def _port_state(model, weights, train, test, rows):
    opt = model.optimizer.init(weights)
    return model._fit_state(weights, opt, model.normalizer, train, test,
                            rows)


def _gaps(got, want):
    """Relative gap of each leaf's tensor against the reference's, by the
    leaf's largest element."""
    return {k: float((got[k] - want[k]).abs().max() /
                     want[k].abs().max()) for k in want}


def _reference_loss_grads(weights, stats, o, a, d, variant):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in ref.named(weights).items()}
    params = ref.tree(list(leaves.values()), 1)
    kw = dict(forget_bias=0.0) if variant == 'forget_bias_0' else \
        dict(stop_gradient=False) if variant == 'no_stop' else {}
    with RoundedProducts('tf32') if variant == 'tf32' else nullcontext():
        loss = ref.tbptt_loss(params, stats, o, a, d, BP, **kw)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize('variant', [None, 'tf32', 'forget_bias_0',
                                     'no_stop'])
def test_tbptt_loss_and_gradients(variant):
    """The port's TBPTT loss and gradient (its train step's own
    tbptt_chunks and chunk_grads on the fit state's cuDNN-layout weights)
    against the reference's; each variant of the reference parts from it
    beyond a tolerance."""
    model, weights, stats, train, test, _ = _setup()
    st = _port_state(model, weights, train, test, 1)
    idx = torch.tensor([5, 0, 7, 2])
    obs, act, delta = model._split(train[idx])
    with torch.enable_grad():
        loss, grads, streams = model.tbptt_chunks(
            st.layers, st.out, st.norm, obs, act, delta, st.leaves)
    grads = model.chunk_grads(grads, streams, 1.0)
    loss = float(loss)
    got = ref.named(model._from_step_layout(list(grads)))
    want_loss, want = _reference_loss_grads(weights, stats, obs, act, delta,
                                            variant)
    loss_ok = np.isclose(loss, want_loss, **LOSS_TOL)
    grads_ok = max(_gaps(got, want).values()) <= GRAD_TOL
    if variant is None:
        assert loss_ok, (loss, want_loss)
        assert grads_ok, _gaps(got, want)
    else:
        assert not (loss_ok and grads_ok), (variant, _gaps(got, want))


@pytest.mark.parametrize('variant', [None, 'tf32'])
def test_three_clip_adam_steps(variant):
    """Three of the port's train steps (its `_train_step` on path indices
    in the index table, clip and Adam in place) against the reference's
    three: each step's loss, the first clipped gradient (Adam's m / (1 -
    b1)) and each leaf's change after three; under TF32 products the
    reference parts from the port."""
    model, weights, stats, train, test, raw = _setup()
    steps = [torch.tensor([5, 0, 7, 2]), torch.tensor([1, 3, 4, 6]),
             torch.tensor([2, 7, 0, 1])]
    st = _port_state(model, weights, train, test, 3)
    for i, s in enumerate(steps):
        st.path_idx[i].copy_(s)
    sums, moment = [], None
    with torch.no_grad():
        for i in range(3):
            model._train_step(st)
            sums.append(float(st.sums[0]))
            if i == 0:
                moment = ref.named(model._state_out(st, clone=True)[1]['mu'])
    losses = [sums[0]] + [b - a for a, b in zip(sums[:-1], sums[1:])]
    after = ref.named(model._state_out(st, clone=True)[0])
    names, want_losses, first, params = ref.train_steps(
        weights, raw, stats, steps, BP, LR, 100.0,
        'control' if variant == 'tf32' else 'reference')
    grad = {k: m / 0.1 for k, m in moment.items()}
    start = ref.named(weights)
    change = {k: torch.linalg.vector_norm(after[k] - start[k])
              for k in names}
    want_change = {k: torch.linalg.vector_norm(p - start[k])
                   for k, p in zip(names, params)}
    loss_ok = np.allclose(losses, want_losses, **STEPS_LOSS_TOL)
    grad_ok = max(_gaps(grad, dict(zip(names, first))).values()) <= GRAD_TOL
    change_ok = max(abs(float(change[k] / want_change[k]) - 1)
                    for k in names) <= CHANGE_TOL
    if variant is None:
        assert loss_ok, (losses, want_losses)
        assert grad_ok and change_ok, (grad_ok, change_ok)
    else:
        assert not (loss_ok and grad_ok and change_ok)


@pytest.mark.parametrize('variant', [None, 'tf32', 'forget_bias_0'])
def test_validation_loss(variant):
    """The port's masked validation loss over the padded test paths (its
    validation step's terms) against the reference's."""
    model, weights, stats, train, test, _ = _setup()
    st = _port_state(model, weights, train, test, 1)
    with torch.no_grad():
        num, den = model.valid_terms(st.layers, st.out, st.norm, st.test)
    paths, w = test
    obs, act, delta = model._split(paths)
    params = {'cells': weights['cells'], 'out': weights['out']}
    with RoundedProducts('tf32') if variant == 'tf32' else torch.no_grad():
        if variant == 'forget_bias_0':
            pred, _ = ref.forward(params, stats, obs, act, forget_bias=0.0)
            err = torch.mean(torch.square(pred - ref_models.norm(
                delta, stats, 'delta')), dim=(1, 2))
            want = torch.sum(err * w) / torch.clamp(w.sum(), min=1.0)
        else:
            want = ref.valid_loss(params, stats, obs, act, delta, w)
    ok = np.isclose(float(num / torch.clamp(den, min=1.0)), float(want),
                    **LOSS_TOL)
    assert ok == (variant is None), (float(num / den), float(want))


@pytest.mark.parametrize('variant', [None, 'forget_bias_0'])
def test_predict_thread_against_whole_sequence(variant):
    """predict_fn threaded 40 steps from a zero hidden state (the cell
    equations the planner runs) against the reference's whole-sequence
    forward, each step's obs + denormalized delta; the reference's own
    single step, threaded, gives its whole sequence too."""
    model, weights, stats, _, _, (obs, act, _) = _setup()
    hidden, ref_hidden = model.get_initial_hidden(PATHS), None
    got, ref_steps = [], []
    with torch.no_grad():
        for t in range(T_LEN):
            nxt, hidden = model.predict_fn(weights, model.normalizer,
                                           obs[:, t], act[:, t], hidden)
            got.append(nxt)
            nxt, ref_hidden = ref.predict(weights, stats, obs[:, t],
                                          act[:, t], ref_hidden)
            ref_steps.append(nxt)
        kw = dict(forget_bias=0.0) if variant else {}
        delta, _ = ref.forward(weights, stats, obs, act, **kw)
    want = obs + delta * (stats['delta_std'] + ref_models.EPS) + \
        stats['delta_mean']
    ok = np.allclose(torch.stack(got, 1).numpy(), want.numpy(),
                     **PREDICT_TOL)
    assert ok == (variant is None)
    if variant is None:
        np.testing.assert_allclose(torch.stack(ref_steps, 1).numpy(),
                                   want.numpy(), **PREDICT_TOL)


def test_rnn_seq_spans_and_steps_counter():
    """One eager train step records n_chunks 'rnn.seq' spans inside its
    'fit.loss', the validation step one; 'rnn.seq_steps' counts T x
    layers a forward, and nothing inside a capture's warm-ups (quiet)."""
    model = RNNDynamicsModel('d', FakeEnv(), hidden_sizes=(HIDDEN, 16),
                             batch_size=BATCH, backprop_steps=BP,
                             device='cpu')
    obs, act, nxt = _data()
    train, _ = model.stage(dict(obs=obs, act=act, delta=nxt - obs))
    test = model.stage(dict(obs=obs[:5], act=act[:5], delta=(nxt - obs)[:5]))
    gen = torch.Generator().manual_seed(0)
    before = tracing.counters().get('rnn.seq_steps', 0)
    tracing.enable(True)
    try:
        tracing.reset()
        model.epoch_fn(model.params, model.opt_state, model.normalizer,
                       train, test, PATHS, 1, gen)
        recs = tracing.records()
        with tracing.quiet():
            model.epoch_fn(model.params, model.opt_state, model.normalizer,
                           train, test, PATHS, 1, gen)
    finally:
        tracing.enable(False)
        tracing.reset()
    seq = [r for r in recs if r.name == 'rnn.seq']
    parents = [recs[recs[r.parent].parent].name if
               recs[r.parent].name == 'fit.loss' else recs[r.parent].name
               for r in seq]
    layers, chunks = 2, T_LEN // BP
    assert parents.count('fit.train_step') == chunks * layers
    assert parents.count('fit.valid_step') == layers
    assert len(seq) == (chunks + 1) * layers
    # a train step's chunks and the validation sequence, T steps each
    assert tracing.counters()['rnn.seq_steps'] - before == 2 * T_LEN * layers


def test_reference_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, '-c',
         'import json, sys\nimport port_bench.reference.rnn\n'
         'print(json.dumps(sorted(sys.modules)))'],
        cwd=REPO, capture_output=True, text=True, check=True)
    top = {m.split('.')[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert 'torch' in top
    assert not top & {'learning_to_adapt_torch', 'learning_to_adapt_tpu',
                      'jax', 'jaxlib', 'flax'}
