"""ReBAL's recurrent dynamics model written out plainly: the LSTM's gate
equations as matrix products, the truncated-BPTT loss, the masked
validation loss and the single step the planner threads; with
reference/models.py's normalizer and Adam, three clip + Adam steps
(`run`), which decide a `rebal_fit` run's `correct`.

    gates = x_t @ wi + h @ wh + b        (B, 4H), gate order i, f, g, o
    c'    = sigmoid(f + FORGET_BIAS) * c + sigmoid(i) * tanh(g)
    h'    = sigmoid(o) * tanh(c')
    delta = h' @ out.w + out.b           the normalized next-state delta

Each chunk's input products x @ wi + b are taken for all its steps at
once; the recurrence h @ wh runs step by step. No recurrent layer op
(torch.lstm, cuDNN) runs here, so the reference is apart from the op the
program runs. Everything is f32 with exact f32 products (TF32 off:
lib/precision.py exact_f32); the caller picks the products' precision
(RoundedProducts).

Departures from run_rebal.py's TF model (iclavera/learning_to_adapt, an
LSTM of TF's BasicLSTMCell equations): the parameters keep the
JAX package's layout, {'cells': [{'wi' (in, 4H), 'wh' (H, 4H), 'b'
(4H,)}], 'out': {'w': [(H, obs)], 'b': [(obs,)]}}, one kernel split into
its input and hidden rows, with the gates in torch's order (i, f, g, o
where TF's cell takes i, j, f, o); the forget gate's bias of 1.0 is
one constant on the hidden side, as TF's forget_bias adds it, not a
trained parameter."""
from contextlib import nullcontext

import torch

from port_bench.lib.precision import RoundedProducts
from port_bench.reference import models

FORGET_BIAS = 1.0


def named(tree):
    """{leaf name: tensor} of a params-shaped tree, in a fixed order:
    cells.<layer>.{wi, wh, b}, then out.w, out.b (the output layer's one
    weight and bias)."""
    out = {}
    for i, cell in enumerate(tree['cells']):
        for k in ('wi', 'wh', 'b'):
            out[f'cells.{i}.{k}'] = cell[k]
    (w,), (b,) = tree['out']['w'], tree['out']['b']
    out['out.w'], out['out.b'] = w, b
    return out


def tree(leaves, n_layers):
    """The params tree of leaves in `named` order."""
    it = iter(leaves)
    cells = [dict(wi=next(it), wh=next(it), b=next(it))
             for _ in range(n_layers)]
    return {'cells': cells, 'out': {'w': [next(it)], 'b': [next(it)]}}


def lstm_layer(cell, x, h, c, forget_bias=FORGET_BIAS):
    """x (B, T, in) through one LSTM layer from (h, c) (B, H): (outputs
    (B, T, H), (h, c) after the last step)."""
    xw = torch.matmul(x, cell['wi']) + cell['b']
    outs = []
    for t in range(x.shape[1]):
        gates = xw[:, t] + h @ cell['wh']
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + forget_bias) * c + \
            torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1), (h, c)


def zero_hidden(params, batch, like):
    return [(like.new_zeros(batch, cell['wh'].shape[0]),) * 2
            for cell in params['cells']]


def forward(params, stats, obs, act, hidden=None,
            forget_bias=FORGET_BIAS):
    """obs (B, T, obs), act (B, T, act) from hidden ([(h, c)] a layer;
    zeros when None): (normalized deltas (B, T, obs), hidden after)."""
    if hidden is None:
        hidden = zero_hidden(params, obs.shape[0], obs)
    x = torch.cat([models.norm(obs, stats, 'obs'),
                   models.norm(act, stats, 'act')], dim=-1)
    after = []
    for cell, (h, c) in zip(params['cells'], hidden):
        x, hc = lstm_layer(cell, x, h, c, forget_bias)
        after.append(hc)
    (w,), (b,) = params['out']['w'], params['out']['b']
    return torch.matmul(x, w) + b, after


def predict(params, stats, obs, act, hidden):
    """One step for rows obs, act (B, d): (obs + denormalized delta,
    hidden after)."""
    delta, hidden = forward(params, stats, obs[:, None], act[:, None],
                            hidden)
    return obs + (delta[:, 0] * (stats['delta_std'] + models.EPS) +
                  stats['delta_mean']), hidden


def tbptt_loss(params, stats, obs, act, delta, backprop_steps,
               forget_bias=FORGET_BIAS, stop_gradient=True):
    """Paths (B, T, d) cut into max(T // backprop_steps, 1) chunks of
    backprop_steps steps (a remainder is left out): the mean over chunks
    of each chunk's mean squared error on the normalized delta, the
    hidden state carried from chunk to chunk with its gradient stopped.
    forget_bias and stop_gradient give the variants the program must not
    match."""
    bp = backprop_steps
    n_chunks = max(obs.shape[1] // bp, 1)
    hidden, total = None, 0.0
    for k in range(n_chunks):
        span = slice(k * bp, (k + 1) * bp)
        pred, hidden = forward(params, stats, obs[:, span], act[:, span],
                               hidden, forget_bias)
        total = total + torch.mean(torch.square(
            pred - models.norm(delta[:, span], stats, 'delta')))
        if stop_gradient:
            hidden = [(h.detach(), c.detach()) for h, c in hidden]
    return total / n_chunks


def valid_loss(params, stats, obs, act, delta, weight):
    """The masked validation loss over padded test paths (P, T, d): each
    path's mean squared error over its steps and dims, weighted by
    `weight` (P,) (0 on padding), over max(sum of weights, 1)."""
    pred, _ = forward(params, stats, obs, act)
    err = torch.mean(torch.square(
        pred - models.norm(delta, stats, 'delta')), dim=(1, 2))
    return torch.sum(err * weight) / torch.clamp(weight.sum(), min=1.0)


def train_steps(weights, data, stats, steps, backprop_steps, lr, clip_norm,
                mode='reference'):
    """Clip + Adam train steps from the params tree `weights`: data (obs,
    act, next obs) (P, T, d) of the train paths the steps index, stats
    the normalizer's (models.normalizer), steps each step's path indices.
    mode: 'reference', 'control' (TF32 products) or 'half' (the first
    half of each step's paths). Returns (names, each step's loss, the
    first step's clipped gradients, the parameters after the steps), the
    tensors in `named` order."""
    names = list(named(weights))
    n_layers = len(weights['cells'])
    params = [p.detach().clone() for p in named(weights).values()]
    adam = models.Adam(params, lr, clip_norm)
    losses, first = [], None
    for k, idx in enumerate(steps):
        sel = idx[:len(idx) // 2] if mode == 'half' else idx
        o, a, x = (d[sel] for d in data)
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad(), (RoundedProducts('tf32')
                                   if mode == 'control' else nullcontext()):
            loss = tbptt_loss(tree(leaves, n_layers), stats, o, a, x - o,
                              backprop_steps)
            grads = torch.autograd.grad(loss, leaves)
        params, clipped = adam.step(params, list(grads))
        losses.append(float(loss.detach()))
        if k == 0:
            first = clipped
    return names, losses, first, params


def run(weights, data, stats_data, steps, backprop_steps, lr, clip_norm,
        mode='reference'):
    """The reference's train steps (`train_steps`, the normalizer fitted on
    stats_data, the (obs, act, delta) the fit normalizes by) as the
    numbers reference/fitting.py compares: {'losses', 'grad', 'change'},
    each step's loss, the first clipped gradient's norm by leaf and the
    parameters' change after the steps by leaf."""
    names, losses, first, params = train_steps(
        weights, data, models.normalizer(*stats_data), steps,
        backprop_steps, lr, clip_norm, mode)
    start = named(weights).values()
    return dict(
        losses=losses,
        grad={n: float(torch.linalg.vector_norm(g))
              for n, g in zip(names, first)},
        change={n: float(torch.linalg.vector_norm(p - s))
                for n, p, s in zip(names, params, start)})
