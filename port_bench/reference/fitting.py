"""What decides a fit cell's `correct`: the fit's first three train steps,
which the set-up drives through the window's own captured train step from
the seed's weights on rows that all differ, held against the plain
reference following the same three steps from the same weights, data and
rows.

Three numbers:

loss_gap    the wider relative gap of the first two steps' training loss
            (GrBAL: the post-update meta loss), |program - reference| /
            |reference|; the second step's loss is taken after the first
            update;
grad_gap    the first gradient as the optimizer took it (clipped), read
            from its first moment after one step (g = m / (1 - b1)): the
            widest gap between the program's and the reference's norm of
            a leaf, over the larger of the reference's norm of that leaf
            and of the median leaf;
change_gap  the same gap for the parameters' change after the three
            steps, of the median leaf, over the leaves whose reference
            gradient is at least a thousandth of the median leaf's (a leaf
            with none moves by round-off alone under Adam).

The third step's loss and the worst leaf's change are not compared: on
some seeds Adam turns gradient elements of the size of round-off (|g|
near its eps, which the second-order meta gradient has by the thousand)
into steps of up to the learning rate whose sign is the round-off's, so
by the third step a leaf's change, and the loss, part by up to 3e-4 where
other seeds read 7e-6 (the look and its readings are in PERF.md).

The reference is f32 with exact f32 products; in the program's place the
control runs it with TF32 products (every product, forward, backward and
second order), and the faults run it with half of each batch (the mean
over the rest)."""
from contextlib import nullcontext

import numpy as np
import torch

from port_bench.lib.precision import RoundedProducts
from port_bench.reference import models



def leaf_names(n_layers):
    return ([f'w{i}' for i in range(n_layers)] +
            [f'b{i}' for i in range(n_layers)])


def _batch(hp, data, idx, half):
    """The step's rows: GrBAL (tasks, 2k, d) windows of the paths at
    (path, offset), rows [offset - k, offset + k); MB-MPC (rows, d)."""
    obs, act, nxt = data
    if hp.algo == 'grbal':
        pidx, offs = idx
        if half:
            pidx, offs = pidx[:len(pidx) // 2], offs[:len(offs) // 2]
        k = hp.batch_size
        span = torch.arange(-k, k, device=obs.device)
        rows = offs[:, None] + span
        return tuple(x[pidx[:, None], rows] for x in (obs, act, nxt))
    sel = idx[:len(idx) // 2] if half else idx
    return tuple(x[sel] for x in (obs, act, nxt))


def run(hp, weights, data, stats_data, steps, mode='reference'):
    """The reference's three steps. weights (ws, bs); data (obs, act, next
    obs) device tensors of the train paths or rows the steps index;
    stats_data the data the fit normalizes by; steps the rows of each step
    (GrBAL (path index, offset) tensors, MB-MPC row indices). mode:
    'reference', 'control' (TF32 products) or 'half' (half of each
    batch). Returns {'losses', 'grad', 'change'} (norms by leaf name)."""
    stats = models.normalizer(*stats_data)
    ws, bs = weights
    n = len(ws)
    params = [p.detach().clone() for p in list(ws) + list(bs)]
    start = [p.clone() for p in params]
    adam = models.Adam(params, hp.lr, hp.clip_norm)
    losses, first = [], None
    for k, idx in enumerate(steps):
        o, a, x = _batch(hp, data, idx, mode == 'half')
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad(), (RoundedProducts('tf32')
                                   if mode == 'control' else nullcontext()):
            if hp.algo == 'grbal':
                loss, _ = models.meta_loss(
                    leaves[:n], leaves[n:], stats, o, a, x, hp.inner_lr,
                    hp.batch_size, hp.nonlinearity)
            else:
                loss = models.weighted_loss(
                    leaves[:n], leaves[n:], stats, o, a, x,
                    torch.ones(o.shape[0], device=o.device),
                    hp.nonlinearity)
            grads = torch.autograd.grad(loss, leaves)
        params, clipped = adam.step(params, list(grads))
        losses.append(float(loss.detach()))
        if k == 0:
            first = clipped
    names = leaf_names(n)
    return dict(
        losses=losses,
        grad={m: float(torch.linalg.vector_norm(g))
              for m, g in zip(names, first)},
        change={m: float(torch.linalg.vector_norm(p - s))
                for m, p, s in zip(names, params, start)})


def numbers(got, ref):
    """{'loss_gap', 'grad_gap', 'change_gap'} of readings `got` (the
    program's, or the control's or a fault's) against the reference's."""
    loss = max(abs(g - r) / abs(r) for g, r in zip(got['losses'][:2],
                                                    ref['losses'][:2]))
    g_med = float(np.median(list(ref['grad'].values())))
    grad = max(abs(got['grad'][k] - r) / max(r, g_med)
               for k, r in ref['grad'].items())
    moved = [k for k, r in ref['grad'].items() if r >= 1e-3 * g_med]
    c_med = float(np.median([ref['change'][k] for k in moved]))
    change = float(np.median([abs(got['change'][k] - ref['change'][k]) /
                              max(ref['change'][k], c_med) for k in moved]))
    return dict(loss_gap=loss, grad_gap=grad, change_gap=change)
