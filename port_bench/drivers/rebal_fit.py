"""Driver 'rebal_fit': calls of ReBAL's recurrent model's `fit`
(models/rnn.py RNNDynamicsModel), as the Trainer makes them late in a
run: each call brings one iteration's new paths, refits the normalizer
on them, aggregates, stages and runs a fixed number of epochs of
truncated-BPTT train steps and one validation step, the rolling-average
early stop held off (rolling_average_persitency 1.0).

Set-up builds the model as the entry point does, hands it LSTM weights
drawn from the seed in the JAX-layout tree, and fits the traffic's
starting dataset (drawn from the seed, paths of path_length steps) for
one epoch, which captures the train and validation steps of the window's
shape key. It then drives the model's first three train steps through
that captured train step, from the seed's weights and a fresh optimizer,
each on batch_size paths written into the step's path-index table, all
different, and reads the losses, Adam's first moment after one step and
the parameters after three (reference/rnn.py holds them against the
plain LSTM). The window is drivers/fit.py's: `calls_per_cycle` calls,
each with new paths, the set-up snapshot loaded at each cycle's start;
each call's train steps must be the captured train step's replays.

`correct` judges the three steps of set-up, by reference/fitting.py's
numbers; the window's own fits are not compared, as in drivers/fit.py."""
import math

import numpy as np
import torch

from port_bench.drivers import fit
from port_bench.lib import program
from port_bench.reference import fitting, rnn

release = fit.release
_split = fit._split


def lstm_weights(hp, gen, device):
    """The params tree at the configuration's widths, in one draw:
    Xavier-uniform wi and wh with the limit of the whole (in + H, 4H)
    kernel and an output layer with its own, biases uniform on [-0.1,
    0.1]."""
    d, a = hp.obs_dim, hp.act_dim
    (h,) = hp.hidden
    shapes = [(d + a, 4 * h), (h, 4 * h), (4 * h,), (h, d), (d,)]
    limits = [math.sqrt(6.0 / (d + a + h + 4 * h))] * 2 + [0.1] + \
        [math.sqrt(6.0 / (h + d)), 0.1]
    sizes = [math.prod(s) for s in shapes]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = [], 0
    for shape, n, limit in zip(shapes, sizes, limits):
        out.append((u[off:off + n] * (2 * limit) - limit).reshape(shape))
        off += n
    wi, wh, b, w, bo = out
    return {'cells': [dict(wi=wi, wh=wh, b=b)], 'out': {'w': [w], 'b': [bo]}}


def _clone(tree):
    from learning_to_adapt_torch.models.optim import tree_map
    return tree_map(torch.clone, tree)


def setup(ctx):
    cfg, tr, dev, hp = ctx.config, ctx.traffic, ctx.device, ctx.hp
    if len(hp.hidden) != 1 or cfg['run_config']['cell_type'] != 'lstm':
        raise ValueError('the rebal_fit driver runs one LSTM layer')
    _, model, _ = program.build(cfg, dev)
    gen = program.generator(dev, program.sub_seed(ctx.seed, 0))
    weights = lstm_weights(hp, gen, dev)
    first, per_call, calls = (tr['first'], tr['per_call'],
                              tr['calls_per_cycle'])
    total = first + per_call * calls
    obs, act, nxt = program.fit_data(hp, gen, dev,
                                     (total, tr['path_length']))
    model.params = _clone(weights)
    model.fit(obs[:first], act[:first], nxt[:first], epochs=1,
              valid_split_ratio=tr['first_valid_split'],
              rolling_average_persitency=1.0)
    n_train = _split(first, tr['first_valid_split'])
    got = model._train['obs'].shape[0]
    if got != n_train:
        raise RuntimeError(f'the first fit kept {got} train paths, the '
                           f'traffic expects {n_train}')
    rng = np.random.RandomState(program.sub_seed(ctx.seed, 3) % 2 ** 32)
    bs = hp.batch_size
    paths = rng.choice(n_train, size=3 * bs, replace=False)
    steps = [paths[i * bs:(i + 1) * bs] for i in range(3)]
    readings = _program_steps(model, weights, (obs, act, nxt), first,
                              n_train, steps)
    train_steps, p_tr = [], n_train
    for _ in range(calls):
        p_tr += _split(per_call, hp.valid_split_ratio)
        train_steps.append(tr['epochs_per_call'] *
                           fit.steps_per_epoch(hp, p_tr, 1))
    return dict(model=model, data=(obs, act, nxt), weights=weights,
                steps=steps, program=readings, snapshot=model.state_dict(
                    include_data=True), train_steps=train_steps)


def _program_steps(model, weights, data, first, n_train, steps):
    """The program's three steps through its captured train step (a plain
    call on the CPU), on the first n_train paths in order. Returns each
    step's loss, the first clipped gradient's norm by leaf (Adam's m / (1
    - b1)) and the parameters' change after three by leaf."""
    obs, act, nxt = data
    part = [slice(0, n_train), slice(n_train, first)]
    train, test = (dict(obs=obs[s], act=act[s], delta=nxt[s] - obs[s])
                   for s in part)
    train, _ = model.stage(train)
    test = model.stage(test)
    params = _clone(weights)
    opt = model.optimizer.init(params)
    compiled = model.compiled_epoch(train, test)
    compiled.prepare(lambda st: model._load_state(
        st, params, opt, model.normalizer, train, test))
    st = compiled.state
    dev = st.counter.device
    with torch.no_grad():
        for i, idx in enumerate(steps):
            st.path_idx[i].copy_(torch.as_tensor(idx, device=dev))
        st.counter.zero_()
        st.sums.zero_()
    sums, first_moment = [], None
    for i in range(len(steps)):
        compiled.train()
        sums.append(float(st.sums[0]))
        if i == 0:
            first_moment = rnn.named(model._state_out(st, clone=True)[1]
                                     ['mu'])
    losses = [sums[0]] + [b - a for a, b in zip(sums[:-1], sums[1:])]
    # the model goes on from its three steps
    model.params, model.opt_state = model._state_out(st, clone=True)
    start = rnn.named(weights)
    return dict(
        losses=losses,
        grad={k: float(torch.linalg.vector_norm(m / (1 - fit.B1)))
              for k, m in first_moment.items()},
        change={k: float(torch.linalg.vector_norm(p - start[k]))
                for k, p in rnn.named(model.params).items()})


def window(ctx, state):
    """drivers/fit.py's window; the traced call's work also gives the
    rows of its validation forwards (the staged test capacity)."""
    out = fit.window(ctx, state)
    if out['trace'] is not None:
        (compiled,) = state['model']._epoch_cache.values()
        out['trace'].work['valid_rows'] = compiled.state.test[0].shape[0]
    return out


def readings(ctx, state, mode='program'):
    """The cell's numbers: the program's three steps (mode 'program'), or
    the control's ('control') or a fault's ('half'), against the
    reference's."""
    hp, dev, tr = ctx.hp, torch.device(ctx.device), ctx.traffic
    obs, act, nxt = (torch.as_tensor(x, device=dev) for x in state['data'])
    n_train = _split(tr['first'], tr['first_valid_split'])
    first = tr['first']
    steps = [torch.as_tensor(s, device=dev) for s in state['steps']]
    data = (obs[:n_train], act[:n_train], nxt[:n_train])
    stats_data = (obs[:first], act[:first], nxt[:first] - obs[:first])
    bp = ctx.config['run_config']['backprop_steps']

    def ref(m):
        return rnn.run(state['weights'], data, stats_data, steps, bp,
                       hp.lr, hp.clip_norm, m)
    got = state['program'] if mode == 'program' else ref(mode)
    return fitting.numbers(got, ref('reference'))
