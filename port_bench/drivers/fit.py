"""Driver 'fit': calls of the dynamics model's `fit`, as the Trainer makes
them late in a run: each call brings one iteration's new paths (GrBAL) or
rows (MB-MPC), refits the normalizer on them, aggregates, stages and runs
a fixed number of epochs, the rolling-average early stop held off through
fit's own rolling_average_persitency argument (1.0 keeps the average
where it starts, so it never rises).

Set-up builds the model as the entry point does, hands it weights drawn
from the seed, and fits the traffic's starting dataset (drawn from the
seed) for one epoch, which captures the train and validation steps of
the window's shape key. It then drives the model's first three train
steps through that captured train step, from the seed's weights and a
fresh optimizer, on rows that all differ (reference/fitting.py), reads
the loss, the optimizer's first moment and the parameters back, and
hands the model on from there. The window makes `calls_per_cycle` calls,
each with new data; the next call would cross a capacity bucket and
recapture, so the model's state after set-up is loaded again
(load_state_dict) and the cycle repeats, until `seconds` have passed.
fit_step_ms is the window's wall time over the train steps its calls
ran, counted as replays of the model's captured train steps
(StepGraph.replays); a call that ran another number than its epochs
times its steps an epoch stops the run.

`correct` judges the three steps of set-up; the window's own fits (their
staging, the normalizer's refit, each epoch's index draws, the snapshot
loaded at each cycle's start) are not compared with the reference: the
program has no public entry that runs k steps of its captured train
step, and the losses a fit returns are means over an epoch's moving
parameters, which nothing outside the fit can recompute."""
import time

import numpy as np
import torch

from port_bench.lib import program, trace
from port_bench.reference import fitting
from port_bench.roofline.counts import bucket_pow2

B1 = 0.9


def _split(n, ratio):
    return max(int(n * (1 - ratio)), 1)


def steps_per_epoch(hp, n_train, t_len):
    """Train steps of one epoch over n_train paths (GrBAL) or rows."""
    if hp.algo == 'grbal':
        per_step = hp.meta_batch_size * hp.batch_size * 2
        return bucket_pow2(max(int(n_train * t_len / per_step), 1))
    return bucket_pow2(max(n_train // hp.batch_size, 1))


def setup(ctx):
    cfg, tr, dev, hp = ctx.config, ctx.traffic, ctx.device, ctx.hp
    _, model, _ = program.build(cfg, dev)
    gen = program.generator(dev, program.sub_seed(ctx.seed, 0))
    ws, bs = program.weights(hp, gen, dev)
    first, per_call, calls = (tr['first'], tr['per_call'],
                              tr['calls_per_cycle'])
    total = first + per_call * calls
    t_len = tr.get('path_length')
    lead = (total, t_len) if hp.algo == 'grbal' else (total,)
    obs, act, nxt = program.fit_data(hp, gen, dev, lead)
    model.params = {'w': [w.clone() for w in ws],
                    'b': [b.clone() for b in bs]}
    model.fit(obs[:first], act[:first], nxt[:first], epochs=1,
              valid_split_ratio=tr['first_valid_split'],
              rolling_average_persitency=1.0)
    n_train = _split(first, tr['first_valid_split'])
    got = model._train['obs'].shape[0]
    if got != n_train:
        raise RuntimeError(f'the first fit kept {got} train paths or rows, '
                           f'the traffic expects {n_train}')
    rng = np.random.RandomState(program.sub_seed(ctx.seed, 3) % 2 ** 32)
    steps = _three_steps(hp, rng, n_train, t_len)
    readings = _program_steps(model, hp, (ws, bs), (obs, act, nxt),
                              first, n_train, steps)
    ratio = hp.valid_split_ratio
    train_steps, p_tr = [], n_train
    for _ in range(calls):
        p_tr += _split(per_call, ratio)
        train_steps.append(tr['epochs_per_call'] *
                           steps_per_epoch(hp, p_tr, t_len or 1))
    return dict(model=model, data=(obs, act, nxt), weights=(ws, bs),
                steps=steps, program=readings, snapshot=model.state_dict(
                    include_data=True), train_steps=train_steps)


def _three_steps(hp, rng, n_train, t_len):
    """The rows of three train steps, all different: GrBAL (path index,
    offset) a task, MB-MPC a minibatch of row indices."""
    if hp.algo == 'grbal':
        m, k = hp.meta_batch_size, hp.batch_size
        paths = rng.choice(n_train, size=3 * m, replace=False)
        offs = rng.randint(k, t_len - k, size=3 * m)
        return [(paths[i * m:(i + 1) * m], offs[i * m:(i + 1) * m])
                for i in range(3)]
    rows = rng.choice(n_train, size=3 * hp.batch_size, replace=False)
    return [rows[i * hp.batch_size:(i + 1) * hp.batch_size]
            for i in range(3)]


def _program_steps(model, hp, weights, data, first, n_train, steps):
    """The program's three steps through its captured train step (a plain
    call on the CPU). Returns the readings reference/fitting.py compares:
    each step's loss, the first clipped gradient's norm by leaf, the
    parameters' change after three by leaf."""
    from learning_to_adapt_torch.models.optim import tree_leaves
    obs, act, nxt = data
    tr = dict(obs=obs[:n_train], act=act[:n_train],
              delta=nxt[:n_train] - obs[:n_train])
    te = dict(obs=obs[n_train:first], act=act[n_train:first],
              delta=nxt[n_train:first] - obs[n_train:first])
    if hp.algo == 'grbal':
        cap_tr, cap_te, _, _ = model._fit_shapes(n_train, first - n_train,
                                                 obs.shape[1])
        train, test = model.stage(tr, cap_tr), model.stage(te, cap_te)
    else:
        train, test = model.stage(tr), model.stage(te)
    ws, bs = weights
    params = {'w': [w.clone() for w in ws], 'b': [b.clone() for b in bs]}
    opt = model.optimizer.init(params)
    compiled = model.compiled_epoch(train, test)
    compiled.prepare(lambda st: model._load_state(
        st, params, opt, model.normalizer, train, test))
    st = compiled.state
    dev = st.counter.device
    with torch.no_grad():
        for i, idx in enumerate(steps):
            if hp.algo == 'grbal':
                st.pidx[i].copy_(torch.as_tensor(idx[0], device=dev))
                st.offs[i].copy_(torch.as_tensor(idx[1], device=dev))
            else:
                st.sel[i].copy_(torch.as_tensor(idx, device=dev))
        st.counter.zero_()
        st.sums.zero_()
    n = len(ws)
    names = tree_leaves({'w': [f'w{i}' for i in range(n)],
                         'b': [f'b{i}' for i in range(n)]})
    start = tree_leaves(params)
    sums, first_moment = [], None
    for i in range(len(steps)):
        compiled.train()
        sums.append(float(st.sums[0]))
        if i == 0:
            first_moment = [m.detach().clone() for m in st.mu]
    losses = [sums[0]] + [b - a for a, b in zip(sums[:-1], sums[1:])]
    readings = dict(
        losses=losses,
        grad={k: float(torch.linalg.vector_norm(m / (1 - B1)))
              for k, m in zip(names, first_moment)},
        change={k: float(torch.linalg.vector_norm(p.detach() - s))
                for k, p, s in zip(names, st.leaves, start)})
    # the model goes on from its three steps
    model.params, model.opt_state = model._state_out(st, clone=True)
    return readings


def train_replays(model):
    """Replays of the model's captured train steps so far, over its shape
    keys."""
    return sum(c.train.replays for c in model._epoch_cache.values())


def ran_steps(ctx, model, before, expected):
    """The train steps a call ran: on the card its replays, which have to
    be the `expected` epochs times steps an epoch; on the CPU, where fit
    steps eagerly and replays nothing, `expected`."""
    if ctx.device.type != 'cuda':
        return expected
    ran = train_replays(model) - before
    if ran != expected:
        raise RuntimeError(f'a fit call ran {ran} train steps, the traffic '
                           f'makes {expected}')
    return ran


def window(ctx, state):
    tr = ctx.traffic
    model, (obs, act, nxt) = state['model'], state['data']
    first, per_call = tr['first'], tr['per_call']
    cycle = tr['calls_per_cycle']
    done, steps, traced, traced_s, traced_steps = 0, 0, None, 0.0, 0
    seconds = []
    t0 = time.perf_counter()
    while True:
        t_call = time.perf_counter()
        j = done % cycle
        if j == 0 and done:
            model.load_state_dict(state['snapshot'])
        lo = first + j * per_call
        new = (obs[lo:lo + per_call], act[lo:lo + per_call],
               nxt[lo:lo + per_call])

        def call():
            return model.fit(*new, epochs=tr['epochs_per_call'],
                             rolling_average_persitency=1.0)
        before = train_replays(model)
        if ctx.trace and traced is None:
            traced, info = trace.profile(call)
            traced_s = time.perf_counter() - t_call
        else:
            info = call()
        if info['epochs'] != tr['epochs_per_call'] - 1:
            raise RuntimeError(f'a fit stopped after {info["epochs"] + 1} '
                               f'of {tr["epochs_per_call"]} epochs')
        ran = ran_steps(ctx, model, before, state['train_steps'][j])
        if traced is not None and not traced_steps:
            traced_steps = ran
            traced.work = dict(train_steps=ran)
        steps += ran
        done += 1
        seconds.append(time.perf_counter() - t_call)
        wall = time.perf_counter() - t0
        # a traced run measures `seconds` of unprofiled calls besides
        if wall - traced_s >= ctx.seconds:
            break
    untraced = steps - traced_steps
    return dict(
        attempted=done, failed=0, call_seconds=seconds,
        end_to_end=dict(fit_step_ms=wall * 1e3 / steps),
        trace=traced,
        wall_per_step=((wall - traced_s) / untraced if untraced else None))


def release(state):
    state.pop('model', None)


def readings(ctx, state, mode='program'):
    """The cell's numbers: the program's three steps (mode 'program'), or
    the control's ('control') or a fault's ('half'), against the
    reference's."""
    hp, dev = ctx.hp, torch.device(ctx.device)
    obs, act, nxt = (torch.as_tensor(x, device=dev) for x in state['data'])
    tr = ctx.traffic
    n_train = _split(tr['first'], tr['first_valid_split'])
    first = tr['first']
    steps = [tuple(torch.as_tensor(x, device=dev) for x in s)
             if hp.algo == 'grbal' else torch.as_tensor(s, device=dev)
             for s in state['steps']]
    data = (obs[:n_train], act[:n_train], nxt[:n_train])
    stats_data = (obs[:first], act[:first], nxt[:first] - obs[:first])
    ref = fitting.run(hp, state['weights'], data, stats_data, steps)
    got = (state['program'] if mode == 'program' else
           fitting.run(hp, state['weights'], data, stats_data, steps, mode))
    return fitting.numbers(got, ref)
