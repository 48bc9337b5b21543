"""The port's spans and counters (utils/tracing.py): off records nothing and
changes no result; records nest, carry their parents, call ids and self
times; the recurrent fit's spans; reset and totals; the captured steps'
graphs kept by the tracing state (CompiledRollout, CompiledEpoch on the
CPU, where a StepGraph calls its step); the device stamps' decoding, one
offset a call, and the capture's merging of span edges with nothing
launched between them; Trainer.record_iteration writing the totals and
counters. Two cases, marked cuda, need a card: a captured step's stamps
come back once a replay, in order, each step within 10 us of the host's
readings around its replay; and a profiled sampling call's stamps fall
within 10 us of its trace's stamp kernels once the trace's own scale is
taken out
(`python -m pytest --noconftest tests/test_torch_tracing.py -m cuda -q -s`
on the card; this file imports no JAX)."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.models import (
    MLPDynamicsModel, MetaMLPDynamicsModel, captured)
from learning_to_adapt_torch.models.optim import tree_leaves
from learning_to_adapt_torch.policies import MPCController
from learning_to_adapt_torch.samplers import Sampler
from learning_to_adapt_torch.samplers.rollout import make_rollout_fn
from learning_to_adapt_torch.trainers import Trainer
from learning_to_adapt_torch.utils import logging as port_log, tracing


@pytest.fixture(autouse=True)
def tracing_off():
    """Every case starts and ends with tracing off and no records."""
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture
def compiled_on_cpu(monkeypatch):
    """The device rule patched to take the compiled rollout on the CPU (the
    fits take their compiled epoch everywhere)."""
    monkeypatch.setattr(captured, 'captures', lambda device, mesh: True)


def _env():
    return port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device='cpu'))


def _parts(algo, seed=0):
    env = _env()
    if algo == 'grbal':
        model = MetaMLPDynamicsModel('d', env, hidden_sizes=(16,),
                                     meta_batch_size=2, batch_size=4,
                                     inner_learning_rate=0.01, seed=seed,
                                     device='cpu')
        kw = dict(adapt_batch_size=4)
    else:
        model = MLPDynamicsModel('d', env, hidden_sizes=(16,), batch_size=8,
                                 seed=seed, device='cpu')
        kw = {}
    policy = MPCController('p', env, model, n_candidates=8, horizon=3)
    return env, model, policy, kw


def _sample_and_fit(algo):
    """Two sampling calls and two fits on their paths, from seed 0."""
    torch.manual_seed(0)
    env, model, policy, kw = _parts(algo)
    sampler = Sampler(env, policy, 2, 12, device='cpu', seed=5, **kw)
    out = []
    for _ in range(2):
        paths = sampler.obtain_samples(random=False)
        out.append(paths)
        data = [paths[k] for k in ('observations', 'actions',
                                   'next_observations')]
        if algo != 'grbal':
            data = [a.reshape(-1, a.shape[-1]) for a in data]
        out.append(model.fit(*data, epochs=2))
    return out, [p.detach().clone() for p in tree_leaves(model.params)]


# ---------------------------------------------------------------- on, off
@pytest.mark.parametrize('algo', ['grbal', 'mbmpc'])
def test_off_records_nothing_and_on_changes_nothing(algo, compiled_on_cpu):
    """With tracing off nothing is recorded; on, the same paths, losses and
    parameters bit for bit, and the spans of both calls."""
    off, params_off = _sample_and_fit(algo)
    assert tracing.records() == [] and tracing.totals() == {}
    tracing.enable(True)
    on, params_on = _sample_and_fit(algo)
    for a, b in zip(off, on):
        if isinstance(a, dict) and 'observations' in a:
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a == b
    for a, b in zip(params_off, params_on):
        assert torch.equal(a, b)
    host = tracing.totals()['host']
    assert host['rollout.call']['count'] == 2
    assert host['rollout.step']['count'] == 24      # one a replayed step
    assert host['rollout.plan']['count'] == 24      # the step's own parts
    assert host['fit.call']['count'] == 2
    assert {'fit.normalize', 'fit.stage', 'fit.prepare', 'fit.draws',
            'fit.read', 'fit.state_out', 'fit.train_step', 'fit.valid_step',
            'fit.loss', 'fit.grad', 'fit.optim'} <= set(host)
    assert ('rollout.adapt' in host) == (algo == 'grbal')


def test_recurrent_fit_records_its_spans():
    """The recurrent model's fit, off and on: the same losses and
    parameters bit for bit; on, one read of the losses an epoch and the
    three parts of every train step."""
    from learning_to_adapt_torch.models import RNNDynamicsModel
    rng = np.random.RandomState(3)
    obs = rng.randn(4, 30, 20).astype(np.float32)
    act = rng.uniform(-1, 1, (4, 30, 6)).astype(np.float32)
    out = []
    for on in (False, True):
        tracing.enable(on)
        model = RNNDynamicsModel('d', _env(), hidden_sizes=(16,),
                                 batch_size=3, backprop_steps=10, seed=1,
                                 device='cpu')
        losses = model.fit(obs, act, obs + 0.1, epochs=2)
        out.append((losses, [p.detach().clone()
                             for p in tree_leaves(model.params)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    host = tracing.totals()['host']
    assert host['fit.call']['count'] == 1
    assert host['fit.read']['count'] == 2
    steps = host['fit.train_step']['count']
    assert steps > 0 and all(host[k]['count'] == steps
                             for k in ('fit.loss', 'fit.grad', 'fit.optim'))


def test_spans_nest_with_parents_calls_and_self_time(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(tracing, 'now', lambda: next(clock))
    tracing.enable(True)
    with tracing.span('top'):                       # 0 .. 90
        with tracing.call('c.call'):                # 10 .. 80
            with tracing.span('c.a'):               # 20 .. 50
                with tracing.span('c.b'):           # 30 .. 40
                    pass
            with tracing.span('c.a'):               # 60 .. 70
                pass
    with tracing.call('d.call'):                    # 100 .. 110
        pass
    recs = tracing.records()
    assert [r.name for r in recs] == ['top', 'c.call', 'c.a', 'c.b', 'c.a',
                                      'd.call']
    assert [r.parent for r in recs] == [None, 0, 1, 2, 1, None]
    c = recs[1].call
    assert [r.call for r in recs] == [None, c, c, c, c, c + 1]
    assert [(r.start, r.end) for r in recs] == [
        (0, 90), (10, 80), (20, 50), (30, 40), (60, 70), (100, 110)]
    assert {r.clock for r in recs} == {'host'}
    host = tracing.totals()['host']
    assert host['c.a'] == dict(count=2, total_ns=40, self_ns=30)
    assert host['c.call'] == dict(count=1, total_ns=70, self_ns=30)
    assert host['top'] == dict(count=1, total_ns=90, self_ns=20)


def test_reset_clears_records_and_keeps_counters():
    tracing.count('graph.captures')
    tracing.count('graph.capture_s', 0.5)
    before = tracing.counters()
    tracing.enable(True)
    with tracing.span('x'):
        with pytest.raises(RuntimeError, match='open span'):
            tracing.reset()
    assert len(tracing.records()) == 1
    assert tracing.totals()['host']['x']['count'] == 1
    tracing.reset()
    assert tracing.records() == [] and tracing.totals() == {}
    assert tracing.counters() == before
    with tracing.quiet():
        with tracing.span('y'):
            pass
    assert tracing.records() == []


# ------------------------------------------------- graphs by tracing state
def test_compiled_rollout_keeps_graphs_by_tracing_state(compiled_on_cpu):
    env, model, policy, kw = _parts('grbal')
    fn = make_rollout_fn(env, policy, model, 2, 12, **kw)
    gen = torch.Generator()
    gen.manual_seed(1)
    a = fn(model.params, model.normalizer, gen, 0)
    off = dict(fn.graphs)
    assert sorted(fn.by_tracing) == [False]
    assert sorted(off) == [(False, False), (True, False)]
    replays = {k: g.replays for k, g in off.items()}
    tracing.enable(True)
    gen.manual_seed(1)
    b = fn(model.params, model.normalizer, gen, 0)
    assert sorted(fn.by_tracing) == [False, True]
    assert sorted(fn.graphs) == sorted(off)
    assert not {id(g) for g in fn.graphs.values()} & {
        id(g) for g in off.values()}
    assert fn.by_tracing[False] == off
    assert {k: g.replays for k, g in off.items()} == replays
    assert all(g.name == 'rollout.step' and g.stamps == ()
               for g in fn.graphs.values())
    for k in a:
        assert torch.equal(a[k], b[k])


def test_compiled_epoch_keeps_graphs_by_tracing_state():
    _, model, _, _ = _parts('mbmpc')
    rng = np.random.RandomState(0)
    obs, act = rng.randn(40, 20), rng.uniform(-1, 1, (40, 6))
    model.fit(obs, act, obs + 0.1, epochs=1)
    (compiled,) = model._epoch_cache.values()
    off = compiled.graphs[False]
    assert sorted(compiled.graphs) == [False]
    assert [g.name for g in off] == ['fit.train_step', 'fit.valid_step']
    tracing.enable(True)
    model.fit(obs, act, obs + 0.1, epochs=1)
    assert sorted(compiled.graphs) == [False, True]
    assert compiled.graphs[False] is off
    assert compiled.train is compiled.graphs[True][0]
    tracing.enable(False)
    assert compiled.train is off[0]


# --------------------------------------------------------- device stamps
def test_decode_turns_stamps_into_device_records():
    """A replay's stamps (each marking the span edges of its slot) become
    device records: the step from its first stamp to its last under the
    host span of the replay, each part under the step; every time goes
    by the call's offset. Stamps of streams that ran at once may reach
    the ring in another order: each slot keeps its own time and the
    edges their captured order. Stamps other than a replay's, or out of
    their captured order on one stream, raise."""
    tracing.enable(True)
    with tracing.call('c.call'):
        with tracing.span('c.step'):
            pass
    host = len(tracing.records()) - 1
    base = len(tracing._slots)
    tracing._slots.extend([
        [('open', 'c.step'), ('open', 'c.a')],
        [('close', 'c.a'), ('open', 'c.b')],
        [('close', 'c.b')],
        [('close', 'c.step')]])
    slots = [base, base + 1, base + 2, base + 3]
    tracing._slot_streams[base + 2] = 7  # c.b closes on another stream
    try:
        tracing.decode([100, 130, 170, 180] * 2, slots * 2,
                       [(slots, host, 1)] * 2, 5)
        recs = tracing.records()[host + 1:]
        assert [(r.name, r.clock, r.start, r.end, r.call) for r in recs] == [
            ('c.step', 'device', 105, 185, 1), ('c.a', 'device', 105, 135, 1),
            ('c.b', 'device', 135, 175, 1)] * 2
        step = host + 1
        assert [r.parent for r in recs[:3]] == [host, step, step]
        dev = tracing.totals()['device']
        assert dev['c.step'] == dict(count=2, total_ns=160, self_ns=20)
        tracing.decode([100, 170, 130, 180], [slots[i] for i in (0, 2, 1, 3)],
                       [(slots, host, 1)], 5)
        assert [(r.name, r.start, r.end) for r in tracing.records()[-3:]] \
            == [('c.step', 105, 185), ('c.a', 105, 135), ('c.b', 135, 175)]
        with pytest.raises(RuntimeError, match='where a replay writes'):
            tracing.decode([1, 2, 3, 4], slots[::-1], [(slots, host, 1)], 0)
        with pytest.raises(RuntimeError, match='where a replay writes'):
            tracing.decode([1, 2, 3, 4], [slots[0]] * 4, [(slots, host, 1)],
                           0)
    finally:
        del tracing._slots[base:]
        del tracing._slot_streams[base + 2]


def test_a_call_takes_one_offset_at_its_start(monkeypatch):
    """A call measures each device ring's offset once, as it opens (a call
    nested in it measures nothing), and reads each ring once, as it
    closes, with that offset."""
    seen = []

    class Ring:
        count = 0
        clock = None

        def calibrate(self):
            seen.append('calibrate')
            return tracing.Clock(offset=len(seen), error=0)

        def read(self):
            seen.append(('read', self.clock))

    ring = Ring()
    monkeypatch.setitem(tracing._rings, 'card', ring)
    tracing.enable(True)
    with tracing.call('c.call'):
        with tracing.call('c.inner'):
            pass
        assert seen == ['calibrate']
    assert seen == ['calibrate', ('read', tracing.Clock(1, 0))]


class _FakeLibrary:
    """The stamp library as a capture sees it: each launch (a stamp or the
    step's own work) becomes the capture's one tail node."""

    def __init__(self):
        self.nodes = 0
        self.stamped = []

    def work(self):
        self.nodes += 1

    def span_stamp(self, ring, capacity, slot, stream):
        self.nodes += 1
        self.stamped.append(slot)
        return 0

    def span_capture_tail(self, stream, node, count):
        node._obj.value = self.nodes
        count._obj.value = 1 if self.nodes else 0
        return 0


def test_capture_stamps_each_part_edge_once(monkeypatch):
    """Edges with nothing launched between them share a stamp: a step of
    three parts, work between its third part and its end, has 5 stamps
    (begin and the first open; each close and the next open; the last
    close; the end); with tracing off the capture stamps nothing."""
    lib = _FakeLibrary()
    dev = torch.device('cuda', 0)
    monkeypatch.setattr(tracing, '_library', lambda: lib)
    monkeypatch.setattr(tracing, '_stream', lambda device: None)
    monkeypatch.setitem(tracing._rings, dev, SimpleNamespace(
        buf=SimpleNamespace(data_ptr=lambda: 0)))
    base = len(tracing._slots)

    def step():
        for name in ('c.a', 'c.b', 'c.c'):
            with tracing.span(name):
                lib.work()
        lib.work()
    try:
        with tracing.stamps('c.step', dev) as off:
            step()
        assert off.slots == () and lib.stamped == []
        tracing.enable(True)
        with tracing.stamps('c.step', dev) as on:
            step()
        assert lib.stamped == list(on.slots) == [base + i for i in range(5)]
        assert [tracing._slots[s] for s in on.slots] == [
            [('open', 'c.step'), ('open', 'c.a')],
            [('close', 'c.a'), ('open', 'c.b')],
            [('close', 'c.b'), ('open', 'c.c')],
            [('close', 'c.c')],
            [('close', 'c.step')]]
        assert tracing.records() == []
    finally:
        del tracing._slots[base:]


# ------------------------------------------------------ physics passes
def _ant_parts(device='cpu'):
    """GrBAL on the crippled Ant (RK4) at a tiny size."""
    env = port_envs.normalize(port_envs.AntEnv(
        task='cripple', reset_every_episode=True, device=device))
    model = MetaMLPDynamicsModel('d', env, hidden_sizes=(16,),
                                 meta_batch_size=2, batch_size=4,
                                 inner_learning_rate=0.01, seed=0,
                                 device=device)
    policy = MPCController('p', env, model, n_candidates=8, horizon=2)
    return env, model, policy


@pytest.mark.parametrize('which,passes', [('ant', 4), ('cheetah', 1)])
def test_physics_qacc_span_and_passes_a_step(which, passes,
                                             compiled_on_cpu):
    """Each dynamics pass is a 'physics.qacc' span inside the step's
    'rollout.env_step' and counts one 'physics.passes': 4 an env step on
    the RK4 Ant, 1 on the Euler HalfCheetah (frame_skip 1 on both), with
    tracing on and off alike."""
    env, model, policy = (_ant_parts() if which == 'ant'
                          else _parts('grbal')[:3])
    assert env.frame_skip == 1
    sampler = Sampler(env, policy, 2, 10, device='cpu', seed=2,
                      adapt_batch_size=4)
    before = tracing.counters().get('physics.passes', 0)
    sampler.obtain_samples(random=False)
    off = tracing.counters()['physics.passes'] - before
    assert off == passes * 10 and tracing.records() == []
    tracing.enable(True)
    sampler.obtain_samples(random=False)
    assert tracing.counters()['physics.passes'] - before == 2 * off
    recs = tracing.records()
    qacc = [r for r in recs if r.name == 'physics.qacc']
    assert len(qacc) == passes * 10
    assert {recs[r.parent].name for r in qacc} == {'rollout.env_step'}


def _aten_ops(fn):
    """The operators fn() runs, in order, but the profiler's range markers
    (a span's record_function), which run on the host alone."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not str(func).startswith('profiler.'):
                seen.append(str(func))
            return func(*args, **(kwargs or {}))
    with Log():
        fn()
    return seen


def test_physics_span_adds_no_operator(monkeypatch):
    """An Ant env step runs the same operators with the engine's span as
    with a bare context in its place, with tracing off and on: the span
    launches nothing, so a step captured with tracing off is the graph it
    was before the span."""
    from contextlib import nullcontext
    from learning_to_adapt_torch.physics import engine
    env, _, _ = _ant_parts()
    gen = torch.Generator()
    gen.manual_seed(3)
    state = env.reset(2, 1, gen)
    act = torch.rand((2, env.act_dim), generator=gen) * 2 - 1

    def step():
        return env.step(state, act)
    off = _aten_ops(step)
    tracing.enable(True)
    on = _aten_ops(step)
    tracing.enable(False)
    monkeypatch.setattr(engine, 'tracing', SimpleNamespace(
        span=lambda name: nullcontext(), count=tracing.count))
    bare = _aten_ops(step)
    assert off == on == bare and len(bare) > 100


# ------------------------------------------------------------- exporter
def test_record_iteration_writes_the_totals(tmp_path):
    port_log.configure(dir=str(tmp_path), format_strs=[])
    model = SimpleNamespace(_epoch_cache={}, device=torch.device('cpu'))
    sampler = SimpleNamespace(graph_counts=lambda: {})
    trainer = Trainer(None, sampler, None, None, model, n_itr=1)
    trainer.record_iteration(0)
    tracing.enable(True)
    with tracing.span('fit.call'):
        pass
    tracing.count('graph.captures')
    captures = tracing.counters()['graph.captures']
    trainer.record_iteration(1)
    trainer.record_iteration(2)
    with open(os.path.join(str(tmp_path), 'iterations.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    assert 'spans' not in rows[0] and 'counters' not in rows[0]
    assert rows[1]['spans']['host']['fit.call']['count'] == 1
    assert rows[2]['spans'] == {}
    assert [r['counters']['graph.captures'] for r in rows[1:]] == [
        captures, captures]
    assert rows[1]['kernels'] == captured.kernel_counts()
    assert tracing.records() == []


# ------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda', 0)


@pytest.mark.cuda
def test_captured_step_stamps_come_back_once_a_replay():
    """A step of two parts captured with tracing on (3 stamps: the begin
    and the first open; the first close and the second open; the last
    close and the end): every replay of a call gives its device step and
    parts, in order, under the host span of the replay; the graph captured
    with tracing off stamps nothing. On the host clock each step falls
    within 10 us of the host's readings just before its replay and just
    after waiting for it."""
    dev = _card()
    x = torch.randn(256, 256, device=dev)

    def step():
        with tracing.span('c.a'):
            y = x @ x
        with tracing.span('c.b'):
            x.copy_(torch.tanh(y))
    off = captured.StepGraph(step, dev, name='c.step')
    off.capture(lambda: None)
    assert off.stamps == ()
    tracing.enable(True)
    on = captured.StepGraph(step, dev, name='c.step')
    on.capture(lambda: None)
    assert [tracing._slots[s] for s in on.stamps] == [
        [('open', 'c.step'), ('open', 'c.a')],
        [('close', 'c.a'), ('open', 'c.b')],
        [('close', 'c.b'), ('close', 'c.step')]]
    with tracing.call('c.call'):
        for _ in range(5):
            with tracing.span('c.replay'):
                on()
        off()
    recs = tracing.records()
    replays = [i for i, r in enumerate(recs) if r.name == 'c.replay']
    steps = [r for r in recs if r.name == 'c.step']
    assert len(steps) == 5 and [r.parent for r in steps] == replays
    parts = [r for r in recs if r.clock == 'device' and r.name != 'c.step']
    assert [r.name for r in parts] == ['c.a', 'c.b'] * 5
    prev = 0
    for s, (a, b) in zip(steps, zip(parts[::2], parts[1::2])):
        assert prev <= s.start <= a.start <= a.end <= b.start <= b.end \
            <= s.end
        assert s.call == a.call == recs[replays[0]].call
        prev = s.end
    tracing.reset()
    bracket = []
    with tracing.call('c.call'):
        for _ in range(50):
            torch.cuda.synchronize(dev)
            before = tracing.now()
            on()
            torch.cuda.synchronize(dev)
            bracket.append((before, tracing.now()))
    steps = [r for r in tracing.records() if r.name == 'c.step']
    outside = [max(lo - s.start, s.end - hi, 0)
               for s, (lo, hi) in zip(steps, bracket)]
    print(f'stamped steps against the host readings around them on '
          f'{torch.cuda.get_device_name(dev)}: worst {max(outside)} ns '
          'outside; replay to step start ns, median '
          f'{sorted(s.start - lo for s, (lo, _) in zip(steps, bracket))[25]}')
    assert len(steps) == 50 and max(outside) <= 10_000


@pytest.mark.cuda
def test_stamps_match_the_trace_kernels():
    """One MB-MPC sampling call at its run script's widths, profiled with
    tracing on: each replay's stamps are the 9 stamp kernels the trace
    holds for it, in their order (the step's parts, the physics' dynamics
    pass inside its env step and the smooth-dynamics launches of the pass
    and of the forward pass). The trace's device times run on a scale
    of their own against the host's clock (PERF.md §6), so each stamp is
    held within 10 us of its kernel once that scale is taken out: the line
    through the first and the last stamp kernel's middles. The replays'
    host spans start within 1 ms of the profiler's ranges of them (the
    same clock: another would be seconds off). Prints the distances with
    the scale left in, and the offset."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from learning_to_adapt_torch import run_mb_mpc
    dev = _card()
    cfg = run_mb_mpc.config
    env = port_envs.normalize(cfg['env'](reset_every_episode=True,
                                         task='cripple', device=dev))
    model, policy = run_mb_mpc.ENTRY.build(cfg, env, dev)
    sampler = Sampler(env, policy, cfg['num_rollouts'],
                      cfg['max_path_length'], device=dev, seed=3)
    tracing.enable(True)
    sampler.obtain_samples()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sampler.obtain_samples()
        torch.cuda.synchronize(dev)
    clock = tracing._rings[tracing._device(dev)].clock
    launches, stamps, ranges = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if 'span_stamp_kernel' in e.name():
                stamps.setdefault(e.correlation_id(), []).append(
                    (e.start_ns(), e.end_ns()))
        elif e.name().startswith('cudaGraphLaunch'):
            launches[e.correlation_id()] = e.start_ns()
        elif e.name() == 'rollout.step':
            ranges.append(e.start_ns())
    order = sorted(launches, key=launches.get)
    recs = tracing.records()
    steps = [i for i, r in enumerate(recs)
             if r.clock == 'device' and r.name == 'rollout.step']
    assert len(order) == len(steps) == cfg['max_path_length']
    pairs = []          # (stamp on the host clock, its kernel in the trace)
    for corr, i in zip(order, steps):
        inside = {i}    # the step and every device record nested in it
        for j in range(i + 1, len(recs)):
            if recs[j].clock == 'device' and recs[j].parent in inside:
                inside.add(j)
        edges = sorted({t for j in inside for t in (recs[j].start,
                                                    recs[j].end)})
        kernels = sorted(stamps[corr])
        assert len(edges) == len(kernels) == 9
        assert all(a[1] <= b[0] for a, b in zip(kernels, kernels[1:]))
        pairs += zip(edges, kernels)
    (t0, (lo0, hi0)), (t1, (lo1, hi1)) = pairs[0], pairs[-1]
    m0, m1 = (lo0 + hi0) / 2, (lo1 + hi1) / 2
    scale = (m1 - m0) / (t1 - t0)

    def outside(t, lo, hi):
        return max(lo - t, t - hi, 0)
    raw = [outside(t, lo, hi) for t, (lo, hi) in pairs]
    fitted = [outside(m0 + (t - t0) * scale, lo, hi)
              for t, (lo, hi) in pairs]
    mine = sorted(r.start for r in recs
                  if r.name == 'rollout.step' and r.clock == 'host')
    assert len(mine) == len(ranges)
    host_worst = max(abs(a - b) for a, b in zip(mine, sorted(ranges)))
    quarters = [round(fitted[k * (len(pairs) - 1) // 4]) for k in range(5)]
    print(f'span clock check on {torch.cuda.get_device_name(dev)}: offset '
          f'{clock.offset} ns (+- {clock.error}) at the call\'s start; over '
          f'{len(steps)} steps the trace spans the stamps {scale:.7f} times '
          f'as long; worst stamp outside its trace kernel {max(raw)} ns with '
          f'that scale, {max(fitted):.0f} ns without it (at the call\'s '
          f'quarters {quarters} ns); worst host span start {host_worst} ns '
          'from the profiler range')
    assert max(fitted) <= 10_000 and host_worst <= 1_000_000


@pytest.mark.cuda
def test_captured_physics_passes_and_stamps(monkeypatch):
    """A GrBAL sampling call on the Ant captured on the card (2 envs, 10
    steps: 6 before the adaptation gate, 4 after): with tracing off each
    of its two step graphs launches the kernels, in order, that it
    launches with the engine's span taken out (the graphs of the code
    before the span); each replay counts 4 'physics.passes'; with tracing
    on each step holds 4 'physics.qacc' device records inside its
    'rollout.env_step', each with a 'physics.smooth' inside, and a fifth
    'physics.smooth' for the step's forward pass; each graph holds 14
    stamps more than without the engine's spans: a pass's open (its
    smooth span opens on the same stamp), its smooth span's close and its
    close, and the forward's open and close. A graph's kernels are read as
    the list most of its replays show: the profiler has been seen to drop
    activities of a call's last replay (port_bench/lib/trace.py). A
    profiler session is opened and closed before either side is captured:
    graphs captured before a process's first session have been seen to run
    a device-to-device copy as CUDA's copy kernel 'memcpy32_post', and
    graphs captured after it on the copy engine ('Memcpy DtoD'), with the
    engine's spans and without alike."""
    from collections import Counter
    from contextlib import nullcontext
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from learning_to_adapt_torch.physics import engine
    dev = _card()
    steps, gate = 10, 6

    def kernels(patched):
        """The device activities of each graph (the list most of its
        replays in a profiled call launch), the passes the call counted,
        the sampler."""
        with monkeypatch.context() as m:
            if patched:
                m.setattr(engine, 'tracing', SimpleNamespace(
                    span=lambda name: nullcontext(), count=tracing.count))
            env, _, policy = _ant_parts(dev)
            sampler = Sampler(env, policy, 2, steps, device=dev, seed=4,
                              adapt_batch_size=4)
            sampler.obtain_samples(random=False)    # captures
            tracing.reset()
            torch.cuda.synchronize(dev)
            before = tracing.counters().get('physics.passes', 0)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sampler.obtain_samples(random=False)
                torch.cuda.synchronize(dev)
            passes = tracing.counters().get('physics.passes', 0) - before
        launches, device = {}, {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                device.setdefault(e.correlation_id(), []).append(
                    (e.start_ns(), e.name()))
            elif e.name().startswith('cudaGraphLaunch'):
                launches[e.correlation_id()] = e.start_ns()
        replays = [tuple(n for _, n in sorted(device.get(c, [])))
                   for c in sorted(launches, key=launches.get)]
        assert len(replays) == steps
        graphs = [Counter(part).most_common(1)[0]
                  for part in (replays[:gate], replays[gate:])]
        return graphs, passes, sampler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    off, passes, _ = kernels(False)
    bare, _, _ = kernels(True)
    print(f'Ant GrBAL graphs: {[len(k) for k, _ in off]} device activities '
          f'a replay, the most common list in {[n for _, n in off]} of '
          f'{gate} and {steps - gate} replays; {passes} physics passes '
          'counted')
    assert [k for k, _ in off] == [k for k, _ in bare]
    assert passes == 4 * steps
    tracing.enable(True)
    stamps = {}
    for patched in (False, True):
        _, _, sampler = kernels(patched)
        if not patched:
            recs = tracing.records()
        stamps[patched] = {k: len(g.stamps) for k, g in
                           sampler._rollout_fn(False).graphs.items()}
    print(f'stamps a step by graph: {stamps[False]}; without the engine\'s '
          f'span {stamps[True]}')
    step_recs = [i for i, r in enumerate(recs)
                 if r.clock == 'device' and r.name == 'rollout.step']
    qacc = [r for r in recs if r.clock == 'device' and
            r.name == 'physics.qacc']
    assert len(stamps[False]) == 2 and {
        k: n - stamps[True][k] for k, n in stamps[False].items()} == {
        k: 14 for k in stamps[False]}
    assert len(step_recs) == steps and len(qacc) == 4 * steps
    assert {recs[r.parent].name for r in qacc} == {'rollout.env_step'}
    smooth = [recs[r.parent].name for r in recs
              if r.clock == 'device' and r.name == 'physics.smooth']
    assert sorted(set(smooth)) == ['physics.qacc', 'rollout.env_step']
    assert smooth.count('physics.qacc') == 4 * steps
    assert smooth.count('rollout.env_step') == steps
