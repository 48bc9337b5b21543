"""The readers of the program's spans (lib/spans.py and the metrics that
read it): each returns None where the run traced nothing or the program
has no tracing; the readings against hand counts on made-up records; and
the spans' calls driven on the CPU at a small size, where the steps run
eagerly and only the host spans have something to read."""
from types import SimpleNamespace

import pytest
import torch

from port_bench.lib import cell as cells, spans
from port_bench.lib.run import context
from test_port_bench_runs import SEED, small

NEW = ['sample.plan_ms', 'sample.physics_ms', 'sample.replay_idle_share',
       'sample.launch_ms', 'fit.loss_ms', 'fit.grad_ms', 'fit.optim_ms',
       'fit.prep_share', 'setup.capture_s']


@pytest.fixture(autouse=True)
def fresh_snapshots(monkeypatch):
    monkeypatch.setattr(spans, '_snapshots', {})


@pytest.mark.parametrize('name', NEW)
def test_reader_finds_nothing_without_spans(name, monkeypatch):
    reader = cells.metric_reader(name)
    ctx = SimpleNamespace(name='mb_mpc_fit', seed=1)
    assert reader.read(ctx, None, {}) is None
    monkeypatch.setattr(spans, '_tracing', lambda: None)
    assert reader.read(ctx, object(), {}) is None


def _snapshot():
    from learning_to_adapt_torch.utils.tracing import Span
    r = []

    def add(name, clock, start, end, parent=None, call=1):
        r.append(Span(name, clock, start, end, parent, call))
        return len(r) - 1
    # a sampling call of two steps, 1 ms apart, and a fit call
    c = add('rollout.call', 'host', 0, 10_000_000)
    for k, t0 in enumerate((1_000_000, 4_000_000)):
        h = add('rollout.step', 'host', t0, t0 + 500_000, c)
        s = add('rollout.step', 'device', t0 + 100_000, t0 + 2_100_000, h)
        add('rollout.plan', 'device', t0 + 100_000, t0 + 1_100_000, s)
        add('rollout.env_step', 'device', t0 + 1_100_000, t0 + 2_000_000, s)
    f = add('fit.call', 'host', 0, 1_000_000, call=2)
    add('fit.stage', 'host', 0, 100_000, f, 2)
    add('fit.draws', 'host', 200_000, 250_000, f, 2)
    add('fit.read', 'host', 600_000, 900_000, f, 2)
    h = add('fit.train_step', 'host', 300_000, 310_000, f, 2)
    s = add('fit.train_step', 'device', 320_000, 820_000, h, 2)
    for name, lo, hi in (('fit.loss', 320_000, 520_000),
                         ('fit.grad', 520_000, 700_000),
                         ('fit.optim', 700_000, 800_000)):
        add(name, 'device', lo, hi, s, 2)
    return dict(counters={'graph.capture_s': 1.5}, records=r)


def test_readings_by_hand(monkeypatch):
    snap = _snapshot()
    monkeypatch.setattr(spans, 'snapshot', lambda ctx: snap)
    got = {n: cells.metric_reader(n).read(None, object(), {}) for n in NEW}
    assert got == pytest.approx({
        'sample.plan_ms': 1.0, 'sample.physics_ms': 0.9,
        # steps 1.1-3.1 and 4.1-6.1 ms: 1 ms of a 5 ms window uncovered
        'sample.replay_idle_share': 20.0, 'sample.launch_ms': 0.5,
        'fit.loss_ms': 0.2, 'fit.grad_ms': 0.18, 'fit.optim_ms': 0.1,
        'fit.prep_share': 15.0, 'setup.capture_s': 1.5})


@pytest.mark.parametrize('name', ['mb_mpc_sample', 'mb_mpc_fit'])
def test_spans_calls_on_the_cpu(name):
    """The spans' calls of a small cell on the CPU: the host spans of every
    call are recorded (the eager steps have no stamps, so the device
    readings find nothing), and tracing is off again after."""
    from learning_to_adapt_torch.utils import tracing
    ctx = context(small(name), SEED, 0.2, True, 'cpu')
    snap = spans.snapshot(ctx)
    assert not tracing.enabled() and tracing.records() == []
    host = {r.name for r in snap['records'] if r.clock == 'host'}
    calls = {r.call for r in snap['records']}
    if name == 'mb_mpc_sample':
        assert {'rollout.call', 'rollout.plan', 'rollout.env_step'} <= host
        assert len(calls) == spans.SAMPLE_CALLS
        assert spans.device_ms_per_step(snap, 'rollout.plan',
                                        'rollout.step') is None
    else:
        assert {'fit.call', 'fit.stage', 'fit.read', 'fit.loss'} <= host
        assert len(calls) == spans.FIT_CALLS
        assert 0 < spans.share_of_calls(snap, ('fit.read', 'fit.draws'),
                                        'fit.call') < 100
    assert spans.snapshot(ctx) is snap
    assert torch.device(ctx.device).type == 'cpu'
