"""The rebal_fit cell: its files load by name, its configuration is the
run script's, a small run on the CPU comes out correct while its control
and its fault do not, its counts hold against hand counts at the
published widths, and its metrics' readers read what they should from
made-up records and find nothing where a run traced nothing or the
program has no 'rnn.seq' span."""
import copy
from types import SimpleNamespace

import pytest
import torch

from port_bench.lib import cell as cells, spans
from port_bench.lib.hparams import hparams
from port_bench.lib.run import context, judge, run
from port_bench.roofline import peaks, rnn_counts
from test_port_bench_runs import SEED

NEW = ['rnn.seq_ms', 'lstm.roofline', 'rnn_fit.mfu']


def small():
    """rebal_fit at a size a CPU test holds (hidden 32, paths of 40 steps,
    TBPTT 10, batches of 4), with its real limits."""
    c = cells.load_cell('rebal_fit')
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg['run_config'].update(hidden_sizes=[32], backprop_steps=10,
                             batch_size=4, max_path_length=40)
    tr.update(first=20, path_length=40, per_call=5, calls_per_cycle=2,
              epochs_per_call=1)
    c.config, c.traffic = cfg, tr
    return c


@pytest.fixture(autouse=True)
def fresh_snapshots(monkeypatch):
    monkeypatch.setattr(spans, '_snapshots', {})


def test_cell_loads_by_name_with_its_files():
    c = cells.load_cell('rebal_fit')
    assert c.chips == 1 and c.traffic['config'] == c.config['name']
    assert c.traffic['driver'] == 'rebal_fit'
    drv = cells.driver('rebal_fit')
    assert all(callable(getattr(drv, k)) for k in
               ('setup', 'window', 'release', 'readings'))
    names = {m['name'] for m in c.per_layer}
    assert set(NEW) <= names and not {'fit.mfu', 'fit.optim_share'} & names
    for n in names:
        assert callable(cells.metric_reader(n).read)
    assert {m['name'] for m in c.end_to_end} == {'fit_step_ms', 'setup_s'}


def test_configuration_is_the_run_script():
    """run_config is run_rebal.py's config whole (the port's copy of it),
    with the cripple task and the inert hidden_nonlinearity key."""
    from learning_to_adapt_torch import run_rebal
    cfg = cells.load_cell('rebal_fit').config
    rc = dict(cfg['run_config'])
    assert rc.pop('task') == 'cripple' and rc.pop('env') == 'HalfCheetahEnv'
    assert rc.pop('hidden_nonlinearity') == 'tanh'
    script = {k: list(v) if isinstance(v, tuple) else v
              for k, v in run_rebal.config.items()
              if k not in ('env', 'task')}
    assert rc == script and cfg['reduced'] == []
    hp = hparams(cfg)
    assert (hp.hidden, hp.batch_size, hp.lr) == ([256], 10, 1e-2)


def test_small_run_is_correct():
    result = run(small(), SEED, 0.2, False, 'cpu', 0.0)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and result['device'] is None
    assert set(result['metrics']) == {'fit_step_ms', 'setup_s'}


@pytest.mark.parametrize('mode', ['control', 'half'])
def test_control_and_fault_are_not_correct(mode):
    c = small()
    drv = cells.driver('rebal_fit')
    ctx = context(c, SEED, 0.2, False, 'cpu')
    state = drv.setup(ctx)
    drv.release(state)
    correct, checks = judge(drv.readings(ctx, state, mode),
                            c.traffic['limits'])
    assert not correct, checks


def test_counts_by_hand_at_the_published_widths():
    hp = hparams(cells.load_cell('rebal_fit').config)
    inp, (h,), d = hp.obs_dim + hp.act_dim, hp.hidden, hp.obs_dim
    assert rnn_counts.lstm_row_step(inp, h) == 2 * 1024 * 282 == 577_536
    assert rnn_counts.rnn_row_step(inp, h, d) == 587_776
    step = rnn_counts.train_step_flops(hp.batch_size, 1000, inp, h, d)
    assert step == 3 * 10 * 1000 * 587_776
    assert round(step / peaks.FLOPS['f32'] / 18.23e-3 * 100, 2) == 1.44
    weights = 1024 * 282 + 2 * 1024
    assert rnn_counts.lstm_forward(10, 100, inp, h) == (
        1000 * 577_536, 4 * (weights + 1000 * (26 + 1024 + 512)))
    assert rnn_counts.lstm_backward(10, 100, inp, h) == (
        2000 * 577_536, 4 * (2 * weights + 1000 * (52 + 1024 + 512)))
    # a chunk's forward is bound by its operations
    assert peaks.bound_s(*rnn_counts.lstm_forward(10, 100, inp, h),
                         'f32')[1] == 'operations'


@pytest.mark.parametrize('name', NEW)
def test_reader_finds_nothing_without_a_trace(name, monkeypatch):
    reader = cells.metric_reader(name)
    ctx = SimpleNamespace(name='rebal_fit', seed=1)
    assert reader.read(ctx, None, {}) is None
    monkeypatch.setattr(spans, '_tracing', lambda: None)
    assert reader.read(ctx, SimpleNamespace(work={}), {}) is None


def _records(with_seq=True):
    from learning_to_adapt_torch.utils.tracing import Span
    r = []

    def add(name, clock, start, end, parent=None):
        r.append(Span(name, clock, start, end, parent, 1))
        return len(r) - 1
    f = add('fit.call', 'host', 0, 10_000_000)
    for t0 in (0, 3_000_000):
        h = add('fit.train_step', 'host', t0, t0 + 10_000, f)
        s = add('fit.train_step', 'device', t0, t0 + 2_000_000, h)
        loss = add('fit.loss', 'device', t0, t0 + 800_000, s)
        if with_seq:
            for k in range(2):
                lo = t0 + 100_000 + k * 300_000
                add('rnn.seq', 'device', lo, lo + 250_000, loss)
        add('fit.grad', 'device', t0 + 800_000, t0 + 1_900_000, s)
    h = add('fit.valid_step', 'host', 7_000_000, 7_010_000, f)
    v = add('fit.valid_step', 'device', 7_000_000, 8_000_000, h)
    if with_seq:
        add('rnn.seq', 'device', 7_100_000, 7_900_000, v)
    return dict(counters={}, records=r)


def test_rnn_seq_ms_by_hand(monkeypatch):
    """Two train steps of two 0.25-ms chunks each: 0.5 ms a step; the
    validation step's 0.8 ms is not a train step's. A program without
    the span (the parent of the cell) reads None."""
    reader = cells.metric_reader('rnn.seq_ms')
    snap = _records()
    monkeypatch.setattr(spans, 'snapshot', lambda ctx: snap)
    assert reader.read(None, object(), {}) == pytest.approx(0.5)
    snap = _records(with_seq=False)
    assert reader.read(None, object(), {}) is None


def _window(kernels, train_steps=2, valid_rows=64):
    from port_bench.lib.trace import Window
    win = Window.__new__(Window)
    win.device = kernels
    win.work = dict(train_steps=train_steps, valid_rows=valid_rows)
    win.wall_s = 1.0
    return win


def test_lstm_roofline_by_hand():
    """Two train steps (10 chunks each) and one validation forward of 64
    x 1000 at the published widths: the bound of their calls over the
    named kernels' time; another number of cell kernels reads None."""
    c = cells.load_cell('rebal_fit')
    c.traffic['epochs_per_call'] = 1
    ctx = SimpleNamespace(hp=hparams(c.config), traffic=c.traffic,
                          config=c.config)
    cell = [('void elemWiseRNNcell<float>', 0, 1000)] * (2 * 1000 + 1000)
    other = [('void LSTM_elementWise_bp1<float>', 0, 2000),
             ('void at::native::elementwise_kernel', 0, 10 ** 9)]
    win = _window(cell + other)
    reader = cells.metric_reader('lstm.roofline')
    fwd = rnn_counts.lstm_forward(10, 100, 26, 256)[0] / peaks.FLOPS['f32']
    valid = peaks.bound_s(*rnn_counts.lstm_forward(64, 1000, 26, 256),
                          'f32')[0]
    want = 100 * (20 * 3 * fwd + valid) / (3000e-6 + 2e-6)
    assert reader.read(ctx, win, {}) == pytest.approx(want)
    assert reader.read(ctx, _window(cell[1:] + other), {}) is None


def test_rnn_fit_mfu_by_hand():
    c = cells.load_cell('rebal_fit')
    ctx = SimpleNamespace(hp=hparams(c.config), traffic=c.traffic)
    reader = cells.metric_reader('rnn_fit.mfu')
    got = reader.read(ctx, _window([]), {'wall_per_step': 0.02})
    assert got == pytest.approx(100 * 17_633_280_000 / 67e12 / 0.02)


def test_spans_calls_on_the_cpu():
    """The spans' calls of the small cell on the CPU record an 'rnn.seq'
    host span a chunk of each train step and one a validation step; the
    eager steps have no stamps, so rnn.seq_ms finds nothing."""
    ctx = context(small(), SEED, 0.2, True, 'cpu')
    snap = spans.snapshot(ctx)
    host = [r for r in snap['records'] if r.clock == 'host']
    count = {n: sum(r.name == n for r in host)
             for n in ('rnn.seq', 'fit.train_step', 'fit.valid_step')}
    assert count['rnn.seq'] == (4 * count['fit.train_step'] +
                                count['fit.valid_step']) > 0
    assert cells.metric_reader('rnn.seq_ms').read(ctx, object(), {}) is None
    assert torch.device(ctx.device).type == 'cpu'
