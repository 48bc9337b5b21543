"""The program's spans and counters (learning_to_adapt_torch/utils/
tracing.py) in a traced run, for the per-layer metrics that read them.

The window and its profiled call run with tracing off, as every other run
does. Once they are over, the first reader that asks builds the cell again
from the run's seed with the cell's driver's own set-up and records calls
with tracing on: a sampling cell's set-up runs with tracing on (its warm
calls capture and replay the stamped step graphs, so the card is as warm
as in the window), then SAMPLE_CALLS calls are recorded; a fit cell's
set-up runs as in the run, then, from the snapshot of its set-up, one warm
call (which captures the stamped step graphs) and FIT_CALLS recorded
calls, on the data of the window's first calls, cycling as the window
does. Then tracing is off again and what was built is released. The
counters are read first: they hold the captures of the run's own set-up.
The snapshot is kept for the other readers of the run.

A program without tracing (one older than it) has nothing to read: every
reader then returns None and the run goes on as it did."""
import importlib

from port_bench.lib import cell as cells, program

SAMPLE_CALLS = 5
FIT_CALLS = 2

_snapshots = {}


def _tracing():
    try:
        return importlib.import_module(
            'learning_to_adapt_torch.utils.tracing')
    except ImportError:
        return None


def snapshot(ctx):
    """dict(counters, records) of the run's cell, or None where the program
    has no tracing."""
    key = (ctx.name, ctx.seed)
    if key not in _snapshots:
        _snapshots[key] = _record(ctx)
    return _snapshots[key]


def _record(ctx):
    tracing = _tracing()
    if tracing is None:
        return None
    counters = tracing.counters()
    drv = cells.driver(ctx.traffic['driver'])
    calls = _sample_calls if ctx.traffic['driver'] == 'sample' else \
        _fit_calls
    try:
        records = calls(ctx, drv, tracing)
    finally:
        tracing.enable(False)
    return dict(counters=counters, records=records)


def _sample_calls(ctx, drv, tracing):
    tracing.enable(True)
    state = drv.setup(ctx)
    try:
        tracing.reset()
        for k in range(SAMPLE_CALLS):
            drv._call(state, program.sub_seed(ctx.seed, 5, k), k + 1)
        return tracing.records()
    finally:
        tracing.enable(False)
        tracing.reset()
        drv.release(state)


def _fit_calls(ctx, drv, tracing):
    tr = ctx.traffic
    state = drv.setup(ctx)
    model = state['model']
    obs, act, nxt = state['data']
    try:
        tracing.enable(True)
        for k in range(1 + FIT_CALLS):
            if k == 1:
                tracing.reset()
            j = k % tr['calls_per_cycle']
            if j == 0:
                model.load_state_dict(state['snapshot'])
            lo = tr['first'] + j * tr['per_call']
            hi = lo + tr['per_call']
            model.fit(obs[lo:hi], act[lo:hi], nxt[lo:hi],
                      epochs=tr['epochs_per_call'],
                      rolling_average_persitency=1.0)
        return tracing.records()
    finally:
        tracing.enable(False)
        tracing.reset()
        drv.release(state)


# ------------------------------------------------------------- readings
def _device(snap, name):
    return [r for r in snap['records'] if r.clock == 'device' and
            r.name == name]


def _host(snap, name):
    return [r for r in snap['records'] if r.clock == 'host' and
            r.name == name]


def _ns(recs):
    return sum(r.end - r.start for r in recs)


def device_ms_per_step(snap, part, step):
    """Device ms a step (the device records of `step`) spent in `part`;
    None without stamped steps."""
    steps = _device(snap, step)
    if not steps:
        return None
    return _ns(_device(snap, part)) / len(steps) / 1e6


def host_ms_per_call(snap, name):
    recs = _host(snap, name)
    return _ns(recs) / len(recs) / 1e6 if recs else None


def replay_idle_share(snap, step):
    """Share (%) of the device windows of a call's steps (its first step's
    first stamp to its last step's last) that no step covers."""
    by_call = {}
    for r in _device(snap, step):
        by_call.setdefault(r.call, []).append(r)
    if not by_call:
        return None
    window = sum(max(r.end for r in rs) - min(r.start for r in rs)
                 for rs in by_call.values())
    return 100.0 * (1.0 - sum(_ns(rs) for rs in by_call.values()) / window)


def share_of_calls(snap, names, call):
    """Share (%) of the host time of the `call` spans spent in the host
    spans `names`."""
    total = _ns(_host(snap, call))
    if not total:
        return None
    return 100.0 * sum(_ns(_host(snap, n)) for n in names) / total
