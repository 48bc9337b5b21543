"""Driver 'sample_ant': driver 'sample''s whole policy calls of
`Sampler.obtain_samples` (random=False) on a configuration of the Ant,
judged by the Ant's reference (reference/ant.py) in place of the
Cheetah's.

setup, window, release and the calls are drivers/sample.py's, unchanged.
lib/spans.py records a traced run's spans on its sampling path for the
driver named 'sample' alone (any other driver takes its fit path), so a
traced run's readings record this cell's spans themselves, on that same
sampling path (`spans._sample_calls` with driver 'sample', whose set-up
and calls this driver's are), once the window's state is released and
before the first per-layer reader asks for them."""
from port_bench.drivers.sample import release, setup, window
from port_bench.lib import cell as cells, spans
from port_bench.reference import ant

__all__ = ['setup', 'window', 'release', 'readings']


def readings(ctx, state, mode='program'):
    numbers = ant.readings(ctx.config, ctx.hp, state['calls'],
                           state['weights'], state['stats'], ctx.traffic,
                           ctx.seed, ctx.device, mode)
    if ctx.trace and mode == 'program':
        _record_spans(ctx)
    return numbers


def _record_spans(ctx):
    """The run's spans snapshot (lib/spans.py `snapshot`), recorded on the
    sampling path; nothing where the program has no tracing."""
    key = (ctx.name, ctx.seed)
    tracing = spans._tracing()
    if tracing is None or key in spans._snapshots:
        return
    counters = tracing.counters()
    try:
        records = spans._sample_calls(ctx, cells.driver('sample'),
                                      tracing)
    finally:
        tracing.enable(False)
    spans._snapshots[key] = dict(counters=counters, records=records)
