"""Share of a fit call's wall time in its host phases before and after
the epochs (the normalizer's refit, the split, aggregation and staging,
the compiled epoch's preparation, the state copied out) and in each
epoch's index draws: host spans over 'fit.call' (lib/spans.py)."""
from port_bench.lib import spans

PHASES = ('fit.normalize', 'fit.stage', 'fit.prepare', 'fit.state_out',
          'fit.draws')


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None:
        return None
    return spans.share_of_calls(snap, PHASES, 'fit.call')
