"""Device ms a train step spends in the optimizer: ClipAdam's global-norm clip
and Adam update: the stamped 'fit.optim' span of the captured train step,
over the stamped train steps of the spans' fit calls (lib/spans.py)."""
from port_bench.lib import spans


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None:
        return None
    return spans.device_ms_per_step(snap, 'fit.optim', 'fit.train_step')
