"""Seconds of set-up spent capturing the step graphs (warm-ups included):
the program's counter 'graph.capture_s' (models/captured.py StepGraph),
read before the spans' calls capture anything (lib/spans.py)."""
from port_bench.lib import spans


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None:
        return None
    return snap['counters'].get('graph.capture_s')
