"""Host ms a rollout step spends in its replay: the host span
'rollout.step' around each step graph's replay (lib/spans.py)."""
from port_bench.lib import spans


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None:
        return None
    return spans.host_ms_per_call(snap, 'rollout.step')
