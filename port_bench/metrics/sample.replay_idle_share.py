"""Share of the replay loop's device window that no step covers, with no
profiler on: per sampling call, the first stamped step's first stamp to
the last one's last, less the stamped steps (lib/spans.py)."""
from port_bench.lib import spans


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None:
        return None
    return spans.replay_idle_share(snap, 'rollout.step')
