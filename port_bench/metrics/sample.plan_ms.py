"""Device ms a rollout step spends in the planner: the stamped
'rollout.plan' span of the captured sampling step (the candidates' draw,
the MPC rollouts through the fused MLP, the choice), over the stamped
steps of the spans' sampling calls (lib/spans.py)."""
from port_bench.lib import spans


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None:
        return None
    return spans.device_ms_per_step(snap, 'rollout.plan', 'rollout.step')
