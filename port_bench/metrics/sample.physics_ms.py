"""Device ms a rollout step spends in the env's step: the stamped
'rollout.env_step' span of the captured sampling step (the physics, its
Jacobi kernel, rewards and observations), over the stamped steps of the
spans' sampling calls (lib/spans.py)."""
from port_bench.lib import spans


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None:
        return None
    return spans.device_ms_per_step(snap, 'rollout.env_step',
                                    'rollout.step')
