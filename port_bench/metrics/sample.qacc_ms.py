"""Device ms a rollout step spends in the physics' dynamics passes: the
stamped 'physics.qacc' spans inside 'rollout.env_step' (physics/engine.py
`_qacc`: smooth dynamics, the constraint solve with its Jacobi launch, the
Cholesky solve; one a physics step with Euler, four with RK4), over the
stamped steps of the spans' sampling calls (lib/spans.py). None where the
program stamps no such span."""
from port_bench.lib import spans


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None or not any(r.clock == 'device' and
                               r.name == 'physics.qacc'
                               for r in snap['records']):
        return None
    return spans.device_ms_per_step(snap, 'physics.qacc', 'rollout.step')
