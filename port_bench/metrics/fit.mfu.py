"""A train step's model FLOPs (roofline/counts.py fit_step_flops) at the
f32 peak over the wall time a train step took in the traced run's
unprofiled fit calls."""
from port_bench.roofline import counts, peaks


def read(ctx, window, out):
    if window is None or 'train_steps' not in window.work:
        return None
    per_step = (out['wall_per_step'] or
                window.wall_s / window.work['train_steps'])
    return 100.0 * counts.fit_step_flops(ctx.hp) / peaks.FLOPS['f32'] / \
        per_step
