"""The sampling step's model FLOPs at the card's peaks (the planner's
forwards at the bf16 peak, GrBAL's adaptation at the f32 peak;
roofline/counts.py) over the wall time a step took in the traced run's
unprofiled calls."""
from port_bench.roofline import counts


def read(ctx, window, out):
    if window is None or 'steps' not in window.work:
        return None
    per_step = out['wall_per_step'] or window.wall_s / window.work['steps']
    return 100.0 * counts.sampling_min_s(ctx.hp) / (per_step *
                                                    ctx.hp.t_len)
