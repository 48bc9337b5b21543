"""The Jacobi tier kernel's share of its roofline in the traced sampling
call: the least time its launches could take (f32 operations over the f32
peak or bytes over HBM's; roofline/) over their device time. One launch
solves every env's contact system of one physics step."""
from port_bench.roofline import counts, peaks


def read(ctx, window, out):
    if window is None or 'steps' not in window.work:
        return None
    phys = ctx.config['physics']
    seen = window.launches.get('jacobi_solve', 0)
    if seen == 0:
        return None
    expected = window.work['steps'] * phys['solves_per_step']
    if seen != expected:
        raise ValueError(f'jacobi.roofline: {seen} launches in the traced '
                         f'call, its steps give {expected}')
    one = peaks.bound_s(*counts.jacobi_launch(
        ctx.hp.envs, phys['constraint_rows'], phys['jacobi_sweeps']),
        'f32')[0]
    return 100.0 * seen * one / window.seconds('jacobi_kernel')
