"""The fused-MLP kernel's share of its roofline in the traced sampling
call: the least time its launches could take (each the larger of its bf16
operations over the bf16 peak and its bytes over HBM's; roofline/) over
their device time. Its launches are checked against the call's shapes."""
from port_bench.roofline import counts, peaks


def read(ctx, window, out):
    if window is None or 'steps' not in window.work:
        return None
    dims = counts.mlp_dims(ctx.hp)
    launches = counts.sampling_launches(ctx.hp)
    expected = sum(c for c, _, _, _ in launches)
    seen = window.launches.get('fused_mlp', 0)
    if seen == 0:
        return None
    if seen != expected:
        raise ValueError(f'fused_mlp.roofline: {seen} launches in the '
                         f'traced call, its shapes give {expected}')
    bound = sum(c * peaks.bound_s(*counts.fused_mlp_launch(g, r, dims, w),
                                  'bf16')[0] for c, g, r, w in launches)
    return 100.0 * bound / window.seconds('fused_mlp_kernel')
