"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its
700 W power limit)."""

FLOPS = {'bf16': 989e12, 'fp16': 989e12, 'tf32': 495e12, 'f32': 67e12,
         'fp8': 1979e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops, n_bytes, precision):
    """(least seconds, 'operations' or 'bytes'): the larger of the
    operations over the precision's peak and the bytes over HBM's."""
    t_ops = flops / FLOPS[precision]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')
