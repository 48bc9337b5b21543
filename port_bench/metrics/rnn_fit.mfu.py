"""A recurrent train step's model FLOPs (roofline/rnn_counts.py: forward
and backward of the LSTM's gates and the output layer over batch_size
paths of the whole path length) at the f32 peak over the wall time a
train step took in the traced run's unprofiled fit calls."""
from port_bench.roofline import peaks, rnn_counts


def read(ctx, window, out):
    if window is None or 'train_steps' not in window.work:
        return None
    hp = ctx.hp
    per_step = (out['wall_per_step'] or
                window.wall_s / window.work['train_steps'])
    (hidden,) = hp.hidden
    flops = rnn_counts.train_step_flops(
        hp.batch_size, ctx.traffic['path_length'], hp.obs_dim + hp.act_dim,
        hidden, hp.obs_dim)
    return 100.0 * flops / peaks.FLOPS['f32'] / per_step
