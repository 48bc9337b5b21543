"""The recurrent op's share of its roofline in the traced fit call: the
least time its work could take (f32 operations over the f32 peak or
bytes over HBM's, the larger, for each call: roofline/rnn_counts.py)
over the device time of cuDNN's recurrent kernels, forward and backward.

The work: each train step's TBPTT chunks (batch_size rows, backprop_steps
steps) forward and backward, and each epoch's validation forward over
the staged test capacity (window.work['valid_rows'] rows, the path
length). The kernels, as a trace of the fit on an H100 80GB HBM3 names
them (PyTorch 2.11.0 with CUDA 12.8 and cuDNN 92200, f32 without TF32): the
cell kernels and the products cuDNN launches for the recurrence, its
input projections and its weight gradients. Three of the product
kernels' names are also those of some of the output layer's products,
which are counted with them (under 1 % of their time). Where the trace
holds another number of cell kernels than the work's time steps (cuDNN
chose another algorithm, or the op left the path), it reads None."""
from port_bench.roofline import peaks, rnn_counts

CELL = 'elemWiseRNNcell'
KERNELS = (CELL, 'LSTM_elementWise_bp1', 'GENERIC_elementWise_bp2',
           'gemmSN_TN_kernel', 'cutlass_80_simt_sgemm_64x64_8x5_nn_align1',
           'cutlass_80_simt_sgemm_64x64_8x5_nt_align1',
           'splitKreduce_kernel',
           'xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8',
           'xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8',
           'xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8')


def read(ctx, window, out):
    if window is None or 'valid_rows' not in window.work:
        return None
    hp, tr = ctx.hp, ctx.traffic
    t_len = tr['path_length']
    bp = ctx.config['run_config']['backprop_steps']
    chunks = window.work['train_steps'] * max(t_len // bp, 1)
    valid = tr['epochs_per_call']
    if window.count(CELL) != chunks * bp + valid * t_len:
        return None
    inp, (hidden,) = hp.obs_dim + hp.act_dim, hp.hidden
    shapes = [(rnn_counts.lstm_forward, chunks, hp.batch_size, bp),
              (rnn_counts.lstm_backward, chunks, hp.batch_size, bp),
              (rnn_counts.lstm_forward, valid, window.work['valid_rows'],
               t_len)]
    bound = sum(n * peaks.bound_s(*fn(rows, steps, inp, hidden), 'f32')[0]
                for fn, n, rows, steps in shapes)
    seconds = sum(e - s for name, s, e in window.device
                  if any(k in name for k in KERNELS)) / 1e9
    return 100.0 * bound / seconds
