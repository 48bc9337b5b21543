"""Recurrent dynamics model for ReBAL (models/rnn.py).

LSTM, GRU or plain RNN cells over [B, T, obs+act] inputs, predicting each
step's normalized delta through one linear output layer. Online adaptation
is the hidden state itself: `predict_fn` threads it.

The fit is truncated BPTT: each train step takes batch_size paths, drawn
with replacement, cuts them into backprop_steps-long chunks, carries the
hidden state from chunk to chunk with its gradient stopped, and averages
the chunks' losses and gradients before one clip + Adam step. As the
stopped gradient leaves the chunks' backward recurrences independent, each
chunk takes its own gradient as soon as its forward ends, on the card on a
CUDA stream of its own (`tbptt_chunks`), so that the backwards run beside
the forward recurrence, not after it; the chunks' gradients are summed in
chunk order (`chunk_grads`). Validation is the masked loss over the whole
padded test set.

Two routes compute the same cells. A fit's chunk, and any whole sequence,
runs through torch's recurrent layer ops (torch.lstm / gru / rnn_tanh, as
nn.LSTM / GRU / RNN call them; cuDNN on the card), which use the same gate
order: JAX's `b` is their input-side bias and their hidden-side bias is a
constant, 1.0 on the LSTM's forget gate (core.FORGET_BIAS) and 0
elsewhere, never trained. The planner's single steps use the cell
equations of models/core.py. Parameters keep the JAX package's tree
{'cells': [{'wi', 'wh', 'b'}, ...], 'out': {'w', 'b'}}.
All of it is f32 (TF32 off: device.resolve_device); no kernel of ours runs
here, as the JAX model runs outside both Pallas kernels.

The host RNG (numpy, seed + 1) is consumed as the JAX package consumes it:
one permutation of the paths per fit for the split and one draw that seeds
the device generator of the path indices.

The train step and the validation step are functions of a fit state that
they update in place (models/captured.py), which holds each layer's
weights in cuDNN's layout, one buffer a layer (`_layer_buffers`), mapped
from and to the JAX-layout tree when a fit starts and ends. The fit
(models/fitting.py) runs them on a compiled epoch per shape key
(`compiled_epoch`, cached in _epoch_cache as the JAX package caches its
jitted epoch), captured as CUDA graphs and replayed where captured.captures
holds, the epoch's path indices drawn eagerly into the step's index table.

Spans and counters (utils/tracing.py): each call of the recurrent layer
op is the span 'rnn.seq' (one a layer and TBPTT chunk in a train step,
nested in 'fit.loss'; one a layer over the whole test set in the
validation step), stamped on the device inside the captured steps as the
'fit.*' spans are, on the stream that runs it (a train step's on its
chunk's); with tracing off it is the record_function range it would be
and the captured graphs launch nothing more. The counter 'rnn.seq_steps'
adds the time steps of each such call where the host makes it: every call
of a step that is not captured, and on the card each capture's calls once
(its warm-ups count nothing), not the replays. The counter
'rnn.chunk_streams' adds, in the same way, the chunks a train step forks
onto streams of their own: n_chunks a capture on the card, 0 on the CPU.

With `model.mesh` set (parallel/mesh.py) the fit is data parallel: every
rank holds the whole host dataset (the sampler gathered it) and draws the
same path indices, but stages only its slice of the padded paths. A train
step makes two all_reduces: the first assembles the drawn paths on every
rank (each rank writes the paths it holds, zeros elsewhere); each rank then
takes the TBPTT loss and gradient of its share of the batch, batch_size / W
paths, scaled by that share; the second, of a flat buffer, sums the
gradients and the loss, so the clip's global norm and the Adam step come
out alike on every rank. One more all_reduce an epoch sums the validation
terms of the paths each rank holds. This agrees with the 1-rank fit up to
f32 reduction order. Without a mesh the same code runs with no collective.
"""
import numpy as np
import torch

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.models import captured, core
from learning_to_adapt_torch.models.fitting import FitMixin, _bucket_pow2
from learning_to_adapt_torch.models.optim import (
    state_from_jax_numpy, tree_leaves, tree_map, tree_unflatten)
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.utils import tracing

PATH_CHUNK = 64  # staged dataset capacity grows in path-count chunks


class RNNDynamicsModel(FitMixin):
    def __init__(self, name, env, hidden_sizes=(256,), cell_type='lstm',
                 learning_rate=0.001, batch_size=10, backprop_steps=50,
                 normalize_input=True, output_nonlinearity=None,
                 valid_split_ratio=0.2, rolling_average_persitency=0.99,
                 seed=0, dtype=torch.float32, device='cuda'):
        self.name = name
        self.device = resolve_device(device)
        self.obs_dim = env.obs_dim
        self.act_dim = env.act_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.cell_type = cell_type
        self.batch_size = batch_size
        self.backprop_steps = backprop_steps
        self.learning_rate = learning_rate
        self.normalize_input = normalize_input
        self.output_nonlinearity = output_nonlinearity
        self.valid_split_ratio = valid_split_ratio
        self.rolling_average_persitency = rolling_average_persitency
        self.dtype = dtype

        init_cell, self._cell_step, self._zero_state = core.CELLS[cell_type]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        in_dim = self.obs_dim + self.act_dim
        cells, self._hidden_bias = [], []
        for h in self.hidden_sizes:
            cells.append(init_cell(gen, in_dim, h, dtype, self.device))
            bias = torch.zeros(cells[-1]['b'].shape, dtype=dtype,
                               device=self.device)
            if cell_type == 'lstm':
                bias[h:2 * h] = core.FORGET_BIAS
            self._hidden_bias.append(bias)
            in_dim = h
        out = core.init_mlp(gen, in_dim, (), self.obs_dim, dtype, self.device)
        self.params = {'cells': cells, 'out': out}
        self._streams = []  # the TBPTT chunks' CUDA streams, made as needed
        self._init_fit(learning_rate, seed)

    # ------------------------------------------------------------- forward
    def get_initial_hidden(self, batch_size):
        """Zero hidden state, one entry per layer ((h, c) for the LSTM)."""
        return tuple(self._zero_state(batch_size, h, self.dtype, self.device)
                     for h in self.hidden_sizes)

    def _step_core(self, params, hidden, x):
        """One time step through the stacked cells. x: (B, in_dim)."""
        new_hidden = []
        for cell_p, h in zip(params['cells'], hidden):
            h2, x = self._cell_step(cell_p, h, x)
            new_hidden.append(h2)
        delta_n = core.mlp_forward(params['out'], x, None,
                                   self.output_nonlinearity)
        return tuple(new_hidden), delta_n

    def _torch_weights(self, i, cell):
        """Layer i's weights as torch's recurrent ops take them, [w_ih (kH,
        in), w_hh (kH, H), b_ih, b_hh], from a cell of the JAX-layout tree:
        fresh copies, which cuDNN compacts into one buffer at each call.
        The fit holds them in that buffer from the start
        (`_layer_buffers`)."""
        return [cell['wi'].T.contiguous(), cell['wh'].T.contiguous(),
                cell['b'], self._hidden_bias[i]]

    def _layer_seq(self, weights, x, h):
        """x (B, T, in) through one layer from hidden h, in torch's
        recurrent layer op (torch.lstm / gru / rnn_tanh: cuDNN on the
        card) with the layer's `weights` ([w_ih, w_hh, b_ih, b_hh]); the
        span 'rnn.seq', and T added to the counter 'rnn.seq_steps'."""
        tracing.count('rnn.seq_steps', x.shape[1])
        # cuDNN keeps what its backward needs only in training mode
        args = (weights, True, 1, 0.0, torch.is_grad_enabled(), False, True)
        with tracing.span('rnn.seq'):
            if self.cell_type == 'lstm':
                out, hn, cn = torch.lstm(x, (h[0][None], h[1][None]), *args)
                return out, (hn[0], cn[0])
            op = torch.gru if self.cell_type == 'gru' else torch.rnn_tanh
            out, hn = op(x, h[None], *args)
            return out, hn[0]

    def _seq(self, layers, out, norm, obs, act, hidden):
        """forward_seq over each layer's torch weights `layers` and the
        output layer's params `out`."""
        x = torch.cat([norm.norm_obs(obs), norm.norm_act(act)], dim=-1)
        new_hidden = []
        for weights, h in zip(layers, hidden):
            x, h2 = self._layer_seq(weights, x, h)
            new_hidden.append(h2)
        delta_n = core.mlp_forward(out, x, None, self.output_nonlinearity)
        return delta_n, tuple(new_hidden)

    def forward_seq(self, params, norm, obs, act, hidden):
        """obs/act: (B, T, d). Returns (normalized delta predictions (B, T,
        obs_dim), hidden after the last step)."""
        return self._seq([self._torch_weights(i, c)
                          for i, c in enumerate(params['cells'])],
                         params['out'], norm, obs, act, hidden)

    def predict_fn(self, params, norm, obs, act, hidden):
        """One step from hidden for rows obs/act (B, d), by the cell
        equations: returns (obs + denorm(delta), hidden')."""
        x = torch.cat([norm.norm_obs(obs), norm.norm_act(act)], dim=-1)
        hidden, delta_n = self._step_core(params, hidden, x)
        return obs + norm.denorm_delta(delta_n), hidden

    @torch.no_grad()
    def predict(self, obs, act, hidden):
        """Host API: (next observations as numpy, hidden')."""
        obs, act = (torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                    device=self.device) for a in (obs, act))
        out, hidden = self.predict_fn(self.params, self.normalizer, obs, act,
                                      hidden)
        return out.cpu().numpy(), hidden

    # ------------------------------------------------------------------ fit
    def stage(self, data):
        """Paths dict(obs, act, delta) of numpy [P, T, d] -> (paths (cap, T,
        obs+act+obs) f32, weights (cap,)) on the device, zero-padded to a
        multiple of PATH_CHUNK paths; with a mesh, this rank's slice of the
        capacity."""
        count, t_len = data['obs'].shape[:2]
        cap = int(np.ceil(count / PATH_CHUNK)) * PATH_CHUNK
        rows = np.zeros((cap, t_len, 2 * self.obs_dim + self.act_dim),
                        np.float32)
        rows[:count] = np.concatenate([data['obs'], data['act'],
                                       data['delta']], axis=-1)
        w = np.zeros((cap,), np.float32)
        w[:count] = 1.0
        return par_mesh.stage_fit_data(self, (rows, w))

    def _stage_fit(self):
        """(train paths, test (paths, weights), `_epoch` counts) of the
        aggregated paths, each staged at its PATH_CHUNK capacity; the real
        train path count and the epoch's steps."""
        p_tr = self._train['obs'].shape[0]
        train, _ = self.stage(self._train)
        return train, self.stage(self._test), (p_tr, _bucket_pow2(
            max(p_tr // self.batch_size, 1)))

    def _split(self, paths):
        return paths.split([self.obs_dim, self.act_dim, self.obs_dim],
                           dim=-1)

    def _chunk_streams(self, n_chunks):
        """A CUDA stream of its own for each of n_chunks TBPTT chunks, made
        once a model and kept, so that a capture's warm-ups set up each
        stream's library workspaces before the capture (cuBLAS keeps two
        of 32 MiB a stream on an H100, for the process). PyTorch hands out
        the streams of a priority in turn from a pool of 32; the
        default-priority pool also gives the captures' stream and each
        capture's warm-up stream, so after enough captures a chunk could
        get the step's own stream and run in turn with it. The chunks take
        the high-priority pool, which nothing else draws from; as the
        chunks' work and the step's own do not overlap, the priority itself
        sets no order. None for each chunk off CUDA or for a single chunk:
        nothing forks."""
        if self.device.type != 'cuda' or n_chunks == 1:
            return [None] * n_chunks
        while len(self._streams) < n_chunks:
            self._streams.append(torch.cuda.Stream(self.device, priority=-1))
        return self._streams[:n_chunks]

    def tbptt_chunks(self, layers, out, norm, obs, act, delta, leaves):
        """The TBPTT loss and each chunk's gradient, issued chunk by chunk:
        chunks of backprop_steps steps, max(T // backprop_steps, 1) of
        them, the hidden state carried across chunks with its gradient
        stopped. So chunk c's loss, its mean squared error, reaches the
        weights through its own forward alone, and its gradient
        (`autograd.grad` of `leaves`) is taken as soon as that forward ends.

        On a CUDA device each chunk runs on a stream of its own
        (`_chunk_streams`), forked from the current one: its forward once
        the previous chunk's is done (an event recorded before that
        chunk's gradient is issued: the hidden state it starts from), then
        its gradient. Autograd runs each backward op on its forward op's
        stream, so a chunk's backward recurrence runs beside the later
        chunks' forwards. cuDNN runs its recurrent kernels on streams of its
        handle, one handle a host thread, each joined to the caller's
        stream: the forwards (this thread's) follow one another, as the
        hidden state makes them, and so do the backwards (autograd's device
        thread's), the two chains side by side. Off CUDA, or with one
        chunk, nothing forks and the chunks run one after another. The
        counter 'rnn.chunk_streams' adds the chunks forked onto streams of
        their own (0 where nothing forks).

        Returns (the mean of the chunks' losses, ready on the current
        stream; the chunks' gradients in chunk order; their streams), for
        `chunk_grads`. layers, out: as `_seq` takes them."""
        bp = self.backprop_steps
        n_chunks = max(obs.shape[1] // bp, 1)
        streams = self._chunk_streams(n_chunks)
        forked = streams[0] is not None
        tracing.count('rnn.chunk_streams', n_chunks if forked else 0)
        current = torch.cuda.current_stream(obs.device) if forked else None
        hidden = ready = None
        losses, grads = [], []
        for c, stream in enumerate(streams):
            span = slice(c * bp, (c + 1) * bp)
            if forked:
                stream.wait_stream(current)
            with torch.cuda.stream(stream):
                if ready is not None:
                    stream.wait_event(ready)
                if hidden is None:
                    # made on chunk 0's stream, which allocates nothing
                    # more this step: chunk 0's backward reads it to its
                    # end, when its block may go back to its stream's pool
                    hidden = self.get_initial_hidden(obs.shape[0])
                pred, hidden = self._seq(layers, out, norm, obs[:, span],
                                         act[:, span], hidden)
                hidden = tree_map(torch.Tensor.detach, hidden)
                loss = torch.mean(torch.square(
                    pred - norm.norm_delta(delta[:, span])))
                ready = stream.record_event() if forked else None
                grads.append(torch.autograd.grad(loss, leaves))
            losses.append(loss.detach())
            # chunk c's graph goes before chunk c + 1's forward, so that each
            # forward makes the leaves' AccumulateGrad nodes on its own
            # stream: one kept from an earlier chunk would sync the chunks'
            # backwards through that chunk's stream
            del pred, loss
        if forked:
            # the last chunk's forward waited for every earlier one's
            current.wait_event(ready)
        return torch.stack(losses).mean(), grads, streams

    @staticmethod
    def chunk_grads(grads, streams, scale):
        """The gradient of the chunks' mean loss times scale, from
        `tbptt_chunks`' per-chunk gradients: the current stream joins every
        chunk stream, then the gradients are summed in chunk order, a fixed
        order, so that a captured step and the eager one agree bit for
        bit. The chunks' tensors are read here, on the current stream,
        only after the join, and no chunk stream allocates again before the
        next step forks it from there."""
        for stream in streams:
            if stream is not None:
                torch.cuda.current_stream(stream.device).wait_stream(stream)
        total = list(grads[0])
        for g in grads[1:]:
            total = torch._foreach_add(total, g)
        return torch._foreach_mul(total, scale / len(grads))

    def valid_terms(self, layers, out, norm, test):
        """(each test path's mean squared error weighted by its mask and
        summed, the mask's sum) over the padded test paths."""
        paths, w = test
        obs, act, delta = self._split(paths)
        pred, _ = self._seq(layers, out, norm, obs, act,
                            self.get_initial_hidden(paths.shape[0]))
        err = torch.mean(torch.square(pred - norm.norm_delta(delta)),
                         dim=(1, 2))
        return torch.sum(err * w), w.sum()

    # ------------------------------------------------ the fit's steps
    def _layer_buffers(self):
        """Each layer's weights in cuDNN's layout: one buffer of its own a
        layer, viewed as [w_ih (kH, in), w_hh (kH, H), b_ih, b_hh] in that
        order, so torch's recurrent op hands the buffer to cuDNN as it is
        (it compacts weights held anywhere else at every call). b_hh holds
        the constant hidden-side bias."""
        layers = []
        in_dim = self.obs_dim + self.act_dim
        for i, h in enumerate(self.hidden_sizes):
            kh = self._hidden_bias[i].shape[0]
            sizes = (kh * in_dim, kh * h, kh, kh)
            buf = torch.empty(sum(sizes), dtype=self.dtype,
                              device=self.device)
            w_ih, w_hh, b_ih, b_hh = buf.split(sizes)
            b_hh.copy_(self._hidden_bias[i])
            # detach: each trained view its own autograd leaf
            layers.append([w_ih.view(kh, in_dim).detach(),
                           w_hh.view(kh, h).detach(), b_ih.detach(), b_hh])
            in_dim = h
        return layers

    @staticmethod
    def _step_layout(tree):
        """A params-shaped tree's leaves in JAX's order, each cell's as the
        fit holds them: [b, wh.T, wi.T] (views)."""
        return [x for cell in tree['cells']
                for x in (cell['b'], cell['wh'].T, cell['wi'].T)
                ] + tree_leaves(tree['out'])

    def _from_step_layout(self, leaves):
        """The JAX-layout tree of leaves in `_step_layout` order (views)."""
        n = 3 * len(self.hidden_sizes)
        cells = [dict(wi=wi.T, wh=wh.T, b=b)
                 for b, wh, wi in zip(*[iter(leaves[:n])] * 3)]
        out = tree_unflatten(self.params['out'], leaves[n:])
        return {'cells': cells, 'out': out}

    def _fit_state(self, params, opt_state, norm, train, test, rows,
                   static=False):
        """The state the train and validation steps work on
        (captured.new_state): params copied into `_layer_buffers` and the
        output layer, Adam's state in the same layout, the normalizer and
        staged data (copies when static, else these tensors), an index
        table of `rows` steps' path indices, (rows, batch_size), and the
        loss sums (train, valid)."""
        layers = self._layer_buffers()
        out = tree_map(torch.empty_like, params['out'])
        leaves = [x for w_ih, w_hh, b_ih, _ in layers
                  for x in (b_ih, w_hh, w_ih)] + tree_leaves(out)
        with torch.no_grad():
            for dst, src in zip(leaves, self._step_layout(params)):
                dst.copy_(src)
        keep = (lambda x: x.clone()) if static else (lambda x: x)
        return captured.new_state(
            leaves, opt_state['count'], self._step_layout(opt_state['mu']),
            self._step_layout(opt_state['nu']), 2, layers=layers, out=out,
            norm=captured.clone_normalizer(norm) if static else norm,
            train=keep(train), test=tuple(map(keep, test)),
            path_idx=torch.zeros((rows, self.batch_size), dtype=torch.int64,
                                 device=train.device))

    def _epoch_key(self, train, test):
        """(shape key: the train and test capacities, the path length and
        the batch size; the index table's rows: the most steps any fit of
        this train capacity takes)."""
        key = (train.shape[0], test[0].shape[0], train.shape[1],
               self.batch_size)
        return key, _bucket_pow2(max(
            train.shape[0] * self._n_env // self.batch_size, 1))

    def _train_step(self, st):
        """One train step in place: the batch_size paths at the step
        counter's row of the index table (with a mesh, assembled by one
        all_reduce), the TBPTT loss of this rank's share of them, scaled by
        that share, each chunk's gradient issued as its forward ends (span
        'fit.loss', to the last chunk's loss; on one stream the earlier
        chunks' backwards lie inside it), then the chunks' gradients joined
        and summed and one all_reduce summing gradients and loss over the
        ranks ('fit.grad'), clip and Adam, then the loss added to the sums
        and the counter advanced ('fit.optim', the step's last span)."""
        mesh, bs = self.mesh, self.batch_size
        with tracing.span('fit.loss'):
            share = par_mesh.batch_share(mesh, bs)
            scale = (share.stop - share.start) / bs
            paths, = par_mesh.take_rows(
                mesh, (st.train,), st.path_idx.index_select(0, st.counter)[0])
            with torch.enable_grad():
                loss, grads, streams = self.tbptt_chunks(
                    st.layers, st.out, st.norm, *self._split(paths[share]),
                    st.leaves)
            loss = loss * scale
        with tracing.span('fit.grad'):
            grads = self.chunk_grads(grads, streams, scale)
            *grads, loss = par_mesh.all_reduce_flat(mesh, [*grads, loss])
        with tracing.span('fit.optim'):
            self.optimizer.step_(st.leaves, grads, st.count, st.mu, st.nu)
            st.sums[0].add_(loss)
            st.counter.add_(1)

    def _valid_step(self, st):
        """The masked loss over the padded test paths (with a mesh, its
        terms summed over the ranks by one all_reduce) into the sums."""
        num, den = par_mesh.all_reduce_flat(self.mesh, list(
            self.valid_terms(st.layers, st.out, st.norm, st.test)))
        st.sums[1].add_(num / torch.clamp(den, min=1.0))

    def _epoch(self, st, n_tr, n_batches, generator, path_idx, train_step,
               valid_step):
        """n_batches train steps, each on batch_size paths drawn with
        replacement from the first n_tr (or path_idx[i]) into the index
        table; then the validation step. Returns (mean train loss, valid
        loss), 0-d device tensors."""
        with tracing.span('fit.draws'):
            if path_idx is None:
                path_idx = torch.randint(
                    0, n_tr, (n_batches, self.batch_size),
                    generator=generator, device=st.train.device)
            else:
                path_idx = torch.stack(list(path_idx)).to(st.path_idx.device)
            captured.set_table(st.path_idx, path_idx)
        captured.run_epoch(st, n_batches, 1, train_step, valid_step)
        return st.sums[0] / n_batches, st.sums[1].clone()

    def epoch_fn(self, params, opt_state, norm, train, test, n_tr, n_batches,
                 generator, path_idx=None):
        """One epoch, run eagerly: n_batches train steps, each on
        batch_size paths drawn with replacement from the first n_tr of
        `train` (or path_idx[i]), a TBPTT loss and gradient, clip and Adam;
        then the validation loss. train: staged paths (cap, T, d); test:
        (paths, weights) as `stage` gives them (with a mesh, this rank's
        slice; the indices are global). Returns (params, opt_state, mean
        train loss, valid loss), the losses 0-d device tensors; nothing
        here waits for the device. The steps are the compiled epoch's
        (`_train_step`, `_valid_step`) on a state made for this epoch,
        the spans 'fit.train_step' and 'fit.valid_step'."""
        return self._eager_epoch(params, opt_state, norm, train, test,
                                 n_batches, (n_tr, n_batches), generator,
                                 path_idx)

    @property
    def recurrent(self):
        return True


#: the JAX package's RNNDynamicsModel.state_dict(...) (after
#: jax.device_get) in the port's layout, for load_state_dict; the
#: {'cells': [...], 'out': ...} tree is kept as it is
rnn_state_from_numpy = state_from_jax_numpy
