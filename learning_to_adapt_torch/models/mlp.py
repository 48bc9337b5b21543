"""Feed-forward dynamics model for MB-MPC, and ensembles of it
(models/mlp.py).

    predict(obs, act) = obs + denorm(f(norm(obs, act)))

The model predicts normalized state deltas, aggregates its dataset across
iterations and stops early on a rolling average of the validation loss.
As in the JAX package, the dataset is padded to a multiple of PAD_CHUNK
rows, the padding weighted 0 in the losses, and an epoch's minibatches are
drawn from a permutation of the padded capacity, not of the real rows.

With n_members > 1 every parameter carries a leading member axis: the
training loss sums over members and the prediction is the member mean.

The fit runs in f32 (torch.matmul, TF32 off: device.resolve_device). The
planner's prediction runs the fused-MLP kernel (bf16 products, f32
accumulation), the member axis as its group axis; `pack` makes the
kernel's weight stream once for a sampling call.

A fit stages its dataset on the device once and reads the losses back once
per epoch, for the early stop: no train step waits for the device. The host
RNG (numpy, seed + 1) is consumed as the JAX package consumes it: one
permutation per fit for the split and one draw that seeds the device
generator of the epochs' permutations.

The train step and the validation step are functions of a fit state that
they update in place (models/captured.py); the fit (models/fitting.py)
runs them on a compiled epoch per shape key (`compiled_epoch`, cached in
_epoch_cache as the JAX package caches its jitted epoch), captured as CUDA
graphs and replayed where captured.captures holds, the epoch's permutation
drawn eagerly into the step's index table.

With `model.mesh` set (parallel/mesh.py) the fit is data parallel: every
rank holds the whole host dataset (the sampler gathered it) and draws the
same permutation, but stages only its slice of the padded rows. A train
step makes two all_reduces: the first assembles the minibatch's rows and
weights on every rank (each rank writes the rows it holds, zeros
elsewhere); each rank then takes the loss and gradient of its share of the
minibatch, batch_size / W rows, over the global max(sum(w), 1); the second,
of a flat buffer, sums the gradients and the loss, and the clip's global
norm is taken after it, so every rank steps alike. One more all_reduce an
epoch sums the validation terms of the rows each rank holds. This agrees
with the 1-rank fit up to f32 reduction order. Without a mesh the same
code runs with no collective.
"""
import numpy as np
import torch

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.models import captured, core
from learning_to_adapt_torch.models.fitting import FitMixin, _bucket_pow2
from learning_to_adapt_torch.models.optim import (
    state_from_jax_numpy, tree_leaves)
from learning_to_adapt_torch.ops.fused_mlp import (
    PackedMLP, fused_mlp_forward, pack_weights)
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.utils import tracing

PAD_CHUNK = 16384  # staged dataset capacity grows in row chunks


def _pad_rows(arrs, count, chunk=PAD_CHUNK):
    """Numpy row arrays padded with zeros to a multiple of `chunk` rows (at
    least one chunk); returns the padded arrays and the weight vector, 1
    for the real rows."""
    cap = max(chunk, int(np.ceil(count / chunk)) * chunk)
    out = []
    for a in arrs:
        p = np.zeros((cap,) + a.shape[1:], a.dtype)
        p[:count] = a[:count]
        out.append(p)
    w = np.zeros((cap,), np.float32)
    w[:count] = 1.0
    return out, w


class MLPDynamicsModel(FitMixin):
    _layout = ('rows',)
    _logged = (('TrainLoss', 'train'), ('ValidLoss', 'avg'))

    def __init__(self, name, env, hidden_sizes=(512, 512),
                 hidden_nonlinearity='relu', output_nonlinearity=None,
                 batch_size=500, learning_rate=0.001, normalize_input=True,
                 valid_split_ratio=0.2, rolling_average_persitency=0.99,
                 n_members=1, seed=0, dtype=torch.float32, device='cuda'):
        self.name = name
        self.device = resolve_device(device)
        self.obs_dim = env.obs_dim
        self.act_dim = env.act_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.hidden_nonlinearity = hidden_nonlinearity
        self.output_nonlinearity = output_nonlinearity
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.normalize_input = normalize_input
        self.valid_split_ratio = valid_split_ratio
        self.rolling_average_persitency = rolling_average_persitency
        self.n_members = n_members
        self.dtype = dtype

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        members = [core.init_mlp(gen, self.obs_dim + self.act_dim,
                                 self.hidden_sizes, self.obs_dim, dtype,
                                 self.device) for _ in range(n_members)]
        self.params = members[0] if n_members == 1 else {
            k: [torch.stack(ps) for ps in zip(*(m_[k] for m_ in members))]
            for k in ('w', 'b')}
        self._init_fit(learning_rate, seed)

    # ------------------------------------------------------------------ fit
    def _split_indices(self, idx, ratio):
        """(train, test) of a permutation of the rows: the first
        int(n * (1 - ratio)) train, the rest test."""
        split = int(idx.shape[0] * (1 - ratio))
        return idx[:split], idx[split:]

    def stage(self, data):
        """Rows dict(obs, act, delta) of numpy [rows, d] -> (rows (cap,
        obs+act+obs) f32, weights (cap,)) on the device, zero-padded to the
        PAD_CHUNK capacity; with a mesh, this rank's slice of the
        capacity."""
        count = data['obs'].shape[0]
        (rows,), w = _pad_rows([np.concatenate(
            [data['obs'], data['act'], data['delta']], axis=-1)], count)
        return par_mesh.stage_fit_data(self, (rows, w))

    def _stage_fit(self):
        """(train, test, `_epoch` counts) of the aggregated rows: each
        staged at its PAD_CHUNK capacity; the epoch's minibatches."""
        n_batches = _bucket_pow2(max(
            self._train['obs'].shape[0] // self.batch_size, 1))
        return self.stage(self._train), self.stage(self._test), (n_batches,)

    def _forward_normalized(self, params, norm, obs, act):
        """f32 forward in normalized space: the normalized delta, with a
        leading member axis for an ensemble."""
        x = torch.cat([norm.norm_obs(obs), norm.norm_act(act)], dim=-1)
        return core.mlp_forward(params, x, self.hidden_nonlinearity,
                                self.output_nonlinearity)

    def loss_terms(self, params, norm, rows, w):
        """(the squared error's mean over obs dims, times the row weight,
        summed over rows and members; sum(w)) of staged rows."""
        obs, act, delta = rows.split([self.obs_dim, self.act_dim,
                                      self.obs_dim], dim=-1)
        pred = self._forward_normalized(params, norm, obs, act)
        err = torch.square(pred - norm.norm_delta(delta))
        return torch.sum(err.mean(-1) * w), w.sum()

    def loss_fn(self, params, norm, rows, w):
        """Weighted mean squared error of staged rows: loss_terms' sum
        divided by max(sum(w), 1)."""
        num, den = self.loss_terms(params, norm, rows, w)
        return num / torch.clamp(den, min=1.0)

    # ------------------------------------------------ the fit's steps
    def _fit_state(self, params, opt_state, norm, train, test, rows,
                   static=False):
        """The state the train and validation steps work on
        (captured.new_state): copies of params and opt_state (leaves in
        JAX's order), the normalizer and staged (rows, weights) (copies
        when static, else these tensors), an index table of `rows`
        minibatches, (rows, batch_size), and the loss sums (train,
        valid)."""
        keep = (lambda x: x.clone()) if static else (lambda x: x)
        return captured.new_state(
            [p.detach().clone() for p in tree_leaves(params)],
            opt_state['count'], tree_leaves(opt_state['mu']),
            tree_leaves(opt_state['nu']), 2,
            norm=captured.clone_normalizer(norm) if static else norm,
            train=tuple(map(keep, train)), test=tuple(map(keep, test)),
            sel=torch.zeros((rows, self.batch_size), dtype=torch.int64,
                            device=train[0].device))

    def _epoch_key(self, train, test):
        """(shape key: the train and test capacities and the batch size;
        the index table's rows: the most minibatches any fit of this train
        capacity takes)."""
        rows = train[0].shape[0]
        return (rows, test[0].shape[0], self.batch_size), _bucket_pow2(
            max(rows * self._n_env // self.batch_size, 1))

    def _train_step(self, st):
        """One train step in place: the minibatch at the step counter's row
        of the index table (with a mesh, assembled by one all_reduce), the
        loss of this rank's share of it (span 'fit.loss') and its gradient,
        one all_reduce summing gradients and loss over the ranks ('fit.grad'),
        clip and Adam, then the loss added to the sums and the counter
        advanced ('fit.optim', the step's last span)."""
        mesh = self.mesh
        rows, w = st.train
        with tracing.span('fit.loss'):
            mb_rows, mb_w = par_mesh.take_rows(
                mesh, (rows, w), st.sel.index_select(0, st.counter)[0])
            share = par_mesh.batch_share(mesh, self.batch_size)
            with torch.enable_grad():
                num, _ = self.loss_terms(self._from_step_layout(st.leaves),
                                         st.norm, mb_rows[share],
                                         mb_w[share])
                loss = num / torch.clamp(mb_w.sum(), min=1.0)
        with tracing.span('fit.grad'):
            with torch.enable_grad():
                grads = torch.autograd.grad(loss, st.leaves)
            *grads, loss = par_mesh.all_reduce_flat(
                mesh, list(grads) + [loss.detach()])
        with tracing.span('fit.optim'):
            self.optimizer.step_(st.leaves, grads, st.count, st.mu, st.nu)
            st.sums[0].add_(loss)
            st.counter.add_(1)

    def _valid_step(self, st):
        """The loss on the whole padded test set (with a mesh, its terms
        summed over the ranks by one all_reduce) into the sums."""
        num, den = par_mesh.all_reduce_flat(self.mesh, list(self.loss_terms(
            self._from_step_layout(st.leaves), st.norm, *st.test)))
        st.sums[1].add_(num / torch.clamp(den, min=1.0))

    def _epoch(self, st, n_batches, generator, perm, train_step,
               valid_step):
        """n_batches minibatches of batch_size rows taken in the order of a
        permutation of the padded train capacity (`perm`, or one drawn on
        the device; with a mesh, of the global capacity) into the index
        table, each a train step; then the validation step. Returns (mean
        train loss, valid loss), 0-d device tensors."""
        with tracing.span('fit.draws'):
            if perm is None:
                rows = st.train[0]
                cap = rows.shape[0] * self._n_env
                perm = torch.randperm(cap, generator=generator,
                                      device=rows.device)
            bs = self.batch_size
            captured.set_table(st.sel, perm[:n_batches * bs].reshape(
                n_batches, bs))
        captured.run_epoch(st, n_batches, 1, train_step, valid_step)
        return st.sums[0] / n_batches, st.sums[1].clone()

    def epoch_fn(self, params, opt_state, norm, train, test, n_batches,
                 generator, perm=None):
        """One epoch, run eagerly: n_batches minibatches of batch_size rows
        taken in the order of a permutation of the padded train capacity
        (`perm`, or one drawn on the device), each a loss, gradient, clip
        and Adam step; then the loss on the whole padded test set.
        train/test: staged (see `stage`; with a mesh, this rank's slice of
        the rows, and perm one of the global capacity). Returns (params,
        opt_state, mean train loss, valid loss), the losses 0-d device
        tensors; nothing here waits for the device. The steps are the
        compiled epoch's (`_train_step`, `_valid_step`) on a state made
        for this epoch, the spans 'fit.train_step' and 'fit.valid_step'."""
        return self._eager_epoch(params, opt_state, norm, train, test,
                                 n_batches, (n_batches,), generator, perm)

    # -------------------------------------------------------------- predict
    def _grouped(self, params):
        """Per-layer weights (G, in, out) and biases (G, out), the member
        axis as the kernel's group axis (G = 1 for a single model)."""
        if self.n_members == 1:
            return ([w.unsqueeze(0) for w in params['w']],
                    [b.unsqueeze(0) for b in params['b']])
        return params['w'], params['b']

    def pack(self, params, out=None):
        """The kernel's weight stream for params, made once and reused by
        every prediction of a sampling call; `out`, a pack of the same
        shapes to write in place (ops/fused_mlp.py pack_weights)."""
        return pack_weights(*self._grouped(params), out=out)

    def predict_fn(self, params, norm, obs, act):
        """obs/act rows (N, d) -> next obs (N, obs_dim): the planner path,
        bf16 products and f32 accumulation in the fused-MLP kernel on the
        card; every member sees every row and the prediction is the member
        mean. params: the parameter dict (packed here on every call) or
        its `pack`. The output nonlinearity applies to the kernel's f32
        output."""
        x = torch.cat([norm.norm_obs(obs), norm.norm_act(act)], dim=-1)
        ws, bs = ((params, None) if isinstance(params, PackedMLP)
                  else self._grouped(params))
        xg = x.unsqueeze(0).expand(self.n_members, *x.shape)
        delta = core.activation(self.output_nonlinearity)(
            fused_mlp_forward(xg, ws, bs, self.hidden_nonlinearity))
        return obs + norm.denorm_delta(delta.mean(0))

    @torch.no_grad()
    def predict(self, obs, act):
        """Host API: next observations (N, obs_dim) as numpy."""
        obs, act = (torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                    device=self.device) for a in (obs, act))
        return self.predict_fn(self.params, self.normalizer, obs,
                               act).cpu().numpy()

    # ----------------------------------------------------------- adaptation
    # MB-MPC does not adapt online: no-ops for API parity with the meta and
    # recurrent models
    def adapt(self, obs, act, obs_next):
        pass

    def switch_to_pre_adapt(self):
        pass

    @property
    def recurrent(self):
        return False


#: the JAX package's MLPDynamicsModel.state_dict(...) (after
#: jax.device_get) in the port's layout, for load_state_dict; an
#: ensemble's leading member axis is kept
mlp_state_from_numpy = state_from_jax_numpy
