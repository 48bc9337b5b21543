"""Meta-learned (MAML) dynamics model for GrBAL (models/meta_mlp.py).

    inner_step(theta, window)    theta' = theta - alpha * grad mse   (adapt)
    meta_loss(theta, pre, post)  mean_task mse(inner_step(theta, pre), post)
                                 differentiated through the inner step
    predict(theta_or_adapted)    adapted params carry a leading env axis

Training batches are contiguous windows of 2*batch_size steps at random
(path, offset) positions, pre/post = the time-adjacent halves. The fit runs
in f32 (torch.matmul, TF32 off: device.resolve_device); bf16 is the
planner's prediction path only, in the fused-MLP kernel.

A fit stages its dataset on the device once, draws each epoch's window
indices on the device, and reads the losses back once per epoch, for the
early stop: no train step waits for the device. The host RNG (numpy,
seed + 1) is consumed exactly as the JAX package consumes it (one
permutation per fit for the train/valid split, one draw that seeds the
window generator), so every fit's split and aggregated buffers equal the
JAX package's.

The train step and the validation step are functions of a fit state that
they update in place (models/captured.py); the fit (models/fitting.py)
runs them on a compiled epoch per shape key (`compiled_epoch`, cached in
_epoch_cache as the JAX package caches its jitted epoch), captured as CUDA
graphs and replayed where captured.captures holds.

With `model.mesh` set (parallel/mesh.py) every rank holds the whole host
dataset (the sampler gathered it), so the split, the normalizer and the
window generator's seed come out alike on every rank, but stages only its
slice of the padded paths. The window indices are drawn alike on every
rank; each rank writes the windows of the paths it holds and zeros
elsewhere, and one all_reduce (sum) a step assembles them everywhere, as
the JAX package's sharded epoch lowers its global gather. Adding zeros is
exact, so the second-order step runs the same on every rank and a W-rank
fit equals the 1-rank fit bit for bit on one device type; the sharding
scales the dataset's memory, not the step's work.
"""
import numpy as np
import torch

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.models import captured, core
from learning_to_adapt_torch.models.fitting import FitMixin, _bucket_pow2
from learning_to_adapt_torch.models.optim import (
    state_from_jax_numpy, tree_leaves)
from learning_to_adapt_torch.ops.fused_mlp import PackedMLP, fused_mlp_forward
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.utils import tracing

PATH_CHUNK = 64  # staged dataset capacity grows in path-count chunks


def _leaves(tree):
    return tree['w'] + tree['b']


def _tree(leaves, n_w):
    return {'w': list(leaves[:n_w]), 'b': list(leaves[n_w:])}


class MetaMLPDynamicsModel(FitMixin):
    _losses = ('post', 'pre', 'valid')
    _shown = ('pre', 'post', 'valid')
    _logged = (('Pre-Loss', 'pre'), ('Post-Loss', 'post'))
    _result = 'post'

    def __init__(self, name, env, hidden_sizes=(512, 512), meta_batch_size=10,
                 hidden_nonlinearity='relu', output_nonlinearity=None,
                 batch_size=500, learning_rate=0.001, inner_learning_rate=0.1,
                 normalize_input=True, valid_split_ratio=0.2,
                 rolling_average_persitency=0.99, seed=0,
                 dtype=torch.float32, device='cuda'):
        self.name = name
        self.device = resolve_device(device)
        self.obs_dim = env.obs_dim
        self.act_dim = env.act_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.hidden_nonlinearity = hidden_nonlinearity
        self.output_nonlinearity = output_nonlinearity
        self.meta_batch_size = meta_batch_size
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.inner_learning_rate = inner_learning_rate
        self.normalize_input = normalize_input
        self.valid_split_ratio = valid_split_ratio
        self.rolling_average_persitency = rolling_average_persitency
        self.dtype = dtype

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = core.init_mlp(gen, self.obs_dim + self.act_dim,
                                    self.hidden_sizes, self.obs_dim, dtype,
                                    self.device)
        self._init_fit(learning_rate, seed)
        self._adapted_params = None  # params with a leading env axis, or None

    # ----------------------------------------------------------- core math
    def _forward(self, params, x):
        return core.mlp_forward(params, x, self.hidden_nonlinearity,
                                self.output_nonlinearity)

    def _mse(self, params, obs_n, act_n, delta_n):
        """Mean squared error over all but the leading axes of batched params
        and data: (E, K, d) data against params with an env axis gives (E,);
        unbatched data gives a scalar."""
        x = torch.cat([obs_n, act_n], dim=-1)
        err = torch.square(self._forward(params, x) - delta_n)
        return err.mean(dim=tuple(range(err.ndim - 2, err.ndim)))

    def inner_step_fn(self, params, obs_n, act_n, delta_n):
        """One gradient-descent step at the inner learning rate on each env's
        window. obs_n/act_n/delta_n (E, K, d); params unbatched. Returns
        params with a leading env axis. The params are detached: this is the
        rollout's adaptation, with no meta-gradient (see meta_loss_fn)."""
        with torch.enable_grad():
            # one broadcast copy of the params per env (a stride-0 view); env
            # e's loss depends on its own copy alone, so the gradient of the
            # summed loss is each env's own gradient
            leaves = self.broadcast_params(
                {k: [p.detach() for p in params[k]] for k in ('w', 'b')},
                obs_n.shape[0])
            flat = _leaves(leaves)
            for p in flat:
                p.requires_grad_(True)
            loss = self._mse(leaves, obs_n, act_n, delta_n).sum()
            grads = torch.autograd.grad(loss, flat)
        lr = self.inner_learning_rate
        new = [p.detach() - lr * g for p, g in zip(flat, grads)]
        return _tree(new, len(leaves['w']))

    def meta_loss_fn(self, params, norm, obs, act, delta):
        """obs/act/delta: (meta_bs, 2*bs, d) raw. Returns (post_loss,
        pre_loss), means over tasks, with the inner step differentiated
        through (second order): post_loss's graph reaches `params`, whose
        tensors must require grad."""
        obs_n = norm.norm_obs(obs)
        act_n = norm.norm_act(act)
        delta_n = norm.norm_delta(delta)
        bs = self.batch_size
        # per-task gradients: differentiate the summed pre-update loss with
        # respect to a stride-0 broadcast of the params (task t's loss
        # depends on its own copy alone), keeping the graph of the gradient
        tasks = self.broadcast_params(params, obs.shape[0])
        flat = _leaves(tasks)
        pre = self._mse(tasks, obs_n[:, :bs], act_n[:, :bs], delta_n[:, :bs])
        grads = torch.autograd.grad(pre.sum(), flat, create_graph=True)
        lr = self.inner_learning_rate
        adapted = _tree([p - lr * g for p, g in zip(flat, grads)],
                        len(tasks['w']))
        post = self._mse(adapted, obs_n[:, bs:], act_n[:, bs:],
                         delta_n[:, bs:])
        return post.mean(), pre.mean()

    # ------------------------------------------------------------------ fit
    def _fit_shapes(self, p_tr, p_te, t_len):
        """(train capacity, test capacity, train steps per epoch, validation
        steps) for p_tr / p_te aggregated paths of t_len steps."""
        cap_tr = int(np.ceil(p_tr / PATH_CHUNK)) * PATH_CHUNK
        cap_te = int(np.ceil(p_te / PATH_CHUNK)) * PATH_CHUNK
        per_step = self.meta_batch_size * self.batch_size * 2
        steps_per_epoch = _bucket_pow2(max(int(p_tr * t_len / per_step), 1))
        steps_test = _bucket_pow2(max(int(p_te * t_len / per_step), 1))
        return cap_tr, cap_te, steps_per_epoch, steps_test

    def stage(self, data, capacity):
        """Paths dict(obs, act, delta) of numpy [P, T, d] -> one
        (capacity, T, obs+act+obs) f32 tensor on the device, zero-padded
        beyond P; with a mesh, this rank's slice of the capacity."""
        count, t_len = data['obs'].shape[:2]
        dims = [data[k].shape[-1] for k in ('obs', 'act', 'delta')]
        out = np.zeros((capacity, t_len, sum(dims)), np.float32)
        out[:count] = np.concatenate([data['obs'], data['act'],
                                      data['delta']], axis=-1)
        return par_mesh.stage_fit_data(self, out)

    def _stage_fit(self):
        """(train, test, `_epoch` counts) of the aggregated paths: each
        staged at its PATH_CHUNK capacity; the real path counts and the
        epoch's train and validation steps."""
        p_tr = self._train['obs'].shape[0]
        p_te = self._test['obs'].shape[0]
        cap_tr, cap_te, steps, steps_test = self._fit_shapes(
            p_tr, p_te, self._train['obs'].shape[1])
        return (self.stage(self._train, cap_tr),
                self.stage(self._test, cap_te), (p_tr, p_te, steps,
                                                 steps_test))

    # ------------------------------------------------ the fit's steps
    def _fit_state(self, params, opt_state, norm, train, test, rows,
                   static=False):
        """The state the train and validation steps work on
        (captured.new_state): copies of params and opt_state (leaves in
        JAX's order), the normalizer and staged data (copies when static,
        else these tensors), index tables of `rows` steps (path index and
        window offset, each (rows, meta_batch_size), offsets bs at first)
        and the loss sums (post, pre, valid)."""
        keep = (lambda x: x.clone()) if static else (lambda x: x)
        shape = (rows, self.meta_batch_size)
        dev = train.device
        return captured.new_state(
            [p.detach().clone() for p in tree_leaves(params)],
            opt_state['count'], tree_leaves(opt_state['mu']),
            tree_leaves(opt_state['nu']), 3,
            norm=captured.clone_normalizer(norm) if static else norm,
            train=keep(train), test=keep(test),
            pidx=torch.zeros(shape, dtype=torch.int64, device=dev),
            offs=torch.full(shape, self.batch_size, dtype=torch.int64,
                            device=dev),
            span=torch.arange(-self.batch_size, self.batch_size, device=dev))

    def _epoch_key(self, train, test):
        """(shape key: the capacities, path length, meta batch and batch
        size; the index tables' rows: the most train and validation steps
        a fit of these capacities takes)."""
        key = (train.shape[0], test.shape[0], train.shape[1],
               self.meta_batch_size, self.batch_size)
        _, _, most, most_test = self._fit_shapes(
            train.shape[0] * self._n_env, test.shape[0] * self._n_env,
            train.shape[1])
        return key, most + most_test

    def _window(self, st, data):
        """The meta batch of windows at the step counter's row of the
        index tables: path pidx, rows [off - bs, off + bs) of `data`.
        Returns (obs, act, delta), each (meta_bs, 2*bs, d). With a mesh,
        data is this rank's slice of the paths, the indices are global, and
        one all_reduce assembles the windows on every rank."""
        pidx = st.pidx.index_select(0, st.counter)[0]
        offs = st.offs.index_select(0, st.counter)[0]
        w, = par_mesh.take_rows(self.mesh, (data,), pidx[:, None],
                                offs[:, None] + st.span)
        return w.split([self.obs_dim, self.act_dim, self.obs_dim], dim=-1)

    def _train_step(self, st):
        """One meta-train step in place: the counter's windows of st.train
        and the second-order meta loss on them (span 'fit.loss'), its
        gradient ('fit.grad'), clip and Adam, then post and pre added to
        the sums and the counter advanced ('fit.optim': the step's last
        span, so that its close and the step's end share one stamp)."""
        with tracing.span('fit.loss'):
            o, a, d = self._window(st, st.train)
            with torch.enable_grad():
                post, pre = self.meta_loss_fn(
                    self._from_step_layout(st.leaves), st.norm, o, a, d)
        with tracing.span('fit.grad'), torch.enable_grad():
            grads = torch.autograd.grad(post, st.leaves)
        with tracing.span('fit.optim'):
            self.optimizer.step_(st.leaves, list(grads), st.count, st.mu,
                                 st.nu)
            st.sums[:2].add_(torch.stack([post, pre]).detach())
            st.counter.add_(1)

    def _valid_step(self, st):
        """One validation step: the plain pre-update loss of the params on
        the counter's windows of st.test, added to the sums."""
        o, a, d = self._window(st, st.test)
        n = st.norm
        st.sums[2].add_(self._mse(self._from_step_layout(st.leaves),
                                  n.norm_obs(o), n.norm_act(a),
                                  n.norm_delta(d)).mean())
        st.counter.add_(1)

    def _epoch(self, st, n_tr, n_te, steps, steps_test, generator, windows,
               train_step, valid_step):
        """Draws the epoch's windows (path index in [0, n_tr) for each train
        step, then [0, n_te) for each validation step; offset in [bs,
        T - bs)) from the generator, or takes windows = injected (pidx,
        offs) of every step, into the index tables; runs the steps
        (captured.run_epoch). Returns (post, pre, valid): 0-d device
        tensors, means over the steps; with a mesh, one all_reduce takes
        their max over the ranks, which hold the same values, so every
        rank takes the same early stop."""
        with tracing.span('fit.draws'):
            if windows is None:
                pidx, offs = self._draw_windows(st, n_tr, n_te, steps,
                                                steps_test, generator)
            else:
                pidx, offs = (torch.stack([w[k] for w in windows]).to(
                    st.pidx.device) for k in (0, 1))
            captured.set_table(st.pidx, pidx)
            captured.set_table(st.offs, offs)
        captured.run_epoch(st, steps, steps_test, train_step, valid_step)
        losses = torch.stack([st.sums[0] / steps, st.sums[1] / steps,
                              st.sums[2] / steps_test])
        return par_mesh.all_reduce(self.mesh, losses, op='max')

    def _draw_windows(self, st, n_tr, n_te, steps, steps_test, generator):
        """(path index, offset) of every train step, then of every
        validation step: path index in [0, n_tr) or [0, n_te), offset in
        [bs, T - bs)."""
        mbs, bs = self.meta_batch_size, self.batch_size
        dev, t_len = st.train.device, st.train.shape[1]

        def draw(n, count):
            pidx = torch.randint(0, n, (count, mbs), generator=generator,
                                 device=dev)
            # paths of exactly 2*bs steps have one offset, bs, which
            # jax.random.randint gives when its bounds meet
            offs = torch.randint(bs, max(t_len - bs, bs + 1), (count, mbs),
                                 generator=generator, device=dev)
            return pidx, offs
        (p_tr, o_tr), (p_te, o_te) = draw(n_tr, steps), draw(n_te, steps_test)
        return torch.cat([p_tr, p_te]), torch.cat([o_tr, o_te])

    def epoch_fn(self, params, opt_state, norm, train, test, n_tr, n_te,
                 steps_per_epoch, steps_test, generator, windows=None):
        """One epoch, run eagerly: steps_per_epoch meta-train steps
        (second-order meta loss, clip, Adam) on windows of `train`, then
        steps_test validation steps (the plain pre-update loss of the new
        params) on windows of `test`. train/test: staged paths (see
        `stage`), the first n_tr / n_te real. windows: optionally the
        (pidx, offs) of every train step, then of every validation step,
        in place of the device draws. Returns (params, opt_state, post,
        pre, valid): the losses are 0-d device tensors, means over the
        epoch's steps. Nothing here waits for the device. The steps are
        the compiled epoch's (`_train_step`, `_valid_step`) on a state
        made for this epoch, the spans 'fit.train_step' and
        'fit.valid_step'. With a mesh, one all_reduce a
        step assembles its windows and one more, at the end, takes the
        losses' max over the ranks."""
        return self._eager_epoch(
            params, opt_state, norm, train, test,
            steps_per_epoch + steps_test,
            (n_tr, n_te, steps_per_epoch, steps_test), generator, windows)

    # ------------------------------------------------------------- adapt
    def adapt_fn(self, params, norm, obs, act, obs_next):
        """Per-env fast adaptation. obs/act/obs_next: (n_env, K, d).
        Returns params with a leading env axis."""
        delta = obs_next - obs
        return self.inner_step_fn(params, norm.norm_obs(obs),
                                  norm.norm_act(act), norm.norm_delta(delta))

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def adapt(self, obs, act, obs_next):
        """Host API: lists/arrays of per-env windows (n_env of (K, d))."""
        obs, act, obs_next = (self._tensor(np.stack(a))
                              for a in (obs, act, obs_next))
        self._adapted_params = self.adapt_fn(self.params, self.normalizer,
                                             obs, act, obs_next)

    def switch_to_pre_adapt(self):
        self._adapted_params = None

    # ------------------------------------------------------------- predict
    def predict_adapted_fn(self, adapted_params, norm, obs, act):
        """obs/act: (n_env, n, d), each env's rows through its own params
        (leading env axis; a broadcast view of one set works too), or their
        ops.fused_mlp.pack_weights, which the planner makes once per step.
        The planner path: bf16 products, f32 accumulation, in the fused-MLP
        kernel on the card, which packs unpacked params on every call; the
        output nonlinearity applies to the kernel's f32 output."""
        x = torch.cat([norm.norm_obs(obs), norm.norm_act(act)], dim=-1)
        p = adapted_params
        ws, bs = (p, None) if isinstance(p, PackedMLP) else (p['w'], p['b'])
        delta = core.activation(self.output_nonlinearity)(
            fused_mlp_forward(x, ws, bs, self.hidden_nonlinearity))
        return obs + norm.denorm_delta(delta)

    def predict_fn(self, params, norm, obs, act):
        """Single-parameter-set prediction of rows obs/act (N, d); on the
        card the params are packed for this one call."""
        batched = {k: [p.unsqueeze(0) for p in params[k]] for k in params}
        return self.predict_adapted_fn(batched, norm, obs[None],
                                       act[None])[0]

    @torch.no_grad()
    def predict(self, obs, act):
        """Host API: next observations (N, obs_dim) as numpy; after `adapt`
        the rows split evenly over the adapted envs, in order."""
        obs, act = self._tensor(obs), self._tensor(act)
        if self._adapted_params is not None:
            n_env = self._adapted_params['w'][0].shape[0]
            per = obs.shape[0] // n_env
            out = self.predict_adapted_fn(
                self._adapted_params, self.normalizer,
                obs.reshape(n_env, per, -1), act.reshape(n_env, per, -1))
            return out.reshape(obs.shape[0], -1).cpu().numpy()
        return self.predict_fn(self.params, self.normalizer, obs,
                               act).cpu().numpy()

    def broadcast_params(self, params, n_env):
        """params viewed with a leading env axis of n_env (stride 0, no
        copy): the pre-update parameters for every env."""
        return {k: [p.unsqueeze(0).expand((n_env,) + tuple(p.shape))
                    for p in params[k]] for k in params}

    @property
    def recurrent(self):
        return False

    @property
    def adapted(self):
        return self._adapted_params is not None


#: the JAX package's MetaMLPDynamicsModel.state_dict(...) (after
#: jax.device_get) in the port's layout, for load_state_dict
meta_state_from_numpy = state_from_jax_numpy
