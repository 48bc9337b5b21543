"""The fit that the three dynamics models share (models/fitting.py).

The JAX package writes `fit` once a model (models/meta_mlp.py, mlp.py and
rnn.py); the port writes it once, in FitMixin, and each model keeps what
really differs: its data layout (`stage`, `_stage_fit`, `_epoch_key`), its
split rule (`_split_indices`), its steps and draws (`_fit_state`,
`_train_step`, `_valid_step`, `_epoch`) and its losses' names, log keys and
result (plain data: `_losses`, `_shown`, `_logged`, `_result`).

A fit (the span 'fit.call', utils/tracing.py) runs these stages, their
spans in brackets:

  1. the shape checks of obs and act;
  2. the normalizer, from this fit's data ('fit.normalize');
  3. the split, with the host RNG (numpy, seed + 1) consumed as the JAX
     package consumes it (one permutation a fit), and the aggregation
     across iterations; staging on the device ('fit.stage');
  4. the shape key's CompiledEpoch (models/captured.py), loaded with the
     params, optimizer state, normalizer and data ('fit.prepare'), and the
     seed of the epochs' generator (one more draw of the host RNG);
  5. the epochs (`_fit_epoch`: the draws 'fit.draws', then the steps
     'fit.train_step' and 'fit.valid_step', inside which 'fit.loss',
     'fit.grad' and 'fit.optim'), each followed by its one read of device
     values ('fit.read') and the rolling-average early stop;
  6. fresh parameter and optimizer tensors out of the static state
     ('fit.state_out').

The fit takes this one path on the CPU, over gloo and on the card; whether
a step is captured as a CUDA graph or called as a function is
CompiledEpoch's choice (captured.captures). epoch_fn, the functional epoch
that the tests hold against the JAX package's `_get_epoch_fn`, runs the
same steps on a state made for one epoch (`_eager_epoch`).
"""
import numpy as np
import torch

from learning_to_adapt_torch.models import captured
from learning_to_adapt_torch.models.normalizer import (
    Normalizer, normalizer_from_numpy, normalizer_to_numpy)
from learning_to_adapt_torch.models.optim import (
    ClipAdam, adam_state_from_numpy, adam_state_to_numpy, tree_from_numpy,
    tree_leaves, tree_to_numpy, tree_unflatten)
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.utils import tracing


def _bucket_pow2(n):
    """Round a step count to the nearest power of two (>= 1), as the JAX
    package does to bound its recompiles; kept so that an epoch runs the
    same number of steps."""
    if n <= 1:
        return 1
    return int(2 ** round(np.log2(n)))


class FitMixin:
    """fit, the fit state's hand-over, the shape-key cache and the state
    dict of a dynamics model. The model sets obs_dim, act_dim, dtype,
    device, params, normalize_input, valid_split_ratio and
    rolling_average_persitency, then calls `_init_fit`."""

    _layout = ('paths', 'T')       # the leading axes of obs and act
    _losses = ('train', 'valid')   # what an epoch returns, valid last
    _shown = ('train', 'valid')    # the verbose line's losses
    _logged = (('TrainLoss', 'train'),)  # log key -> loss, or 'avg'
    _result = 'train'              # fit returns {epochs, <_result>_loss}

    def _init_fit(self, learning_rate, seed):
        # global-norm clipping protects the fit from occasional outlier
        # transitions (crash states), as in the JAX package
        self.optimizer = ClipAdam(learning_rate, max_norm=100.0)
        self.opt_state = self.optimizer.init(self.params)
        self.normalizer = Normalizer.init(self.obs_dim, self.act_dim,
                                          self.dtype, self.device)
        self._train = None  # dicts of numpy obs, act, delta, raw
        self._test = None
        self._rng = np.random.RandomState(seed + 1)
        self.mesh = None  # parallel/mesh.py: the fit's data shards on 'env'
        self._epoch_cache = {}  # shape key -> captured.CompiledEpoch

    @property
    def _n_env(self):
        return 1 if self.mesh is None else self.mesh.shape['env']

    # ------------------------------------------------------------------ fit
    @tracing.calls('fit.call')
    def fit(self, obs, act, obs_next, epochs=1000, compute_normalization=True,
            valid_split_ratio=None, rolling_average_persitency=None,
            verbose=False, log_tabular=False, logger=None):
        for name, x, dim in (('obs', obs, self.obs_dim),
                             ('act', act, self.act_dim)):
            if x.ndim != len(self._layout) + 1 or x.shape[-1] != dim:
                raise ValueError(f'{name} must be [{", ".join(self._layout)}'
                                 f', {dim}], got {x.shape}')
        obs = np.asarray(obs, np.float32)
        act = np.asarray(act, np.float32)
        delta = np.asarray(obs_next, np.float32) - obs
        if valid_split_ratio is None:
            valid_split_ratio = self.valid_split_ratio
        if rolling_average_persitency is None:
            rolling_average_persitency = self.rolling_average_persitency

        # normalization stats from this iteration's fresh data
        if self.normalize_input and (compute_normalization or
                                     self._train is None):
            with tracing.span('fit.normalize'):
                self.normalizer = Normalizer.fit(
                    *(torch.as_tensor(a, device=self.device)
                      for a in (obs, act, delta)))

        with tracing.span('fit.stage'):
            # random train/valid split, then append to the aggregated data
            tr, te = self._split_indices(self._rng.permutation(obs.shape[0]),
                                         valid_split_ratio)
            new_tr = dict(obs=obs[tr], act=act[tr], delta=delta[tr])
            new_te = dict(obs=obs[te], act=act[te], delta=delta[te])
            if self._train is None:
                self._train, self._test = new_tr, new_te
            else:
                self._train = {k: np.concatenate([self._train[k], new_tr[k]])
                               for k in new_tr}
                self._test = {k: np.concatenate([self._test[k], new_te[k]])
                              for k in new_te}
            par_mesh.stage_model_state(self)
            train, test, counts = self._stage_fit()
        with tracing.span('fit.prepare'):
            compiled = self.compiled_epoch(train, test)
            compiled.prepare(lambda st: self._load_state(
                st, self.params, self.opt_state, self.normalizer, train,
                test))
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(self._rng.randint(1 << 31)))

        valid_avg = valid_avg_prev = None
        epoch = 0
        losses = [float('nan')] * len(self._losses)
        for epoch in range(epochs):
            out = self._fit_epoch(compiled, generator, counts)
            # the epoch's one read of device values, alike on every rank
            with tracing.span('fit.read'):
                losses = torch.stack(list(out)).tolist()
            valid_loss = losses[-1]
            if valid_avg is None:
                # seeded above the first value so that epoch 0 never stops
                valid_avg = 1.5 * valid_loss if valid_loss >= 0 \
                    else valid_loss / 1.5
                valid_avg_prev = 2 * valid_loss if valid_loss >= 0 \
                    else valid_loss / 2
            valid_avg = (rolling_average_persitency * valid_avg +
                         (1 - rolling_average_persitency) * valid_loss)
            if verbose and logger is not None:
                named = dict(zip(self._losses, losses))
                logger.log(f'Epoch {epoch} ' + ''.join(
                    f'{k} {named[k]:.5f} ' for k in self._shown) +
                    f'avg {valid_avg:.5f}')
            if valid_avg_prev < valid_avg or epoch == epochs - 1:
                break
            valid_avg_prev = valid_avg
        with tracing.span('fit.state_out'):
            self.params, self.opt_state = self._state_out(compiled.state,
                                                          clone=True)
        named = dict(zip(self._losses, losses), avg=valid_avg)
        if log_tabular and logger is not None:
            logger.logkv('Epochs', epoch)
            for key, name in self._logged:
                logger.logkv(key, float(named[name]))
        return {'epochs': epoch, f'{self._result}_loss': named[self._result]}

    def _split_indices(self, idx, ratio):
        """(train, test) of a permutation of the paths: the first
        max(int(n * (1 - ratio)), 1) train, the rest test, or the last path
        when the split takes them all."""
        n = idx.shape[0]
        split = max(int(n * (1 - ratio)), 1)
        return idx[:split], idx[split:] if split < n else idx[-1:]

    def _fit_epoch(self, compiled, generator, counts):
        """One epoch of the fit on the compiled epoch's state: counts are
        the model's `_epoch` arguments that the fit derived (real path or
        row counts and step counts; the capacities are the state's
        shapes). Returns the epoch's losses, 0-d device tensors in
        `_losses` order."""
        return self._epoch(compiled.state, *counts, generator, None,
                           compiled.train, compiled.valid)

    @torch.no_grad()
    def _eager_epoch(self, params, opt_state, norm, train, test, rows, counts,
                     generator, injected):
        """epoch_fn's body: the steps on a state made for one epoch around
        the tensors handed in (`rows` index-table rows), the draws or the
        `injected` ones. Returns (params, opt_state, *losses), the params
        detached views of that state."""
        st = self._fit_state(params, opt_state, norm, train, test, rows)
        losses = self._epoch(st, *counts, generator, injected,
                             lambda: self._train_step(st),
                             lambda: self._valid_step(st))
        return (*self._state_out(st, clone=False), *losses)

    # ------------------------------------------------ the fit state
    _step_layout = staticmethod(tree_leaves)  # the state's leaf order

    def _from_step_layout(self, leaves):
        return tree_unflatten(self.params, leaves)

    def _load_state(self, st, params, opt_state, norm, train, test):
        captured.load(st, self._step_layout, params, opt_state, norm, train,
                      test)

    def _state_out(self, st, clone):
        """(params, opt_state) of a fit state: copies (clone) where the
        state lives on, else detached views where they are contiguous."""
        return captured.state_out(st, self._from_step_layout, clone)

    def compiled_epoch(self, train, test):
        """The CompiledEpoch of staged train/test data's shape key
        (`_epoch_key`: capacities and batch sizes, as in the JAX package's
        key, not the real counts), made on first use: its index tables hold
        the most steps any fit of these capacities takes."""
        key, rows = self._epoch_key(train, test)
        if key not in self._epoch_cache:
            st = self._fit_state(self.params, self.opt_state,
                                 self.normalizer, train, test, rows,
                                 static=True)
            self._epoch_cache[key] = captured.CompiledEpoch(
                st, self._train_step, self._valid_step, self.device,
                self.mesh)
        return self._epoch_cache[key]

    # ---------------------------------------------------------------- state
    def state_dict(self, include_data=False):
        """numpy copies of params, optimizer state and normalizer; with
        include_data also the dataset buffers and the split/shuffle RNG
        (the train/valid composition of every future fit depends on it),
        for full-fidelity resume."""
        sd = dict(params=tree_to_numpy(self.params),
                  opt_state=adam_state_to_numpy(self.opt_state),
                  normalizer=normalizer_to_numpy(self.normalizer))
        if include_data:
            sd.update(train=self._train, test=self._test,
                      rng_state=self._rng.get_state())
        return sd

    def load_state_dict(self, sd):
        dev = self.device
        self.params = tree_from_numpy(sd['params'], dev, self.dtype)
        self.opt_state = adam_state_from_numpy(sd['opt_state'], dev,
                                               self.dtype)
        self.normalizer = normalizer_from_numpy(sd['normalizer'], dev,
                                                self.dtype)
        self._train = sd.get('train')
        self._test = sd.get('test')
        if sd.get('rng_state') is not None:
            self._rng.set_state(sd['rng_state'])
