"""Meta-learned (MAML) dynamics model for GrBAL (models/meta_mlp.py).

The sampling-side half of the JAX model: parameters, the f32 inner
adaptation step, per-env adaptation and the planner's bf16 prediction. The
meta-training fit (meta_loss_fn, fit, state_dict) follows in the next slice
of the port.

    inner_step(theta, window)  theta' = theta - alpha * grad mse   (adapt)
    predict(theta_or_adapted)  adapted params carry a leading env axis
"""
import torch

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.models import core
from learning_to_adapt_torch.models.normalizer import Normalizer
from learning_to_adapt_torch.ops.fused_mlp import PackedMLP, fused_mlp_forward


class MetaMLPDynamicsModel:
    def __init__(self, name, env, hidden_sizes=(512, 512), meta_batch_size=10,
                 hidden_nonlinearity='relu', output_nonlinearity=None,
                 batch_size=500, learning_rate=0.001, inner_learning_rate=0.1,
                 normalize_input=True, valid_split_ratio=0.2,
                 rolling_average_persitency=0.99, seed=0,
                 dtype=torch.float32, device='cuda'):
        if output_nonlinearity is not None:
            raise NotImplementedError('the planner kernel has an identity '
                                      'output layer')
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
        self.normalizer = Normalizer.init(self.obs_dim, self.act_dim, dtype,
                                          self.device)

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
        params with a leading env axis."""
        with torch.enable_grad():
            # one broadcast copy of the params per env (a stride-0 view); env
            # e's loss depends on its own copy alone, so the gradient of the
            # summed loss is each env's own gradient
            leaves = self.broadcast_params(
                {k: [p.detach() for p in params[k]] for k in ('w', 'b')},
                obs_n.shape[0])
            flat = leaves['w'] + leaves['b']
            for p in flat:
                p.requires_grad_(True)
            loss = self._mse(leaves, obs_n, act_n, delta_n).sum()
            grads = torch.autograd.grad(loss, flat)
        lr = self.inner_learning_rate
        new = [p.detach() - lr * g for p, g in zip(flat, grads)]
        n_w = len(leaves['w'])
        return {'w': new[:n_w], 'b': new[n_w:]}

    # ------------------------------------------------------------- adapt
    def adapt_fn(self, params, norm, obs, act, obs_next):
        """Per-env fast adaptation. obs/act/obs_next: (n_env, K, d).
        Returns params with a leading env axis."""
        delta = obs_next - obs
        return self.inner_step_fn(params, norm.norm_obs(obs),
                                  norm.norm_act(act), norm.norm_delta(delta))

    # ------------------------------------------------------------- predict
    def predict_adapted_fn(self, adapted_params, norm, obs, act):
        """obs/act: (n_env, n, d), each env's rows through its own params
        (leading env axis; a broadcast view of one set works too), or their
        ops.fused_mlp.pack_weights, which the planner makes once per step.
        The planner path: bf16 products, f32 accumulation, in the fused-MLP
        kernel on the card, which packs unpacked params on every call."""
        x = torch.cat([norm.norm_obs(obs), norm.norm_act(act)], dim=-1)
        p = adapted_params
        ws, bs = (p, None) if isinstance(p, PackedMLP) else (p['w'], p['b'])
        delta = fused_mlp_forward(x, ws, bs, self.hidden_nonlinearity)
        return obs + norm.denorm_delta(delta)

    def predict_fn(self, params, norm, obs, act):
        """Single-parameter-set prediction of rows obs/act (N, d); on the
        card the params are packed for this one call."""
        batched = {k: [p.unsqueeze(0) for p in params[k]] for k in params}
        return self.predict_adapted_fn(batched, norm, obs[None],
                                       act[None])[0]

    def broadcast_params(self, params, n_env):
        """params viewed with a leading env axis of n_env (stride 0, no
        copy): the pre-update parameters for every env."""
        return {k: [p.unsqueeze(0).expand((n_env,) + tuple(p.shape))
                    for p in params[k]] for k in params}
