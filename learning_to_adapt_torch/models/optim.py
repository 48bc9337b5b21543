"""The models' optimizer and the parameter trees it walks.

A parameter tree is a dict, list or tuple nesting of tensors, such as the
MLPs' {'w': [...], 'b': [...]} or the recurrent model's
{'cells': [{'wi', 'wh', 'b'}, ...], 'out': {'w': [...], 'b': [...]}}.
Leaves are visited in JAX's order (dict keys sorted), so a global norm sums
them as optax does.
"""
from dataclasses import fields

import numpy as np
import torch

from learning_to_adapt_torch.models.normalizer import Normalizer
from learning_to_adapt_torch.ops import clip_adam


def tree_leaves(tree):
    """The tensors (or arrays) of a tree, in JAX's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped as `template` holding `leaves` (tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(template)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def tree_to_numpy(tree):
    return tree_map(lambda p: p.detach().cpu().numpy(), tree)


def tree_from_numpy(tree, device, dtype=torch.float32):
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                           device=device), tree)


class ClipAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(learning_rate)) on
    any parameter tree: the global norm clip `g if norm < max_norm else
    g / norm * max_norm` (not clip_grad_norm_'s max_norm / (norm + 1e-6)),
    then Adam with optax's bias correction. The state is dict(count, mu,
    nu), mu and nu shaped as the params, on the params' device; nothing here
    reads a device value on the host.

    `step_` updates leaf lists in place (the fits' static state, which a
    CUDA graph replays): on the card one hand-written kernel over all
    leaves, on the CPU its plain version (ops/clip_adam.py, which defines
    the arithmetic). `update` is its functional form on trees."""

    def __init__(self, learning_rate, max_norm=100.0, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.learning_rate = learning_rate
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        leaf = tree_leaves(params)[0]
        return dict(count=torch.zeros((), dtype=torch.int32,
                                      device=leaf.device),
                    mu=tree_map(torch.zeros_like, params),
                    nu=tree_map(torch.zeros_like, params))

    def step_(self, params, grads, count, mu, nu):
        """One clip + Adam step in place (ops/clip_adam.py `clip_adam_`):
        params, mu and nu are lists of leaves in JAX's order, grads the
        gradients, count the int32 0-d step count. On CUDA tensors one
        kernel over all leaves (contiguous f32, grads only read); on the
        CPU the plain torch._foreach_* chain (any layout, grads
        overwritten: clipped)."""
        clip_adam.clip_adam_(params, grads, count, mu, nu,
                             self.learning_rate, self.max_norm, self.b1,
                             self.b2, self.eps)

    def update(self, grads, state, params):
        """Returns (new params, new state): step_ on copies."""
        new = [p.detach().clone() for p in tree_leaves(params)]
        count = state['count'].clone()
        mu = [m.clone() for m in tree_leaves(state['mu'])]
        nu = [v.clone() for v in tree_leaves(state['nu'])]
        self.step_(new, [g.clone() for g in tree_leaves(grads)], count, mu,
                   nu)
        return tree_unflatten(params, new), dict(
            count=count, mu=tree_unflatten(params, mu),
            nu=tree_unflatten(params, nu))


def adam_state_to_numpy(opt_state):
    return dict(count=opt_state['count'].cpu().numpy(),
                mu=tree_to_numpy(opt_state['mu']),
                nu=tree_to_numpy(opt_state['nu']))


def adam_state_from_numpy(opt, device, dtype=torch.float32):
    return dict(count=torch.tensor(np.asarray(opt['count']),
                                   dtype=torch.int32, device=device),
                mu=tree_from_numpy(opt['mu'], device, dtype),
                nu=tree_from_numpy(opt['nu'], device, dtype))


def state_from_jax_numpy(sd):
    """A JAX model's state_dict(...) after jax.device_get, in the port's
    state_dict layout: optax's chain state (EmptyState,
    (ScaleByAdamState(count, mu, nu), EmptyState)) becomes dict(count, mu,
    nu), the normalizer a dict of its six fields; the trees keep their
    shapes (a leading member or env axis included), and dataset buffers
    and the host RNG state carry over as they are."""
    _, (adam, _) = sd['opt_state']
    norm = sd['normalizer']

    def arrays(t):
        return tree_map(np.asarray, t)
    return dict(sd, params=arrays(sd['params']),
                opt_state=dict(count=np.asarray(adam.count),
                               mu=arrays(adam.mu), nu=arrays(adam.nu)),
                normalizer={f.name: np.asarray(getattr(norm, f.name))
                            for f in fields(Normalizer)})
