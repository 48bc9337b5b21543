"""Input/output normalization statistics for dynamics models
(models/normalizer.py): per-dimension mean/std over (obs, act, delta),
epsilon 1e-10 in both directions."""
from collections.abc import Mapping
from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch

EPS = 1e-10


@dataclass
class Normalizer:
    obs_mean: Any
    obs_std: Any
    act_mean: Any
    act_std: Any
    delta_mean: Any
    delta_std: Any

    @staticmethod
    def init(obs_dim, act_dim, dtype=torch.float32, device='cpu'):
        def z(n):
            return torch.zeros(n, dtype=dtype, device=device)

        def o(n):
            return torch.ones(n, dtype=dtype, device=device)
        return Normalizer(z(obs_dim), o(obs_dim), z(act_dim), o(act_dim),
                          z(obs_dim), o(obs_dim))

    @staticmethod
    def fit(obs, act, delta, weights=None):
        """Compute stats over leading axes; optional per-row weights mask
        (for padded ring buffers)."""
        def stats(x):
            dims = tuple(range(x.ndim - 1))
            if weights is None:
                m = torch.mean(x, dim=dims)
                s = torch.std(x, dim=dims, correction=0)
            else:
                w = weights / torch.clamp(weights.sum(), min=1.0)
                wx = w.reshape(w.shape + (1,) * (x.ndim - w.ndim))
                m = torch.sum(wx * x, dim=dims)
                var = torch.sum(wx * torch.square(x - m), dim=dims)
                s = torch.sqrt(torch.clamp(var, min=0.0))
            return m, s
        om, os_ = stats(obs)
        am, as_ = stats(act)
        dm, ds = stats(delta)
        return Normalizer(om, os_, am, as_, dm, ds)

    def norm_obs(self, obs):
        return (obs - self.obs_mean) / (self.obs_std + EPS)

    def norm_act(self, act):
        return (act - self.act_mean) / (self.act_std + EPS)

    def norm_delta(self, delta):
        return (delta - self.delta_mean) / (self.delta_std + EPS)

    def denorm_delta(self, delta_n):
        return delta_n * (self.delta_std + EPS) + self.delta_mean


def normalizer_to_numpy(norm):
    return {f.name: getattr(norm, f.name).cpu().numpy()
            for f in fields(Normalizer)}


def normalizer_from_numpy(stats, device, dtype=torch.float32):
    """Normalizer from arrays: a mapping or an object with the six fields
    (e.g. jax.device_get of the JAX package's model.normalizer)."""
    def get(name):
        v = stats[name] if isinstance(stats, Mapping) else getattr(stats, name)
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)
    return Normalizer(**{f.name: get(f.name) for f in fields(Normalizer)})
