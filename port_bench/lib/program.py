"""The system under test, built from a configuration file as its entry
point builds it, and the inputs the benchmark makes for it from the seed:
weights, normalizer statistics, fit data. Every input is made on the
device by a generator seeded from the run's seed, in a few large draws,
and a copy is kept for the reference."""
import importlib

import numpy as np
import torch



def sub_seed(seed, *keys):
    """A 63-bit seed derived from the run's seed and keys."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1)] +
                                [int(k) for k in keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def build(config, device):
    """(env, dynamics model, policy) of the configuration, made by its
    entry point's own `build` on its run config."""
    from learning_to_adapt_torch.envs import normalize
    from learning_to_adapt_torch.experiment import ENVS
    entry = importlib.import_module(config['entry'])
    rc = dict(config['run_config'])
    rc['env'] = ENVS[rc['env']]
    env = normalize(rc['env'](
        reset_every_episode=config['physics']['reset_every_episode'],
        task=rc['task'], device=device))
    model, policy = entry.ENTRY.build(rc, env, device)
    return env, model, policy


def weights(hp, gen, device):
    """Xavier-uniform weights (one draw for all layers) and zero biases:
    (ws, bs), lists of f32 tensors on the device."""
    dims = [hp.obs_dim + hp.act_dim] + hp.hidden + [hp.obs_dim]
    sizes = [a * b for a, b in zip(dims[:-1], dims[1:])]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    ws, off = [], 0
    for (a, b), n in zip(zip(dims[:-1], dims[1:]), sizes):
        limit = float(np.sqrt(6.0 / (a + b)))
        ws.append((u[off:off + n] * (2 * limit) - limit).reshape(a, b))
        off += n
    bs = [torch.zeros(b, device=device) for b in dims[1:]]
    return ws, bs


def normalizer_stats(hp, gen, device):
    """Plausible normalizer statistics for the planner: obs and delta
    means and stds, the actions' as a uniform on [-1, 1] gives them."""
    d, a = hp.obs_dim, hp.act_dim
    r = torch.rand(4 * d, generator=gen, device=device)
    return dict(
        obs_mean=r[:d] - 0.5, obs_std=0.5 + r[d:2 * d],
        act_mean=torch.zeros(a, device=device),
        act_std=torch.full((a,), 1 / np.sqrt(3.0), device=device),
        delta_mean=0.02 * (r[2 * d:3 * d] - 0.5),
        delta_std=0.02 + 0.05 * r[3 * d:])


def fit_data(hp, gen, device, lead):
    """(obs, act, next obs) as host f32 arrays with leading shape `lead`
    ((paths, T) or (rows,)): obs around per-dim centres and scales, actions
    uniform on [-1, 1], next obs a small step from obs."""
    d, a = hp.obs_dim, hp.act_dim
    shape = tuple(lead)
    centre = torch.rand(d, generator=gen, device=device) - 0.5
    scale = 0.5 + torch.rand(d, generator=gen, device=device)
    obs = torch.randn(shape + (d,), generator=gen, device=device) * scale \
        + centre
    act = 2 * torch.rand(shape + (a,), generator=gen, device=device) - 1
    nxt = obs + 0.05 * torch.randn(shape + (d,), generator=gen,
                                   device=device)
    return tuple(x.cpu().numpy() for x in (obs, act, nxt))

