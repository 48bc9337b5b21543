"""MPC planners (policies/planners.py): random shooting and CEM, each also
in a recurrent form that threads a model's hidden state.

`predict` is any function (obs (N, d), act (N, a)) -> next_obs (N, d), and
`predict_h` its recurrent form (obs, act, hidden) -> (next_obs, hidden').
Candidates use the env-major layout, rows [g*n:(g+1)*n] belong to env g,
so a per-env-adapted model sees its own env's rows as one contiguous block,
and a recurrent model's hidden state is fanned out the same way.

Every planner takes its random draws injected: `candidates`, the uniform
(horizon, n*m, act_dim) actions of random shooting, or `normals`, CEM's
(num_cem_iters, n, m, horizon*act_dim) standard normals. The sampler's
rollout draws them (draw_candidates, draw_normals) for all envs of the mesh
and passes each rank its envs' share; a planner given none draws its own,
in the same order.
"""
from typing import Callable

import torch

from learning_to_adapt_torch.models.optim import tree_map


def _repeat_env_major(x, n):
    """(m, ...) -> (m*n, ...) with each env's row repeated n times
    contiguously (np.repeat semantics)."""
    return torch.repeat_interleave(x, n, dim=0)


def draw_candidates(generator, horizon, rows, act_dim, dtype, device,
                    act_lo=-1.0, act_hi=1.0):
    """Random shooting's uniform candidate actions (horizon, rows,
    act_dim)."""
    u = torch.rand((horizon, rows, act_dim), generator=generator,
                   dtype=dtype, device=device)
    return act_lo + (act_hi - act_lo) * u


def draw_normals(generator, num_cem_iters, n, m, ha, dtype, device):
    """CEM's standard normals (num_cem_iters, n, m, ha), one draw an
    iteration as the planner makes them."""
    return torch.stack([torch.randn((n, m, ha), generator=generator,
                                    dtype=dtype, device=device)
                        for _ in range(num_cem_iters)])


def _uniform_candidates(generator, obs, horizon, rows, act_dim, act_lo,
                        act_hi, candidates):
    if candidates is None:
        return draw_candidates(generator, horizon, rows, act_dim, obs.dtype,
                               obs.device, act_lo, act_hi)
    if tuple(candidates.shape) != (horizon, rows, act_dim):
        raise ValueError(f'candidates shape {tuple(candidates.shape)} != '
                         f'{(horizon, rows, act_dim)}')
    return candidates


def _returns(predict_h, reward_fn, obs0, hidden0, a_seq, discount):
    """Discounted model-rollout returns (rows,) of action sequences a_seq
    (h, rows, act_dim) from obs0, threading hidden0 (None: a feed-forward
    model, called as predict_h(o, a))."""
    o, h = obs0, hidden0
    returns = torch.zeros(obs0.shape[0], dtype=obs0.dtype,
                          device=obs0.device)
    for t in range(a_seq.shape[0]):
        if h is None:
            nxt = predict_h(o, a_seq[t])
        else:
            nxt, h = predict_h(o, a_seq[t], h)
        returns = returns + (discount ** t) * reward_fn(o, a_seq[t], nxt)
        o = nxt
    return returns


def random_shooting(predict: Callable, reward_fn: Callable, obs, generator,
                    *, n_candidates, horizon, act_dim, discount=1.0,
                    act_lo=-1.0, act_hi=1.0, candidates=None):
    """obs: (m, obs_dim). Returns ((m, act_dim) first actions of the best
    candidate sequences, (m, n_candidates) returns)."""
    m = obs.shape[0]
    n = n_candidates
    a = _uniform_candidates(generator, obs, horizon, n * m, act_dim, act_lo,
                            act_hi, candidates)
    returns = _returns(predict, reward_fn, _repeat_env_major(obs, n), None,
                       a, discount).reshape(m, n)
    best = torch.argmax(returns, dim=1)
    first = a[0].reshape(m, n, act_dim)[torch.arange(m, device=obs.device),
                                        best]
    return first, returns


def _cem(returns_fn, obs, generator, n, horizon, act_dim, num_cem_iters,
         percent_elites, alpha, act_lo, act_hi, clip_rollout, normals):
    """The CEM loop over flattened action sequences (m, horizon*act_dim),
    from mean 0 and std 1: each iteration rolls out n candidates per env,
    refits mean and std (the population std) to the top percent_elites of
    them, always on the clipped copy, and smooths the mean by alpha (None:
    no smoothing). Returns (the best first actions of the last iteration,
    (mean, std) of its refit)."""
    m = obs.shape[0]
    ha = horizon * act_dim
    num_elites = max(int(n * percent_elites), 1)
    if normals is not None and tuple(normals.shape) != (
            num_cem_iters, n, m, ha):
        raise ValueError(f'normals shape {tuple(normals.shape)} != '
                         f'{(num_cem_iters, n, m, ha)}')
    mean = torch.zeros((m, ha), dtype=obs.dtype, device=obs.device)
    std = torch.ones((m, ha), dtype=obs.dtype, device=obs.device)
    rows = torch.arange(m, device=obs.device)
    best = None
    for i in range(num_cem_iters):
        z = (normals[i] if normals is not None else
             torch.randn((n, m, ha), generator=generator, dtype=obs.dtype,
                         device=obs.device))
        a_flat = mean + z * std                      # (n, m, h*A)
        a_clip = torch.clamp(a_flat, act_lo, act_hi)
        a_exec = a_clip if clip_rollout else a_flat
        # (n, m, h, A) -> (h, m*n, A): env-major, candidates fastest
        a_seq = a_exec.reshape(n, m, horizon, act_dim).permute(
            2, 1, 0, 3).reshape(horizon, m * n, act_dim)
        returns = returns_fn(a_seq).reshape(m, n)
        elite_idx = torch.topk(returns, num_elites, dim=1).indices  # (m, k)
        elites = torch.gather(a_clip.transpose(0, 1), 1,
                              elite_idx[:, :, None].expand(-1, -1, ha))
        fit_mean = elites.mean(dim=1)
        mean = fit_mean if alpha is None else (mean * alpha +
                                               (1 - alpha) * fit_mean)
        std = torch.std(elites, dim=1, correction=0)
        best = a_seq[0].reshape(m, n, act_dim)[rows, elite_idx[:, 0]]
    return best, (mean, std)


def cem(predict, reward_fn, obs, generator, *, n_candidates, horizon,
        act_dim, discount=1.0, num_cem_iters=8, percent_elites=0.1,
        alpha=0.1, act_lo=-1.0, act_hi=1.0, clip_rollout=True,
        normals=None):
    """Cross-entropy method with mean smoothing alpha. clip_rollout (the
    default) rolls out and returns the clipped actions; False rolls out
    the unclipped Gaussian samples, as the reference does, while the elite
    refit uses the clipped copy either way. Returns ((m, act_dim) actions,
    (mean, std) of the last refit, each (m, horizon*act_dim))."""
    obs0 = _repeat_env_major(obs, n_candidates)
    return _cem(lambda a: _returns(predict, reward_fn, obs0, None, a,
                                   discount),
                obs, generator, n_candidates, horizon, act_dim,
                num_cem_iters, percent_elites, alpha, act_lo, act_hi,
                clip_rollout, normals)


def random_shooting_recurrent(predict_h, reward_fn, obs, hidden, generator,
                              *, n_candidates, horizon, act_dim,
                              discount=1.0, act_lo=-1.0, act_hi=1.0,
                              candidates=None):
    """ReBAL's planner: every candidate starts from its env's hidden state;
    the real hidden state then advances by one prediction with the chosen
    actions. hidden: a tree of tensors with a leading env axis. Returns
    (actions (m, act_dim), new hidden)."""
    m = obs.shape[0]
    n = n_candidates
    a = _uniform_candidates(generator, obs, horizon, n * m, act_dim, act_lo,
                            act_hi, candidates)
    returns = _returns(predict_h, reward_fn, _repeat_env_major(obs, n),
                       tree_map(lambda h: _repeat_env_major(h, n), hidden),
                       a, discount).reshape(m, n)
    best = torch.argmax(returns, dim=1)
    actions = a[0].reshape(m, n, act_dim)[torch.arange(m, device=obs.device),
                                          best]
    _, new_hidden = predict_h(obs, actions, hidden)
    return actions, new_hidden


def cem_recurrent(predict_h, reward_fn, obs, hidden, generator, *,
                  n_candidates, horizon, act_dim, discount=1.0,
                  num_cem_iters=8, percent_elites=0.05, act_lo=-1.0,
                  act_hi=1.0, normals=None):
    """CEM threading the hidden state, with no mean smoothing, rolling out
    the clipped actions; the real hidden state advances by one prediction
    with the chosen actions. Returns (actions (m, act_dim), new hidden)."""
    n = n_candidates
    obs0 = _repeat_env_major(obs, n)
    hidden0 = tree_map(lambda h: _repeat_env_major(h, n), hidden)
    actions, _ = _cem(lambda a: _returns(predict_h, reward_fn, obs0, hidden0,
                                         a, discount),
                      obs, generator, n, horizon, act_dim, num_cem_iters,
                      percent_elites, None, act_lo, act_hi, True, normals)
    _, new_hidden = predict_h(obs, actions, hidden)
    return actions, new_hidden
