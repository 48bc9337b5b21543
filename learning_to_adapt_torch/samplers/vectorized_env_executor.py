"""Host-facing vectorized env executors
(samplers/vectorized_env_executor.py of the JAX package).

Every env steps as one batch on the env's device: the batch axis takes the
place of the reference's in-process loop and of its process pool, so both
names are the same class here. Training uses the Sampler, which never
leaves the device; these executors serve host-driven loops with numpy in
and out, one copy to the host per step.

Auto-reset: an env resets when it is done or when its step count reaches
max_path_length, by a select between a fresh batched reset and the stepped
state. Each env keeps its own episode counter, and tasks are drawn again at
episode boundaries (reset_every_episode).
"""
import dataclasses

import numpy as np
import torch

from learning_to_adapt_torch.envs.base import EnvState
from learning_to_adapt_torch.physics.engine import PhysicsState
from learning_to_adapt_torch.physics.spec import MutableModel


def _select(mask, fresh: EnvState, old: EnvState) -> EnvState:
    """fresh's rows where mask (E,) is set, old's elsewhere."""
    def sel(f, s):
        return torch.where(mask.reshape((-1,) + (1,) * (f.ndim - 1)), f, s)
    mm = MutableModel(**{
        f.name: sel(getattr(fresh.mm, f.name), getattr(old.mm, f.name))
        for f in dataclasses.fields(MutableModel)})
    return EnvState(
        phys=PhysicsState(qpos=sel(fresh.phys.qpos, old.phys.qpos),
                          qvel=sel(fresh.phys.qvel, old.phys.qvel)),
        mm=mm, task={k: sel(fresh.task[k], old.task[k]) for k in old.task},
        obs=sel(fresh.obs, old.obs), t=sel(fresh.t, old.t),
        episode=sel(fresh.episode, old.episode), rng=fresh.rng)


class IterativeEnvExecutor:
    """Batched executor of `num_rollouts` envs (the name is the JAX
    package's; nothing here iterates over envs)."""

    def __init__(self, env, num_rollouts, max_path_length, seed=0):
        self.env = env
        self._num_envs = num_rollouts
        self.max_path_length = max_path_length
        self._device = getattr(env, 'wrapped_env', env).device
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._states = None
        self._episode = np.zeros(num_rollouts, np.int64)

    @property
    def num_envs(self):
        return self._num_envs

    def _fresh(self, episodes):
        """A batched reset, env i at episode episodes[i]: env.reset takes
        one episode index for the batch, and its task gate only asks
        whether it is 0, so a batch that mixes first and later episodes is
        a select between two resets."""
        n = self._num_envs
        later = episodes > 0
        states = self.env.reset(n, int(later.any()), self._generator)
        if later.any() and not later.all():
            first = self.env.reset(n, 0, self._generator)
            states = _select(torch.as_tensor(later, device=self._device),
                             states, first)
        states.episode = torch.as_tensor(episodes, dtype=torch.int32,
                                         device=self._device)
        return states

    def reset(self):
        """Observations (num_envs, obs_dim) of fresh episodes."""
        self._states = self._fresh(self._episode)
        return self._states.obs.cpu().numpy()

    def step(self, actions):
        """(obs, rewards, dones, env_infos) as numpy after one step of
        every env; dones marks the envs that were reset."""
        if self._states is None:
            raise RuntimeError('call reset() first')
        actions = torch.as_tensor(np.asarray(actions),
                                  dtype=self._states.obs.dtype,
                                  device=self._device)
        states, obs, rewards, dones, _ = self.env.step(self._states, actions)
        done = dones | (states.t >= self.max_path_length)
        # the step's one copy to the host
        host = torch.cat([obs, rewards[:, None].to(obs.dtype),
                          done[:, None].to(obs.dtype)], dim=1).cpu().numpy()
        obs_np, rew_np = host[:, :-2], host[:, -2]
        dones_np = host[:, -1] > 0
        if dones_np.any():
            fresh = self._fresh(self._episode + 1)
            states = _select(done, fresh, states)
            self._episode = np.where(dones_np, self._episode + 1,
                                     self._episode)
        self._states = states
        # the host's running obs/reward normalization (NormalizedEnv), a
        # no-op unless enabled, as by default
        maybe_norm = getattr(self.env, 'maybe_normalize', None)
        if maybe_norm is not None:
            outs = [maybe_norm(obs_np[i], rew_np[i])
                    for i in range(self._num_envs)]
            obs_np = np.asarray([o for o, _ in outs])
            rew_np = np.asarray([r for _, r in outs])
        return (obs_np, rew_np, dones_np,
                [{} for _ in range(self._num_envs)])

    def set_tasks(self, tasks=None):
        """Tasks are data drawn inside env.reset; kept for the API."""


#: the reference's process pool: the batch axis plays its role here
ParallelEnvExecutor = IterativeEnvExecutor
