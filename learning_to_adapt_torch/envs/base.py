"""Batched environment API.

Counterpart of learning_to_adapt_tpu/envs/base.py. An environment is a
bundle of functions over an explicit EnvState whose tensors carry a leading
env axis (where the JAX package vmaps over one-env functions):

    reset(n_envs, episode_idx, generator) -> EnvState
    step(state, action)  -> (EnvState, obs, reward, done, info)
    reward(obs, act, next_obs)  # batched planner-side reward

Tasks (dynamics perturbations) are data inside EnvState.mm (a MutableModel)
plus env-specific extras in EnvState.task, resampled per episode from the
second episode on when reset_every_episode is set.
"""
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.physics import engine
from learning_to_adapt_torch.physics.spec import (
    MutableModel, PhysicsModel, batched_mutable, default_mutable)
from learning_to_adapt_torch.utils import logging as logger
from learning_to_adapt_torch.utils.serializable import Serializable

#: joint speed above which a step counts as diverged (envs/base.py:162-171)
UNSTABLE_QVEL = 150.0


@dataclass
class EnvState:
    phys: Any         # PhysicsState, (E, nq) / (E, nv)
    mm: Any           # MutableModel, fields (E, ...)
    task: Any         # dict of env-specific task tensors (cripple_mask (E, nu))
    obs: Any          # (E, obs_dim) current observation
    t: Any            # (E,) int32 steps taken in current episode
    episode: Any      # (E,) int32 episode counter


class TorchEnv(Serializable):
    """Base env: subclasses define model, observation, reward and task
    sampling. Instances hold static config and the nominal model tensors.
    Serializable: pickling replays the constructor, device included, which
    is how envs ride in params.pkl snapshots; a loader may name another
    device (utils/checkpoint.py load_snapshot)."""

    name: str = 'env'

    #: float32 physics, as the JAX envs run by default
    dtype = torch.float32

    def __init__(self, task=None, reset_every_episode=False, device='cuda'):
        if not getattr(self, '_serializable_initialized', False):
            # fallback capture for subclasses that do not quick_init
            Serializable.quick_init(self, locals())
        task = None if task == 'None' else task
        self.task = task
        self.reset_every_episode = reset_every_episode
        self.device = resolve_device(device)
        self.model: PhysicsModel = self._build_model()
        self.mm0: MutableModel = default_mutable(self.model, np.float32)
        self.frame_skip = self.model.frame_skip
        self.dt = self.model.timestep
        self.act_dim = self.model.nu
        self.obs_dim = self._obs_dim()
        lo = self.model.act_ctrlrange[:, 0]
        hi = self.model.act_ctrlrange[:, 1]
        self.action_space_bounds = (self._t(lo), self._t(hi))

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # ---- to implement in subclasses -------------------------------------
    def _build_model(self) -> PhysicsModel:
        raise NotImplementedError

    def _obs_dim(self) -> int:
        raise NotImplementedError

    def observe(self, data: engine.ForwardData, phys) -> torch.Tensor:
        raise NotImplementedError

    def step_reward(self, data, action):
        raise NotImplementedError

    def reward(self, obs, act, next_obs):
        """Batched model-rollout reward from observations only."""
        raise NotImplementedError

    def sample_task(self, generator, mm: MutableModel, task: dict):
        """Returns (mm, task) for freshly sampled tasks, one per env."""
        return mm, task

    def default_task(self, n_envs) -> dict:
        return dict(cripple_mask=torch.ones(
            (n_envs, self.act_dim), dtype=self.dtype, device=self.device))

    def init_state(self, n_envs, generator):
        """Gaussian-perturbed initial (qpos, qvel): qpos sigma .01, qvel
        sigma .1 (envs/base.py init_state)."""
        init_qpos = (self.model.init_qpos if self.model.init_qpos is not None
                     else self.model.qpos0)
        noise = torch.randn((n_envs, self.model.nq + self.model.nv),
                            generator=generator, dtype=self.dtype,
                            device=self.device)
        qpos = self._t(init_qpos) + 0.01 * noise[:, :self.model.nq]
        qvel = 0.1 * noise[:, self.model.nq:]
        return engine.PhysicsState(qpos=qpos, qvel=qvel)

    # ---- generic machinery ----------------------------------------------
    def reset(self, n_envs, episode_idx=0, generator=None) -> EnvState:
        """n_envs fresh episodes. episode_idx is a host int: with
        reset_every_episode the first episode runs the nominal task and
        tasks are drawn from the second on (envs/base.py reset)."""
        mm = batched_mutable(self.mm0, n_envs, self.device, self.dtype)
        task = self.default_task(n_envs)
        if self.task is not None and (not self.reset_every_episode or
                                      episode_idx > 0):
            mm, task = self.sample_task(generator, mm, task)
        phys = self.init_state(n_envs, generator)
        return self.reset_to(phys, mm, task, episode_idx)

    def reset_to(self, phys, mm, task, episode_idx=0) -> EnvState:
        """EnvState for given initial physics state and task."""
        n_envs = phys.qpos.shape[0]
        data = engine.forward(self.model, mm, phys)
        return EnvState(
            phys=phys, mm=mm, task=task, obs=self.observe(data, phys),
            t=torch.zeros(n_envs, dtype=torch.int32, device=self.device),
            episode=torch.full((n_envs,), episode_idx, dtype=torch.int32,
                               device=self.device))

    def step(self, state: EnvState, action):
        """One env step for every env: mask crippled actuators, frame_skip
        physics substeps, recover diverged envs, recompute obs/reward."""
        action = state.task['cripple_mask'] * action
        phys = state.phys
        for _ in range(self.frame_skip):
            phys = engine.step(self.model, state.mm, phys, action)
        # instability recovery, the JAX package's documented deviation from
        # MuJoCo: a diverged env goes back to its pre-step pose at rest, so
        # non-finite states never reach the rollout data
        finite = (torch.isfinite(phys.qpos).all(-1) &
                  torch.isfinite(phys.qvel).all(-1))
        bad = ~finite | (torch.abs(phys.qvel).amax(-1) > UNSTABLE_QVEL)
        bad = bad[:, None]
        phys = engine.PhysicsState(
            qpos=torch.where(bad, state.phys.qpos, phys.qpos),
            qvel=torch.where(bad, torch.zeros_like(phys.qvel), phys.qvel))
        # the applied ctrl fills ForwardData.qfrc_actuator (mj_forward)
        data = engine.forward(self.model, state.mm, phys, ctrl=action)
        obs = self.observe(data, phys)
        reward = self.step_reward(data, action)
        done = torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)
        new_state = EnvState(phys=phys, mm=state.mm, task=state.task,
                             obs=obs, t=state.t + 1, episode=state.episode)
        return new_state, obs, reward, done, {}

    def log_diagnostics(self, paths, prefix=''):
        """Forward-progress stats over collected paths: progress is the
        change in obs[..., -3], the COM x position."""
        obs = paths['observations']
        progs = obs[:, -1, -3] - obs[:, 0, -3]
        logger.logkv(prefix + 'AverageForwardProgress', float(progs.mean()))
        logger.logkv(prefix + 'MaxForwardProgress', float(progs.max()))
        logger.logkv(prefix + 'MinForwardProgress', float(progs.min()))
        logger.logkv(prefix + 'StdForwardProgress', float(progs.std()))

    def body_comvel(self, data, body_name):
        return data.subtree_comvel[:, self.model.body_id(body_name)]

    def body_com(self, data, body_name):
        return data.subtree_com[:, self.model.body_id(body_name)]


class NormalizedEnv(Serializable):
    """Action-normalizing wrapper: planner/policy space is [-1,1]^act_dim,
    rescaled and clipped to the env bounds (envs/base.py NormalizedEnv; its
    optional running obs/reward normalization is not ported)."""

    def __init__(self, env: TorchEnv):
        Serializable.quick_init(self, locals())
        self.wrapped_env = env

    def __getattr__(self, name):
        # never delegate private/dunder lookups
        if name.startswith('_') or name == 'wrapped_env':
            raise AttributeError(name)
        return getattr(self.wrapped_env, name)

    def denormalize_action(self, action):
        lo, hi = self.wrapped_env.action_space_bounds
        scaled = lo + (action + 1.0) * 0.5 * (hi - lo)
        return torch.clamp(scaled, lo, hi)

    def step(self, state, action):
        return self.wrapped_env.step(state, self.denormalize_action(action))

    def reset(self, n_envs, episode_idx=0, generator=None):
        return self.wrapped_env.reset(n_envs, episode_idx, generator)

    def reward(self, obs, act, next_obs):
        # planner actions are normalized; the reward's ctrl cost is taken in
        # planner space, as in the reference
        return self.wrapped_env.reward(obs, act, next_obs)


def normalize(env: TorchEnv) -> NormalizedEnv:
    return NormalizedEnv(env)
