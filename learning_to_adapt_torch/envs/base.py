"""Batched environment API.

Counterpart of learning_to_adapt_tpu/envs/base.py. An environment is a
bundle of functions over an explicit EnvState whose tensors carry a leading
env axis (where the JAX package vmaps over one-env functions):

    reset(n_envs, episode_idx, generator) -> EnvState
    step(state, action[, noise])  -> (EnvState, obs, reward, done, info)
    reward(obs, act, next_obs)  # batched planner-side reward

Tasks (dynamics perturbations) are data inside EnvState.mm (a MutableModel)
plus env-specific extras in EnvState.task, resampled per episode from the
second episode on when reset_every_episode is set.
"""
import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.envs import spaces
from learning_to_adapt_torch.envs.env_spec import EnvSpec
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
    rng: Any = None   # torch.Generator of the action noise (the reset's)


def map_state(fn, state: EnvState) -> EnvState:
    """The EnvState of fn applied to each of its tensors; the generator is
    shared."""
    def each(obj):
        return dataclasses.replace(obj, **{
            f.name: fn(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return EnvState(phys=each(state.phys), mm=each(state.mm),
                    task={k: fn(v) for k, v in state.task.items()},
                    obs=fn(state.obs), t=fn(state.t),
                    episode=fn(state.episode), rng=state.rng)


def state_rows(state: EnvState, rows) -> EnvState:
    """The EnvState of the envs at `rows` (a slice of the env axis)."""
    return map_state(lambda x: x[rows], state)


def static_state(state: EnvState) -> EnvState:
    """A copy of `state` whose every tensor is contiguous with storage of
    its own: the MutableModel's broadcast (stride-0) fields are written out
    per env, so that `load_state` can copy any reset's values into it."""
    return map_state(
        lambda x: x.clone(memory_format=torch.contiguous_format), state)


def _tensors(state: EnvState):
    return [state.phys.qpos, state.phys.qvel] + [
        getattr(state.mm, f.name) for f in dataclasses.fields(state.mm)] + [
        state.task[k] for k in sorted(state.task)] + [
        state.obs, state.t, state.episode]


@torch.no_grad()
def load_state(dst: EnvState, src: EnvState):
    """Copies src's tensors into dst's (a `static_state`); raises unless
    the two hold the same task fields."""
    if sorted(dst.task) != sorted(src.task):
        raise ValueError(f'task fields {sorted(src.task)} != the static '
                         f'state\'s {sorted(dst.task)}')
    for d, s in zip(_tensors(dst), _tensors(src), strict=True):
        d.copy_(s)


class TorchEnv(Serializable):
    """Base env: subclasses define model, observation, reward and task
    sampling. Instances hold static config and the nominal model tensors.
    Serializable: pickling replays the constructor, device included, which
    is how envs ride in params.pkl snapshots; a loader may name another
    device (utils/checkpoint.py load_snapshot)."""

    name: str = 'env'

    def __init__(self, task=None, reset_every_episode=False, frame_skip=None,
                 action_noise=0.0, dtype=torch.float32,
                 instability_recovery=True, device='cuda'):
        """frame_skip overrides the model's physics steps per env step;
        action_noise adds 0.5 (hi - lo) action_noise N(0, 1) to the masked
        action; dtype is the physics' (float32, as the JAX envs run by
        default, or float64); instability_recovery=False gives the raw
        engine output (the physics-parity mode of the JAX env)."""
        if not getattr(self, '_serializable_initialized', False):
            # fallback capture for subclasses that do not quick_init
            Serializable.quick_init(self, locals())
        task = None if task == 'None' else task
        self.task = task
        self.reset_every_episode = reset_every_episode
        self.action_noise = action_noise
        self.instability_recovery = instability_recovery
        self.dtype = dtype
        self.device = resolve_device(device)
        self.model: PhysicsModel = self._build_model()
        self.mm0: MutableModel = default_mutable(
            self.model, np.float64 if dtype == torch.float64 else np.float32)
        self.frame_skip = (frame_skip if frame_skip is not None
                           else self.model.frame_skip)
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
        return self.reset_to(phys, mm, task, episode_idx, generator)

    def reset_to(self, phys, mm, task, episode_idx=0, rng=None) -> EnvState:
        """EnvState for given initial physics state and task; rng is the
        generator the action noise draws from."""
        n_envs = phys.qpos.shape[0]
        data = engine.forward(self.model, mm, phys)
        return EnvState(
            phys=phys, mm=mm, task=task, obs=self.observe(data, phys),
            t=torch.zeros(n_envs, dtype=torch.int32, device=self.device),
            episode=torch.full((n_envs,), episode_idx, dtype=torch.int32,
                               device=self.device), rng=rng)

    def step(self, state: EnvState, action, noise=None):
        """One env step for every env: mask crippled actuators, add the
        action noise (its N(0, 1) draw from state.rng, or `noise` when
        given), frame_skip physics substeps, recover diverged envs,
        recompute obs/reward."""
        action = state.task['cripple_mask'] * action
        if self.action_noise > 0:
            if noise is None:
                noise = torch.randn(action.shape, generator=state.rng,
                                    dtype=action.dtype, device=action.device)
            lo, hi = self.action_space_bounds
            action = action + 0.5 * (hi - lo) * (self.action_noise * noise)
        phys = state.phys
        for _ in range(self.frame_skip):
            phys = engine.step(self.model, state.mm, phys, action)
        if self.instability_recovery:
            # the JAX package's documented deviation from MuJoCo: a
            # diverged env goes back to its pre-step pose at rest, so
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
                             obs=obs, t=state.t + 1, episode=state.episode,
                             rng=state.rng)
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

    @property
    def action_space(self):
        """Box of the actuators' ctrlrange."""
        return spaces.Box(self.model.act_ctrlrange[:, 0],
                          self.model.act_ctrlrange[:, 1])

    @property
    def observation_space(self):
        big = 1e6
        return spaces.Box(-big * np.ones(self.obs_dim),
                          big * np.ones(self.obs_dim))

    @property
    def spec(self):
        return EnvSpec(self.observation_space, self.action_space)


class NormalizedEnv(Serializable):
    """Action-normalizing wrapper: planner/policy space is [-1,1]^act_dim,
    rescaled and clipped to the env bounds (envs/base.py NormalizedEnv).

    Optional running mean/std normalization of one env's observation and
    reward on the host (maybe_normalize), off by default as in every run
    script; the sampler always consumes raw observations. scale_reward is
    ignored (a hard-coded 1), as in the JAX wrapper."""

    def __init__(self, env: TorchEnv, scale_reward=1.0, normalize_obs=False,
                 normalize_reward=False, obs_alpha=0.001, reward_alpha=0.001):
        Serializable.quick_init(self, locals())
        self.wrapped_env = env
        self._normalize_obs = normalize_obs
        self._normalize_reward = normalize_reward
        self._obs_alpha = obs_alpha
        self._obs_mean = np.zeros(env.obs_dim)
        self._obs_var = np.ones(env.obs_dim)
        self._reward_alpha = reward_alpha
        self._reward_mean = 0.0
        self._reward_var = 1.0

    def _update_obs_estimate(self, obs):
        a = self._obs_alpha
        self._obs_mean = (1 - a) * self._obs_mean + a * obs
        self._obs_var = (1 - a) * self._obs_var + \
            a * np.square(obs - self._obs_mean)

    def _update_reward_estimate(self, reward):
        a = self._reward_alpha
        self._reward_mean = (1 - a) * self._reward_mean + a * reward
        self._reward_var = (1 - a) * self._reward_var + \
            a * np.square(reward - self._reward_mean)

    def maybe_normalize(self, obs, reward):
        """(obs, reward) of one env step through the running normalization
        (exponential moving averages with rates obs_alpha / reward_alpha);
        a no-op unless enabled."""
        if self._normalize_obs:
            obs = (obs.detach().cpu().numpy() if torch.is_tensor(obs)
                   else np.asarray(obs))
            self._update_obs_estimate(obs)
            obs = (obs - self._obs_mean) / (np.sqrt(self._obs_var) + 1e-8)
        if self._normalize_reward:
            reward = float(reward)
            self._update_reward_estimate(reward)
            reward = reward / (np.sqrt(self._reward_var) + 1e-8)
        return obs, reward

    def __getattr__(self, name):
        # never delegate private/dunder lookups
        if name.startswith('_') or name == 'wrapped_env':
            raise AttributeError(name)
        return getattr(self.wrapped_env, name)

    @property
    def action_space(self):
        d = self.wrapped_env.act_dim
        return spaces.Box(-np.ones(d), np.ones(d))

    def denormalize_action(self, action):
        lo, hi = self.wrapped_env.action_space_bounds
        scaled = lo + (action + 1.0) * 0.5 * (hi - lo)
        return torch.clamp(scaled, lo, hi)

    def step(self, state, action, noise=None):
        return self.wrapped_env.step(state, self.denormalize_action(action),
                                     noise)

    def reset(self, n_envs, episode_idx=0, generator=None):
        return self.wrapped_env.reset(n_envs, episode_idx, generator)

    def reward(self, obs, act, next_obs):
        # planner actions are normalized; the reward's ctrl cost is taken in
        # planner space, as in the reference
        return self.wrapped_env.reward(obs, act, next_obs)


def normalize(env: TorchEnv) -> NormalizedEnv:
    return NormalizedEnv(env)
