"""7-DoF arm reacher with cripple/damping/mass/force task distributions
(envs/arm.py Arm7DofEnv).

obs = [qpos, qvel, com(object) - com(target)] (dim 23); reward =
-|object - target| - 0.005 |a|^2; reset with the fixed goal (0.3, 0.15, 0)
and uniform qvel noise.
"""
import dataclasses

import numpy as np
import torch

from learning_to_adapt_torch.envs.base import TorchEnv
from learning_to_adapt_torch.envs.model_defs import get_model
from learning_to_adapt_torch.physics import engine
from learning_to_adapt_torch.utils import logging as logger
from learning_to_adapt_torch.utils.serializable import Serializable


class Arm7DofEnv(TorchEnv):
    """Tasks, drawn per env: 'cripple' zeroes one of the 7 actuators;
    'damping' draws every dof's damping from U(0, 2) and zeroes the last two
    (the target's y and z; target_x keeps its draw, as the JAX env keeps the
    reference's quirk); 'mass' multiplies the object's compiled mass by 1, 2
    or 3; 'force' pushes the object down with -m g, g ~ U(force_range)."""

    name = 'arm_7dof'

    TASKS = (None, 'cripple', 'damping', 'mass', 'force')

    def __init__(self, task='force', reset_every_episode=False,
                 fixed_goal=False, force_range=(0.1, 2.0), **kw):
        Serializable.quick_init(self, locals())
        self.force_range = (float(force_range[0]), float(force_range[1]))
        if self.force_range[0] > self.force_range[1]:
            raise ValueError(f'force_range {self.force_range}: lo > hi')
        super().__init__(task=task, reset_every_episode=reset_every_episode,
                         **kw)
        if self.task not in self.TASKS:
            raise ValueError(f'unknown Arm7DofEnv task {self.task!r}')
        self._obj = self.model.body_id('object')
        self._tgt = self.model.body_id('target')
        self._goal = self._t([0.3, 0.15, 0.0])
        self._obj_mass0 = self._t(self.model.body_mass0[self._obj])

    def _build_model(self):
        return get_model('arm_7dof')

    def _obs_dim(self):
        return self.model.nq + self.model.nv + 3

    def init_state(self, n_envs, generator):
        """qpos = 0.5 everywhere with the goal written into the target's
        slide joints; qvel ~ U(-.005, .005) with the target at rest."""
        nq, nv = self.model.nq, self.model.nv
        qpos = torch.full((n_envs, nq), 0.5, dtype=self.dtype,
                          device=self.device)
        qpos[:, -3:] = self._goal
        qvel = -0.005 + 0.01 * torch.rand((n_envs, nv), generator=generator,
                                          dtype=self.dtype,
                                          device=self.device)
        qvel[:, -3:] = 0.0
        return engine.PhysicsState(qpos=qpos, qvel=qvel)

    def _to_target(self, data):
        return (data.subtree_com[:, self._obj] -
                data.subtree_com[:, self._tgt])

    def observe(self, data, phys):
        return torch.cat([phys.qpos, phys.qvel, self._to_target(data)],
                         dim=-1)

    def step_reward(self, data, action):
        reward_dist = -torch.linalg.norm(self._to_target(data), dim=-1)
        reward_ctrl = -torch.sum(torch.square(action), dim=-1)
        return reward_dist + 0.01 * 0.5 * reward_ctrl

    def reward(self, obs, act, next_obs):
        reward_dist = -torch.linalg.norm(next_obs[..., -3:], dim=-1)
        reward_ctrl = -torch.sum(torch.square(act), dim=-1)
        return reward_dist + 0.01 * 0.5 * reward_ctrl

    def log_diagnostics(self, paths, prefix=''):
        """Final distance-to-target stats (obs[-3:] is object - target)."""
        obs = paths['observations']
        dist = np.linalg.norm(obs[:, -1, -3:], axis=-1)
        logger.logkv(prefix + 'AverageFinalDistance', float(dist.mean()))
        logger.logkv(prefix + 'MinFinalDistance', float(dist.min()))

    def sample_task(self, generator, mm, task):
        n_envs = task['cripple_mask'].shape[0]
        kw = dict(generator=generator, device=self.device)
        rows = torch.arange(n_envs, device=self.device)
        if self.task == 'cripple':
            crippled = torch.randint(self.act_dim, (n_envs,), **kw)
            mask = torch.ones((n_envs, self.act_dim), dtype=self.dtype,
                              device=self.device)
            mask[rows, crippled] = 0.0
            return mm, dict(task, cripple_mask=mask)
        if self.task == 'damping':
            damp = 2.0 * torch.rand((n_envs, self.model.nv), dtype=self.dtype,
                                    **kw)
            damp[:, -2:] = 0.0
            return dataclasses.replace(mm, dof_damping=damp), task
        if self.task == 'mass':
            mult = torch.randint(1, 4, (n_envs,), **kw).to(self.dtype)
            mass = mm.body_mass.clone(memory_format=torch.contiguous_format)
            mass[:, self._obj] = self._obj_mass0 * mult
            return dataclasses.replace(mm, body_mass=mass), task
        if self.task == 'force':
            lo, hi = self.force_range
            g = lo + (hi - lo) * torch.rand((n_envs,), dtype=self.dtype, **kw)
            xfrc = torch.zeros(mm.xfrc_applied.shape, dtype=self.dtype,
                               device=self.device)
            xfrc[:, self._obj, 2] = -mm.body_mass[:, self._obj] * g
            return dataclasses.replace(mm, xfrc_applied=xfrc), task
        return mm, task
