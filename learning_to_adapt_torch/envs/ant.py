"""Ant with the crippled-leg task distribution (envs/ant.py AntEnv).

obs = [qpos, qvel, ximat(torso), subtree_com(torso)] (dim 41); reward =
forward COM velocity + 0.05 (no control or contact cost); task 'cripple'
disables one leg per env, drawn from cripple_set (default legs 0-2: leg 3
is the meta-test holdout): its two actuators are zeroed, its two geoms
halved in radius and half-length and the lower one moved onto the upper
one (collision only: the compiled inertia stays).
"""
import dataclasses

import torch

from learning_to_adapt_torch.envs.base import TorchEnv
from learning_to_adapt_torch.envs.model_defs import get_model
from learning_to_adapt_torch.utils.serializable import Serializable

# actuator pairs and geom pairs per crippled leg id (geom indexing: floor
# 0, torso 1, then (aux, leg, ankle) triples per leg)
_ACT_PAIRS = ((2, 3), (4, 5), (6, 7), (0, 1))
_GEOM_PAIRS = ((3, 4), (6, 7), (9, 10), (12, 13))


class AntEnv(TorchEnv):
    name = 'ant'

    def __init__(self, task='cripple', reset_every_episode=False,
                 cripple_set=(0, 1, 2), **kw):
        """cripple_set: the legs the task distribution draws from; the
        meta-test protocol builds its eval env with cripple_set=(3,)."""
        Serializable.quick_init(self, locals())
        self.cripple_set = tuple(int(g) for g in cripple_set)
        if not self.cripple_set or not all(
                0 <= g <= 3 for g in self.cripple_set):
            raise ValueError(f'cripple_set {self.cripple_set} must hold legs '
                             'in 0..3')
        super().__init__(task=task, reset_every_episode=reset_every_episode,
                         **kw)
        if self.task not in (None, 'cripple'):
            raise ValueError(f'unknown AntEnv task {self.task!r}')
        self._torso = self.model.body_id('torso')
        self._legs = torch.as_tensor(self.cripple_set, device=self.device)
        self._act_pairs = torch.as_tensor(_ACT_PAIRS, device=self.device)
        self._geom_pairs = torch.as_tensor(_GEOM_PAIRS, device=self.device)

    def _build_model(self):
        return get_model('ant')

    def _obs_dim(self):
        return self.model.nq + self.model.nv + 9 + 3

    def observe(self, data, phys):
        return torch.cat([phys.qpos, phys.qvel,
                          data.ximat[:, self._torso].flatten(1),
                          data.subtree_com[:, self._torso]], dim=-1)

    def step_reward(self, data, action):
        return data.subtree_comvel[:, self._torso, 0] + 0.05

    def reward(self, obs, act, next_obs):
        vel = (next_obs[..., -3] - obs[..., -3]) / self.dt
        return vel + 0.05

    def sample_task(self, generator, mm, task):
        n_envs = task['cripple_mask'].shape[0]
        pick = torch.randint(len(self.cripple_set), (n_envs,),
                             generator=generator, device=self.device)
        return self.cripple(mm, task, self._legs[pick])

    def cripple(self, mm, task, legs):
        """(mm, task) with leg legs[e] crippled in env e."""
        n_envs = legs.shape[0]
        rows = torch.arange(n_envs, device=self.device)[:, None]
        mask = torch.ones((n_envs, self.act_dim), dtype=self.dtype,
                          device=self.device)
        mask[rows, self._act_pairs[legs]] = 0.0
        geoms = self._geom_pairs[legs]                       # (E, 2)
        upper, lower = geoms[:, 0], geoms[:, 1]
        geom_size = mm.geom_size.clone(memory_format=torch.contiguous_format)
        geom_pos = mm.geom_pos.clone(memory_format=torch.contiguous_format)
        geom_size[rows, geoms, :2] *= 0.5
        geom_pos[rows[:, 0], lower] = geom_pos[rows[:, 0], upper]
        mm = dataclasses.replace(mm, geom_size=geom_size, geom_pos=geom_pos)
        return mm, dict(task, cripple_mask=mask)
