"""HalfCheetah, nominal or crippled (envs/half_cheetah.py HalfCheetahEnv).

The obs layout is load-bearing: the planner reward finite-differences
obs[..., -3] (COM x).
"""
import torch

from learning_to_adapt_torch.envs.base import TorchEnv
from learning_to_adapt_torch.envs.model_defs import get_model
from learning_to_adapt_torch.utils.serializable import Serializable


class HalfCheetahEnv(TorchEnv):
    """obs = [qpos[1:], qvel, subtree_com(torso)] (dim 20).

    task 'cripple': zero one actuator drawn from cripple_set (default 1..5;
    bthigh, actuator 0, is never crippled)."""

    name = 'half_cheetah'

    def __init__(self, task='cripple', reset_every_episode=False,
                 cripple_set=None, **kw):
        Serializable.quick_init(self, locals())
        self.cripple_set = (tuple(int(a) for a in cripple_set)
                            if cripple_set is not None
                            else tuple(range(1, 6)))
        super().__init__(task=task, reset_every_episode=reset_every_episode,
                         **kw)
        if not self.cripple_set or not all(
                1 <= a < self.act_dim for a in self.cripple_set):
            raise ValueError(f'cripple_set {self.cripple_set} must hold '
                             f'actuators in 1..{self.act_dim - 1}')
        if self.task not in (None, 'cripple'):
            raise ValueError(f'unknown HalfCheetah task {self.task!r}')
        self._cripple_ids = torch.as_tensor(self.cripple_set,
                                            device=self.device)
        self._torso = self.model.body_id('torso')

    def _build_model(self):
        return get_model('half_cheetah')

    def _obs_dim(self):
        return (self.model.nq - 1) + self.model.nv + 3

    def observe(self, data, phys):
        return torch.cat([phys.qpos[:, 1:], phys.qvel,
                          data.subtree_com[:, self._torso]], dim=-1)

    def step_reward(self, data, action):
        ctrl_cost = 1e-1 * 0.5 * torch.sum(torch.square(action), dim=-1)
        return data.subtree_comvel[:, self._torso, 0] - ctrl_cost

    def reward(self, obs, act, next_obs):
        ctrl_cost = 1e-1 * 0.5 * torch.sum(torch.square(act), dim=-1)
        forward = (next_obs[..., -3] - obs[..., -3]) / self.dt
        return forward - ctrl_cost

    def sample_task(self, generator, mm, task):
        n_envs = task['cripple_mask'].shape[0]
        pick = torch.randint(len(self.cripple_set), (n_envs,),
                             generator=generator, device=self.device)
        crippled = self._cripple_ids[pick]
        mask = torch.ones((n_envs, self.act_dim), dtype=self.dtype,
                          device=self.device)
        mask[torch.arange(n_envs, device=self.device), crippled] = 0.0
        return mm, dict(task, cripple_mask=mask)
