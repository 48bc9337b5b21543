"""HalfCheetah environments: nominal or crippled, on terrain, on blocks
(envs/half_cheetah.py HalfCheetahEnv, HalfCheetahHFieldEnv,
HalfCheetahBlocksEnv).

The obs layout is load-bearing: the planner reward finite-differences
obs[..., -3] (COM x).
"""
import dataclasses

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

    @property
    def _torso(self):
        return self.model.body_id('torso')

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


class HalfCheetahHFieldEnv(HalfCheetahEnv):
    """Cheetah on procedural terrain. Tasks regenerate the heightfield
    profile per episode and per env: 'hfield' draws six random walls, a
    named task ('basin', 'hill', 'gentle', 'steep') fixes one profile, and
    terrain_set draws uniformly among named profiles."""

    name = 'half_cheetah_hfield'

    NAMED_TERRAINS = ('basin', 'hill', 'gentle', 'steep')
    #: named profile -> (wall heights, terrain height hfield_size[2])
    _NAMED = {'basin': ((-1., 1., 0., 0., 0., 0.), 0.55),
              'hill': ((1., -1., 0., 0., 0., 0.), 0.6),
              'gentle': ((1., 1., 1., 1., 1., 1.), 1.0),
              'steep': ((1., 1., 1., 1., 1., 1.), 4.0)}

    def __init__(self, task='hfield', reset_every_episode=False,
                 terrain_set=None, **kw):
        Serializable.quick_init(self, locals())
        self.terrain_set = (tuple(str(t) for t in terrain_set)
                            if terrain_set is not None else None)
        if self.terrain_set is not None and not (self.terrain_set and all(
                t in self.NAMED_TERRAINS for t in self.terrain_set)):
            raise ValueError(f'terrain_set members must be in '
                             f'{self.NAMED_TERRAINS}')
        TorchEnv.__init__(self, task=task,
                          reset_every_episode=reset_every_episode, **kw)
        if self.task not in (None, 'hfield') + self.NAMED_TERRAINS:
            raise ValueError(f'unknown HalfCheetahHFieldEnv task '
                             f'{self.task!r}')

    def _build_model(self):
        return get_model('half_cheetah_hfield')

    def _profile(self, x_walls, height_walls, width, ncol=500):
        """row[x] = sum_i h_i * clip(x - x_i + 1, 0, width), normalized to
        [0, 1], for walls (E, 6): each wall a linear ramp of `width` cells,
        then a plateau. Returns (E, ncol)."""
        xs = torch.arange(ncol, dtype=self.dtype, device=self.device)
        ramp = torch.clamp(xs - x_walls[..., None] + 1.0, 0.0, width)
        row = torch.sum(height_walls[..., None] * ramp, dim=-2)
        lo = row.amin(-1, keepdim=True)
        return (row - lo) / (row.amax(-1, keepdim=True) - lo + 1e-12)

    def _named_profile(self, name):
        """(row (ncol,), size (4,)) of a named terrain variant."""
        heights, size_z = self._NAMED[name]
        walls = self._t([[250., 265., 280., 295., 310., 325.]])
        row = self._profile(walls, self._t([heights]), 15.0)[0]
        return row, self._t([50., 5., size_z, 0.1])

    def sample_task(self, generator, mm, task):
        n_envs = task['cripple_mask'].shape[0]
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        if self.terrain_set is not None:
            rows, sizes = zip(*(self._named_profile(t)
                                for t in self.terrain_set))
            pick = torch.randint(len(self.terrain_set), (n_envs,),
                                 generator=generator, device=self.device)
            return dataclasses.replace(
                mm, hfield_row=torch.stack(rows)[pick],
                hfield_size=torch.stack(sizes)[pick]), task
        if self.task == 'hfield':
            height = 0.2 + 0.8 * torch.rand((n_envs,), **kw)
            # a permutation per env of the six wall positions
            order = torch.argsort(torch.rand((n_envs, 6), **kw), dim=-1)
            walls = self._t([255., 265., 275., 285., 295., 305.])[order]
            sign = torch.where(torch.rand((n_envs, 6), **kw) < 0.5, 1.0,
                               -1.0).to(self.dtype)
            sign[:, :2] = 1.0
            h = (0.2 + 0.4 * torch.rand((n_envs, 6), **kw)) * sign
            row = self._profile(walls, h, 10.0)
            size = torch.stack([torch.full_like(height, 50.),
                                torch.full_like(height, 5.), height,
                                torch.full_like(height, 0.1)], dim=-1)
        else:
            row, size = self._named_profile(self.task)
            row = row.expand(n_envs, -1)
            size = size.expand(n_envs, -1)
        return dataclasses.replace(mm, hfield_row=row, hfield_size=size), task


class HalfCheetahBlocksEnv(HalfCheetahEnv):
    """Cheetah on 8 spring-loaded blocks; obs drops the block dofs
    (qpos[9:], qvel[8:], torso COM: dim 20). task 'damping': the 8 block
    dampings, dof_damping[:8], drawn from U(damping_range) per env."""

    name = 'half_cheetah_blocks'

    def __init__(self, task='damping', reset_every_episode=False,
                 damping_range=(0.0, 10.0), **kw):
        Serializable.quick_init(self, locals())
        self.damping_range = (float(damping_range[0]),
                              float(damping_range[1]))
        if self.damping_range[0] > self.damping_range[1]:
            raise ValueError(f'damping_range {self.damping_range}: lo > hi')
        TorchEnv.__init__(self, task=task,
                          reset_every_episode=reset_every_episode, **kw)
        if self.task not in (None, 'damping'):
            raise ValueError(f'unknown HalfCheetahBlocksEnv task '
                             f'{self.task!r}')

    def _build_model(self):
        return get_model('half_cheetah_blocks')

    def _obs_dim(self):
        return (self.model.nq - 9) + (self.model.nv - 8) + 3

    def observe(self, data, phys):
        return torch.cat([phys.qpos[:, 9:], phys.qvel[:, 8:],
                          data.subtree_com[:, self._torso]], dim=-1)

    def sample_task(self, generator, mm, task):
        n_envs = task['cripple_mask'].shape[0]
        lo, hi = self.damping_range
        damp = lo + (hi - lo) * torch.rand(
            (n_envs, 8), generator=generator, dtype=self.dtype,
            device=self.device)
        return dataclasses.replace(mm, dof_damping=torch.cat(
            [damp, mm.dof_damping[:, 8:]], dim=-1)), task
