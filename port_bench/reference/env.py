"""The crippled HalfCheetah as the reference runs it: the reset's random
draws, one env step and the observation, on the reference's C++ physics
(reference/oracle.py) in f64. What it follows is the task's published
definition as the program's env states it: obs = [qpos[1:], qvel, torso
subtree COM]; reward = torso COM x velocity - 0.05 |ctrl|^2; task
'cripple' zeroes one actuator drawn from the cripple set; the reset
perturbs qpos by 0.01 and qvel by 0.1 standard normals; a step whose joint
speeds pass 150, or are not finite, goes back to its pre-step pose at
rest."""
import numpy as np
import torch

from . import oracle
from .physics import model_defs, spec

UNSTABLE_QVEL = 150.0


class Cheetah:
    def __init__(self, config, device):
        self.model = model_defs.get_model(config['physics']['model'])
        self.native = oracle.Native(self.model)
        self.mm = spec.default_mutable(self.model, np.float64)
        self.device = torch.device(device)
        self.task = config['run_config']['task']
        self.cripple_set = tuple(config['physics']['cripple_set'])
        self.reset_every_episode = config['physics']['reset_every_episode']
        self.frame_skip = self.model.frame_skip
        self.dt = self.model.timestep
        self.torso = self.model.body_id('torso')

    def reset_draws(self, generator, n, episode_idx):
        """(qpos, qvel, cripple mask) of n envs, f32, drawn from generator
        in the task's order: the crippled actuators first, then the
        Gaussian perturbation of the pose."""
        dev, f32 = self.device, torch.float32
        mask = torch.ones((n, self.model.nu), dtype=f32, device=dev)
        if self.task is not None and (not self.reset_every_episode or
                                      episode_idx > 0):
            pick = torch.randint(len(self.cripple_set), (n,),
                                 generator=generator, device=dev)
            ids = torch.as_tensor(self.cripple_set, device=dev)[pick]
            mask[torch.arange(n, device=dev), ids] = 0.0
        m = self.model
        noise = torch.randn((n, m.nq + m.nv), generator=generator,
                            dtype=f32, device=dev)
        init = m.init_qpos if m.init_qpos is not None else m.qpos0
        qpos = torch.as_tensor(np.asarray(init), dtype=f32,
                               device=dev) + 0.01 * noise[:, :m.nq]
        return qpos, 0.1 * noise[:, m.nq:], mask

    def _observe(self, qpos, qvel):
        com, comvel = self.native.forward(qpos, qvel, self.mm)
        return (np.concatenate([qpos[1:], qvel, com[self.torso]]),
                comvel[self.torso])

    def observe(self, qpos, qvel):
        """The observations (E, obs) of states (E, nq), (E, nv), f64."""
        q, v = (x.detach().cpu().double().numpy() for x in (qpos, qvel))
        obs = np.stack([self._observe(a, b)[0] for a, b in zip(q, v)])
        return torch.as_tensor(obs, device=qpos.device)

    def step(self, qpos, qvel, action, mask, rounding=None):
        """One env step of each row from (qpos, qvel) with planner-space
        actions in [-1, 1]: (qpos', qvel', obs', reward), f64 tensors on
        the inputs' device. rounding: None for f64 products, 'tf32' for
        the control's."""
        m = self.model
        q0, v0, a, k = (x.detach().cpu().double().numpy()
                        for x in (qpos, qvel, action, mask))
        lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
        ctrl = k * np.clip(lo + (a + 1.0) * 0.5 * (hi - lo), lo, hi)
        rows = []
        for q, v, c in zip(q0, v0, ctrl):
            q1, v1 = q, v
            for _ in range(self.frame_skip):
                q1, v1 = self.native.step(q1, v1, c, self.mm, rounding)
            if (not (np.isfinite(q1).all() and np.isfinite(v1).all()) or
                    np.abs(v1).max() > UNSTABLE_QVEL):
                q1, v1 = q, np.zeros_like(v)
            obs, comvel = self._observe(q1, v1)
            rows.append((q1, v1, obs, comvel[0] - 0.1 * 0.5 * c @ c))
        dev = qpos.device
        return tuple(torch.as_tensor(np.stack([r[i] for r in rows]),
                                     device=dev) for i in range(4))
