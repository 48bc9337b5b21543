"""Sampler (samplers/sampler.py): collects `num_rollouts` paths of
`max_path_length` steps per call, all envs batched on one device (every
env of the batch steps at once). With a mesh (parallel/mesh.py) each rank
steps its share of the envs on its own device, and one all_gather a call
brings every path to every rank, so the host-side fit and logging see all
of them.

On a CUDA device (without a mesh, or over nccl) a call replays the
rollout's step captured as CUDA graphs (samplers/rollout.py
CompiledRollout), captured in the first call of each kind (random,
policy), whose `last_seconds` include the capture; on the CPU and over
gloo the step runs eagerly. Either leaves the generator in the same state.

Its state (the generator, the episode counter) is tied to the generator's
device type: a CUDA generator's stream does not continue on the CPU.
"""
import time

import numpy as np
import torch

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.samplers.rollout import make_rollout_fn
from learning_to_adapt_torch.utils import logging as logger, tracing


class Sampler:
    def __init__(self, env, policy, num_rollouts, max_path_length,
                 adapt_batch_size=None, seed=0, device='cuda',
                 ablate_hidden=None, ablate_warmup=16, mesh=None):
        self.env = env
        self.policy = policy
        self.num_rollouts = num_rollouts
        self.max_path_length = max_path_length
        self.adapt_batch_size = adapt_batch_size
        # the recurrent model's adaptation ablation (None | 'zero' |
        # 'frozen', samplers/rollout.py), for evaluation
        self.ablate_hidden = ablate_hidden
        self.ablate_warmup = ablate_warmup
        self.total_samples = num_rollouts * max_path_length
        self.total_timesteps_sampled = 0
        self.device = resolve_device(device)
        self._episode_idx = 0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._fns = {}
        # the env axis shards over the mesh's 'env' axis; every rank seeds
        # its generator alike and draws for all envs (samplers/rollout.py)
        self.mesh = mesh
        par_mesh.shard_rows(mesh, num_rollouts)   # raises unless it divides
        #: seconds of the last obtain_samples call, device work included
        self.last_seconds = None

    def _rollout_fn(self, random):
        if random not in self._fns:
            self._fns[random] = make_rollout_fn(
                self.env, self.policy, self.policy.dynamics_model,
                self.num_rollouts, self.max_path_length,
                adapt_batch_size=self.adapt_batch_size, random=random,
                ablate_hidden=self.ablate_hidden,
                ablate_warmup=self.ablate_warmup, mesh=self.mesh)
        return self._fns[random]

    def graph_counts(self):
        """The captured step graphs of each rollout function made so far,
        by its `random` flag (0 where it runs eagerly)."""
        return {str(k): len(getattr(fn, 'graphs', {}))
                for k, fn in self._fns.items()}

    def obtain_samples(self, log=False, log_prefix='', random=False):
        """Returns a dict of numpy arrays [num_rollouts, T, ...]. The call
        is the span 'rollout.call' (utils/tracing.py)."""
        with tracing.call('rollout.call'):
            t0 = time.time()
            model = self.policy.dynamics_model
            fn = self._rollout_fn(random)
            paths = fn(model.params, model.normalizer, self._generator,
                       self._episode_idx)
            # one device-to-host copy per call, after the whole rollout
            # (with a mesh, of every rank's paths after one all_gather)
            with tracing.span('rollout.gather'):
                paths = par_mesh.gather(self.mesh, paths)
            self.last_seconds = time.time() - t0
        self._episode_idx += 1
        self.total_timesteps_sampled += self.total_samples
        if log:
            logger.logkv(log_prefix + 'TimeStepsCtr',
                         self.total_timesteps_sampled)
            logger.logkv(log_prefix + 'PolicyExecTime', self.last_seconds)
            logger.logkv(log_prefix + 'EnvExecTime', 0.0)  # fused in a step
        return paths

    def update_tasks(self):
        pass  # tasks are resampled inside env.reset (task-as-data)

    # ---- resume fidelity: the generator and the episode counter determine
    # the task/reset sequence, so a resumed run continues the exact stream a
    # fresh run would have produced (utils/checkpoint.py)
    def state_dict(self):
        return dict(generator=self._generator.get_state().numpy(),
                    device_type=self._generator.device.type,
                    episode_idx=self._episode_idx,
                    total_timesteps_sampled=self.total_timesteps_sampled)

    def load_state_dict(self, sd):
        """Refuses the state of another device type's generator: a CUDA
        generator's stream has no CPU counterpart, nor the reverse."""
        recorded = sd.get('device_type', self._generator.device.type)
        if recorded != self._generator.device.type:
            raise ValueError(
                f'the sampler state was recorded from a {recorded} '
                f'generator and cannot continue on '
                f'{self._generator.device.type}: resume on a {recorded} '
                'device to continue its stream')
        self._generator.set_state(torch.from_numpy(
            np.array(sd['generator'], dtype=np.uint8)))
        self._episode_idx = int(sd['episode_idx'])
        self.total_timesteps_sampled = int(sd['total_timesteps_sampled'])


class ModelSampleProcessor:
    """Shapes rollout arrays for model fitting. recurrent=True keeps the
    [n_paths, T, dim] layout (GrBAL/ReBAL); recurrent=False flattens to 2-D
    (MB-MPC)."""

    def __init__(self, recurrent=False):
        self.recurrent = recurrent

    def process_samples(self, paths, log=False, log_prefix=''):
        obs = paths['observations']
        nxt = paths['next_observations']
        act = paths['actions']
        rew = paths['rewards']
        if obs.ndim != 3:
            raise ValueError(f'observations must be [paths, T, d], got '
                             f'{obs.shape}')
        ret = rew.sum(axis=1)
        if log:
            logger.logkv(log_prefix + 'AverageReturn', float(ret.mean()))
            logger.logkv(log_prefix + 'MaxReturn', float(ret.max()))
            logger.logkv(log_prefix + 'MinReturn', float(ret.min()))
            logger.logkv(log_prefix + 'StdReturn', float(ret.std()))
        if self.recurrent:
            return dict(observations=obs, next_observations=nxt, actions=act,
                        rewards=rew, returns=ret)
        d = obs.shape[-1]
        return dict(
            observations=obs.reshape(-1, d),
            next_observations=nxt.reshape(-1, d),
            actions=act.reshape(-1, act.shape[-1]),
            rewards=np.reshape(rew, -1),
            returns=ret)
