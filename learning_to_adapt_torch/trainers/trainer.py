"""Training orchestration (trainers/trainer.py).

Per-iteration loop: obtain samples (uniform-random actions on iteration 0
when initial_random_samples) -> process -> fit dynamics model -> log named
timing segments (Time-EnvSampling / Time-EnvSampleProc / Time-ModelFit) ->
snapshot. The progress.csv keys and their order are the JAX trainer's;
what the port adds goes to iterations.jsonl beside it (`record_iteration`).
"""
import contextlib
import json
import os
import time

import torch

from learning_to_adapt_torch.models import captured
from learning_to_adapt_torch.utils import logging as logger, tracing


class Trainer:
    def __init__(self, env, sampler, sample_processor, policy, dynamics_model,
                 n_itr, start_itr=0, initial_random_samples=True,
                 dynamics_model_max_epochs=200, config=None,
                 profile_dir=None):
        self.env = env
        self.sampler = sampler
        self.sample_processor = sample_processor
        self.policy = policy
        self.dynamics_model = dynamics_model
        self.n_itr = n_itr
        self.start_itr = start_itr
        self.initial_random_samples = initial_random_samples
        self.dynamics_model_max_epochs = dynamics_model_max_epochs
        self.config = config
        # torch.profiler trace target (--profile): one sampling pass and one
        # model fit, the device-level layer of the Time-* wall-clock metrics
        # (utils/profiling.py)
        self.profile_dir = profile_dir

    def train(self):
        t_start = time.time()
        for itr in range(self.start_itr, self.n_itr):
            itr_t0 = time.time()
            logger.log(f'\n ---------------- Iteration {itr} ----------------')

            t = time.time()
            random = itr == 0 and self.initial_random_samples
            if random:
                logger.log('Obtaining random samples from the environment...')
            else:
                logger.log('Obtaining samples from the environment using '
                           'the policy...')
            # trace a steady iteration: the first policy iteration is
            # start_itr+1 only when itr 0 is actually random
            # (initial_random_samples AND a fresh run — on a resumed run
            # itr start_itr already plans), and steady state is one
            # iteration after that (clamped so short runs still produce a
            # trace)
            itr0_random = self.initial_random_samples and self.start_itr == 0
            steady = self.start_itr + (2 if itr0_random else 1)
            do_trace = (self.profile_dir is not None
                        and itr == min(steady, self.n_itr - 1))
            if do_trace:
                from learning_to_adapt_torch.utils.profiling import (
                    device_trace)
                sampling_ctx = device_trace(
                    os.path.join(self.profile_dir, 'sampling'))
                fit_ctx = device_trace(os.path.join(self.profile_dir, 'fit'))
            else:
                sampling_ctx = fit_ctx = contextlib.nullcontext()
            with sampling_ctx:
                paths = self.sampler.obtain_samples(
                    log=True, log_prefix='EnvSampler-', random=random)
            logger.logkv('Time-EnvSampling', time.time() - t)

            logger.log('Processing environment samples...')
            t = time.time()
            samples = self.sample_processor.process_samples(
                paths, log=True, log_prefix='EnvTrajs-')
            base_env = getattr(self.env, 'wrapped_env', self.env)
            if hasattr(base_env, 'log_diagnostics'):
                base_env.log_diagnostics(paths, prefix='EnvTrajs-')
            logger.logkv('Time-EnvSampleProc', time.time() - t)

            t = time.time()
            logger.log('Training dynamics model for '
                       f'{self.dynamics_model_max_epochs} epochs...')
            with fit_ctx:
                self.dynamics_model.fit(
                    samples['observations'], samples['actions'],
                    samples['next_observations'],
                    epochs=self.dynamics_model_max_epochs,
                    verbose=True, log_tabular=True, logger=logger)
            logger.logkv('Time-ModelFit', time.time() - t)

            logger.logkv('Itr', itr)
            logger.logkv('n_timesteps', self.sampler.total_timesteps_sampled)
            logger.logkv('Time', time.time() - t_start)
            logger.logkv('ItrTime', time.time() - itr_t0)

            logger.log('Saving snapshot...')
            t = time.time()
            logger.save_itr_params(itr, self.get_itr_snapshot(itr))
            logger.logkv('Time-Snapshot', time.time() - t)

            logger.dumpkvs()
            self.record_iteration(itr)
        logger.log('Training finished')

    def record_iteration(self, itr):
        """Appends one JSON line to iterations.jsonl in the log directory
        (none where the logger writes nothing): the fit's captured shape
        keys, the sampler's captured step graphs, on the card the
        allocated, peak and reserved bytes and, with tracing on (--spans),
        the iteration's span totals (utils/tracing.py totals(); the records
        are cleared after), the process's counters so far (the graphs
        captured, `graph.captures`, and their seconds: a count that rises
        after the first iterations is a step captured again) and its
        kernel launches so far (models/captured.py kernel_counts). A --resume
        appends to it, and its process captures anew."""
        log_dir = logger.get_dir()
        if log_dir is None:
            return
        model = self.dynamics_model
        rec = dict(itr=itr,
                   fit_keys=[list(k) for k in
                             getattr(model, '_epoch_cache', {})],
                   sampler_graphs=self.sampler.graph_counts())
        if model.device.type == 'cuda':
            rec.update(mem_allocated=torch.cuda.memory_allocated(model.device),
                       mem_peak=torch.cuda.max_memory_allocated(model.device),
                       mem_reserved=torch.cuda.memory_reserved(model.device))
        if tracing.enabled():
            rec['spans'] = tracing.totals()
            rec['counters'] = tracing.counters()
            rec['kernels'] = captured.kernel_counts()
            tracing.reset()
        with open(os.path.join(log_dir, 'iterations.jsonl'), 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def get_itr_snapshot(self, itr):
        # the env rides along as a Serializable (constructor replay); model,
        # optimizer and sampler state as explicit state dicts of numpy
        # arrays. include_data=True: a --resume'd run continues with the
        # SAME aggregated dataset + split RNG + sampler generator a
        # straight-through run would have (tests/test_torch_train.py)
        return dict(itr=itr,
                    env=self.env,
                    dynamics_model=self.dynamics_model.state_dict(
                        include_data=True),
                    sampler=self.sampler.state_dict(),
                    config=self.config)
