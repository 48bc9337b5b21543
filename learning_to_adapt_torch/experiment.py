"""What the port's training entry points share (run_grbal, run_mb_mpc,
run_rebal): the command line, the experiment directory, building env,
sampler and Trainer around an algorithm's model and policy, and the resume.

Each entry point is an `EntryPoint`: its experiment name, its config dict
(a copy of its JAX run script's), a `build(config, env, device) ->
(dynamics_model, policy)` and whether its sample processor keeps the path
axis. Runs go on the card unless config['device'] says otherwise; without a
card they raise before anything is written. Given a mesh
(parallel/mesh.py), a run shards its envs and its fits over the mesh's
ranks, and only rank 0 writes the experiment directory.
"""
import argparse
import json
import os

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.envs import (
    AntEnv, Arm7DofEnv, HalfCheetahBlocksEnv, HalfCheetahEnv,
    HalfCheetahHFieldEnv, normalize)
from learning_to_adapt_torch.samplers import ModelSampleProcessor, Sampler
from learning_to_adapt_torch.trainers import Trainer
from learning_to_adapt_torch.utils import logging as logger, tracing
from learning_to_adapt_torch.utils.checkpoint import resume_trainer
from learning_to_adapt_torch.utils.config import (
    ClassEncoder, add_task_distribution_args, apply_task_distribution_args,
    check_resume_config, task_env_kwargs)

#: the envs --env names: every env of the JAX package
ENVS = {c.__name__: c for c in (HalfCheetahEnv, HalfCheetahHFieldEnv,
                                HalfCheetahBlocksEnv, AntEnv, Arm7DofEnv)}


class EntryPoint:
    def __init__(self, exp_name, module, config, build, recurrent):
        self.exp_name = exp_name
        self.module = module
        self.config = config
        self.build = build
        self.recurrent = recurrent

    def experiment_dir(self, config):
        """data/<exp_name>/<config['exp_name']> under the working
        directory, apart from the JAX package's data/<name>, so a --resume
        never reads a JAX snapshot."""
        return os.path.join(os.getcwd(), 'data', self.exp_name,
                            config.get('exp_name', ''))

    def run_experiment(self, config, mesh=None):
        """Builds env, model, policy and sampler from config, resumes from
        the experiment's params.pkl when config['resume'] is set, trains,
        and returns the Trainer. config['device'] (default 'cuda') places
        every tensor, or with `mesh` the mesh's device: the sampler's envs
        and the model's fit then shard over the mesh's 'env' axis, and the
        ranks other than 0 log and snapshot nothing, so that the ranks do
        not race on one progress.csv. config['spans'] (--spans) turns
        tracing on for the run (utils/tracing.py)."""
        # raises before anything is written when the card is missing
        device = (mesh.device if mesh is not None
                  else resolve_device(config.get('device', 'cuda')))
        exp_dir = self.experiment_dir(config)
        if config.get('resume'):
            # refuse to resume under a mismatched task distribution (would
            # contaminate the holdout split and clobber the recorded config)
            check_resume_config(exp_dir, config)
        if mesh is None or mesh.rank == 0:
            logger.configure(dir=exp_dir,
                             format_strs=['stdout', 'log', 'csv'],
                             snapshot_mode='last')
            with open(os.path.join(exp_dir, 'params.json'), 'w') as f:
                json.dump(config, f, indent=2, sort_keys=True,
                          cls=ClassEncoder)
        else:
            logger.Logger.CURRENT = logger.Logger()  # writes nothing

        env = normalize(config['env'](reset_every_episode=True,
                                      task=config['task'], device=device,
                                      **task_env_kwargs(config)))
        dynamics_model, policy = self.build(config, env, device)
        dynamics_model.mesh = mesh
        # config['n_parallel'] has no counterpart: every env of the batch
        # steps at once on the device
        sampler = Sampler(
            env=env,
            policy=policy,
            seed=config.get('seed', 0),
            max_path_length=config['max_path_length'],
            num_rollouts=config['num_rollouts'],
            adapt_batch_size=config.get('adapt_batch_size'),
            device=device,
            mesh=mesh,
        )

        start_itr = 0
        if config.get('resume'):
            start_itr = resume_trainer(exp_dir, dynamics_model, sampler,
                                       device=device)
            logger.log(f'Resuming from iteration {start_itr}')

        algo = Trainer(
            env=env,
            policy=policy,
            dynamics_model=dynamics_model,
            sampler=sampler,
            sample_processor=ModelSampleProcessor(recurrent=self.recurrent),
            n_itr=config['n_itr'],
            start_itr=start_itr,
            initial_random_samples=config['initial_random_samples'],
            dynamics_model_max_epochs=config['dynamic_model_epochs'],
            config=config,
            profile_dir=(os.path.join(exp_dir, 'profile')
                         if config.get('profile') else None),
        )
        was = tracing.enabled()
        tracing.enable(was or bool(config.get('spans')))
        try:
            algo.train()
        finally:
            tracing.enable(was)
        return algo

    def parse_args(self, argv=None):
        p = argparse.ArgumentParser(
            prog=f'python -m learning_to_adapt_torch.{self.module}')
        p.add_argument('--n_itr', type=int, default=None)
        p.add_argument('--exp_name', type=str, default='')
        p.add_argument('--resume', action='store_true')
        p.add_argument('--seed', type=int, default=0)
        p.add_argument('--profile', action='store_true',
                       help='capture torch.profiler traces of one sampling '
                            'iteration and one model fit into <exp>/profile')
        p.add_argument('--spans', action='store_true',
                       help='record the spans of utils/tracing.py (the '
                            'device parts of the captured steps included); '
                            'each iteration adds their totals to '
                            '<exp>/iterations.jsonl')
        p.add_argument('--env', type=str, default=None,
                       help='env class name (default HalfCheetahEnv); one '
                            f'of {", ".join(sorted(ENVS))}')
        p.add_argument('--task', type=str, default=None,
                       help="task distribution, e.g. 'cripple', 'hfield', "
                            "'damping', 'force'")
        p.add_argument('--device', type=str, default='cuda',
                       help="torch device; 'cpu' runs without a card")
        add_task_distribution_args(p)
        return p.parse_args(argv)

    def config_from_args(self, args):
        """A copy of the config with the command line applied."""
        cfg = dict(self.config)
        if args.env:
            if args.env not in ENVS:
                raise ValueError(f'unknown --env {args.env!r}; the port has '
                                 f'{sorted(ENVS)}')
            cfg['env'] = ENVS[args.env]
        if args.task:
            cfg['task'] = args.task
        apply_task_distribution_args(args, cfg)
        cfg['resume'] = args.resume
        cfg['seed'] = args.seed
        cfg['profile'] = args.profile
        cfg['spans'] = args.spans
        cfg['device'] = args.device
        if args.n_itr:
            cfg['n_itr'] = args.n_itr
        cfg['exp_name'] = args.exp_name
        return cfg

    def main(self, argv=None):
        return self.run_experiment(self.config_from_args(
            self.parse_args(argv)))
