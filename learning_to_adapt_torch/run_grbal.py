"""GrBAL on the port: a MAML dynamics model + MPC with per-step fast
adaptation inside the rollout, meta-trained by `Trainer.train`
(run_scripts/run_grbal.py, whose config dict this module copies).

    python -m learning_to_adapt_torch.run_grbal --task cripple [--n_itr N]
        [--exp_name NAME] [--resume] [--seed S] [--profile] [--device cpu]

Runs on the card unless --device cpu is given; without a card and without
--device cpu it raises. Writes progress.csv, params.json, params.pkl and
log.txt to data/grbal_torch/<exp_name> under the working directory, apart
from the JAX package's data/grbal, so a --resume never reads a JAX snapshot.
"""
import argparse
import json
import os

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.envs import HalfCheetahEnv, normalize
from learning_to_adapt_torch.models import MetaMLPDynamicsModel
from learning_to_adapt_torch.policies import MPCController
from learning_to_adapt_torch.samplers import ModelSampleProcessor, Sampler
from learning_to_adapt_torch.trainers import Trainer
from learning_to_adapt_torch.utils import logging as logger
from learning_to_adapt_torch.utils.checkpoint import resume_trainer
from learning_to_adapt_torch.utils.config import (
    ClassEncoder, add_task_distribution_args, apply_task_distribution_args,
    check_resume_config, task_env_kwargs)

EXP_NAME = 'grbal_torch'

#: envs the port has; the JAX package's other four (HalfCheetahHFieldEnv,
#: HalfCheetahBlocksEnv, AntEnv, Arm7DofEnv) are ROADMAP queue 1, item 8
ENVS = {c.__name__: c for c in (HalfCheetahEnv,)}


def experiment_dir(config):
    return os.path.join(os.getcwd(), 'data', EXP_NAME,
                        config.get('exp_name', ''))


def run_experiment(config):
    """Builds env, model, policy and sampler from config, resumes from
    the experiment's params.pkl when config['resume'] is set, trains, and
    returns the Trainer. config['device'] (default 'cuda') places every
    tensor."""
    # raises before anything is written when the card is missing
    device = resolve_device(config.get('device', 'cuda'))
    exp_dir = experiment_dir(config)
    if config.get('resume'):
        # refuse to resume under a mismatched task distribution (would
        # contaminate the holdout split and clobber the recorded config)
        check_resume_config(exp_dir, config)
    logger.configure(dir=exp_dir, format_strs=['stdout', 'log', 'csv'],
                     snapshot_mode='last')
    with open(os.path.join(exp_dir, 'params.json'), 'w') as f:
        json.dump(config, f, indent=2, sort_keys=True, cls=ClassEncoder)

    env_kw = task_env_kwargs(config)
    env = normalize(config['env'](reset_every_episode=True,
                                  task=config['task'], device=device,
                                  **env_kw))

    dynamics_model = MetaMLPDynamicsModel(
        name='dyn_model',
        env=env,
        seed=config.get('seed', 0),
        meta_batch_size=config['meta_batch_size'],
        inner_learning_rate=config['inner_learning_rate'],
        learning_rate=config['learning_rate'],
        hidden_sizes=config['hidden_sizes_model'],
        valid_split_ratio=config['valid_split_ratio'],
        rolling_average_persitency=config['rolling_average_persitency'],
        hidden_nonlinearity=config['hidden_nonlinearity_model'],
        batch_size=config['adapt_batch_size'],
        device=device,
    )

    policy = MPCController(
        name='policy',
        env=env,
        dynamics_model=dynamics_model,
        discount=config['discount'],
        n_candidates=config['n_candidates'],
        horizon=config['horizon'],
        use_cem=config['use_cem'],
        num_cem_iters=config['num_cem_iters'],
    )

    # config['n_parallel'] has no counterpart: every env of the batch steps
    # at once on the device
    sampler = Sampler(
        env=env,
        policy=policy,
        seed=config.get('seed', 0),
        max_path_length=config['max_path_length'],
        num_rollouts=config['num_rollouts'],
        adapt_batch_size=config['adapt_batch_size'],
        device=device,
    )

    start_itr = 0
    if config.get('resume'):
        start_itr = resume_trainer(exp_dir, dynamics_model, sampler)
        logger.log(f'Resuming from iteration {start_itr}')

    sample_processor = ModelSampleProcessor(recurrent=True)

    algo = Trainer(
        env=env,
        policy=policy,
        dynamics_model=dynamics_model,
        sampler=sampler,
        sample_processor=sample_processor,
        n_itr=config['n_itr'],
        start_itr=start_itr,
        initial_random_samples=config['initial_random_samples'],
        dynamics_model_max_epochs=config['dynamic_model_epochs'],
        config=config,
        profile_dir=(os.path.join(exp_dir, 'profile')
                     if config.get('profile') else None),
    )
    algo.train()
    return algo


config = {
    # Environment
    'env': HalfCheetahEnv,
    'max_path_length': 1000,
    'task': None,
    'normalize': True,
    'n_itr': 50,
    'discount': 1.,

    # Policy
    'n_candidates': 500,
    'horizon': 10,
    'use_cem': False,
    'num_cem_iters': 5,

    # Training
    'num_rollouts': 5,
    'valid_split_ratio': 0.1,
    'rolling_average_persitency': 0.99,
    'initial_random_samples': True,

    # Dynamics Model
    'meta_batch_size': 10,
    'hidden_nonlinearity_model': 'relu',
    'learning_rate': 1e-3,
    'inner_learning_rate': 0.001,
    'hidden_sizes_model': (512, 512, 512),
    'dynamic_model_epochs': 100,
    'adapt_batch_size': 16,

    # Other
    'n_parallel': 5,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m learning_to_adapt_torch.run_grbal')
    p.add_argument('--n_itr', type=int, default=None)
    p.add_argument('--exp_name', type=str, default='')
    p.add_argument('--resume', action='store_true')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--profile', action='store_true',
                   help='capture torch.profiler traces of one sampling '
                        'iteration and one model fit into <exp>/profile')
    p.add_argument('--env', type=str, default=None,
                   help='env class name (default HalfCheetahEnv, the only '
                        'one ported)')
    p.add_argument('--task', type=str, default=None,
                   help="task distribution, e.g. 'cripple'")
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device; 'cpu' runs without a card")
    add_task_distribution_args(p)
    return p.parse_args(argv)


def config_from_args(args):
    """A copy of `config` with the command line applied."""
    cfg = dict(config)
    if args.env:
        if args.env not in ENVS:
            raise NotImplementedError(
                f'{args.env} is not ported yet (ROADMAP.md queue 1, item 8: '
                'the rest of physics and envs); the port has '
                f'{sorted(ENVS)}')
        cfg['env'] = ENVS[args.env]
    if args.task:
        cfg['task'] = args.task
    apply_task_distribution_args(args, cfg)
    cfg['resume'] = args.resume
    cfg['seed'] = args.seed
    cfg['profile'] = args.profile
    cfg['device'] = args.device
    if args.n_itr:
        cfg['n_itr'] = args.n_itr
    cfg['exp_name'] = args.exp_name
    return cfg


def main(argv=None):
    return run_experiment(config_from_args(parse_args(argv)))


if __name__ == '__main__':
    main()
