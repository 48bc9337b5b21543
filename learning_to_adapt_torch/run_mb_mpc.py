"""MB-MPC on the port: a feed-forward dynamics model (an ensemble with
n_members > 1) + MPC, refit on all data after every sampling iteration by
`Trainer.train` (run_scripts/run_mb_mpc.py, whose config dict this module
copies). The baseline without online adaptation.

    python -m learning_to_adapt_torch.run_mb_mpc --task cripple [--n_itr N]
        [--exp_name NAME] [--resume] [--seed S] [--profile] [--device cpu]

Runs on the card unless --device cpu is given; without a card and without
--device cpu it raises. Writes progress.csv, params.json, params.pkl and
log.txt to data/mb_mpc_torch/<exp_name> under the working directory.
"""
from learning_to_adapt_torch.envs import HalfCheetahEnv
from learning_to_adapt_torch.experiment import EntryPoint
from learning_to_adapt_torch.models import MLPDynamicsModel
from learning_to_adapt_torch.policies import MPCController


def build(config, env, device):
    dynamics_model = MLPDynamicsModel(
        name='dyn_model',
        env=env,
        seed=config.get('seed', 0),
        learning_rate=config['learning_rate'],
        hidden_sizes=config['hidden_sizes'],
        valid_split_ratio=config['valid_split_ratio'],
        rolling_average_persitency=config['rolling_average_persitency'],
        hidden_nonlinearity=config['hidden_nonlinearity'],
        batch_size=config['batch_size'],
        n_members=config.get('n_members', 1),
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
    return dynamics_model, policy


config = {
    # Environment
    'env': HalfCheetahEnv,
    'task': None,

    # Policy
    'n_candidates': 2000,
    'horizon': 20,
    'use_cem': False,
    'num_cem_iters': 5,
    'discount': 1.,

    # Sampling
    'max_path_length': 100,
    'num_rollouts': 10,
    'initial_random_samples': True,

    # Training
    'n_itr': 50,
    'learning_rate': 1e-3,
    'batch_size': 128,
    'dynamic_model_epochs': 100,
    'valid_split_ratio': 0.1,
    'rolling_average_persitency': 0.99,

    # Dynamics Model
    'hidden_sizes': (512, 512),
    'hidden_nonlinearity': 'relu',

    # Other
    'n_parallel': 2,
}

ENTRY = EntryPoint('mb_mpc_torch', 'run_mb_mpc', config, build,
                   recurrent=False)
EXP_NAME = ENTRY.exp_name
run_experiment = ENTRY.run_experiment
parse_args = ENTRY.parse_args
config_from_args = ENTRY.config_from_args
main = ENTRY.main

if __name__ == '__main__':
    main()
