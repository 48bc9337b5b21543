"""ReBAL on the port: a recurrent dynamics model whose hidden state adapts
online + MPC that threads it, trained by truncated BPTT in `Trainer.train`
(run_scripts/run_rebal.py, whose config dict this module copies).

    python -m learning_to_adapt_torch.run_rebal --task cripple [--n_itr N]
        [--exp_name NAME] [--resume] [--seed S] [--profile] [--device cpu]

Runs on the card unless --device cpu is given; without a card and without
--device cpu it raises. Writes progress.csv, params.json, params.pkl and
log.txt to data/rebal_torch/<exp_name> under the working directory.
"""
from learning_to_adapt_torch.envs import HalfCheetahEnv
from learning_to_adapt_torch.experiment import EntryPoint
from learning_to_adapt_torch.models import RNNDynamicsModel
from learning_to_adapt_torch.policies import RNNMPCController


def build(config, env, device):
    dynamics_model = RNNDynamicsModel(
        name='dyn_model',
        env=env,
        seed=config.get('seed', 0),
        hidden_sizes=config['hidden_sizes'],
        learning_rate=config['learning_rate'],
        backprop_steps=config['backprop_steps'],
        cell_type=config['cell_type'],
        batch_size=config['batch_size'],
        valid_split_ratio=config['valid_split_ratio'],
        rolling_average_persitency=config['rolling_average_persitency'],
        device=device,
    )
    policy = RNNMPCController(
        name='policy',
        env=env,
        dynamics_model=dynamics_model,
        discount=config['discount'],
        n_candidates=config['n_candidates'],
        horizon=config['horizon'],
        use_cem=config['use_cem'],
        num_cem_iters=config['num_cem_iters'],
        num_rollouts=config['num_rollouts'],
    )
    return dynamics_model, policy


config = {
    # Environment
    'env': HalfCheetahEnv,
    'task': None,

    # Policy
    'n_candidates': 500,
    'horizon': 10,
    'use_cem': False,
    'num_cem_iters': 5,
    'discount': 1.,

    # Sampling
    'max_path_length': 1000,
    'num_rollouts': 5,
    'initial_random_samples': True,

    # Training
    'n_itr': 50,
    'learning_rate': 1e-2,
    'batch_size': 10,
    'backprop_steps': 100,
    'dynamic_model_epochs': 50,
    'valid_split_ratio': 0.1,
    'rolling_average_persitency': 0.99,

    # Dynamics Model
    'cell_type': 'lstm',
    'hidden_sizes': (256,),

    # Other
    'n_parallel': 5,
}

ENTRY = EntryPoint('rebal_torch', 'run_rebal', config, build,
                   recurrent=True)
EXP_NAME = ENTRY.exp_name
run_experiment = ENTRY.run_experiment
parse_args = ENTRY.parse_args
config_from_args = ENTRY.config_from_args
main = ENTRY.main

if __name__ == '__main__':
    main()
