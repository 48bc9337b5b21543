"""A configuration file's run config (the keys of its published run
script) read into the few numbers the yardstick needs, whichever of the
two run scripts' key names it uses."""
from types import SimpleNamespace


def hparams(config):
    rc = config['run_config']
    algo = config['algo']
    meta = algo == 'grbal'
    return SimpleNamespace(
        algo=algo,
        obs_dim=config['obs_dim'], act_dim=config['act_dim'],
        envs=rc['num_rollouts'], t_len=rc['max_path_length'],
        n_candidates=rc['n_candidates'], horizon=rc['horizon'],
        discount=rc['discount'],
        hidden=list(rc['hidden_sizes_model'] if meta
                    else rc['hidden_sizes']),
        nonlinearity=(rc['hidden_nonlinearity_model'] if meta
                      else rc['hidden_nonlinearity']),
        adapt_batch_size=rc.get('adapt_batch_size') if meta else None,
        inner_lr=rc.get('inner_learning_rate'),
        meta_batch_size=rc.get('meta_batch_size'),
        # GrBAL's model takes its window half from adapt_batch_size
        batch_size=rc['adapt_batch_size'] if meta else rc['batch_size'],
        lr=rc['learning_rate'], clip_norm=config['clip_norm'],
        valid_split_ratio=rc['valid_split_ratio'])
