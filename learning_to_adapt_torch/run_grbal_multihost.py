"""GrBAL over several ranks (run_scripts/run_grbal_multihost.py): the run
of run_grbal.py with its env axis and its meta fit sharded over the ranks of
a torch.distributed group (parallel/mesh.py), one process a rank.

    torchrun --nproc_per_node N -m learning_to_adapt_torch.run_grbal_multihost \
        [--n_itr N] [--max_path_length T] [--exp_name NAME] [--device cpu]
    python -m learning_to_adapt_torch.run_grbal_multihost ...   # 1 rank

Under torchrun each rank runs on cuda:LOCAL_RANK over nccl (one card a
rank), or on the CPU over gloo with --device cpu; run plainly, one rank
starts its own group. num_rollouts is rounded up to a multiple of the
ranks. Only rank 0 writes progress.csv, params.json, params.pkl and log.txt
to data/grbal_multihost_torch/<exp_name> under the working directory, with
run_grbal's columns. Without a card and without --device cpu it raises.
"""
import argparse

from learning_to_adapt_torch import run_grbal
from learning_to_adapt_torch.experiment import EntryPoint
from learning_to_adapt_torch.parallel.mesh import make_mesh

ENTRY = EntryPoint('grbal_multihost_torch', 'run_grbal_multihost',
                   run_grbal.config, run_grbal.build, recurrent=True)
EXP_NAME = ENTRY.exp_name
experiment_dir = ENTRY.experiment_dir


def run_experiment(config, mesh=None):
    """Trains on `mesh` (default: make_mesh on config['device'], closed at
    the end) and returns the Trainer."""
    own = mesh is None
    if own:
        mesh = make_mesh(device=config.get('device', 'cuda'))
    try:
        # at least the configured rollouts, rounded up to fill the env axis
        n = mesh.shape['env']
        per = max(config['num_rollouts'], 1)
        config = dict(config, num_rollouts=-(-per // n) * n)
        return ENTRY.run_experiment(config, mesh=mesh)
    finally:
        if own:
            mesh.close()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m learning_to_adapt_torch.run_grbal_multihost')
    p.add_argument('--n_itr', type=int, default=None)
    p.add_argument('--max_path_length', type=int, default=None)
    p.add_argument('--exp_name', type=str, default='')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device; 'cpu' runs the ranks over gloo")
    return p.parse_args(argv)


def config_from_args(args):
    config = dict(run_grbal.config, exp_name=args.exp_name,
                  device=args.device)
    if args.n_itr:
        config['n_itr'] = args.n_itr
    if args.max_path_length:
        config['max_path_length'] = args.max_path_length
    return config


def main(argv=None):
    return run_experiment(config_from_args(parse_args(argv)))


if __name__ == '__main__':
    main()
