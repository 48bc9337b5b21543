"""Time-ModelFit of the port's three trainers, for one or more copies of
the package, on one NVIDIA card.

    python3 fit_time_study.py [TREE ...]

Each TREE is a directory holding a `learning_to_adapt_torch/` package (the
default: this repository's). For each, in the order given and in a fresh
process each, the script runs the trainers at chip_smoke.py's trainer
configs (seed 0, --task cripple; GrBAL and ReBAL 3 iterations of 100-step
paths, MB-MPC its full config for 2 iterations) in a temporary directory
and prints one JSON line: each trainer's wall seconds and the
Time-ModelFit and Epochs of each iteration from its progress.csv. To hold
two trees against each other, give them in turns (a b b a): the host's
speed varies between calls. Imports nothing of JAX.
"""
import contextlib
import csv
import io
import json
import os
import subprocess
import sys
import tempfile
import time

TRAINERS = (('GrBAL', 'run_grbal', dict(n_itr=3, max_path_length=100)),
            ('MB-MPC', 'run_mb_mpc', dict(n_itr=2)),
            ('ReBAL', 'run_rebal', dict(n_itr=3, max_path_length=100)))


def time_tree(tree):
    """The trainers of the package under `tree`, in this process."""
    import importlib
    sys.path.insert(0, tree)
    import torch
    import learning_to_adapt_torch
    from learning_to_adapt_torch.utils import logging as logger
    if not learning_to_adapt_torch.__file__.startswith(tree):
        raise RuntimeError(f'imported {learning_to_adapt_torch.__file__}, '
                           f'not the package under {tree}')
    if not torch.cuda.is_available():
        raise RuntimeError('needs an NVIDIA card')
    out = {'tree': tree}
    for name, module, kw in TRAINERS:
        mod = importlib.import_module(f'learning_to_adapt_torch.{module}')
        cfg = dict(mod.config, task='cripple', seed=0, device='cuda',
                   exp_name='fit_time_study', resume=False, profile=False,
                   **kw)
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                t0 = time.time()
                with contextlib.redirect_stdout(io.StringIO()):
                    mod.run_experiment(cfg)
                run_s = time.time() - t0
                logger.Logger.CURRENT.close()
                with open(os.path.join(mod.ENTRY.experiment_dir(cfg),
                                       'progress.csv')) as f:
                    rows = list(csv.DictReader(f))
            finally:
                os.chdir(cwd)
        out[name] = dict(run_s=run_s,
                         fit_s=[float(r['Time-ModelFit']) for r in rows],
                         epochs=[int(r['Epochs']) for r in rows])
    return out


def main(argv):
    if len(argv) == 2 and argv[0] == '--one':
        print(json.dumps(time_tree(os.path.abspath(argv[1]))), flush=True)
        return 0
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    print(out.stdout.strip(), flush=True)
    for tree in argv or ['.']:
        subprocess.run([sys.executable, os.path.abspath(__file__), '--one',
                        tree], check=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
