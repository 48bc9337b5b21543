"""The whole experiment at full length on the port: the six 50-iteration
GrBAL and MB-MPC runs (RUNS), each an entry point at its run script's own
config with only --task and --seed given, and their learning curves held
against the JAX package's runs of the same config in results/.

    python -m learning_to_adapt_torch.long_runs commands
    python -m learning_to_adapt_torch.long_runs collect [--data .]
    python -m learning_to_adapt_torch.long_runs compare [--data .]

`commands` prints the runs' command lines. A run that does not fit one
sitting runs in chunks, `--n_itr k` and then `--n_itr 50 --resume`
(train(N) == train(k) + resume(N-k), utils/checkpoint.py); a resumed run's
progress.csv starts anew, so copy it to progress.part<i>.csv in the
experiment directory before each --resume.

`collect` joins each run's parts in its experiment directory (where the
entry point writes it, under the working directory --data) by `Itr`, a
later part's row winning, into results/<RUNS file>. `compare` prints, per
algorithm and task, each seed's mean of the last 5
`EnvTrajs-AverageReturn`, their mean against the JAX seeds' mean +- 3 x
their spread (population std), the ranges of `Epochs` and the losses over
the last 10 iterations, `Time-ModelFit` and `Time-EnvSampling` at
CHECK_ITRS, the first iteration at which the port's mean curve leaves the
range of the JAX seeds and the one from which it stays outside; and,
where the run's experiment directory holds the Trainer's
iterations.jsonl, the fit's shape keys, the sampler's graphs and the
card's peak memory.
"""
import argparse
import csv
import glob
import importlib
import json
import os
import sys

import numpy as np

#: name -> (entry module, task, seed, results file of its progress.csv)
RUNS = {
    'grbal_cripple_s0': ('run_grbal', 'cripple', 0,
                         'grbal_cheetah_cripple_h100_r1.csv'),
    'grbal_cripple_s1': ('run_grbal', 'cripple', 1,
                         'grbal_cheetah_cripple_h100_r1_seed1.csv'),
    'grbal_nominal_s0': ('run_grbal', None, 0,
                         'grbal_halfcheetah_h100_r1.csv'),
    'grbal_nominal_s1': ('run_grbal', None, 1,
                         'grbal_halfcheetah_h100_r1_seed1.csv'),
    'mbmpc_cripple_s0': ('run_mb_mpc', 'cripple', 0,
                         'mb_mpc_cheetah_cripple_h100_r1.csv'),
    'mbmpc_cripple_s1': ('run_mb_mpc', 'cripple', 1,
                         'mb_mpc_cheetah_cripple_h100_r1_seed1.csv'),
}
#: (entry module, task) -> the JAX package's runs of the same config
JAX_RUNS = {
    ('run_grbal', 'cripple'): ['grbal_cheetah_cripple_tpu_r3.csv',
                               'grbal_cheetah_cripple_tpu_r3_seed1.csv'],
    ('run_grbal', None): ['grbal_halfcheetah_tpu_r3.csv',
                          'grbal_halfcheetah_tpu_r3_seed1.csv',
                          'grbal_halfcheetah_tpu_r3_seed2.csv'],
    ('run_mb_mpc', 'cripple'): ['mb_mpc_cheetah_cripple_tpu_r3.csv',
                                'mb_mpc_cheetah_cripple_tpu_r3_seed1.csv'],
}
RETURN = 'EnvTrajs-AverageReturn'
BAND_SIGMAS = 3
N_LAST = 5
CHECK_ITRS = (1, 10, 25, 49)


def exp_name(name):
    _, task, seed, _ = RUNS[name]
    return f'{task or "nominal"}_s{seed}'


def exp_dir(name, root=None):
    module = RUNS[name][0]
    entry = importlib.import_module(f'learning_to_adapt_torch.{module}')
    return os.path.join(root or os.getcwd(), 'data', entry.ENTRY.exp_name,
                        exp_name(name))


def entry_argv(name, resume=False):
    _, task, seed, _ = RUNS[name]
    argv = (['--task', task] if task else []) + [
        '--seed', str(seed), '--exp_name', exp_name(name)]
    return argv + ['--resume'] if resume else argv


def commands():
    """Each run's command line."""
    return [' '.join(['python', '-m',
                      f'learning_to_adapt_torch.{RUNS[n][0]}'] +
                     entry_argv(n)) for n in RUNS]


# ------------------------------------------------------------------ collect
def _rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return list(csv.DictReader(f))


def joined_rows(path):
    """A run's rows by Itr: the file, or its parts (<stem>.part*.csv, a run
    resumed in chunks) joined, a later part's row winning."""
    by_itr = {}
    stem = path[:-len('.csv')]
    for p in sorted(glob.glob(stem + '.part*.csv')) + [path]:
        for r in _rows(p):
            by_itr[int(r['Itr'])] = r
    return [by_itr[i] for i in sorted(by_itr)]


def collect(data='.', to='results'):
    """Writes each run's rows, joined over the parts in its experiment
    directory under `data`, to to/<RUNS file>."""
    written = []
    for name, (_, _, _, fname) in RUNS.items():
        rows = joined_rows(os.path.join(exp_dir(name, data), 'progress.csv'))
        if rows:
            with open(os.path.join(to, fname), 'w', newline='') as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
            written.append((fname, len(rows)))
    print(written)
    return written


def iteration_stats(name, data='.'):
    """From the Trainer's iterations.jsonl of a run (None without one): its
    distinct fit shape keys, the sampler's graphs at the end, the peak and
    the final allocated card bytes."""
    path = os.path.join(exp_dir(name, data), 'iterations.jsonl')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    keys = []
    for r in recs:
        keys += [k for k in r['fit_keys'] if k not in keys]
    peaks = [r['mem_peak'] for r in recs if 'mem_peak' in r]
    return dict(fit_keys=keys, sampler_graphs=recs[-1]['sampler_graphs'],
                mem_peak=max(peaks) if peaks else None,
                mem_allocated_end=recs[-1].get('mem_allocated'))


# ------------------------------------------------------------------ compare
def _col(rows, key):
    return np.array([float(r[key]) for r in rows])


def _last_mean(rows, n=N_LAST):
    return float(_col(rows, RETURN)[-n:].mean())


def compare(port_dir='results', jax_dir='results', data=None):
    """The comparison table as a dict (also printed)."""
    report = {}
    for (module, task), jax_files in JAX_RUNS.items():
        jax_rows = [_rows(os.path.join(jax_dir, f)) for f in jax_files]
        jax_last = [_last_mean(r) for r in jax_rows]
        j_mean, j_std = float(np.mean(jax_last)), float(np.std(jax_last))
        band = (j_mean - BAND_SIGMAS * j_std, j_mean + BAND_SIGMAS * j_std)
        names = [n for n, (m, t, _, _) in RUNS.items()
                 if m == module and t == task]
        port = {}
        for n in names:
            rows = joined_rows(os.path.join(port_dir, RUNS[n][3]))
            if not rows:
                continue
            loss = ('Pre-Loss', 'Post-Loss') if 'Pre-Loss' in rows[0] \
                else ('TrainLoss', 'ValidLoss')
            last10 = rows[-10:]
            at = {i: rows[i] for i in CHECK_ITRS if i < len(rows)}
            port[n] = dict(
                iterations=len(rows), last5=_last_mean(rows),
                epochs_last10=[int(_col(last10, 'Epochs').min()),
                               int(_col(last10, 'Epochs').max())],
                loss_last10={k: [float(_col(last10, k).min()),
                                 float(_col(last10, k).max())]
                             for k in loss},
                fit_s={i: float(r['Time-ModelFit']) for i, r in at.items()},
                sampling_s={i: float(r['Time-EnvSampling'])
                            for i, r in at.items()},
                itr_time_sum=float(_col(rows, 'ItrTime').sum()),
                epochs_stopped=int((_col(rows, 'Epochs') < 99).sum()))
            stats = iteration_stats(n, data) if data else None
            if stats:
                port[n].update(stats)
        jax_loss = ('Pre-Loss', 'Post-Loss') if 'Pre-Loss' in jax_rows[0][0] \
            else ('TrainLoss', 'ValidLoss')
        entry = dict(
            jax_files=jax_files, jax_last5=jax_last, jax_mean=j_mean,
            jax_std=j_std, band=list(band),
            jax_epochs_last10=[int(min(_col(r[-10:], 'Epochs').min()
                                       for r in jax_rows)),
                               int(max(_col(r[-10:], 'Epochs').max()
                                       for r in jax_rows))],
            jax_loss_last10={k: [float(min(_col(r[-10:], k).min()
                                           for r in jax_rows)),
                                 float(max(_col(r[-10:], k).max()
                                           for r in jax_rows))]
                             for k in jax_loss},
            port=port)
        full = [n for n in port if port[n]['iterations'] == len(jax_rows[0])]
        if full:
            p_mean = float(np.mean([port[n]['last5'] for n in full]))
            entry.update(port_mean=p_mean, port_seeds=len(full),
                         in_band=bool(band[0] <= p_mean <= band[1]))
            curves = np.stack([_col(joined_rows(os.path.join(
                port_dir, RUNS[n][3])), RETURN) for n in full])
            jax_curves = np.stack([_col(r, RETURN) for r in jax_rows])
            mean = curves.mean(axis=0)
            outside = ((mean < jax_curves.min(axis=0)) |
                       (mean > jax_curves.max(axis=0)))
            out = np.nonzero(outside)[0]
            inside = np.nonzero(~outside)[0]
            entry['first_itr_outside_jax_range'] = (int(out[0]) if len(out)
                                                    else None)
            entry['itrs_outside_jax_range'] = int(len(out))
            # the iteration from which the curve stays outside to the end
            entry['outside_from_itr'] = (
                None if not outside[-1] else
                int(inside[-1]) + 1 if len(inside) else 0)
            entry['port_mean_curve'] = mean.round(2).tolist()
        report[f'{module}:{task or "nominal"}'] = entry
    print(json.dumps(report, indent=1))
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m learning_to_adapt_torch.long_runs')
    sub = p.add_subparsers(dest='cmd', required=True)
    sub.add_parser('commands')
    for cmd in ('collect', 'compare'):
        sub.add_parser(cmd).add_argument('--data', type=str, default='.')
    args = p.parse_args(argv)
    if args.cmd == 'commands':
        print('\n'.join(commands()))
    elif args.cmd == 'collect':
        collect(args.data)
    else:
        compare(data=args.data)
    return 0


if __name__ == '__main__':
    sys.exit(main())
