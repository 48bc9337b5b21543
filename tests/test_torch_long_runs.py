"""learning_to_adapt_torch/long_runs.py on the CPU: the runs' command lines
(only --task and --seed given), the Trainer's per-iteration record around a
tiny run resumed in chunks, the join of a chunked run's rows, and the
comparison with the JAX package's curves in results/."""
import csv
import json
import os
import shutil

import numpy as np
import pytest

from learning_to_adapt_torch import long_runs, run_grbal
from learning_to_adapt_torch.models import captured
from learning_to_adapt_torch.utils import logging as port_log

_RESULTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'results')


def test_runs_give_only_task_and_seed():
    assert long_runs.entry_argv('grbal_cripple_s1') == [
        '--task', 'cripple', '--seed', '1', '--exp_name', 'cripple_s1']
    assert long_runs.entry_argv('grbal_nominal_s0') == [
        '--seed', '0', '--exp_name', 'nominal_s0']
    assert long_runs.entry_argv('mbmpc_cripple_s0', resume=True) == [
        '--task', 'cripple', '--seed', '0', '--exp_name', 'cripple_s0',
        '--resume']
    cfg = run_grbal.ENTRY.config_from_args(run_grbal.ENTRY.parse_args(
        long_runs.entry_argv('grbal_cripple_s0')))
    for k in ('n_itr', 'max_path_length', 'num_rollouts', 'n_candidates',
              'hidden_sizes_model', 'dynamic_model_epochs'):
        assert cfg[k] == run_grbal.config[k], k
    assert {m for m, *_ in long_runs.RUNS.values()} == {'run_grbal',
                                                        'run_mb_mpc'}
    assert long_runs.commands()[0] == (
        'python -m learning_to_adapt_torch.run_grbal --task cripple --seed 0 '
        '--exp_name cripple_s0')
    assert len(set(long_runs.commands())) == len(long_runs.RUNS)


def test_compare_gives_the_jax_bands(tmp_path):
    """Mean +- 3 population std of the JAX seeds' last-5 means."""
    rep = long_runs.compare(port_dir=str(tmp_path), jax_dir=_RESULTS)
    want = {'run_grbal:cripple': (157.908, 9.465),
            'run_grbal:nominal': (160.677, 15.081),
            'run_mb_mpc:cripple': (40.427, 4.424)}
    for key, (mean, std) in want.items():
        np.testing.assert_allclose(rep[key]['jax_mean'], mean, atol=0.01)
        np.testing.assert_allclose(rep[key]['jax_std'], std, atol=0.01)
        lo, hi = rep[key]['band']
        np.testing.assert_allclose([lo, hi], [mean - 3 * std, mean + 3 * std],
                                   atol=0.05)
        assert rep[key]['port'] == {} and 'in_band' not in rep[key]


def test_compare_holds_runs_inside_the_jax_seeds(tmp_path):
    """Two of the JAX seeds put where the port's runs go: in the band, and
    their mean curve never leaves the JAX seeds' range."""
    for name, (module, task, _, fname) in long_runs.RUNS.items():
        seed = int(name[-1])
        src = long_runs.JAX_RUNS[(module, task)][seed]
        shutil.copy(os.path.join(_RESULTS, src), str(tmp_path / fname))
    rep = long_runs.compare(port_dir=str(tmp_path), jax_dir=_RESULTS)
    for key, entry in rep.items():
        assert entry['port_seeds'] == 2 and entry['in_band'], key
        assert entry['first_itr_outside_jax_range'] is None, key
        for run in entry['port'].values():
            assert run['iterations'] == 50
            assert set(run['fit_s']) == set(long_runs.CHECK_ITRS)


def _write(path, itrs, tag):
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['Itr', 'tag'])
        w.writerows([[i, tag] for i in itrs])


def test_a_stopped_and_resumed_runs_rows_join_by_itr(tmp_path):
    """A resumed run's progress.csv starts anew: the parts kept in its
    experiment directory join by Itr, the later part's row winning where
    both have one."""
    name = 'grbal_cripple_s0'
    d = long_runs.exp_dir(name, str(tmp_path))
    os.makedirs(d)
    _write(os.path.join(d, 'progress.part0.csv'), range(0, 3), 'a')
    _write(os.path.join(d, 'progress.part1.csv'), range(2, 4), 'b')
    _write(os.path.join(d, 'progress.csv'), range(3, 5), 'c')
    rows = long_runs.joined_rows(os.path.join(d, 'progress.csv'))
    assert [(r['Itr'], r['tag']) for r in rows] == [
        ('0', 'a'), ('1', 'a'), ('2', 'b'), ('3', 'c'), ('4', 'c')]
    to = tmp_path / 'results'
    to.mkdir()
    assert long_runs.collect(str(tmp_path), str(to)) == [
        (long_runs.RUNS[name][3], 5)]
    assert [r['tag'] for r in long_runs.joined_rows(
        str(to / long_runs.RUNS[name][3]))] == ['a', 'a', 'b', 'c', 'c']


def test_recording_writes_a_line_an_iteration(tmp_path, monkeypatch):
    """Around a tiny run on the CPU, run in chunks as a long run is, its
    fits and sampling compiled as on the card (captured.captures patched
    to True; graphs are plain calls on the CPU): the Trainer appends one
    record an iteration to iterations.jsonl (its index, the fit's capture
    keys, the sampler's graphs; no card memory on the CPU), a --resume goes
    on appending, and `iteration_stats` reads it."""
    monkeypatch.setattr(captured, 'captures', lambda device, mesh: True)
    cfg = dict(run_grbal.config, task='cripple', device='cpu', n_itr=2,
               max_path_length=20, num_rollouts=2, n_candidates=8, horizon=3,
               dynamic_model_epochs=2, hidden_sizes_model=(32, 32),
               adapt_batch_size=4, meta_batch_size=4,
               exp_name=long_runs.exp_name('grbal_cripple_s0'))
    cwd = os.getcwd()
    os.chdir(str(tmp_path))
    try:
        run_grbal.run_experiment(cfg)
        port_log.Logger.CURRENT.close()
        run_grbal.run_experiment(dict(cfg, n_itr=3, resume=True))
    finally:
        port_log.Logger.CURRENT.close()
        port_log.Logger.CURRENT = None
        os.chdir(cwd)
    d = long_runs.exp_dir('grbal_cripple_s0', str(tmp_path))
    with open(os.path.join(d, 'iterations.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert [r['itr'] for r in recs] == [0, 1, 2]
    key = [64, 64, 20, 4, 4]   # (cap_tr, cap_te, T, meta_batch, batch)
    assert all(r['fit_keys'] == [key] and 'mem_peak' not in r for r in recs)
    # the random graph, then both sides of the adaptation gate; the resumed
    # process plans from its first iteration and captures anew
    assert [r['sampler_graphs'] for r in recs] == [
        {'True': 1}, {'True': 1, 'False': 2}, {'False': 2}]
    assert long_runs.iteration_stats('grbal_cripple_s0', str(tmp_path)) == {
        'fit_keys': [key], 'sampler_graphs': {'False': 2}, 'mem_peak': None,
        'mem_allocated_end': None}
    assert long_runs.iteration_stats('grbal_cripple_s1',
                                     str(tmp_path)) is None


@pytest.mark.parametrize('name', sorted(long_runs.RUNS))
def test_results_files_follow_the_jax_names(name):
    module, task, seed, fname = long_runs.RUNS[name]
    jax = long_runs.JAX_RUNS[(module, task)][seed]
    assert fname == jax.replace('tpu_r3', 'h100_r1')
