"""Parity of the port's meta-test protocol (learning_to_adapt_torch.meta_test
and summarize_meta_test) with the JAX package's scripts
(benchmarks/meta_test.py, benchmarks/summarize_meta_test.py, loaded through
importlib): the held-out env resolver, the gap statistics, the pooled
summary over every result file of results/, and whole evaluations of tiny
port snapshots on the CPU."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import recorded_rollouts, tiny_snapshot
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch import meta_test as port_mt
from learning_to_adapt_torch import summarize_meta_test as port_sm
from learning_to_adapt_tpu import envs as jax_envs

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a JAX result file with every key of a GrBAL evaluation: the two modes,
#: the gap, an lr sweep of two rates and a window sweep, ablate_warmup and
#: set_kind
SWEEPS_JSON = os.path.join(_REPO, 'results',
                           'meta_test_ant_leg1_grbal_loo_sweeps.json')


def _load_module(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jax_mt():
    return _load_module('benchmarks/meta_test.py', 'jax_meta_test_mod')


@pytest.fixture(scope='module')
def jax_sm():
    return _load_module('benchmarks/summarize_meta_test.py',
                        'jax_summarize_meta_test_mod')


# ------------------------------------------------------------------ resolver
RESOLVER_CASES = {
    'cripple_ids': ('HalfCheetahEnv', dict(task='cripple',
                                           cripple_set=(1, 2, 3, 5)),
                    '4', 'cripple_set'),
    'ant_leg': ('AntEnv', dict(task='cripple'), '3', 'cripple_set'),
    'terrain_names': ('HalfCheetahHFieldEnv',
                      dict(task='hfield', terrain_set=('gentle', 'hill')),
                      'steep,basin', 'terrain_set'),
    'damping_span': ('HalfCheetahBlocksEnv', dict(task='damping'), '12:20',
                     'damping_range'),
    'arm_force_span': ('Arm7DofEnv', dict(task='force'), '3:6',
                       'force_range'),
}


@pytest.mark.parametrize('case', sorted(RESOLVER_CASES))
def test_resolve_eval_env_matches_jax(case, jax_mt, capsys):
    """The same class, train_set, eval_set, set_kind and cloned attribute
    as the JAX resolver; the port's clone keeps the snapshot's device and
    env options (frame_skip, dtype)."""
    cls, kw, spec, attr = RESOLVER_CASES[case]
    jax_base = getattr(jax_envs, cls)(**kw)
    base = getattr(port_envs, cls)(frame_skip=3, dtype=torch.float64,
                                   device='cpu', **kw)
    ev, train_set, eval_set, kind = port_mt.resolve_eval_env(base, spec)
    jev, jtrain, jeval, jkind = jax_mt.resolve_eval_env(jax_base, spec)
    assert (train_set, eval_set, kind) == (jtrain, jeval, jkind)
    assert type(ev) is port_envs.NormalizedEnv
    inner = ev.wrapped_env
    assert type(inner).__name__ == type(jev.wrapped_env).__name__ == cls
    assert getattr(inner, attr) == getattr(jev.wrapped_env, attr)
    assert inner.task == base.task and inner is not base
    assert (inner.frame_skip, inner.dtype, inner.device) == (
        3, torch.float64, base.device)
    # none of these holdouts overlaps its train set
    assert 'WARNING' not in capsys.readouterr().out


@pytest.mark.parametrize('cls,kw,spec', [
    ('HalfCheetahEnv', dict(task='cripple'), 'steep'),
    ('Arm7DofEnv', dict(task='mass'), '3:6'),
    ('HalfCheetahBlocksEnv', dict(task='damping'), '3'),
])
def test_resolve_eval_env_refuses_a_kind_mismatch(cls, kw, spec, jax_mt):
    """An eval set of another task kind than the snapshot's is refused, by
    the JAX resolver with an assertion, by the port's with ValueError."""
    with pytest.raises(AssertionError):
        jax_mt.resolve_eval_env(getattr(jax_envs, cls)(**kw), spec)
    with pytest.raises(ValueError):
        port_mt.resolve_eval_env(
            getattr(port_envs, cls)(device='cpu', **kw), spec)


def test_gap_stats_match_jax(jax_mt):
    rng = np.random.RandomState(0)
    a, b = rng.randn(15) * 30 + 100, rng.randn(15) * 20 + 90
    assert port_mt.gap_stats(a, b) == jax_mt.gap_stats(a, b)


# ------------------------------------------------------------------- summary
def test_summary_over_results_matches_jax(jax_sm, capsys, monkeypatch):
    """Over every results/meta_test_*.json the port's summary prints what
    the JAX script prints, letter for letter (the pooled GrBAL and ReBAL
    gaps included)."""
    monkeypatch.chdir(_REPO)
    jax_sm.main('results/meta_test_*.json')
    want = capsys.readouterr().out
    port_sm.main('results/meta_test_*.json')
    got = capsys.readouterr().out
    assert got == want
    assert 'pooled OOD adaptation gap (GrBAL, adapted - pre-update) ' \
           '(23 snapshots)' in got


def test_pool_modes_and_diff_sem_match_jax(jax_sm):
    """Pooling two disjoint halves gives the whole sample's statistics, as
    in the JAX package; diff_sem equal."""
    rng = np.random.RandomState(0)
    x = rng.randn(90) * 25 + 100

    def summ(v):
        return dict(mean=float(v.mean()), std=float(v.std()), n=len(v),
                    per_seed_mean=[float(v[0])])
    p = port_sm.pool_modes(summ(x[:30]), summ(x[30:]))
    assert p == jax_sm.pool_modes(summ(x[:30]), summ(x[30:]))
    assert abs(p['mean'] - x.mean()) < 1e-8
    assert abs(p['std'] - x.std()) < 1e-8 and p['n'] == 90
    a, b = summ(x[:40]), summ(x[40:])
    assert port_sm.diff_sem(a, b) == jax_sm.diff_sem(a, b)


def _write(path, doc):
    path.write_text(json.dumps(doc))


def test_ext_files_fold_into_base_as_in_jax(jax_sm, tmp_path):
    """The JAX test's inputs: an `_ext` file's seeds pool into its base
    file's, the gap is recomputed from the pooled modes; the port's pooled
    documents equal the JAX package's."""
    rng = np.random.RandomState(1)
    a, b = rng.randn(30) + 50, rng.randn(60) + 55

    def doc(v, seeds, pre):
        return dict(train_set=[1, 2], eval_set=[3], seeds=seeds,
                    adapted=dict(mean=float(v.mean()), std=float(v.std()),
                                 n=len(v), per_seed_mean=[]),
                    **{'pre-update': dict(mean=float(pre.mean()),
                                          std=float(pre.std()), n=len(pre),
                                          per_seed_mean=[])})
    _write(tmp_path / 'meta_test_ant_leg3_x_s0.json', doc(a, [0, 1], a - 10))
    _write(tmp_path / 'meta_test_ant_leg3_x_s0_ext.json',
           doc(b, [2, 3, 4], b - 12))
    pattern = str(tmp_path / 'meta_test_*.json')
    got = port_sm.load_pooled(pattern)
    assert got == jax_sm.load_pooled(pattern)
    d = got['ant_leg3_x_s0']
    assert d['adapted']['n'] == 90 and d['seeds'] == [0, 1, 2, 3, 4]
    both = np.concatenate([a, b])
    assert abs(d['adapted']['mean'] - both.mean()) < 1e-8


def test_is_ood_matches_jax(jax_sm):
    docs = [dict(train_set=[0, 1, 2], eval_set=[3]),
            dict(train_set=[0, 1, 2], eval_set=[0, 1, 2]),
            dict(train_set=[1, 2, 3], eval_set=[3, 4]),
            dict(train_set=['gentle', 'hill'], eval_set=['steep']),
            dict(train_set=[0.0, 10.0], eval_set=[12.0, 20.0]),
            dict(train_set=[0.0, 10.0], eval_set=[5.0, 15.0]),
            dict(train_set=[0.1, 2.0], eval_set=[3.0, 6.0],
                 set_kind='range'),
            dict(train_set='damping', eval_set='damping'),
            dict(train_set=None, eval_set=None)]
    assert [port_sm.is_ood(d) for d in docs] == [
        jax_sm.is_ood(d) for d in docs] == [
        True, False, False, True, True, False, True, False, False]


def test_protocol_mismatch_and_repeated_seeds_refused(jax_sm, tmp_path):
    """The JAX tests' inputs: an extension run at another path length, and
    one that repeats the base file's seeds, are refused with the JAX
    script's messages (the port raises ValueError)."""
    mk = dict(train_set=[1], eval_set=[2], num_rollouts=5,
              max_path_length=1000, seeds=[0],
              adapted=dict(mean=0.0, std=1.0, n=5, per_seed_mean=[]))
    for sub, ext, match in (
            ('p', dict(mk, seeds=[1], max_path_length=500),
             'differs on max_path_length'),
            ('r', mk, 'repeats eval seeds')):
        d = tmp_path / sub
        d.mkdir()
        _write(d / 'meta_test_t_s0.json', mk)
        _write(d / 'meta_test_t_s0_ext.json', ext)
        pattern = str(d / 'meta_test_*.json')
        with pytest.raises(AssertionError, match=match):
            jax_sm.load_pooled(pattern)
        with pytest.raises(ValueError, match=match):
            port_sm.load_pooled(pattern)


def test_missing_ablate_warmup_pools_at_its_default(jax_sm, tmp_path):
    """An older base file without ablate_warmup pools with an extension run
    at the default 16 and refuses one at 8, as in the JAX package."""
    base = dict(train_set=[1], eval_set=[2], seeds=[0],
                adapted=dict(mean=1.0, std=1.0, n=5, per_seed_mean=[1.0]))
    for warmup, ok in ((16, True), (8, False)):
        d = tmp_path / f'w{warmup}'
        d.mkdir()
        _write(d / 'meta_test_b_s0.json', base)
        _write(d / 'meta_test_b_s0_ext.json',
               dict(base, seeds=[1], ablate_warmup=warmup))
        pattern = str(d / 'meta_test_*.json')
        if ok:
            assert port_sm.load_pooled(pattern) == \
                jax_sm.load_pooled(pattern)
        else:
            with pytest.raises(ValueError, match='ablate_warmup'):
                port_sm.load_pooled(pattern)


# ------------------------------------------------------- whole evaluations
@pytest.fixture(scope='module')
def snapshots(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('snapshots'))
    return dict(grbal=tiny_snapshot(root, 'grbal', cripple_set=(1, 2, 3, 5)),
                mb_mpc=tiny_snapshot(root, 'mb_mpc'),
                rebal=tiny_snapshot(root, 'rebal'))


def _key_tree(d):
    return [(k, _key_tree(v) if isinstance(v, dict) else None)
            for k, v in d.items()]


def test_grbal_meta_test_writes_the_jax_files_keys(snapshots, tmp_path,
                                                   monkeypatch):
    """A port GrBAL snapshot (32, 32) through meta_test.main on a held-out
    actuator with an lr and a window sweep: the JSON's key tree (keys,
    nesting, order) is the JAX file's, with the sweep's own labels; each
    mode's rollout runs on a new Sampler that sees the model's inner
    learning rate of the moment, so the lr sweep changes the trajectory,
    and the rate is restored after it."""
    monkeypatch.chdir(tmp_path)
    calls = recorded_rollouts(monkeypatch, port_mt)
    out = port_mt.main([snapshots['grbal'], '--eval_set', '4', '--seeds',
                        '0', '--num_rollouts', '2', '--max_path_length',
                        '20', '--inner_lrs', '0.0001,10', '--windows', '8',
                        '--tag', 'act4', '--device', 'cpu'])
    with open(tmp_path / 'results' / 'meta_test_act4.json') as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(out))
    with open(SWEEPS_JSON) as f:
        want = json.load(f)
    want = {('adapted_lr10' if k == 'adapted_lr0.0003' else k): v
            for k, v in want.items()}
    assert _key_tree(written) == _key_tree(want)
    assert written['train_set'] == [1, 2, 3, 5]
    assert written['eval_set'] == [4] and written['set_kind'] == 'discrete'
    for mode in ('adapted', 'pre-update', 'adapted_lr0.0001',
                 'adapted_lr10', 'adapted_window8'):
        assert np.isfinite(written[mode]['mean']) and \
            written[mode]['n'] == 2
    lrs = [lr for lr, _ in calls]
    assert lrs == [1e-3, 1e-3, 1e-4, 10.0, 1e-3]
    actions = [paths['actions'] for _, paths in calls]
    assert not np.array_equal(actions[0], actions[3])


def test_rebal_meta_test_ablations_differ(snapshots, tmp_path, monkeypatch):
    """A ReBAL snapshot on its own task distribution: the three modes and
    their gaps, each mode with its own trajectory."""
    monkeypatch.chdir(tmp_path)
    calls = recorded_rollouts(monkeypatch, port_mt)
    out = port_mt.main([snapshots['rebal'], '--seeds', '0',
                        '--num_rollouts', '2', '--max_path_length', '20',
                        '--ablate_warmup', '8', '--device', 'cpu'])
    assert list(out)[8:] == ['rebal', 'rebal_hidden_zero',
                             'rebal_hidden_frozen', 'rebal_gap',
                             'rebal_gap_frozen']
    assert out['train_set'] == out['eval_set'] == (1, 2, 3, 4, 5)
    assert out['ablate_warmup'] == 8
    actions = [paths['actions'] for _, paths in calls]
    assert len(actions) == 3
    for i in range(3):
        assert np.isfinite(actions[i]).all()
        for j in range(i):
            assert not np.array_equal(actions[i], actions[j]), (i, j)


def test_mb_mpc_meta_test_has_one_mode(snapshots, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = port_mt.main([snapshots['mb_mpc'], '--seeds', '0,1',
                        '--num_rollouts', '2', '--max_path_length', '20',
                        '--tag', 'mb', '--device', 'cpu'])
    assert list(out)[8:] == ['mb_mpc']
    assert out['mb_mpc']['n'] == 4 and len(out['mb_mpc']['per_seed_mean']) == 2
    assert (tmp_path / 'results' / 'meta_test_mb.json').exists()
