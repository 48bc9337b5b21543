"""The harness driven on the CPU at a small size (the look for a card
skipped): each driver's run comes out correct; the control, in the
program's place, comes out not correct; and so does each run whose timed
path is broken underneath, once for each fault the cell can have. Without
a card run.py prints no result."""
import copy
import subprocess
import sys

import pytest
import torch

from port_bench.lib import cell as cells
from port_bench.lib.run import context, judge, run

SEED = 2 ** 31 + 77


def cell(name):
    """The cell of BENCHMARK.json; grbal_sample, whose traffic file is
    kept though BENCHMARK.json does not run it, made from its file and its
    configuration's, reporting what mb_mpc_sample reports."""
    if name != 'grbal_sample':
        return cells.load_cell(name)
    c = cells.load_cell('mb_mpc_sample')
    c.name = name
    c.traffic = cells.load_json(cells.HERE / 'workloads' / f'{name}.json')
    c.config = cells.load_cell('grbal_fit').config
    return c


def small(name):
    """The cell at a size a CPU test holds (widths and counts cut; the
    shapes' kinds kept), with its real limits."""
    c = cell(name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    rc = cfg['run_config']
    rc.update(n_candidates=64, horizon=3)
    if cfg['algo'] == 'grbal':
        rc.update(num_rollouts=2, max_path_length=24, adapt_batch_size=4,
                  meta_batch_size=4, hidden_sizes_model=[64, 64])
    else:
        rc.update(num_rollouts=3, max_path_length=12, batch_size=16,
                  hidden_sizes=[64, 64])
    if tr['driver'] == 'sample':
        tr['check'] = dict(calls=2, physics_steps=8, planner_steps=6)
        tr['warm_seconds'] = 0
    elif cfg['algo'] == 'grbal':
        tr.update(first=20, path_length=20, per_call=5, calls_per_cycle=2,
                  epochs_per_call=1)
    else:
        tr.update(first=400, per_call=100, calls_per_cycle=2,
                  epochs_per_call=1)
    c.config, c.traffic = cfg, tr
    return c


def numbers(name, mode='program', seconds=0.2):
    c = small(name)
    drv = cells.driver(c.traffic['driver'])
    ctx = context(c, SEED, seconds, False, 'cpu')
    state = drv.setup(ctx)
    drv.window(ctx, state)
    drv.release(state)
    return judge(drv.readings(ctx, state, mode), c.traffic['limits'])


@pytest.mark.parametrize('name', ['grbal_sample', 'grbal_fit',
                                  'mb_mpc_sample', 'mb_mpc_fit'])
def test_small_run_is_correct(name):
    result = run(small(name), SEED, 0.2, False, 'cpu', 0.0)
    assert result['correct'], result['checks']
    assert result['device'] is None and result['attempted'] >= 1
    assert list(result)[-1] == 'checks'
    assert set(result['metrics']) == {m['name']
                                      for m in small(name).end_to_end}


@pytest.mark.parametrize('name', ['grbal_sample', 'grbal_fit',
                                  'mb_mpc_sample', 'mb_mpc_fit'])
def test_control_is_not_correct(name):
    correct, checks = numbers(name, 'control')
    assert not correct, checks


def _unchanged_physics(monkeypatch):
    from learning_to_adapt_torch.physics import engine
    monkeypatch.setattr(engine, 'step', lambda model, mm, state, ctrl: state)


def _half_candidates(monkeypatch):
    """The planner takes its best from half of its candidates."""
    from learning_to_adapt_torch.policies import planners
    real = planners._returns

    def half(*args, **kwargs):
        r = real(*args, **kwargs)
        keep = torch.arange(r.shape[0], device=r.device) % 2 == 0
        return r.where(keep, torch.full_like(r, -1e30))
    monkeypatch.setattr(planners, '_returns', half)


def _altered_action(monkeypatch):
    from learning_to_adapt_torch.policies import planners
    real = planners.random_shooting

    def altered(*args, **kwargs):
        first, returns = real(*args, **kwargs)
        return first + 1e-3, returns
    monkeypatch.setattr(planners, 'random_shooting', altered)


def _unchanged_state(monkeypatch):
    from learning_to_adapt_torch.models.optim import ClipAdam
    monkeypatch.setattr(ClipAdam, 'step_',
                        lambda self, params, grads, count, mu, nu: None)


def _half_batch(monkeypatch):
    from learning_to_adapt_torch.models.meta_mlp import MetaMLPDynamicsModel
    from learning_to_adapt_torch.models.mlp import MLPDynamicsModel
    meta = MetaMLPDynamicsModel.meta_loss_fn
    terms = MLPDynamicsModel.loss_terms

    def meta_half(self, params, norm, obs, act, delta):
        h = obs.shape[0] // 2
        return meta(self, params, norm, obs[:h], act[:h], delta[:h])

    def terms_half(self, params, norm, rows, w):
        h = rows.shape[0] // 2
        return terms(self, params, norm, rows[:h], w[:h])
    monkeypatch.setattr(MetaMLPDynamicsModel, 'meta_loss_fn', meta_half)
    monkeypatch.setattr(MLPDynamicsModel, 'loss_terms', terms_half)


def _altered_gradient(monkeypatch):
    from learning_to_adapt_torch.models.optim import ClipAdam
    real = ClipAdam.step_

    def altered(self, params, grads, count, mu, nu):
        torch._foreach_mul_(grads, 1.01)
        return real(self, params, grads, count, mu, nu)
    monkeypatch.setattr(ClipAdam, 'step_', altered)


SAMPLE_FAULTS = [_unchanged_physics, _half_candidates, _altered_action]
FIT_FAULTS = [_unchanged_state, _half_batch, _altered_gradient]


@pytest.mark.parametrize('fault', SAMPLE_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize('name', ['grbal_sample', 'mb_mpc_sample'])
def test_broken_sampling_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = numbers(name)
    assert not correct, checks


@pytest.mark.parametrize('fault', FIT_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize('name', ['grbal_fit', 'mb_mpc_fit'])
def test_broken_fit_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = numbers(name)
    assert not correct, checks


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload', 'mb_mpc_fit',
         '--seed', '1', '--seconds', '1', '--trace', '1'],
        cwd=cells.ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ''
    assert 'cuda' in out.stderr.lower()


@pytest.mark.cuda
def test_card_run_is_correct():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    import json
    out = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload', 'mb_mpc_fit',
         '--seed', str(SEED), '--seconds', '3', '--trace', '0'],
        cwd=cells.ROOT, capture_output=True, text=True, check=True)
    result = json.loads(out.stdout.splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'


def test_fit_call_must_run_its_steps():
    """On the card a fit call's train steps are its captured train steps'
    replays; a call that ran another number than the traffic makes stops
    the run."""
    from types import SimpleNamespace
    fit = cells.driver('fit')
    graphs = [SimpleNamespace(train=SimpleNamespace(replays=7)),
              SimpleNamespace(train=SimpleNamespace(replays=5))]
    model = SimpleNamespace(_epoch_cache=dict(enumerate(graphs)))
    ctx = SimpleNamespace(device=torch.device('cuda'))
    before = fit.train_replays(model)
    graphs[1].train.replays += 512
    assert fit.ran_steps(ctx, model, before, 512) == 512
    before = fit.train_replays(model)
    graphs[0].train.replays += 256
    with pytest.raises(RuntimeError, match='ran 256 train steps'):
        fit.ran_steps(ctx, model, before, 512)
