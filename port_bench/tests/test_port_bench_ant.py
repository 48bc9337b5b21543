"""The Ant's cell (grbal_sample_ant): it loads by name; its
configuration's physics constants are the model's; its launch counts hold
against hand counts; at a small size on the CPU the program's run is
correct, while the control, the reference's fault and each fault planted
in the program are not, a fault in one env of five among them; and its
reference loads nothing of the program or of JAX."""
import copy
import json

import pytest
import torch

from port_bench.lib import cell as cells
from port_bench.lib.hparams import hparams
from port_bench.lib.run import context, judge, run
from port_bench.roofline import counts
from port_bench.tests.test_port_bench_files import _loaded_after
from port_bench.tests.test_port_bench_runs import SAMPLE_FAULTS, SEED

CELL = 'grbal_sample_ant'


def test_cell_loads_by_name():
    cell = cells.load_cell(CELL)
    assert cell.config['name'] == cell.traffic['config'] == \
        'grbal_ant_cripple'
    assert cell.chips == 1 and cell.config['reduced'] == []
    drv = cells.driver(cell.traffic['driver'])
    assert all(callable(getattr(drv, k)) for k in (
        'setup', 'window', 'release', 'readings'))
    hp = hparams(cell.config)
    assert (hp.obs_dim, hp.act_dim, hp.envs, hp.t_len) == (41, 8, 5, 1000)
    assert (hp.n_candidates, hp.horizon, hp.hidden) == (500, 10,
                                                        [512, 512, 512])
    assert {m['name'] for m in cell.end_to_end} == {'env_steps_per_s',
                                                    'setup_s'}
    assert 'sample.qacc_ms' in {m['name'] for m in cell.per_layer}


def test_physics_constants_of_the_ant():
    """By test_physics_constants_of_the_configs' rule: two rows a limited
    hinge (8: 16 rows), four pyramid facets a contact point (the torso's
    sphere 1 point, each of 12 leg capsules 2: 100 rows); two Jacobi
    sweeps an iteration; RK4's four dynamics passes a physics step, each
    with its solve."""
    from learning_to_adapt_torch.physics import engine
    from port_bench.reference.physics import model_defs, spec
    phys = cells.load_cell(CELL).config['physics']
    m = model_defs.get_model(phys['model'])
    limits = 2 * int(sum(bool(lim) and t != spec.FREE for lim, t in
                         zip(m.jnt_limited, m.jnt_type)))
    points = {'plane_capsule': 2, 'plane_sphere': 1}
    contacts = sum((4 if m.geom_condim[a] >= 3 else 1) * points[kind]
                   for kind, pairs in m.pair_groups for a, _ in pairs)
    assert (limits, contacts) == (16, 100)
    assert limits + contacts == phys['constraint_rows'] == 116
    assert 2 * m.iterations == phys['jacobi_sweeps'] == 60
    assert m.integrator == spec.RK4 and phys['integrator'] == 'RK4'
    assert phys['solves_per_step'] == engine.PASSES[m.integrator] * \
        m.frame_skip == 4


def test_launch_counts_of_an_ant_call_by_hand():
    """One call of 5 envs x 1000 steps: 10 fused-MLP launches a step, on 5
    per-env weight sets once adapting (t >= 18), on the shared set before;
    4 Jacobi launches a step of 5 systems of 116 rows."""
    cell = cells.load_cell(CELL)
    hp = hparams(cell.config)
    launches = counts.sampling_launches(hp)
    assert launches == [(10 * 982, 5, 500, 5), (10 * 18, 5, 500, 1)]
    assert sum(c for c, _, _, _ in launches) == 10 * 1000
    p = 49 * 512 + 2 * 512 * 512 + 512 * 41
    flops, n_bytes = counts.fused_mlp_launch(5, 500, [49, 512, 512, 512, 41],
                                             5)
    assert flops == 2 * 2500 * p
    assert n_bytes == 2500 * (49 + 41) * 4 + 5 * (2 * p + 4 * (3 * 512 + 41))
    phys = cell.config['physics']
    assert hp.t_len * phys['solves_per_step'] == 4000
    assert counts.jacobi_launch(5, 116, 60) == (
        5 * 60 * (2 * 116 * 116 + 5 * 116), 5 * 4 * (116 * 116 + 3 * 116 + 1))


def small(envs=2):
    """The cell at a size a CPU test holds, with its real limits."""
    c = cells.load_cell(CELL)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg['run_config'].update(n_candidates=64, horizon=3, num_rollouts=envs,
                             max_path_length=24, adapt_batch_size=4,
                             meta_batch_size=4, hidden_sizes_model=[64, 64])
    tr['check'] = dict(calls=2, physics_steps=24, planner_steps=8)
    tr['warm_seconds'] = 0
    c.config, c.traffic = cfg, tr
    return c


def numbers(mode='program', seconds=0.2, envs=2):
    c = small(envs)
    drv = cells.driver(c.traffic['driver'])
    ctx = context(c, SEED, seconds, False, 'cpu')
    state = drv.setup(ctx)
    drv.window(ctx, state)
    drv.release(state)
    return judge(drv.readings(ctx, state, mode), c.traffic['limits'])


def test_small_run_is_correct():
    result = run(small(), SEED, 0.2, False, 'cpu', 0.0)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and list(result)[-1] == 'checks'
    assert set(result['metrics']) == {'env_steps_per_s', 'setup_s'}


@pytest.mark.parametrize('mode', ['control', 'fault'])
def test_control_and_fault_are_not_correct(mode):
    correct, checks = numbers(mode)
    assert not correct, checks
    # each fails by both of its numbers
    assert all(c['value'] > c['limit'] for c in checks.values()), checks


def test_one_step_off_at_a_limit_edge_is_correct():
    """A joint's velocity 1e-3 off in one transition of a call, as where
    the f32 program and the f64 reference part on whether a joint limit
    acts in one RK4 stage (PERF.md §2), leaves the run correct: the
    physics number is the widest over envs of the median of each env's
    transitions' gaps."""
    c = small()
    drv = cells.driver(c.traffic['driver'])
    ctx = context(c, SEED, 0.2, False, 'cpu')
    state = drv.setup(ctx)
    drv.window(ctx, state)
    drv.release(state)
    for _, _, paths in state['calls']:
        paths['qvel'][0, -1, 9] += 1e-3    # the last step is checked
    correct, checks = judge(drv.readings(ctx, state), c.traffic['limits'])
    assert correct, checks


def _wrong_leg(monkeypatch):
    """The port cripples the next leg in place of the drawn one."""
    from learning_to_adapt_torch.envs.ant import AntEnv
    real = AntEnv.cripple

    def wrong(self, mm, task, legs):
        return real(self, mm, task, (legs + 1) % 4)
    monkeypatch.setattr(AntEnv, 'cripple', wrong)


@pytest.mark.parametrize('fault', SAMPLE_FAULTS + [_wrong_leg],
                         ids=lambda f: f.__name__)
def test_broken_ant_sampling_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = numbers()
    assert not correct, checks


def _one_env_unstepped(monkeypatch):
    """The port leaves the physics of the batch's first env where it
    was."""
    from learning_to_adapt_torch.physics import engine
    real = engine.step

    def step(model, mm, state, ctrl):
        new = real(model, mm, state, ctrl)
        first = torch.zeros(state.qpos.shape[0], 1, dtype=torch.bool,
                            device=state.qpos.device)
        first[0] = True
        return engine.PhysicsState(
            qpos=torch.where(first, state.qpos, new.qpos),
            qvel=torch.where(first, state.qvel, new.qvel))
    monkeypatch.setattr(engine, 'step', step)


def _wrong_leg_in_one_env(monkeypatch):
    """The port cripples the next leg in the first env alone."""
    from learning_to_adapt_torch.envs.ant import AntEnv
    real = AntEnv.cripple

    def wrong(self, mm, task, legs):
        legs = legs.clone()
        legs[0] = (legs[0] + 1) % 4
        return real(self, mm, task, legs)
    monkeypatch.setattr(AntEnv, 'cripple', wrong)


@pytest.mark.parametrize('fault', [_one_env_unstepped,
                                   _wrong_leg_in_one_env],
                         ids=lambda f: f.__name__)
def test_a_fault_in_one_env_of_five_is_not_correct(fault, monkeypatch):
    """A fault in one env of five, a fifth of the checked transitions,
    fails the physics number: it is each env's own median, not the median
    of the transitions of all envs together."""
    fault(monkeypatch)
    correct, checks = numbers(envs=5)
    assert not correct, checks
    gap = checks['physics_gap']
    assert gap['value'] > gap['limit'], checks


def test_reference_loads_nothing_of_the_program():
    top = _loaded_after('import sys; sys.path.insert(0, ".")\n'
                        'import port_bench.reference.ant')
    assert not top & {'learning_to_adapt_torch', 'learning_to_adapt_tpu',
                      'jax', 'jaxlib', 'flax'}


def test_parent_without_the_cell_fails_fast(tmp_path):
    """A checkout whose BENCHMARK.json lacks the cell stops at once."""
    bench = cells.load_json(cells.ROOT / 'BENCHMARK.json')
    bench['workloads'] = [w for w in bench['workloads'] if w['name'] != CELL]
    path = tmp_path / 'BENCHMARK.json'
    path.write_text(json.dumps(bench))
    with pytest.raises(KeyError, match=CELL):
        cells.load_cell(CELL, path)

