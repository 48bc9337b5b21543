"""The port's entry points on the terrain, blocks, arm and Ant envs, on
the CPU at test size, chosen through --env as a user chooses them:
run_grbal on each of these envs (progress.csv with the header of the JAX
run on that env, letter for letter), run_mb_mpc and run_rebal on the arm
and the Ant, the task-distribution flags reaching the env, and an unknown
--env refused."""
import math
import os
import pickle

import pytest
import torch

from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch import run_grbal, run_mb_mpc, run_rebal

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _header(name):
    with open(os.path.join(REPO, 'results', name)) as f:
        return f.readline()


def _arm_header(name):
    """The JAX run's header on HalfCheetah with the arm's diagnostics in
    place of the forward-progress ones (the arm's log_diagnostics writes
    AverageFinalDistance and MinFinalDistance, as
    results/grbal_arm7dof_force_tpu_r4.csv shows for GrBAL)."""
    progress = ','.join(f'EnvTrajs-{k}ForwardProgress'
                        for k in ('Average', 'Max', 'Min', 'Std'))
    return _header(name).replace(
        progress, 'EnvTrajs-AverageFinalDistance,EnvTrajs-MinFinalDistance')


#: sizes of each entry point's tiny run (as tests/test_torch_train.py,
#: test_torch_mbmpc.py and test_torch_rebal.py size them)
TINY = {
    run_grbal: dict(max_path_length=20, num_rollouts=2, n_candidates=8,
                    horizon=3, hidden_sizes_model=(32,), adapt_batch_size=4,
                    meta_batch_size=4, dynamic_model_epochs=2),
    run_mb_mpc: dict(max_path_length=20, num_rollouts=2, n_candidates=8,
                     horizon=3, hidden_sizes=(32,), batch_size=16,
                     dynamic_model_epochs=2),
    run_rebal: dict(max_path_length=20, num_rollouts=2, n_candidates=8,
                    horizon=3, hidden_sizes=(16,), batch_size=2,
                    backprop_steps=10, dynamic_model_epochs=2),
}


def _run(entry, argv, tmp_path, monkeypatch):
    """entry's command line, then its config cut to test size, run in
    tmp_path; returns (progress.csv lines, snapshot, trainer)."""
    monkeypatch.chdir(tmp_path)
    cfg = entry.config_from_args(entry.parse_args(
        argv + ['--device', 'cpu', '--n_itr', '2', '--exp_name', 'e']))
    cfg.update(TINY[entry])
    trainer = entry.run_experiment(cfg)
    exp_dir = tmp_path / 'data' / entry.EXP_NAME / 'e'
    lines = (exp_dir / 'progress.csv').read_text().splitlines(True)
    snap = pickle.loads((exp_dir / 'params.pkl').read_bytes())
    return lines, snap, trainer


def _check(lines, want_header, loss_keys):
    assert lines[0] == want_header
    assert len(lines) == 3
    keys = want_header.strip().split(',')
    for row in lines[1:]:
        vals = dict(zip(keys, row.strip().split(',')))
        for k in loss_keys + ('EnvTrajs-AverageReturn',):
            assert math.isfinite(float(vals[k])), k


@pytest.mark.parametrize('argv,cls,header,env_kw', [
    (['--env', 'HalfCheetahHFieldEnv', '--task', 'hfield'],
     port_envs.HalfCheetahHFieldEnv, 'grbal_cheetah_hfield_tpu_r3.csv', {}),
    (['--env', 'HalfCheetahHFieldEnv', '--task', 'hfield',
      '--terrain_set', 'gentle,hill'],
     port_envs.HalfCheetahHFieldEnv, 'grbal_cheetah_hfield_tpu_r3.csv',
     dict(terrain_set=('gentle', 'hill'))),
    (['--env', 'HalfCheetahBlocksEnv', '--task', 'damping',
      '--damping_range', '2:4'],
     port_envs.HalfCheetahBlocksEnv, 'grbal_blocks_tpu_r5.csv',
     dict(damping_range=(2.0, 4.0))),
    (['--env', 'Arm7DofEnv', '--task', 'force', '--force_range', '0.5:1'],
     port_envs.Arm7DofEnv, 'grbal_arm7dof_force_tpu_r4.csv',
     dict(force_range=(0.5, 1.0))),
], ids=['hfield', 'hfield-terrain_set', 'blocks', 'arm'])
def test_run_grbal_on_env(argv, cls, header, env_kw, tmp_path, monkeypatch):
    """Two GrBAL iterations (one random, one policy) through --env: the
    JAX run's header on that env, finite losses and returns, and a
    params.pkl that re-creates its env with the task and its range."""
    lines, snap, trainer = _run(run_grbal, argv, tmp_path, monkeypatch)
    _check(lines, _header(header), ('Pre-Loss', 'Post-Loss'))
    env = snap['env'].wrapped_env
    assert type(env) is cls and env.task == argv[3]
    for k, v in env_kw.items():
        assert getattr(env, k) == v
    assert snap['dynamics_model']['train']['obs'].shape[-1] == env.obs_dim
    assert trainer.sampler.total_timesteps_sampled == 2 * 2 * 20


@pytest.mark.parametrize('entry,header,loss_keys', [
    (run_mb_mpc, 'mb_mpc_halfcheetah_tpu_r3.csv', ('TrainLoss', 'ValidLoss')),
    (run_rebal, 'rebal_halfcheetah_tpu_r3.csv', ('TrainLoss',)),
], ids=['mb_mpc', 'rebal'])
def test_mb_mpc_and_rebal_on_the_arm(entry, header, loss_keys, tmp_path,
                                     monkeypatch):
    lines, snap, _ = _run(entry, ['--env', 'Arm7DofEnv', '--task', 'mass'],
                          tmp_path, monkeypatch)
    _check(lines, _arm_header(header), loss_keys)
    env = snap['env'].wrapped_env
    assert type(env) is port_envs.Arm7DofEnv and env.task == 'mass'


@pytest.mark.parametrize('entry,header,loss_keys', [
    (run_grbal, 'grbal_ant_cripple_tpu_r4.csv', ('Pre-Loss', 'Post-Loss')),
    (run_mb_mpc, 'mb_mpc_ant_cripple_tpu_r4.csv', ('TrainLoss', 'ValidLoss')),
    (run_rebal, 'rebal_ant_cripple_tpu_r4_seed1.csv', ('TrainLoss',)),
], ids=['grbal', 'mb_mpc', 'rebal'])
def test_entry_points_on_the_ant(entry, header, loss_keys, tmp_path,
                                 monkeypatch):
    """Two iterations of each algorithm through --env AntEnv --task cripple
    --cripple_set 3 (the meta-test holdout leg): the JAX Ant run's header,
    finite losses and returns, a params.pkl that re-creates the Ant with
    its leg set, and only leg 3 crippled in the sampled episodes."""
    lines, snap, trainer = _run(
        entry, ['--env', 'AntEnv', '--task', 'cripple', '--cripple_set', '3'],
        tmp_path, monkeypatch)
    _check(lines, _header(header), loss_keys)
    env = snap['env'].wrapped_env
    assert type(env) is port_envs.AntEnv and env.task == 'cripple'
    assert env.cripple_set == (3,) and env.obs_dim == 41
    assert trainer.sampler.total_timesteps_sampled == 2 * 2 * 20
    state = trainer.env.reset(4, 1, torch.Generator().manual_seed(0))
    assert (state.task['cripple_mask'][:, :2] == 0).all()
    assert (state.task['cripple_mask'][:, 2:] == 1).all()


@pytest.mark.parametrize('entry', [run_grbal, run_mb_mpc, run_rebal])
def test_ant_is_refused_naming_its_slice(entry):
    """Named from when --env AntEnv was refused: it now gives AntEnv, and
    an unknown name is refused naming the envs the port has."""
    cfg = entry.config_from_args(entry.parse_args(
        ['--env', 'AntEnv', '--task', 'cripple']))
    assert cfg['env'] is port_envs.AntEnv and cfg['task'] == 'cripple'
    with pytest.raises(ValueError, match='AntEnv'):
        entry.config_from_args(entry.parse_args(['--env', 'Humanoid']))


def test_new_envs_default_to_cuda_and_never_fall_back(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is usable')
    for cls in (port_envs.HalfCheetahHFieldEnv,
                port_envs.HalfCheetahBlocksEnv, port_envs.Arm7DofEnv,
                port_envs.AntEnv):
        with pytest.raises(RuntimeError, match='cuda'):
            cls()
    cfg = run_grbal.config_from_args(run_grbal.parse_args(
        ['--env', 'HalfCheetahBlocksEnv', '--task', 'damping']))
    assert cfg['device'] == 'cuda'
    with pytest.raises(RuntimeError, match='cuda'):
        run_grbal.run_experiment(cfg)
    assert not (tmp_path / 'data').exists()
