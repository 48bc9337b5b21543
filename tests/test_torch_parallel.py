"""The port's data parallelism over ranks (learning_to_adapt_torch/parallel
/mesh.py) on the CPU: a 2-rank gloo job (tests/_torch_multihost_worker.py
started twice with torchrun's variables) against a 1-rank job, both run
once by a module fixture, as tests/test_multihost.py runs the JAX package's
multi-controller jobs; and the mesh's math against the JAX package's on the
8 virtual CPU devices of tests/conftest.py.

The 2-rank run must compute what the 1-rank run computes: the sampler's
paths (every random draw is made for all envs and sliced), the meta fit bit
for bit (its windows are assembled by adding zeros), the MLP and RNN fits
up to f32 reduction order, with both ranks' parameters bitwise equal."""
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from learning_to_adapt_torch import entry as port_entry
from learning_to_adapt_torch import run_grbal_multihost
from learning_to_adapt_torch.envs import HalfCheetahEnv, normalize
from learning_to_adapt_torch.models import MetaMLPDynamicsModel
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.policies import MPCController
from learning_to_adapt_torch.samplers import Sampler
from learning_to_adapt_torch.samplers.rollout import make_rollout_fn
import test_torch_mbmpc as mbmpc_parity
import test_torch_rebal as rebal_parity
from _torch_multihost_worker import planner_returns
from learning_to_adapt_tpu.parallel import mesh as jax_mesh
from test_torch_train import (
    EPOCH_TOL, _draw_windows, _jax_epoch, _models, _paths)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', '_torch_multihost_worker.py')
HEADER_CSV = os.path.join(REPO, 'results', 'grbal_halfcheetah_tpu_r3.csv')
JOB_TIMEOUT = 240                       # seconds; a job takes ~10
STEP_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_infra.py:124-127
FIT_TOL = dict(rtol=2e-4, atol=2e-5)    # tests/test_infra.py:183-188
PATH_KEYS = ('observations', 'actions', 'rewards', 'next_observations')
# the planner's candidate returns, 2 ranks vs 1: the same model on other
# batch shapes, so f32 rounding apart
RETURN_TOL = dict(rtol=1e-5, atol=1e-5)


def _job_env(rank=None, port=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                        'MASTER_PORT')}
    if rank is not None:
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE='2',
                   MASTER_ADDR='localhost', MASTER_PORT=str(port))
    return env


def _write_inputs(path):
    """The JAX model's state and the paths and windows of
    test_torch_train.py's injected-window epoch; returns the JAX epoch's
    (params, losses) on them."""
    jm, _ = _models()
    train, test = _paths(6, 40, 2), _paths(2, 40, 3)
    train = (train[0], train[1], train[2] - train[0])
    test = (test[0], test[1], test[2] - test[0])
    rng = np.random.RandomState(4)
    windows = (_draw_windows(rng, 8, 6, 40, 4, 8) +
               _draw_windows(rng, 2, 2, 40, 4, 8))
    params, _, *losses = _jax_epoch(jm, jm.params, jm.opt_state, train,
                                    test, windows, 8)
    norm = jm.normalizer
    arrays = dict(n_layers=len(jm.params['w']), n_train=8,
                  pidx=np.stack([p for p, _ in windows]),
                  offs=np.stack([o for _, o in windows]))
    for i, (w, b) in enumerate(zip(jm.params['w'], jm.params['b'])):
        arrays[f'w_{i}'], arrays[f'b_{i}'] = np.asarray(w), np.asarray(b)
    for i, name in enumerate(('obs_mean', 'obs_std', 'act_mean', 'act_std',
                              'delta_mean', 'delta_std')):
        arrays[f'norm_{i}'] = np.asarray(getattr(norm, name))
    for split, (o, a, d) in (('train', train), ('test', test)):
        arrays.update({f'{split}_obs': o, f'{split}_act': a,
                       f'{split}_delta': d})
    np.savez(path, **arrays)
    # leaves in the port's tree_leaves order (dict keys sorted), as JAX's
    return [np.asarray(x) for x in jax.tree.leaves(params)], np.asarray(
        losses)


def _write_epochs(path):
    """The port models' state, data and the JAX draws of
    tests/test_torch_mbmpc.py's MLP epoch on an injected permutation (50
    real rows in 64, 4 steps of 16) and tests/test_torch_rebal.py's LSTM
    epoch on injected path indices (6 real paths in 8, 3 steps of 3
    paths); returns {name: the JAX epoch's (params, losses, Adam mu)}."""
    jm, pm = mbmpc_parity._models(1)
    j_train, p_train = mbmpc_parity._padded(50, 64, 3)
    j_test, p_test = mbmpc_parity._padded(10, 64, 4)
    key = jax.random.PRNGKey(5)
    j_mlp = jm._get_epoch_fn(64, 64, 4)(
        jm.params, jm.opt_state, jm.normalizer,
        tuple(map(jnp.asarray, j_train)), tuple(map(jnp.asarray, j_test)),
        key)
    jobs = dict(mlp=dict(
        kw=dict(hidden_sizes=(32, 32), batch_size=16, learning_rate=1e-3,
                seed=0),
        state=pm.state_dict(), n_batches=4,
        train=tuple(x.numpy() for x in p_train),
        test=tuple(x.numpy() for x in p_test),
        perm=np.array(jax.random.permutation(key, 64))))

    jm, pm = rebal_parity._models('lstm', hidden=(24,))
    j_tr, p_tr, _ = rebal_parity._staged(6, 8, 40, 5)
    j_te, _, p_te = rebal_parity._staged(3, 8, 40, 6)
    key = jax.random.PRNGKey(7)
    j_rnn = jm._get_epoch_fn(8, 8, 40, 3)(
        jm.params, jm.opt_state, jm.normalizer,
        tuple(map(jnp.asarray, j_tr)), tuple(map(jnp.asarray, j_te)),
        jnp.asarray(6), key)
    jobs['rnn'] = dict(
        kw=dict(hidden_sizes=(24,), cell_type='lstm', learning_rate=1e-3,
                batch_size=3, backprop_steps=10),
        state=pm.state_dict(), n_batches=3, n_tr=6, train=p_tr.numpy(),
        test=tuple(x.numpy() for x in p_te),
        # the path indices the JAX epoch drew (models/rnn.py:264, 272)
        path_idx=[np.array(jax.random.randint(k, (3,), 0, 6))
                  for k in jax.random.split(key, 3)])
    with open(path, 'wb') as f:
        pickle.dump(jobs, f)
    out = {}
    for name, (params, opt_state, train_loss, valid) in (('mlp', j_mlp),
                                                          ('rnn', j_rnn)):
        out[name] = ([np.asarray(x) for x in jax.tree.leaves(params)],
                     np.array([float(train_loss), float(valid)]),
                     [np.asarray(x) for x in
                      jax.tree.leaves(opt_state[1][0].mu)])
    return out


def _load(out, job, rank):
    stem = os.path.join(out, f'{job}_rank{rank}')
    with open(stem + '.json') as f:
        info = json.load(f)
    return dict(np.load(stem + '.npz')), info


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{'single': (arrays, info), 'pair': [(arrays, info) of rank 0, 1],
    'jax_epoch': (params, losses), 'jax_epochs': {'mlp', 'rnn': (params,
    losses, Adam mu)}}."""
    out = str(tmp_path_factory.mktemp('torch_multihost'))
    jax_epoch = _write_inputs(os.path.join(out, 'inputs.npz'))
    jax_epochs = _write_epochs(os.path.join(out, 'epochs.pkl'))
    port = par_mesh.free_port()
    cmds = [(['single'], _job_env())] + [
        (['pair'], _job_env(r, port)) for r in range(2)]
    procs = [subprocess.Popen([sys.executable, WORKER, out] + args, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for args, env in cmds]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOB_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), '\n'.join(
        log[-4000:] for log in logs)
    return dict(single=_load(out, 'single', 0),
                pair=[_load(out, 'pair', r) for r in range(2)],
                jax_epoch=jax_epoch, jax_epochs=jax_epochs)


def _leaves_of(arrays, prefix):
    n = sum(k.startswith(prefix) for k in arrays)
    return [arrays[f'{prefix}{i}'] for i in range(n)]


def test_jobs_ran_on_their_meshes(runs):
    single, pair = runs['single'][1], [info for _, info in runs['pair']]
    assert (single['world'], single['rank'], single['backend']) == (
        1, 0, 'gloo')
    assert [(i['world'], i['rank']) for i in pair] == [(2, 0), (2, 1)]


@pytest.mark.parametrize('algo', ['grbal', 'mbmpc'])
def test_random_call_matches_one_rank(runs, algo):
    """Every rank gathers the same paths, and they are the 1-rank run's
    (reset, task and action draws made for all envs, then sliced)."""
    single = runs['single'][0]
    (r0, _), (r1, _) = runs['pair']
    for k in PATH_KEYS:
        key = f'{algo}_random_{k}'
        assert r0[key].shape[0] == 8
        np.testing.assert_array_equal(r0[key], r1[key])
        np.testing.assert_allclose(r0[key], single[key], **STEP_TOL,
                                   err_msg=key)


def _first_parting_step(a, b):
    """The first step at which paths a and b part by more than STEP_TOL, or
    None."""
    close = np.ones(a['observations'].shape[1], bool)
    for k in PATH_KEYS:
        ok = np.isclose(a[k], b[k], **STEP_TOL)
        close &= ok.reshape(ok.shape[0], ok.shape[1], -1).all(axis=(0, 2))
    bad = np.flatnonzero(~close)
    return int(bad[0]) if bad.size else None


def _order_gaps(returns, n_elites):
    """(iterations,) the smallest gap in the returns of one env's
    candidates (iterations, n) that its planner's choice rests on: best vs
    second best, and for CEM the last elite vs the first non-elite."""
    r = -np.sort(-returns, axis=-1)
    gaps = [r[:, 0] - r[:, 1]]
    if n_elites is not None:
        gaps.append(r[:, n_elites - 1] - r[:, n_elites])
    return np.min(gaps, axis=0)


def check_policy_paths(a, b, ret_a, ret_b, n_elites=None):
    """Holds the policy paths a of one run to those of another, b, both
    dicts of (envs, T, ...) arrays, with the planner's candidate returns of
    each step ret_a, ret_b (T, iterations, envs, n). Up to the first step
    where the paths part, the returns of every candidate agree to
    RETURN_TOL (the two runs scored the same candidates with the same
    model) and the paths to STEP_TOL. A parting passes only as a near tie:
    after step 0, in one env, where the returns agree up to an iteration
    whose order gap is within twice their difference, so f32 rounding can
    flip the choice. Returns the parting step or None."""
    step = _first_parting_step(a, b)
    end = a['observations'].shape[1] if step is None else step
    for k in PATH_KEYS:
        np.testing.assert_allclose(a[k][:, :end], b[k][:, :end], **STEP_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(ret_a[:end], ret_b[:end], **RETURN_TOL)
    if step is None:
        return None
    assert step > 0, 'the paths part at step 0'
    acted = ~np.isclose(a['actions'][:, step], b['actions'][:, step],
                        **STEP_TOL).all(axis=-1)
    envs = np.flatnonzero(acted)
    assert envs.size == 1, f'step {step}: envs {envs} act otherwise'
    e = int(envs[0])
    others = np.arange(a['actions'].shape[0]) != e
    np.testing.assert_allclose(ret_a[step][:, others], ret_b[step][:, others],
                               **RETURN_TOL)
    for i in range(ret_a.shape[1]):
        x, y = ret_a[step, i, e], ret_b[step, i, e]
        np.testing.assert_allclose(x, y, **RETURN_TOL,
                                   err_msg=f'step {step} iteration {i}')
        noise = np.abs(x - y).max()
        gap = min(_order_gaps(x[None], n_elites)[0],
                  _order_gaps(y[None], n_elites)[0])
        if gap <= 2 * noise:
            return step
    raise AssertionError(f'step {step}, env {e}: no near tie explains the '
                         'parting')


def _n_elites(algo):
    """CEM's elite count in the jobs' MB-MPC config (24 candidates, 10 %),
    or None for random shooting."""
    return max(int(24 * 0.1), 1) if algo == 'mbmpc' else None


@pytest.mark.parametrize('algo', ['grbal', 'mbmpc'])
def test_policy_call_matches_one_rank(runs, algo):
    """The planner (GrBAL: random shooting with per-env adaptation;
    MB-MPC: CEM) on sliced candidates or normals: every candidate's return
    and every step agree with the 1-rank run, up to a near tie that parts
    the paths (check_policy_paths)."""
    single = runs['single'][0]
    (r0, _), (r1, _) = runs['pair']
    a = {k: r0[f'{algo}_policy_{k}'] for k in PATH_KEYS}
    b = {k: single[f'{algo}_policy_{k}'] for k in PATH_KEYS}
    for k in PATH_KEYS:
        np.testing.assert_array_equal(a[k], r1[f'{algo}_policy_{k}'])
    # each rank recorded its own envs' returns
    ret_a = np.concatenate([r0[f'{algo}_policy_returns'],
                            r1[f'{algo}_policy_returns']], axis=2)
    assert ret_a.shape == single[f'{algo}_policy_returns'].shape
    check_policy_paths(a, b, ret_a, single[f'{algo}_policy_returns'],
                       _n_elites(algo))


def _rollout_paths(env, policy, model, mesh, t_len, seed=5):
    """One policy call's paths (numpy) and candidate returns (T,
    iterations, envs, n) of make_rollout_fn on mesh's share of 8 envs."""
    fn = make_rollout_fn(env, policy, model, 8, t_len, adapt_batch_size=4,
                         mesh=mesh)
    gen = torch.Generator()
    gen.manual_seed(seed)
    with planner_returns([]) as returns:
        paths = fn(model.params, model.normalizer, gen, 0)
    iters = policy.num_cem_iters if policy.use_cem else 1
    m = paths['observations'].shape[0]
    return ({k: paths[k].numpy() for k in PATH_KEYS},
            torch.stack(returns).reshape(t_len, iters, m, -1).numpy())


@pytest.mark.parametrize('algo', ['grbal', 'mbmpc'])
def test_policy_check_catches_a_mis_sliced_draw(algo):
    """Two ranks' rollouts run here one after the other (a rollout makes no
    collective) pass check_policy_paths against the 1-rank rollout; with
    a planted mis-slice (each rank planning with its neighbour env's
    candidates or normals) they fail it."""
    from learning_to_adapt_torch.models import MLPDynamicsModel
    env = normalize(HalfCheetahEnv(task='cripple', device='cpu'))
    if algo == 'grbal':
        model = MetaMLPDynamicsModel('d', env, hidden_sizes=(32,),
                                     meta_batch_size=4, batch_size=4,
                                     inner_learning_rate=0.01, seed=3,
                                     device='cpu')
        policy = MPCController('p', env, model, n_candidates=24, horizon=3)
    else:
        model = MLPDynamicsModel('d', env, hidden_sizes=(32,), seed=3,
                                 device='cpu')
        policy = MPCController('p', env, model, n_candidates=24, horizon=3,
                               use_cem=True, num_cem_iters=2)
    t_len = 8
    single, ret_single = _rollout_paths(env, policy, model, None, t_len)

    def two_ranks():
        parts = [_rollout_paths(env, policy, model,
                                par_mesh.Mesh(r, 2, 2, 1, torch.device('cpu'),
                                              'gloo'), t_len)
                 for r in range(2)]
        return ({k: np.concatenate([p[k] for p, _ in parts])
                 for k in PATH_KEYS},
                np.concatenate([r for _, r in parts], axis=2))
    paths, returns = two_ranks()
    check_policy_paths(paths, single, returns, ret_single, _n_elites(algo))
    draw = policy.draw

    def mis_sliced(generator, m, **like):
        candidates, normals = draw(generator, m, **like)
        if candidates is not None:
            return candidates.roll(policy.n_candidates, dims=1), None
        return None, normals.roll(1, dims=2)
    policy.draw = mis_sliced
    paths, returns = two_ranks()
    with pytest.raises(AssertionError):
        check_policy_paths(paths, single, returns, ret_single,
                           _n_elites(algo))


@pytest.mark.parametrize('call', ['grbal_random', 'grbal_policy',
                                  'mbmpc_random', 'mbmpc_policy'])
def test_one_gather_a_sampling_call_and_none_in_a_step(runs, call):
    infos = [runs['single'][1]] + [info for _, info in runs['pair']]
    for info in infos:
        assert info[f'{call}_counts'] == dict(all_reduce=0, all_gather=1,
                                              broadcast=0)
        assert info[f'{call}_steps_counts'] == dict(
            all_reduce=0, all_gather=0, broadcast=0)


def test_meta_fit_bit_for_bit(runs):
    single = _leaves_of(runs['single'][0], 'meta_params_')
    r0, r1 = (_leaves_of(a, 'meta_params_') for a, _ in runs['pair'])
    assert len(single) == 4
    for a, b, c in zip(r0, r1, single):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize('name', ['mlp', 'rnn', 'ensemble'])
def test_data_parallel_fits_match_one_rank(runs, name):
    single = _leaves_of(runs['single'][0], f'{name}_params_')
    r0, r1 = (_leaves_of(a, f'{name}_params_') for a, _ in runs['pair'])
    assert single
    for a, b, c in zip(r0, r1, single):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, **FIT_TOL)


@pytest.mark.parametrize('name', ['meta', 'mlp', 'rnn'])
def test_fit_collectives_per_step_and_epoch(runs, name):
    """One broadcast of the learner's state a fit; per epoch, the meta fit
    one all_reduce a train step and a validation step, the MLP and RNN
    fits two a train step (the minibatch, then the gradients), and one
    more for the epoch's losses."""
    for _, info in [runs['single']] + runs['pair']:
        epochs = info[f'{name}_epochs'] + 1
        if name == 'meta':
            steps, valid = info['meta_steps']
            per_epoch = steps + valid + 1
        else:
            per_epoch = 2 * info[f'{name}_batches'] + 1
        assert info[f'{name}_counts'] == dict(
            all_reduce=epochs * per_epoch, all_gather=0, broadcast=1)


def test_early_stop_at_the_same_epoch(runs):
    epochs = [info['stop_epochs'] for _, info in
              [runs['single']] + runs['pair']]
    assert epochs[0] < runs['single'][1]['stop_max_epochs'] - 1
    assert len(set(epochs)) == 1


def test_data_parallel_grad_step_matches_jax(runs):
    """tests/test_infra.py:130-156's toy loss: the JAX shard_map step on 8
    devices and the port's on 2 ranks give the single-device SGD step."""
    mesh = jax_mesh.make_mesh(n_env=8, n_model=1)
    params = {'w': jnp.ones((4, 4))}

    def loss_fn(params, x, y):
        return jnp.mean((x @ params['w'] - y) ** 2)
    opt = optax.sgd(0.1)
    step = jax_mesh.data_parallel_grad_step(mesh, loss_fn, opt)
    x = jnp.asarray(np.random.RandomState(0).randn(16, 4), jnp.float32)
    y = x @ jnp.ones((4, 4)) * 0.5
    with mesh:
        want, _, loss = step(params, opt.init(params),
                             *jax_mesh.shard_batch(mesh, (x, y)))
    for arrays, _ in [runs['single']] + runs['pair']:
        np.testing.assert_allclose(arrays['dp_w'], np.asarray(want['w']),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(arrays['dp_loss'], float(loss), rtol=1e-5)


def test_psum_normalizer_stats_matches_jax(runs):
    """Global mean and std from per-rank sums. Both packages take
    var = E[x^2] - mean^2, which cancels where |mean| >> std, so the data
    keep |mean| <= std, where the two summation orders agree to 1e-5."""
    from jax import shard_map
    mesh = jax_mesh.make_mesh(n_env=8, n_model=1)
    rng = np.random.RandomState(1)
    data = [jnp.asarray(rng.randn(16, d).astype(np.float32) * s + o)
            for d, s, o in ((20, 2.0, 1.0), (6, 0.5, 0.0), (20, 1.0, -0.5))]
    fn = shard_map(jax_mesh.psum_normalizer_stats, mesh=mesh,
                   in_specs=(P('env'),) * 3, out_specs=P(), check_vma=False)
    with mesh:
        want = jax.jit(fn)(*data)
    for arrays, _ in [runs['single']] + runs['pair']:
        for i, (m, s) in enumerate(want):
            np.testing.assert_allclose(arrays[f'norm_mean_{i}'], m,
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(arrays[f'norm_std_{i}'], s,
                                       rtol=1e-5, atol=1e-5)


def test_sharded_meta_epoch_matches_jax(runs):
    """Eight meta-train and two validation steps on injected windows
    (tests/test_torch_train.py's epoch) over paths sharded on 2 ranks,
    against the JAX epoch."""
    want_params, want_losses = runs['jax_epoch']
    for arrays, _ in [runs['single']] + runs['pair']:
        np.testing.assert_allclose(arrays['window_losses'], want_losses,
                                   **EPOCH_TOL)
        for a, b in zip(_leaves_of(arrays, 'window_params_'), want_params):
            np.testing.assert_allclose(a, b, **EPOCH_TOL)


@pytest.mark.parametrize('name', ['mlp', 'rnn'])
def test_sharded_epoch_matches_jax(runs, name):
    """tests/test_torch_mbmpc.py's MLP epoch (4 steps on an injected
    permutation of 64 padded rows, 32 a rank) and test_torch_rebal.py's
    LSTM epoch (3 steps of 3 injected paths of 8, 4 a rank, so the ranks
    compute 1 and 2 paths of a batch) against the JAX epoch, at those
    files' EPOCH_TOL; the ranks alike, and two all_reduces a step and one
    for validation."""
    want_params, want_losses, want_mu = runs['jax_epochs'][name]
    steps = 4 if name == 'mlp' else 3
    (r0, _), (r1, _) = runs['pair']
    for arrays, info in [runs['single']] + runs['pair']:
        assert info[f'{name}_epoch_counts'] == dict(
            all_reduce=2 * steps + 1, all_gather=0, broadcast=0)
        np.testing.assert_allclose(arrays[f'{name}_epoch_losses'],
                                   want_losses, **EPOCH_TOL)
        for prefix, want in (('params_', want_params), ('mu_', want_mu)):
            got = _leaves_of(arrays, f'{name}_epoch_{prefix}')
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, **EPOCH_TOL)
    for a, b in zip(_leaves_of(r0, f'{name}_epoch_params_'),
                    _leaves_of(r1, f'{name}_epoch_params_')):
        np.testing.assert_array_equal(a, b)


def test_members_over_the_model_axis_step_independently(runs):
    """Four ensemble members on a (1, 2) mesh, two a rank, each stepped on
    its own loss (tests/test_configs.py:46-82): gathered over 'model' they
    equal the unsharded step, and their losses differ."""
    for arrays, _ in runs['pair']:
        sharded = _leaves_of(arrays, 'members_sharded_')
        plain = _leaves_of(arrays, 'members_plain_')
        assert sharded and sharded[0].shape[0] == 4
        for a, b in zip(sharded, plain):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        losses = arrays['member_losses']
        np.testing.assert_allclose(losses, arrays['plain_member_losses'],
                                   rtol=1e-6)
        assert len(set(np.round(losses, 8).tolist())) == 4


def test_run_grbal_multihost_writes_from_rank_zero_only(runs):
    """Rank 0 writes the experiment (run_grbal's progress.csv header, and
    the Trainer's iterations.jsonl); rank 1 writes nothing; 3 rollouts
    round up to 4 on two ranks, and the losses and returns are the 1-rank
    run's."""
    (_, r0), (_, r1) = runs['pair']
    single = runs['single'][1]
    assert r0['trainer_files'] == single['trainer_files'] == [
        'iterations.jsonl', 'log.txt', 'params.json', 'params.pkl',
        'progress.csv']
    assert r1['trainer_written'] == []
    assert r0['trainer_num_rollouts'] == r1['trainer_num_rollouts'] == 4
    with open(HEADER_CSV) as f:
        header = f.readline()
    rows = {}
    for name, info in (('pair', r0), ('single', single)):
        lines = info['trainer_progress'].splitlines(True)
        assert lines[0] == header and len(lines) == 3
        keys = header.strip().split(',')
        rows[name] = [dict(zip(keys, line.strip().split(',')))
                      for line in lines[1:]]
    for a, b in zip(rows['pair'], rows['single']):
        for k in ('Pre-Loss', 'Post-Loss', 'EnvTrajs-AverageReturn',
                  'Epochs', 'n_timesteps'):
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_dryrun_multichip_two_cpu_ranks():
    port_entry.dryrun_multichip(2, device='cpu')


def _three_rank_mesh():
    """A mesh object of 3 ranks on the 'env' axis, without a process group:
    the divisibility checks raise before any collective."""
    return par_mesh.Mesh(0, 3, 3, 1, torch.device('cpu'), 'gloo')


def test_indivisible_rollouts_and_capacities_raise():
    env = normalize(HalfCheetahEnv(task=None, device='cpu'))
    model = MetaMLPDynamicsModel('d', env, hidden_sizes=(8,), device='cpu')
    policy = MPCController('p', env, model, n_candidates=4, horizon=2)
    mesh = _three_rank_mesh()
    with pytest.raises(ValueError, match='divide'):
        Sampler(env, policy, num_rollouts=8, max_path_length=5,
                device='cpu', mesh=mesh)
    with pytest.raises(ValueError, match='divide'):
        make_rollout_fn(env, policy, model, 8, 5, mesh=mesh)
    model.mesh = mesh
    with pytest.raises(ValueError, match='divide'):
        model.stage(dict(obs=np.zeros((2, 10, 20), np.float32),
                         act=np.zeros((2, 10, 6), np.float32),
                         delta=np.zeros((2, 10, 20), np.float32)), 64)


def test_make_mesh_refuses_nccl_without_a_card(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match='gloo'):
        par_mesh.make_mesh(device='cpu', backend='nccl')
    with pytest.raises(RuntimeError, match='cuda'):
        par_mesh.make_mesh()
    # the entry point raises before writing anything unless --device cpu
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='cuda'):
        run_grbal_multihost.main(['--n_itr', '1'])
    assert not (tmp_path / 'data').exists()
