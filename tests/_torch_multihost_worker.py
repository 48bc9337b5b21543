"""One rank of the port's multi-rank CPU jobs (tests/test_torch_parallel.py).

    python tests/_torch_multihost_worker.py OUT_DIR JOB

Run once alone (JOB 'single': make_mesh starts its own 1-rank group) and
twice with the variables torchrun sets (JOB 'pair': RANK, WORLD_SIZE = 2,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK), over gloo on the CPU. Each rank runs
the same seeded work through the port's sharded paths (parallel/mesh.py):
the sampler (GrBAL, MB-MPC with CEM; the planner's candidate returns of
every policy step recorded), the three fits, an early-stopping fit,
data_parallel_grad_step, psum_normalizer_stats, a meta epoch on the windows
of OUT_DIR/inputs.npz, an MLP and an RNN epoch on the injected permutation
and path indices of OUT_DIR/epochs.pkl, ensemble members over the 'model'
axis (pair only) and run_grbal_multihost, and writes its fingerprint to
OUT_DIR/JOB_rank<r>.npz (arrays) and .json (counts, epochs). Imports no
jax.
"""
import contextlib
import json
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from learning_to_adapt_torch import run_grbal  # noqa: E402
from learning_to_adapt_torch import run_grbal_multihost  # noqa: E402
from learning_to_adapt_torch.envs import (  # noqa: E402
    HalfCheetahEnv, normalize)
from learning_to_adapt_torch.models import (  # noqa: E402
    MetaMLPDynamicsModel, MLPDynamicsModel, RNNDynamicsModel, core)
from learning_to_adapt_torch.models.fitting import (  # noqa: E402
    _bucket_pow2)
from learning_to_adapt_torch.models.meta_mlp import (  # noqa: E402
    PATH_CHUNK)
from learning_to_adapt_torch.models.optim import (  # noqa: E402
    tree_leaves, tree_unflatten)
from learning_to_adapt_torch.parallel import mesh as par_mesh  # noqa: E402
from learning_to_adapt_torch.policies import (  # noqa: E402
    MPCController, planners)
from learning_to_adapt_torch.samplers import Sampler  # noqa: E402
from learning_to_adapt_torch.utils import logging as logger  # noqa: E402

N_ENVS, T_LEN = 8, 25
FIT_EPOCHS = 3


class SGD:
    """optax.sgd's update in the port's optimizer interface."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return tree_unflatten(params, [
            p - self.lr * g for p, g in zip(tree_leaves(params),
                                            tree_leaves(grads))]), state


def delta(before):
    now = par_mesh.collective_counts()
    return {k: now[k] - before[k] for k in now}


def leaves_np(tree):
    return [x.detach().numpy() for x in tree_leaves(tree)]


def fit_paths(n_paths=8, t_len=24, seed=0, obs_dim=20, act_dim=6):
    """tests/test_infra.py TestShardedFit's paths."""
    rng = np.random.RandomState(seed)
    obs = rng.randn(n_paths, t_len, obs_dim).astype(np.float32)
    act = rng.uniform(-1, 1, (n_paths, t_len, act_dim)).astype(np.float32)
    nxt = obs + 0.05 * rng.randn(*obs.shape).astype(np.float32)
    return obs, act, nxt


@contextlib.contextmanager
def planner_returns(record):
    """Appends the model-rollout returns of every candidate the planners
    score ((rows,) in the env-major layout: one call a step for random
    shooting, one a CEM iteration) to record."""
    returns = planners._returns

    def spy(*args, **kwargs):
        out = returns(*args, **kwargs)
        record.append(out.detach().clone())
        return out
    planners._returns = spy
    try:
        yield record
    finally:
        planners._returns = returns


def sample(mesh, arrays, info, name, policy, **kw):
    """A random and a policy call of a Sampler on `mesh`, with the
    collective counts of each call and those at its gather (after every
    step), and the policy call's candidate returns (T, CEM iterations,
    this rank's envs, candidates)."""
    at_gather = []
    gather = par_mesh.gather

    def spy(*args, **kwargs):
        at_gather.append(par_mesh.collective_counts())
        return gather(*args, **kwargs)
    sampler = Sampler(policy.env, policy, num_rollouts=N_ENVS,
                      max_path_length=T_LEN, seed=5, device='cpu', mesh=mesh,
                      **kw)
    par_mesh.gather = spy
    try:
        for call in ('random', 'policy'):
            before = par_mesh.collective_counts()
            with planner_returns([]) as returns:
                paths = sampler.obtain_samples(random=call == 'random')
            info[f'{name}_{call}_counts'] = delta(before)
            info[f'{name}_{call}_steps_counts'] = {
                k: at_gather[-1][k] - before[k] for k in before}
            for k in ('observations', 'actions', 'rewards',
                      'next_observations'):
                arrays[f'{name}_{call}_{k}'] = paths[k]
        # `returns` holds the last call's, the policy call's
        iters = policy.num_cem_iters if policy.use_cem else 1
        arrays[f'{name}_policy_returns'] = torch.stack(returns).reshape(
            T_LEN, iters, N_ENVS // mesh.shape['env'], -1).numpy()
    finally:
        par_mesh.gather = gather


def fit(mesh, arrays, info, name, model, data, **kw):
    model.mesh = mesh
    before = par_mesh.collective_counts()
    out = model.fit(*data, **kw)
    info[f'{name}_counts'] = delta(before)
    info[f'{name}_epochs'] = out['epochs']
    for i, x in enumerate(leaves_np(model.params)):
        arrays[f'{name}_params_{i}'] = x
    return model


def fits(mesh, arrays, info):
    env = normalize(HalfCheetahEnv(task=None, device='cpu'))
    obs, act, nxt = fit_paths()
    meta = fit(mesh, arrays, info, 'meta', MetaMLPDynamicsModel(
        'd', env, hidden_sizes=(16,), meta_batch_size=4, batch_size=8,
        seed=7, device='cpu'), (obs, act, nxt), epochs=FIT_EPOCHS)
    info['meta_steps'] = meta._fit_shapes(
        meta._train['obs'].shape[0], meta._test['obs'].shape[0], 24)[2:]

    def flat(x):
        return x.reshape(-1, x.shape[-1])
    mlp = fit(mesh, arrays, info, 'mlp', MLPDynamicsModel(
        'd', env, hidden_sizes=(16,), batch_size=16, seed=7, device='cpu'),
        (flat(obs), flat(act), flat(nxt)), epochs=FIT_EPOCHS)
    info['mlp_batches'] = _bucket_pow2(max(mlp._train['obs'].shape[0] // 16,
                                           1))
    rnn = fit(mesh, arrays, info, 'rnn', RNNDynamicsModel(
        'd', env, hidden_sizes=(16,), backprop_steps=8, batch_size=4, seed=7,
        device='cpu'), (obs, act, nxt), epochs=FIT_EPOCHS)
    info['rnn_batches'] = _bucket_pow2(max(rnn._train['obs'].shape[0] // 4,
                                           1))
    # an ensemble's members ride along the fit's rows
    fit(mesh, arrays, info, 'ensemble', MLPDynamicsModel(
        'd', env, hidden_sizes=(16,), batch_size=16, n_members=3, seed=7,
        device='cpu'), (flat(obs), flat(act), flat(nxt)), epochs=2)
    # a fit that stops early: a short rolling average, a large step
    fit(mesh, arrays, info, 'stop', MLPDynamicsModel(
        'd', env, hidden_sizes=(16,), batch_size=64, learning_rate=0.3,
        rolling_average_persitency=0.2, seed=7, device='cpu'),
        (flat(obs), flat(act), flat(nxt)), epochs=40)
    info['stop_max_epochs'] = 40


def math(mesh, arrays, info):
    """data_parallel_grad_step on tests/test_infra.py's toy loss and
    psum_normalizer_stats, each on this rank's shard."""
    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    y = (x @ np.ones((4, 4), np.float32)) * 0.5

    def loss_fn(params, x, y):
        return torch.mean(torch.square(x @ params['w'] - y))
    step = par_mesh.data_parallel_grad_step(mesh, loss_fn, SGD(0.1))
    params = {'w': torch.ones((4, 4))}
    params, _, loss = step(params, None, *par_mesh.shard_batch(mesh, (x, y)))
    arrays['dp_w'] = params['w'].numpy()
    arrays['dp_loss'] = loss.numpy()

    rng = np.random.RandomState(1)
    data = [rng.randn(16, d).astype(np.float32) * s + o
            for d, s, o in ((20, 2.0, 1.0), (6, 0.5, 0.0), (20, 1.0, -0.5))]
    stats = par_mesh.psum_normalizer_stats(
        mesh, *par_mesh.shard_batch(mesh, tuple(data)))
    for i, (m, s) in enumerate(stats):
        arrays[f'norm_mean_{i}'] = m.numpy()
        arrays[f'norm_std_{i}'] = s.numpy()


def window_epoch(mesh, arrays, info, inputs):
    """One meta epoch of the sharded model on the injected windows of
    inputs.npz (test_torch_train.py's epoch test at two ranks)."""
    class Dims:
        obs_dim, act_dim = 20, 6
    n_w = int(inputs['n_layers'])
    model = MetaMLPDynamicsModel('dyn', Dims(), hidden_sizes=(64, 64),
                                 meta_batch_size=4, batch_size=8,
                                 inner_learning_rate=0.01, device='cpu')
    model.params = core.params_from_numpy(
        {'w': [inputs[f'w_{i}'] for i in range(n_w)],
         'b': [inputs[f'b_{i}'] for i in range(n_w)]}, 'cpu')
    model.normalizer = type(model.normalizer)(*(
        torch.as_tensor(inputs[f'norm_{i}']) for i in range(6)))
    model.opt_state = model.optimizer.init(model.params)
    model.mesh = mesh
    staged = [model.stage(dict(obs=inputs[f'{k}_obs'], act=inputs[f'{k}_act'],
                               delta=inputs[f'{k}_delta']), PATH_CHUNK)
              for k in ('train', 'test')]
    windows = [(torch.as_tensor(p), torch.as_tensor(o))
               for p, o in zip(inputs['pidx'], inputs['offs'])]
    n_train = int(inputs['n_train'])
    params, _, *losses = model.epoch_fn(
        model.params, model.opt_state, model.normalizer, *staged,
        inputs['train_obs'].shape[0], inputs['test_obs'].shape[0], n_train,
        len(windows) - n_train, None, windows=windows)
    arrays['window_losses'] = torch.stack(losses).numpy()
    for i, x in enumerate(leaves_np(params)):
        arrays[f'window_params_{i}'] = x


def jax_epochs(mesh, arrays, info, inputs):
    """An MLP epoch on an injected permutation and an RNN epoch on injected
    path indices (tests/test_torch_mbmpc.py's and test_torch_rebal.py's
    epochs against the JAX package), each on this rank's slice of the
    staged data."""
    class Dims:
        obs_dim, act_dim = 20, 6
    for name, cls in (('mlp', MLPDynamicsModel), ('rnn', RNNDynamicsModel)):
        job = inputs[name]
        model = cls('dyn', Dims(), device='cpu', **job['kw'])
        model.load_state_dict(job['state'])
        model.mesh = mesh
        train, test = (par_mesh.shard_batch(mesh, job[k])
                       for k in ('train', 'test'))
        before = par_mesh.collective_counts()
        if name == 'mlp':
            out = model.epoch_fn(model.params, model.opt_state,
                                 model.normalizer, train, test,
                                 job['n_batches'], None,
                                 perm=torch.as_tensor(job['perm']))
        else:
            out = model.epoch_fn(model.params, model.opt_state,
                                 model.normalizer, train, test, job['n_tr'],
                                 job['n_batches'], None,
                                 path_idx=[torch.as_tensor(i)
                                           for i in job['path_idx']])
        info[f'{name}_epoch_counts'] = delta(before)
        params, opt_state, *losses = out
        arrays[f'{name}_epoch_losses'] = torch.stack(losses).numpy()
        for i, x in enumerate(leaves_np(params)):
            arrays[f'{name}_epoch_params_{i}'] = x
        for i, x in enumerate(leaves_np(opt_state['mu'])):
            arrays[f'{name}_epoch_mu_{i}'] = x


def members(arrays):
    """Four ensemble members sharded over the 'model' axis of a (1, 2)
    mesh: each rank steps its two, and a gather over 'model' against the
    unsharded step of all four."""
    mesh = par_mesh.make_mesh(n_env=1, n_model=2, device='cpu')
    gen = torch.Generator()
    gen.manual_seed(0)
    ms = [core.init_mlp(gen, 4, (16,), 4) for _ in range(4)]
    params = {k: [torch.stack(p) for p in zip(*(m[k] for m in ms))]
              for k in ('w', 'b')}
    x, y = torch.ones((32, 4)), torch.zeros((32, 4))

    def step(params):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            pred = core.mlp_forward(tree_unflatten(params, leaves), x)
            losses = torch.square(pred - y).mean(dim=(1, 2))
            grads = torch.autograd.grad(losses.sum(), leaves)
        return tree_unflatten(params, [p.detach() - 0.01 * g for p, g in
                                       zip(leaves, grads)]), losses.detach()
    mine = par_mesh.shard_batch(mesh, params, 'model')
    stepped, losses = step(mine)
    gathered = par_mesh.gather(mesh, (stepped, losses), axis='model')
    plain, plain_losses = step(params)
    for i, (a, b) in enumerate(zip(tree_leaves(gathered[0]),
                                   tree_leaves(plain))):
        arrays[f'members_sharded_{i}'] = a
        arrays[f'members_plain_{i}'] = b.numpy()
    arrays['member_losses'] = gathered[1]
    arrays['plain_member_losses'] = plain_losses.numpy()


def trainer(mesh, job, out_dir, info):
    """run_grbal_multihost.run_experiment at test size (2 iterations of 4
    envs x 30 steps; num_rollouts 3 rounds up to 4 on two ranks), each rank
    in its own working directory."""
    cwd = os.getcwd()
    work = os.path.join(out_dir, f'{job}_work_rank{mesh.rank}')
    os.makedirs(work)
    os.chdir(work)
    try:
        cfg = dict(run_grbal.config, task='cripple', device='cpu',
                   exp_name='tiny', n_itr=2, max_path_length=30,
                   num_rollouts=3 if mesh.shape['env'] == 2 else 4,
                   n_candidates=8, horizon=3, hidden_sizes_model=(32,),
                   adapt_batch_size=4, meta_batch_size=4,
                   dynamic_model_epochs=3)
        algo = run_grbal_multihost.run_experiment(cfg, mesh=mesh)
        logger.Logger.CURRENT.close()
        exp_dir = run_grbal_multihost.experiment_dir(cfg)
        info['trainer_num_rollouts'] = algo.sampler.num_rollouts
        info['trainer_files'] = (sorted(os.listdir(exp_dir))
                                 if os.path.isdir(exp_dir) else [])
        info['trainer_written'] = sorted(
            os.path.relpath(os.path.join(d, f), work)
            for d, _, fs in os.walk(work) for f in fs)
        if info['trainer_files']:
            with open(os.path.join(exp_dir, 'progress.csv')) as f:
                info['trainer_progress'] = f.read()
    finally:
        os.chdir(cwd)


def main():
    out_dir, job = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    mesh = par_mesh.make_mesh(device='cpu')
    arrays, info = {}, dict(rank=mesh.rank, world=mesh.world_size,
                            backend=mesh.backend)
    try:
        env = normalize(HalfCheetahEnv(task='cripple',
                                       reset_every_episode=True,
                                       device='cpu'))
        meta = MetaMLPDynamicsModel('dyn', env, hidden_sizes=(32,),
                                    meta_batch_size=4, batch_size=4,
                                    inner_learning_rate=0.01, seed=3,
                                    device='cpu')
        sample(mesh, arrays, info, 'grbal',
               MPCController('p', env, meta, n_candidates=24, horizon=3),
               adapt_batch_size=4)
        mlp = MLPDynamicsModel('dyn', env, hidden_sizes=(32,), seed=3,
                               device='cpu')
        sample(mesh, arrays, info, 'mbmpc',
               MPCController('p', env, mlp, n_candidates=24, horizon=3,
                             use_cem=True, num_cem_iters=2))
        fits(mesh, arrays, info)
        math(mesh, arrays, info)
        inputs = os.path.join(out_dir, 'inputs.npz')
        if os.path.exists(inputs):
            window_epoch(mesh, arrays, info, np.load(inputs))
        epochs = os.path.join(out_dir, 'epochs.pkl')
        if os.path.exists(epochs):
            with open(epochs, 'rb') as f:
                jax_epochs(mesh, arrays, info, pickle.load(f))
        if mesh.world_size == 2:
            members(arrays)
        trainer(mesh, job, out_dir, info)
    finally:
        mesh.close()
    stem = os.path.join(out_dir, f'{job}_rank{info["rank"]}')
    np.savez(stem + '.npz', **arrays)
    with open(stem + '.json', 'w') as f:
        json.dump(info, f)


if __name__ == '__main__':
    main()
