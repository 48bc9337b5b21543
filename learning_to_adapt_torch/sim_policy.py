"""Replay a trained snapshot (experiment_utils/sim_policy.py of the JAX
package).

    python -m learning_to_adapt_torch.sim_policy data/grbal_torch/<exp>
        [--max_path_length 1000] [--num_rollouts 1] [--seed 0]
        [--out replay.npz] [--check-native] [--device cpu]

Loads params.pkl and params.json from an experiment directory written by
run_grbal, run_mb_mpc or run_rebal, rebuilds env, model and policy on the
device, re-runs the MPC policy (with online adaptation for GrBAL) through
the Sampler, prints the returns and writes the trajectory to replay.npz
(the JAX replay's keys and shapes: tools/render_trajectory.py reads it).
--check-native re-runs every recorded action through the repository's
float64 C++ physics (native/ltao_physics.cc) and prints the worst one-step
qpos deviation; it applies to nominal dynamics only (task None).

Runs on the card unless --device cpu is given; without a card it raises.
"""
import argparse
import json
import os

import numpy as np

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.envs import normalize
from learning_to_adapt_torch.experiment import ENVS
from learning_to_adapt_torch.models import (
    MetaMLPDynamicsModel, MLPDynamicsModel, RNNDynamicsModel)
from learning_to_adapt_torch.policies import MPCController, RNNMPCController
from learning_to_adapt_torch.samplers import Sampler
from learning_to_adapt_torch.utils.checkpoint import load_snapshot
from learning_to_adapt_torch.utils.config import task_env_kwargs

#: bound on the worst one-step qpos deviation of a float32 trajectory from
#: the float64 oracle
NATIVE_TOL = 1e-2


def load_experiment(exp_dir, env_override=None, device='cuda'):
    """(env, model, policy, config, adapt_batch_size) rebuilt on `device`
    from a snapshot directory. env_override: evaluate on this env instead of
    the snapshot's (the meta-test protocol's held-out task distribution,
    meta_test.py)."""
    device = resolve_device(device)
    with open(os.path.join(exp_dir, 'params.json')) as f:
        config = json.load(f)
    snapshot = load_snapshot(os.path.join(exp_dir, 'params.pkl'), device)

    if env_override is not None:
        env = env_override
    elif 'env' in snapshot:
        # the env itself rides in the snapshot (constructor replay: its
        # task, noise and frame_skip config), rebuilt on `device`
        env = snapshot['env']
    else:
        env_name = config['env']
        if isinstance(env_name, dict):
            env_name = env_name.get('$class', '')
        env_cls = ENVS[env_name.split('.')[-1]]
        # the recorded task-distribution params: without them the
        # meta-test would misstate train_set and evaluate a default
        # distribution
        env = normalize(env_cls(reset_every_episode=True,
                                task=config.get('task'), device=device,
                                **task_env_kwargs(config)))

    if 'meta_batch_size' in config:
        model = MetaMLPDynamicsModel(
            'dyn_model', env, meta_batch_size=config['meta_batch_size'],
            inner_learning_rate=config['inner_learning_rate'],
            hidden_sizes=tuple(config['hidden_sizes_model']),
            batch_size=config['adapt_batch_size'], device=device)
        adapt_batch_size = config.get('adapt_batch_size')
    elif 'cell_type' in config:
        model = RNNDynamicsModel(
            'dyn_model', env, hidden_sizes=tuple(config['hidden_sizes']),
            cell_type=config['cell_type'],
            backprop_steps=config['backprop_steps'],
            batch_size=config['batch_size'], device=device)
        adapt_batch_size = None
    else:
        model = MLPDynamicsModel(
            'dyn_model', env, hidden_sizes=tuple(config['hidden_sizes']),
            batch_size=config['batch_size'], device=device)
        adapt_batch_size = None

    model.load_state_dict(snapshot['dynamics_model'])
    policy = build_policy(env, model, config)
    return env, model, policy, config, adapt_batch_size


def build_policy(env, model, config):
    """The planner of a loaded model on `env` (the meta-test rebinds a
    trained model to a held-out env without loading the snapshot again)."""
    policy_cls = (RNNMPCController if isinstance(model, RNNDynamicsModel)
                  else MPCController)
    return policy_cls(
        'policy', env, model,
        discount=config.get('discount', 1.0),
        n_candidates=config['n_candidates'],
        horizon=config['horizon'],
        use_cem=config.get('use_cem', False),
        num_cem_iters=config.get('num_cem_iters', 5))


def rollout(env, policy, model, max_path_length=1000, num_rollouts=1,
            adapt_batch_size=None, seed=0, ablate_hidden=None,
            ablate_warmup=16):
    """Paths of the policy from a new Sampler: each call builds its rollout
    function anew, so it sees the model's inner learning rate as it is
    now."""
    sampler = Sampler(env=env, policy=policy, num_rollouts=num_rollouts,
                      max_path_length=max_path_length,
                      adapt_batch_size=adapt_batch_size, seed=seed,
                      device=model.device, ablate_hidden=ablate_hidden,
                      ablate_warmup=ablate_warmup)
    sampler._episode_idx = 1  # tasks are active from the second episode
    return sampler.obtain_samples()


def check_native(env, paths, n_steps=None):
    """Worst one-step qpos deviation of path 0 from the native oracle:
    each recorded action, mapped to ctrl as NormalizedEnv maps it, is
    applied to the recorded previous (qpos, qvel) by the float64 C++
    physics. Nominal dynamics only (task None): a task's MutableModel stays
    on the device and is not recorded."""
    from learning_to_adapt_torch.native import NativePhysics
    base = env.wrapped_env
    nat = NativePhysics(base.model)
    qpos, qvel, acts = paths['qpos'][0], paths['qvel'][0], paths['actions'][0]
    lo = np.asarray(base.model.act_ctrlrange[:, 0])
    hi = np.asarray(base.model.act_ctrlrange[:, 1])
    n = n_steps or min(len(acts) - 1, 200)
    worst = 0.0
    for t in range(1, 1 + n):
        ctrl = np.clip(lo + (np.asarray(acts[t]) + 1.0) * 0.5 * (hi - lo),
                       lo, hi)
        qp = np.asarray(qpos[t - 1], np.float64)
        qv = np.asarray(qvel[t - 1], np.float64)
        for _ in range(base.frame_skip):
            qp, qv = nat.step(qp, qv, ctrl)
        worst = max(worst, float(np.max(np.abs(qp - np.asarray(qpos[t])))))
    print(f'native oracle one-step qpos deviation over {n} steps: '
          f'{worst:.3e} (float32 {base.device.type} vs float64 C++; '
          f'<{NATIVE_TOL:g} expected)')
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m learning_to_adapt_torch.sim_policy')
    p.add_argument('exp_dir', type=str)
    p.add_argument('--max_path_length', type=int, default=1000)
    p.add_argument('--num_rollouts', type=int, default=1)
    p.add_argument('--out', type=str, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--check-native', action='store_true',
                   help='verify the trajectory against the C++ oracle '
                        '(nominal dynamics only)')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device; 'cpu' runs without a card")
    args = p.parse_args(argv)

    env, model, policy, config, adapt_bs = load_experiment(
        args.exp_dir, device=args.device)
    paths = rollout(env, policy, model,
                    max_path_length=args.max_path_length,
                    num_rollouts=args.num_rollouts,
                    adapt_batch_size=adapt_bs, seed=args.seed)
    returns = paths['rewards'].sum(axis=1)
    print(f'returns: {returns} (mean {returns.mean():.2f})')
    if args.check_native:
        if config.get('task'):
            print('check-native skipped: task-perturbed dynamics are not '
                  'recorded in the trajectory (run with task=None)')
        else:
            check_native(env, paths)
    out = args.out or os.path.join(args.exp_dir, 'replay.npz')
    np.savez_compressed(out, **paths)
    print(f'trajectory saved to {out}')
    return paths


if __name__ == '__main__':
    main()
