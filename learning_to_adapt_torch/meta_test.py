"""Meta-test on held-out dynamics (benchmarks/meta_test.py of the JAX
package), the paper's evaluation protocol: a snapshot trained on one task
distribution is evaluated on another, comparing

  adapted     GrBAL with its online fast adaptation (an inner gradient step
              on the trailing window every step)
  pre-update  the same meta-trained model with adaptation off (pre-update
              parameters throughout)

MB-MPC snapshots evaluate as one non-adaptive mode, 'mb_mpc'. ReBAL
snapshots evaluate the recurrent model, 'rebal', and two ablations of its
hidden-state update: 'rebal_hidden_zero' plans from the initial hidden
state every step, 'rebal_hidden_frozen' stops the update after a warm-up.

--eval_set names the held-out tasks, by the snapshot's task kind:
  cripple   comma-separated leg / actuator ids, e.g. "3"
  terrain   comma-separated named terrains, e.g. "steep,basin"
  range     "lo:hi": the blocks env's damping range, or the arm's force
            range (task 'force')
Without it the snapshot is evaluated on its own task distribution.
--inner_lrs and --windows sweep the adapted mode's inner learning rate and
adaptation window at evaluation time.

    python -m learning_to_adapt_torch.meta_test data/grbal_torch/<exp>
        --eval_set 3 --tag ant_leg3_grbal_s0 [--seeds 0,1,2]
        [--num_rollouts 5] [--max_path_length 1000] [--device cpu]

Writes results/meta_test_<tag>.json under the working directory with the
keys, nesting and order of the JAX package's files. Runs on the card unless
--device cpu is given; without a card it raises.
"""
import argparse
import json
import os

import numpy as np

from learning_to_adapt_torch.envs import (
    Arm7DofEnv, HalfCheetahBlocksEnv, HalfCheetahHFieldEnv, normalize)
from learning_to_adapt_torch.models import RNNDynamicsModel
from learning_to_adapt_torch.sim_policy import (
    build_policy, load_experiment, rollout)
from learning_to_adapt_torch.utils.serializable import Serializable

TERRAINS = HalfCheetahHFieldEnv.NAMED_TERRAINS


def eval_mode(env, policy, model, label, adapt_bs, seeds, num_rollouts,
              max_path_length, results, ablate_hidden=None,
              ablate_warmup=16):
    """Returns of num_rollouts paths for every seed (a new Sampler each);
    writes their statistics to results[label]."""
    rets = []
    per_seed = []
    for seed in seeds:
        paths = rollout(env, policy, model, max_path_length=max_path_length,
                        num_rollouts=num_rollouts, adapt_batch_size=adapt_bs,
                        seed=seed, ablate_hidden=ablate_hidden,
                        ablate_warmup=ablate_warmup)
        r = paths['rewards'].sum(axis=1)
        per_seed.append(float(r.mean()))
        rets.extend(r.tolist())
    rets = np.asarray(rets)
    results[label] = dict(mean=float(rets.mean()), std=float(rets.std()),
                          sem=float(rets.std() / np.sqrt(rets.size)),
                          n=int(rets.size), per_seed_mean=per_seed)
    print(f'{label}: {rets.mean():.1f} +- {rets.std():.1f} '
          f'(SEM {rets.std() / np.sqrt(rets.size):.1f}, n={rets.size} '
          f'rollouts x {max_path_length} steps)', flush=True)
    return rets


def gap_stats(a, b):
    """Difference of means with the pooled SEM."""
    return dict(mean=float(a.mean() - b.mean()),
                sem=float(np.sqrt(a.var() / a.size + b.var() / b.size)))


def _warn_overlap(kind, train_set, eval_set, overlapping):
    if overlapping:
        print(f'WARNING: eval {kind} {eval_set} overlaps train '
              f'distribution {train_set} — not a holdout evaluation',
              flush=True)


def resolve_eval_env(base, eval_spec):
    """The train env cloned onto the held-out task distribution, on the
    train env's device and with its options. Returns (eval_env, train_set,
    eval_set, set_kind): set_kind is 'discrete' (terrain names or cripple
    ids: set disjointness decides holdout-ness) or 'range' (a continuous
    lo:hi interval). Raises ValueError when eval_spec's kind does not fit
    the snapshot's task."""
    toks = [t.strip() for t in eval_spec.split(',')]
    if all(t in TERRAINS for t in toks):
        if not isinstance(base, HalfCheetahHFieldEnv):
            raise ValueError(f'terrain eval set on a {type(base).__name__} '
                             'snapshot')
        train_set = tuple(base.terrain_set or (base.task,))
        eval_set = tuple(toks)
        _warn_overlap('terrains', train_set, eval_set,
                      set(train_set) & set(eval_set))
        eval_env = normalize(Serializable.clone(base, terrain_set=eval_set))
        set_kind = 'discrete'
    elif len(toks) == 1 and ':' in toks[0]:
        # "lo:hi", a continuous range holdout of the snapshot's task kind
        lo, hi = (float(x) for x in toks[0].split(':'))
        if isinstance(base, HalfCheetahBlocksEnv):
            attr = 'damping_range'
        elif isinstance(base, Arm7DofEnv) and base.task == 'force':
            attr = 'force_range'
        else:
            raise ValueError(
                f'range eval set on a {type(base).__name__} snapshot '
                f'(task={base.task}): supported are the blocks damping and '
                'the arm force')
        train_set = tuple(getattr(base, attr))
        eval_set = (lo, hi)
        _warn_overlap(attr, train_set, eval_set,
                      lo < train_set[1] and hi > train_set[0])
        eval_env = normalize(Serializable.clone(base, **{attr: (lo, hi)}))
        set_kind = 'range'
    else:
        if base.task != 'cripple':
            raise ValueError(f'integer eval sets are the cripple-task '
                             f'protocol, snapshot has task={base.task}')
        eval_set = tuple(int(x) for x in toks)
        train_set = tuple(base.cripple_set)
        _warn_overlap('set', train_set, eval_set,
                      set(train_set) & set(eval_set))
        eval_env = normalize(Serializable.clone(base, cripple_set=eval_set))
        set_kind = 'discrete'
    return eval_env, train_set, eval_set, set_kind


def main(argv=None):
    """Evaluates the snapshot and writes results/meta_test_<tag>.json;
    returns the results dict."""
    p = argparse.ArgumentParser(
        prog='python -m learning_to_adapt_torch.meta_test')
    p.add_argument('exp_dir', type=str)
    p.add_argument('--eval_set', type=str, default=None,
                   help='held-out task spec (see module docstring): '
                        'cripple ids "3", terrain names "steep,basin", or '
                        'a range "12:20"; omit to evaluate on the '
                        'snapshot\'s own task distribution')
    p.add_argument('--tag', type=str, default=None)
    p.add_argument('--seeds', type=str, default='0,1,2')
    p.add_argument('--num_rollouts', type=int, default=5)
    p.add_argument('--max_path_length', type=int, default=1000)
    p.add_argument('--inner_lrs', type=str, default=None,
                   help='comma-separated eval-time inner learning rates to '
                        'sweep for the adapted mode')
    p.add_argument('--windows', type=str, default=None,
                   help='comma-separated eval-time adaptation window '
                        'lengths to sweep')
    p.add_argument('--skip_ablations', action='store_true',
                   help='for recurrent snapshots, evaluate only the full '
                        'recurrent mode (no hidden-state ablations)')
    p.add_argument('--ablate_warmup', type=int, default=16,
                   help='warm-up steps before the frozen-hidden ablation '
                        'stops updating (default 16, the canonical '
                        'adapt_batch_size)')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device; 'cpu' runs without a card")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',')]

    # one snapshot load; an eval env rebinds the policy to the same model
    env, model, policy, config, adapt_bs = load_experiment(
        args.exp_dir, device=args.device)
    base = env.wrapped_env
    kind = 'GrBAL' if adapt_bs else 'non-adaptive/recurrent'
    if args.eval_set is not None:
        env, train_set, eval_set, set_kind = resolve_eval_env(
            base, args.eval_set)
        policy = build_policy(env, model, config)
        print(f'{args.exp_dir}: trained on {train_set}, evaluating on '
              f'held-out {eval_set} ({kind})', flush=True)
    else:
        set_kind = 'discrete'
        if base.task == 'cripple':
            train_set = eval_set = tuple(base.cripple_set)
        elif getattr(base, 'terrain_set', None):
            train_set = eval_set = tuple(base.terrain_set)
        else:
            train_set = eval_set = base.task
        print(f'{args.exp_dir}: evaluating on its own task distribution '
              f'({base.task}), ({kind})', flush=True)

    results = dict(exp_dir=args.exp_dir, train_set=train_set,
                   eval_set=eval_set, seeds=seeds,
                   num_rollouts=args.num_rollouts,
                   max_path_length=args.max_path_length,
                   ablate_warmup=args.ablate_warmup, set_kind=set_kind)
    run = dict(seeds=seeds, num_rollouts=args.num_rollouts,
               max_path_length=args.max_path_length, results=results)
    if adapt_bs:
        adapted = eval_mode(env, policy, model, 'adapted', adapt_bs, **run)
        pre = eval_mode(env, policy, model, 'pre-update', None, **run)
        results['gap'] = gap_stats(adapted, pre)
        print(f'online-adaptation gap on held-out dynamics: '
              f'{results["gap"]["mean"]:+.1f} +- {results["gap"]["sem"]:.1f}'
              f' (adapted - pre-update)', flush=True)

        base_lr = model.inner_learning_rate
        if args.inner_lrs:
            for lr in (float(x) for x in args.inner_lrs.split(',')):
                model.inner_learning_rate = lr
                eval_mode(env, policy, model, f'adapted_lr{lr:g}', adapt_bs,
                          **run)
            model.inner_learning_rate = base_lr
        if args.windows:
            for w in (int(x) for x in args.windows.split(',')):
                eval_mode(env, policy, model, f'adapted_window{w}', w, **run)
    elif isinstance(model, RNNDynamicsModel):
        # ReBAL adapts by the hidden state's update with every real
        # transition: the ablations isolate it
        full = eval_mode(env, policy, model, 'rebal', None, **run)
        if not args.skip_ablations:
            zero = eval_mode(env, policy, model, 'rebal_hidden_zero', None,
                             ablate_hidden='zero', **run)
            frozen = eval_mode(env, policy, model, 'rebal_hidden_frozen',
                               None, ablate_hidden='frozen',
                               ablate_warmup=args.ablate_warmup, **run)
            results['rebal_gap'] = gap_stats(full, zero)
            results['rebal_gap_frozen'] = gap_stats(full, frozen)
            print(f'recurrent-adaptation gap (full - hidden_zero): '
                  f'{results["rebal_gap"]["mean"]:+.1f} +- '
                  f'{results["rebal_gap"]["sem"]:.1f}; '
                  f'(full - hidden_frozen): '
                  f'{results["rebal_gap_frozen"]["mean"]:+.1f} +- '
                  f'{results["rebal_gap_frozen"]["sem"]:.1f}', flush=True)
    else:
        eval_mode(env, policy, model, 'mb_mpc', None, **run)

    tag = args.tag or os.path.basename(os.path.normpath(args.exp_dir))
    out = os.path.join('results', f'meta_test_{tag}.json')
    os.makedirs('results', exist_ok=True)
    with open(out, 'w') as f:
        json.dump(results, f, indent=2)
    print(f'wrote {out}', flush=True)
    return results


if __name__ == '__main__':
    main()
