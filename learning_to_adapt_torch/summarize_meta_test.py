"""Aggregate results/meta_test_*.json into the markdown meta-test table,
with pooled-gap estimates across snapshots (benchmarks/summarize_meta_test.py
of the JAX package, whose output this copy prints letter for letter).

    python -m learning_to_adapt_torch.summarize_meta_test \
        ['results/meta_test_*.json']

Seed-extension pooling: a file tagged `<tag>_ext*` holds extra eval seeds
for the snapshot already evaluated in `meta_test_<tag>.json` (disjoint
seed lists); its per-mode stats are pooled with the base file's before any
table/gap computation, so each snapshot appears once at its full n. Files
that repeat a seed or differ in protocol are refused (ValueError).
"""
import glob
import json
import math
import re
import sys

import numpy as np

MODES = ('adapted', 'pre-update', 'mb_mpc', 'rebal', 'rebal_hidden_zero',
         'rebal_hidden_frozen')

#: protocol fields that must be identical before an _ext file may pool
#: with its base (disjoint seeds alone are not enough — a different path
#: length or eval set would silently shift the pooled statistic)
PROTOCOL_KEYS = ('train_set', 'eval_set', 'num_rollouts',
                 'max_path_length', 'ablate_warmup')

#: defaults for protocol keys absent from older result files, so a
#: pre-field base file pools with a post-field extension run at the
#: same (default) protocol but refuses a genuinely different one
PROTOCOL_DEFAULTS = {'ablate_warmup': 16}


def fmt(v):
    return f"{v['mean']:.1f} ± {v['sem']:.1f}"


def pool_modes(a, b):
    """Pool two (mean, std, n) summaries of disjoint samples."""
    n1, n2 = a['n'], b['n']
    n = n1 + n2
    mean = (n1 * a['mean'] + n2 * b['mean']) / n
    msq = (n1 * (a['std'] ** 2 + a['mean'] ** 2) +
           n2 * (b['std'] ** 2 + b['mean'] ** 2)) / n
    var = max(msq - mean ** 2, 0.0)
    return dict(mean=mean, std=math.sqrt(var),
                sem=math.sqrt(var / n), n=n,
                per_seed_mean=(a.get('per_seed_mean', []) +
                               b.get('per_seed_mean', [])))


def diff_sem(a, b):
    return dict(mean=a['mean'] - b['mean'],
                sem=math.sqrt(a['std'] ** 2 / a['n'] +
                              b['std'] ** 2 / b['n']))


def load_pooled(pattern):
    """Load result files, folding `_ext` seed-extension files into their
    base tags; recompute gaps from the pooled modes."""
    docs = {}
    exts = []
    for f in sorted(glob.glob(pattern)):
        if 'smoke' in f or '_sweeps' in f:
            # _sweeps files are preserved pass-1 copies of snapshots that
            # were re-evaluated with more seeds — counting both would
            # double-weight those snapshots
            continue
        tag = f.split('meta_test_')[1][:-5]
        with open(f) as fh:
            d = json.load(fh)
        m = re.match(r'(.+)_ext\d*$', tag)
        if m:
            exts.append((m.group(1), d))
        else:
            docs[tag] = d
    for base_tag, d in exts:
        if base_tag not in docs:
            docs[base_tag] = d
            continue
        base = docs[base_tag]
        dup = set(base.get('seeds', [])) & set(d.get('seeds', []))
        if dup:
            raise ValueError(f'{base_tag}: extension file repeats eval '
                             f'seeds {sorted(dup)} — pooling would '
                             'double-count')
        for k in PROTOCOL_KEYS:
            dflt = PROTOCOL_DEFAULTS.get(k)
            if base.get(k, dflt) != d.get(k, dflt):
                raise ValueError(
                    f'{base_tag}: extension file differs on {k} '
                    f'({base.get(k)!r} vs {d.get(k)!r}) — not the same '
                    'protocol; refusing to pool')
        for mode in MODES:
            if mode in base and mode in d:
                base[mode] = pool_modes(base[mode], d[mode])
            elif mode in d:
                # mode evaluated only in the extension run (e.g.
                # ablations added after the base pass): carry it at its
                # own n rather than silently dropping it
                base[mode] = d[mode]
        base['seeds'] = list(base.get('seeds', [])) + list(d.get('seeds', []))
    for d in docs.values():
        if 'adapted' in d and 'pre-update' in d:
            d['gap'] = diff_sem(d['adapted'], d['pre-update'])
        if 'rebal' in d and 'rebal_hidden_zero' in d:
            d['rebal_gap'] = diff_sem(d['rebal'], d['rebal_hidden_zero'])
        if 'rebal' in d and 'rebal_hidden_frozen' in d:
            d['rebal_gap_frozen'] = diff_sem(d['rebal'],
                                             d['rebal_hidden_frozen'])
    return docs


def is_ood(doc):
    """Held-out evaluation = the eval distribution is disjoint from the
    train distribution, judged from the RESULT DATA (train_set/eval_set),
    not from tag-name substrings (which silently drift as files
    accumulate). Files written since round-5 batch 8 carry an explicit
    `set_kind` ('range' | 'discrete') from resolve_eval_env; older files
    fall back to a float-endpoint heuristic (continuous ranges always
    serialize float endpoints; discrete cripple ids are ints). Ranges use
    interval disjointness; discrete sets use set disjointness;
    fixed-protocol evaluations (train == eval, or task-label strings)
    are in-distribution."""
    tr, ev = doc.get('train_set'), doc.get('eval_set')
    if tr is None or ev is None or tr == ev:
        return False
    if isinstance(tr, (list, tuple)) and isinstance(ev, (list, tuple)):
        both = list(tr) + list(ev)
        kind = doc.get('set_kind')
        if kind is None and len(tr) == len(ev) == 2 and both and any(
                isinstance(x, float) for x in both):
            kind = 'range'
        if kind == 'range':
            if not all(isinstance(x, (int, float)) and
                       not isinstance(x, bool) for x in both):
                raise ValueError(
                    f'range endpoints must be numeric: {tr!r} vs {ev!r}')
            return ev[0] >= tr[1] or ev[1] <= tr[0]  # disjoint intervals
        return not (set(map(str, tr)) & set(map(str, ev)))
    return False


def report_pool(name, entries):
    if not entries:
        return
    means = np.array([g['mean'] for _, g in entries])
    sems = np.array([g['sem'] for _, g in entries])
    pooled_sem = np.sqrt(np.sum(sems ** 2)) / len(entries)
    pooled = means.mean()
    pos = int((means > 0).sum())
    sign_p = sum(math.comb(len(means), k)
                 for k in range(pos, len(means) + 1)) / 2 ** len(means)
    print(f'\n{name} ({len(entries)} snapshots): '
          f'{pooled:+.1f} ± {pooled_sem:.1f} '
          f'({abs(pooled) / pooled_sem:.1f}σ; {pos}/{len(means)} positive, '
          f'sign test p={sign_p:.3f})')


def main(pattern='results/meta_test_*.json'):
    docs = load_pooled(pattern)
    print('| snapshot | train set | eval set | mode | return |')
    print('|---|---|---|---|---|')
    for tag, d in docs.items():
        for mode in MODES:
            if mode in d:
                print(f'| {tag} | {d["train_set"]} | {d["eval_set"]} | '
                      f'{mode} | {fmt(d[mode])} (n={d[mode]["n"]}) |')
    print()
    for key, label in (('gap', 'gap'), ('rebal_gap', 'rebal_gap'),
                       ('rebal_gap_frozen', 'rebal_gap_frozen')):
        for tag, d in docs.items():
            if key in d:
                print(f'{label} {tag}: {d[key]["mean"]:+.1f} ± '
                      f'{d[key]["sem"]:.1f}')
    report_pool('pooled OOD adaptation gap (GrBAL, adapted - pre-update)',
                [(t, d['gap']) for t, d in docs.items()
                 if 'gap' in d and is_ood(d)])
    report_pool('pooled OOD recurrent-machinery gap (ReBAL, full - '
                'hidden_zero)',
                [(t, d['rebal_gap']) for t, d in docs.items()
                 if 'rebal_gap' in d and is_ood(d)])


if __name__ == '__main__':
    main(*sys.argv[1:])
