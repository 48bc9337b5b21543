"""The readings that the limits of a cell's numbers are set from.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3
        [--seconds 4] [--modes control,half]

For each seed, in one process: the cell's set-up and a short window at
its own load, then its numbers as a run computes them (the program's
readings, the lower end of each limit) and, with the program's place
taken by the reference in a lower precision ('control') or with a fault
planted in it ('half': half of each batch, fit cells only), the same
numbers again (the upper end). One JSON line a seed, then the widest
program reading and the smallest of each mode's by number. A run of the
benchmark never runs this."""
import argparse
import gc
import json
import os
import sys
import time

os.environ['OMP_NUM_THREADS'] = '1'    # as run.py runs
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    p = argparse.ArgumentParser(prog='port_bench/control.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, default=4.0)
    p.add_argument('--modes', default='control')
    args = p.parse_args(argv)
    import torch
    from port_bench.lib import card, cell as cells, precision
    from port_bench.lib.run import context
    cell = cells.load_cell(args.workload)
    # the warm-up steadies a run's timing and judges nothing: the readings
    # skip it (the first call still captures)
    cell.traffic['warm_seconds'] = 0
    card.require_cards(cell.chips)
    drv = cells.driver(cell.traffic['driver'])
    modes = [m for m in args.modes.split(',') if m]
    table = {}
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        ctx = context(cell, seed, args.seconds, False, 'cuda:0')
        state = drv.setup(ctx)
        setup_s = time.perf_counter() - t0
        out = drv.window(ctx, state)
        drv.release(state)
        gc.collect()
        torch.cuda.empty_cache()
        precision.exact_f32()
        t1 = time.perf_counter()
        row = dict(seed=seed, setup_s=setup_s, end_to_end=out['end_to_end'],
                   attempted=out['attempted'],
                   program=drv.readings(ctx, state, 'program'))
        row['reference_s'] = time.perf_counter() - t1
        for mode in modes:
            row[mode] = drv.readings(ctx, state, mode)
        for key in ['program'] + modes:
            for name, v in row[key].items():
                table.setdefault(key, {}).setdefault(name, []).append(v)
        print(json.dumps(row), flush=True)
        del state
        gc.collect()
    summary = {'program_max': {k: max(v) for k, v in table['program'].items()}}
    for mode in modes:
        summary[mode + '_min'] = {k: min(v) for k, v in table[mode].items()}
    print(json.dumps(summary), flush=True)


if __name__ == '__main__':
    main()
