"""Runs one cell of the port's benchmark once and prints its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell is BENCHMARK.json's workload of that
name; everything it needs is found by name under port_bench/. The last line
of standard output is one JSON object: correct, attempted, failed, metrics
(--trace 0: the cell's end-to-end metrics; --trace 1: its per-layer
metrics, with the device's busy and window seconds and a breakdown) and
device, then the numbers that decided `correct`, each beside its limit,
which also close standard error. Without a CUDA card (or with fewer than
the cell asks for), or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with 2.
"""
import os
import time

STARTED = time.perf_counter()
# one host thread for PyTorch's CPU work: with its default pool the host
# side of a run was slower at times (the replay loop of a sampling call
# 3.67 s in place of 2.95), and it stays steady with one
os.environ['OMP_NUM_THREADS'] = '1'

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse(argv=None):
    p = argparse.ArgumentParser(prog='port_bench/run.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from port_bench.lib import card
    from port_bench.lib.cell import load_cell
    from port_bench.lib.run import run
    cell = load_cell(args.workload)
    try:
        card.require_cards(cell.chips)
    except card.NoCard as e:
        print(f'port_bench: {e}', file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, args.trace, 'cuda:0',
                 STARTED)
    found = card.forbidden_modules()
    if found:
        print('port_bench: the run loaded ' + ', '.join(found) +
              '; the benchmark measures the port alone', file=sys.stderr)
        return 2
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
