"""One run of one cell: set-up, the measured window, the card's peak
memory, then, with the program's state freed, the reference's readings
against the cell's limits; the result as the one JSON line a run prints.

The stages are those of the traffic kind's module (drivers/<kind>.py):
setup(ctx) -> state; window(ctx, state) -> {attempted, failed,
call_seconds, end_to_end, trace, wall_per_step}; release(state);
readings(ctx, state) -> {number: value}.
"""
import gc
import math
import sys
import time
from types import SimpleNamespace

import torch

from port_bench.lib import card, cell as cells, precision
from port_bench.lib.hparams import hparams


def context(cell, seed, seconds, trace, device):
    return SimpleNamespace(
        name=cell.name, config=cell.config, traffic=cell.traffic,
        hp=hparams(cell.config), seed=int(seed), seconds=float(seconds),
        trace=bool(trace), device=torch.device(device), cell=cell)


def judge(numbers, limits):
    """(correct, checks): each number beside its limit; a number that is
    not finite, or over its limit, is not correct."""
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    ok = all(math.isfinite(v['value']) and v['value'] <= v['limit']
             for v in checks.values())
    return ok, checks


def per_layer(ctx, out):
    """{metric: {value, unit}} of the cell's per-layer metrics that have
    something to read; a reader that finds nothing returns None."""
    got = {}
    for m in ctx.cell.per_layer:
        value = cells.metric_reader(m['name']).read(ctx, out['trace'], out)
        if value is not None:
            got[m['name']] = dict(value=value, unit=m['unit'])
    return got


def run(cell, seed, seconds, trace, device, started):
    """The result of one run; `started` is the process's start on the
    perf_counter clock (set-up counts from there)."""
    ctx = context(cell, seed, seconds, trace, device)
    drv = cells.driver(ctx.traffic['driver'])
    on_card = ctx.device.type == 'cuda'
    state = drv.setup(ctx)
    if on_card:
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - started
    out = drv.window(ctx, state)
    dev_rec = (card.device_record(cell.chips, ctx.device) if on_card
               else None)
    drv.release(state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    precision.exact_f32()
    t0 = time.perf_counter()
    numbers = drv.readings(ctx, state)
    print(f'port_bench: set-up {setup_s:.3f} s, calls of the window '
          f'{[round(s, 4) for s in out["call_seconds"]]} s, reference '
          f'readings {time.perf_counter() - t0:.3f} s', file=sys.stderr,
          flush=True)
    correct, checks = judge(numbers, ctx.traffic['limits'])
    if trace:
        metrics = per_layer(ctx, out) if out['trace'] is not None else {}
    else:
        values = dict(out['end_to_end'], setup_s=setup_s)
        metrics = {m['name']: dict(value=values[m['name']], unit=m['unit'])
                   for m in cell.end_to_end}
    result = dict(correct=correct, attempted=out['attempted'],
                  failed=out['failed'], metrics=metrics, device=dev_rec)
    if trace and out['trace'] is not None:
        win = out['trace']
        result['device'] = dict(dev_rec, busy_s=win.busy_s(),
                                window_s=win.window_s())
        result['breakdown'] = win.breakdown()
    result['checks'] = checks
    return result
