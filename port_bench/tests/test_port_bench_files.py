"""Every file of the benchmark loads by name, BENCHMARK.json keeps to its
contract's characters, the yardstick's counts hold against hand counts,
and neither the harness nor the reference loads what it may not."""
import json
import re
import subprocess
import sys

import pytest
import torch

from port_bench.lib import cell as cells
from port_bench.lib.hparams import hparams
from port_bench.roofline import counts, peaks

BENCH = json.loads((cells.ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_cell_loads_by_name(name):
    cell = cells.load_cell(name)
    assert cell.traffic['config'] == cell.config['name']
    cells.driver(cell.traffic['driver'])
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m['name']).read)
    assert {m['name'] for m in cell.end_to_end} >= {'setup_s'}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_names_units_and_lengths():
    names = ([c['name'] for c in BENCH['configs']] + CELLS +
             [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']])
    assert len(names) == len(set(names))
    for n in names + [w['traffic'] for w in BENCH['workloads']]:
        assert NAME.match(n), n
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for w in BENCH['workloads'] + BENCH['configs']:
        assert 1 <= len(w['why']) <= 200 and '\n' not in w['why']
    for m in BENCH['per_layer']:
        assert m['moves'] in {e['name'] for e in BENCH['end_to_end']}
        assert set(m['workloads']) <= set(CELLS)
        assert 1 <= len(m['layer']) <= 200
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0 < m['bound'] <= 0.25


def test_metric_files_match_benchmark():
    files = {p.stem for p in (cells.HERE / 'metrics').glob('*.py')
             if p.stem != '__init__'}
    assert files == {m['name'] for m in BENCH['per_layer']}


def test_fused_mlp_counts_by_hand():
    grbal = counts.fused_mlp_launch(5, 500, [26, 512, 512, 512, 20], 5)[0]
    mb_mpc = counts.fused_mlp_launch(1, 20000, [26, 512, 512, 20], 1)[0]
    assert grbal == 2 * 2500 * (26 * 512 + 2 * 512 * 512 + 512 * 20)
    assert round(grbal / 1e9, 2) == 2.74 and round(mb_mpc / 1e9, 2) == 11.43
    t, what = peaks.bound_s(*counts.fused_mlp_launch(
        5, 500, [26, 512, 512, 512, 20], 5), 'bf16')
    assert what == 'operations' and abs(t - grbal / 989e12) < 1e-15


def test_jacobi_and_step_counts_by_hand():
    flops, n_bytes = counts.jacobi_launch(5, 76, 60)
    assert flops == 5 * 60 * (2 * 76 * 76 + 5 * 76)
    assert n_bytes == 5 * 4 * (76 * 76 + 3 * 76 + 1)
    g = hparams(cells.load_cell('grbal_fit').config)
    launches = counts.sampling_launches(g)
    assert sum(c for c, _, _, _ in launches) == 10 * 1000
    assert launches[0][0] == 10 * (1000 - 18)     # adapting from t = 18
    m = hparams(cells.load_cell('mb_mpc_sample').config)
    assert counts.sampling_launches(m) == [(20 * 100, 1, 20000, 1)]
    p = 26 * 512 + 2 * 512 * 512 + 512 * 20
    assert counts.fit_step_flops(g) == 10 * 2 * 10 * 16 * p
    assert counts.fit_step_flops(m) == 3 * 2 * 128 * (26 * 512 + 512 * 512
                                                      + 512 * 20)


def test_physics_constants_of_the_configs():
    """constraint_rows and jacobi_sweeps are those of the configured model
    as the reference's C++ physics lays them out: two rows a limited joint,
    four pyramid facets a contact (one where condim < 3), a capsule on the
    plane touching at its two end spheres; two Jacobi sweeps an
    iteration."""
    from port_bench.reference.physics import model_defs, spec
    cfg = cells.load_cell('grbal_fit').config
    phys = cfg['physics']
    m = model_defs.get_model(phys['model'])
    limits = 2 * int(sum(bool(lim) and t != spec.FREE for lim, t in
                         zip(m.jnt_limited, m.jnt_type)))
    points = {'plane_capsule': 2, 'plane_sphere': 1}
    contacts = sum((4 if m.geom_condim[a] >= 3 else 1) * points[kind]
                   for kind, pairs in m.pair_groups for a, _ in pairs)
    assert limits + contacts == phys['constraint_rows']
    assert 2 * m.iterations == phys['jacobi_sweeps']
    assert m.solver == 'jacobi' and phys['solves_per_step'] == 1


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport json, sys\n'
         'print(json.dumps(sorted(sys.modules)))'],
        cwd=cells.ROOT, capture_output=True, text=True, check=True)
    return {m.split('.')[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_harness_loads_no_jax():
    """Importing the harness and its drivers (which import the port) loads
    no module whose top-level name is jax, jaxlib, flax or the JAX
    package; learning_to_adapt_torch is the port and allowed."""
    top = _loaded_after(
        'import runpy, sys\n'
        'sys.argv = ["port_bench/run.py"]\n'
        'm = runpy.run_path("port_bench/run.py", run_name="port_bench_run")\n'
        'from port_bench.lib import cell\n'
        'for k in ("sample", "fit"): cell.driver(k)\n'
        'import learning_to_adapt_torch.run_grbal, '
        'learning_to_adapt_torch.run_mb_mpc')
    assert 'learning_to_adapt_torch' in top
    assert not top & {'jax', 'jaxlib', 'flax', 'learning_to_adapt_tpu'}


def test_reference_loads_nothing_of_the_program():
    top = _loaded_after(
        'import sys; sys.path.insert(0, ".")\n'
        'import port_bench.reference.sampling, '
        'port_bench.reference.fitting')
    assert not top & {'learning_to_adapt_torch', 'learning_to_adapt_tpu',
                      'jax', 'jaxlib', 'flax'}
