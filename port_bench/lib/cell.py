"""A cell of BENCHMARK.json and the files it is made of, found by name.

    BENCHMARK.json          the cell's entry (configuration, traffic), the
                            metrics it reports
    configs/<config>.json   the configuration's file (its `file` entry)
    workloads/<traffic>.json   the traffic mix, which names its driver
    drivers/<kind>.py       the module that runs that kind of traffic
    metrics/<metric>.py     one reader for each per-layer metric
"""
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # port_bench/
ROOT = HERE.parent                                  # the checkout


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module of a file found by name (metric files have dots in their
    names, so they are loaded from their paths)."""
    if not path.is_file():
        raise FileNotFoundError(f'{path} is missing')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind):
    return load_module(HERE / 'drivers' / f'{kind}.py',
                       f'port_bench_driver_{kind}')


def metric_reader(name):
    return load_module(HERE / 'metrics' / f'{name}.py',
                       'port_bench_metric_' + name.replace('.', '_'))


@dataclass
class Cell:
    """One cell: its name, configuration and traffic, the end-to-end and
    per-layer metric entries of BENCHMARK.json that it reports, and the
    number of cards it asks for."""
    name: str
    config: dict
    traffic: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric, cell_name):
    return 'workloads' not in metric or cell_name in metric['workloads']


def load_cell(name, bench_path=None):
    """The cell named `name` in BENCHMARK.json, with its files."""
    bench = load_json(bench_path or ROOT / 'BENCHMARK.json')
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'BENCHMARK.json has no workload {name!r}')
    conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
    return Cell(
        name=name,
        config=load_json(ROOT / conf['file']),
        traffic=load_json(HERE / 'workloads' / f'{entry["traffic"]}.json'),
        chips=entry['chips'],
        end_to_end=[m for m in bench['end_to_end'] if _reports(m, name)],
        per_layer=[m for m in bench['per_layer'] if _reports(m, name)])
