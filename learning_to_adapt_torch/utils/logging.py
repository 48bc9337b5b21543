"""Key-value metrics logger and snapshot store (utils/logging.py).

Module-level `configure/logkv/logkv_mean/dumpkvs/log/save_itr_params` fanned
out to a stdout table, `log.txt`, and a `progress.csv` with retroactive
column addition, written byte for byte as the JAX package writes them, so
tools/ and the viskit server read port runs. Snapshots are pickles of state
dicts with modes all|last|gap|last_gap|none.
"""
import datetime
import json
import os
import os.path as osp
import pickle
import sys
import tempfile
import time
from collections import defaultdict

DEBUG, INFO, WARN, ERROR, DISABLED = 10, 20, 30, 40, 50


class CSVWriter:
    """progress.csv with retroactive column addition (reference
    logger.py:112-145)."""

    def __init__(self, filename):
        self.filename = filename
        self.keys = []
        self.sep = ','
        self.file = open(filename, 'w+t')

    def writekvs(self, kvs):
        extra = [k for k in kvs.keys() if k not in self.keys]
        if extra:
            self.keys.extend(extra)
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.truncate()
            self.file.write(self.sep.join(self.keys) + '\n')
            for line in lines[1:]:
                self.file.write(line[:-1] + self.sep * len(extra) + '\n')
        vals = []
        for k in self.keys:
            v = kvs.get(k)
            vals.append('' if v is None else str(v))
        self.file.write(self.sep.join(vals) + '\n')
        self.file.flush()

    def close(self):
        self.file.close()


class HumanWriter:
    def __init__(self, file, owned=False):
        self.file = file
        self.owned = owned  # a file configure opened, closed by close()

    def writekvs(self, kvs):
        key2str = {}
        for k, v in sorted(kvs.items()):
            if isinstance(v, float):
                key2str[k] = f'{v:<10.5g}'
            else:
                key2str[k] = str(v)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = '-' * (keywidth + valwidth + 7)
        lines = [dashes]
        for k, v in sorted(key2str.items()):
            lines.append(f'| {k}{" " * (keywidth - len(k))} | '
                         f'{v}{" " * (valwidth - len(v))} |')
        lines.append(dashes)
        self.file.write('\n'.join(lines) + '\n')
        self.file.flush()

    def writeseq(self, seq):
        self.file.write(' '.join(map(str, seq)) + '\n')
        self.file.flush()

    def close(self):
        if self.owned:
            self.file.close()


class JSONWriter:
    def __init__(self, filename):
        self.file = open(filename, 'wt')

    def writekvs(self, kvs):
        out = {}
        for k, v in kvs.items():
            if hasattr(v, 'dtype'):
                v = float(v) if getattr(v, 'ndim', 0) == 0 else v.tolist()
            out[k] = v
        self.file.write(json.dumps(out) + '\n')
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardWriter:
    """Optional TensorBoard events output (reference logger.py:148-181);
    uses torch.utils.tensorboard, which is available without TF."""

    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter
        self.writer = SummaryWriter(log_dir=logdir)
        self.step = 0

    def writekvs(self, kvs):
        step = int(kvs.get('Itr', self.step))
        for k, v in kvs.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass
        self.writer.flush()
        self.step = step + 1

    def close(self):
        self.writer.close()


class Logger:
    CURRENT = None

    def __init__(self, dir=None, output_formats=(), snapshot_mode='last',
                 snapshot_gap=1):
        self.name2val = {}
        self.name2cnt = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = list(output_formats)
        self.snapshot_mode = snapshot_mode
        self.snapshot_gap = snapshot_gap
        self._human = [w for w in self.output_formats
                       if isinstance(w, HumanWriter)]

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        if val is None:
            self.name2val[key] = None
            return
        oldval, cnt = self.name2val.get(key, 0), self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def logkvs(self, d):
        for k, v in d.items():
            self.logkv(k, v)

    def dumpkvs(self):
        out = dict(self.name2val)
        for w in self.output_formats:
            w.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args, level=INFO):
        if self.level <= level:
            for w in self._human:
                w.writeseq(args)

    def save_itr_params(self, itr, params):
        """Pickle a state snapshot per iteration under the configured mode
        (reference logger.py:376-396)."""
        if self.dir is None:
            return
        mode = self.snapshot_mode
        if mode == 'all':
            path = osp.join(self.dir, f'itr_{itr}.pkl')
        elif mode == 'last':
            path = osp.join(self.dir, 'params.pkl')
        elif mode == 'gap':
            if itr % self.snapshot_gap != 0:
                return
            path = osp.join(self.dir, f'itr_{itr}.pkl')
        elif mode == 'last_gap':
            if itr % self.snapshot_gap != 0:
                return
            path = osp.join(self.dir, 'params.pkl')
        elif mode in ('none', None):
            return
        else:
            raise ValueError(mode)
        with open(path, 'wb') as f:
            pickle.dump(params, f)

    def close(self):
        for w in self.output_formats:
            w.close()


def configure(dir=None, format_strs=('stdout', 'log', 'csv'),
              snapshot_mode='last', snapshot_gap=1):
    if dir is None:
        dir = osp.join(tempfile.gettempdir(), 'lta_torch',
                       datetime.datetime.now().strftime('%Y%m%d-%H%M%S'))
    os.makedirs(dir, exist_ok=True)
    writers = []
    for fmt in format_strs:
        if fmt == 'stdout':
            writers.append(HumanWriter(sys.stdout))
        elif fmt == 'log':
            writers.append(HumanWriter(open(osp.join(dir, 'log.txt'), 'wt'),
                                       owned=True))
        elif fmt == 'csv':
            writers.append(CSVWriter(osp.join(dir, 'progress.csv')))
        elif fmt == 'json':
            writers.append(JSONWriter(osp.join(dir, 'progress.json')))
        elif fmt == 'tensorboard':
            try:
                writers.append(TensorBoardWriter(osp.join(dir, 'tb')))
            except ImportError:
                pass
    Logger.CURRENT = Logger(dir=dir, output_formats=writers,
                            snapshot_mode=snapshot_mode,
                            snapshot_gap=snapshot_gap)
    return Logger.CURRENT


def _current():
    if Logger.CURRENT is None:
        Logger.CURRENT = Logger(output_formats=[HumanWriter(sys.stdout)])
    return Logger.CURRENT


def logkv(key, val):
    _current().logkv(key, val)


def logkv_mean(key, val):
    _current().logkv_mean(key, val)


def logkvs(d):
    _current().logkvs(d)


def dumpkvs():
    return _current().dumpkvs()


def log(*args, **kwargs):
    _current().log(*args, **kwargs)


def save_itr_params(itr, params):
    _current().save_itr_params(itr, params)


def get_dir():
    return _current().dir


class ProfileKV:
    """Context manager accumulating wall time under `wait_<name>` (reference
    logger.py:287-311)."""

    def __init__(self, name):
        self.name = 'wait_' + name

    def __enter__(self):
        self.t0 = time.time()

    def __exit__(self, *args):
        _current().name2val[self.name] = \
            _current().name2val.get(self.name, 0.0) + time.time() - self.t0


def profile(name):
    def decorator(fn):
        def wrapped(*args, **kwargs):
            with ProfileKV(name):
                return fn(*args, **kwargs)
        return wrapped
    return decorator
