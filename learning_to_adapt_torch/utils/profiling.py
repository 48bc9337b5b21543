"""Profiling instruments (utils/profiling.py).

Named wall-clock segments are tabular metrics (Time-EnvSampling etc.,
utils/logging.py), and the port's spans and counters are utils/tracing.py's.
This module adds the operator's full profile: torch.profiler traces of the
host's operators and, with a card, its kernels and copies, written as
chrome traces (ui.perfetto.dev, chrome://tracing), in which every span is a
labelled range.
"""
import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(logdir):
    """torch.profiler trace of the managed region, written to
    logdir/trace.json. The card's work is waited for before the trace
    stops, so every kernel the region queued is in it."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
