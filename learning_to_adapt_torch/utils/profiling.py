"""Profiling instruments (utils/profiling.py).

Named wall-clock segments are tabular metrics (Time-EnvSampling etc.,
utils/logging.py). This module adds the device-level layer: torch.profiler
traces of the host's operators and, with a card, its kernels and copies,
written as chrome traces (ui.perfetto.dev, chrome://tracing), and a timer
that waits for the card before it stops.
"""
import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from learning_to_adapt_torch.utils import logging as logger


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


@contextlib.contextmanager
def blocked_timer(name, log=True):
    """Wall-clock a region including the card's completion of the work it
    queued (synchronizes on exit); logged as the mean of `Profile-<name>`."""
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if log:
        logger.logkv_mean(f'Profile-{name}', dt)
