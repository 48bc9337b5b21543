"""The traced window: one whole call of the cell's unit of work (a
sampling call, a fit call) under torch.profiler, read from the raw kineto
events (building the profiler's FunctionEvents for a call's millions of
kernels would take minutes).

A window that lost kernel launches, which the profiler has been seen to
do, is run again and never reported: the launches of the port's own
kernels that the trace holds must equal those its counters
(models/captured.py kernel_counts) saw in the window.
"""
import bisect
import time

import torch

LABEL = 'port_bench.window'

#: the port's kernels by their counter in kernel_counts() -> the name of
#: the kernel in a trace
KERNELS = dict(fused_mlp='fused_mlp_kernel', jacobi_solve='jacobi_kernel',
               jacobi_solve_cluster='jacobi_cluster_kernel')


class LostLaunches(RuntimeError):
    pass


class Window:
    """The device activity of one profiled call.

    device: (name, start ns, end ns) of each kernel, copy or set on the
    card; host: (name, start ns, end ns) of each host event (operators,
    runtime calls, labels); start/end: the window's own label, in the
    trace's clock; wall_s: the call's wall time by the host clock; work:
    the call's units of work (env steps, train steps), set by its caller."""

    def __init__(self, prof, wall_s):
        from torch.autograd import DeviceType
        self.device, self.host = [], []
        self.start = self.end = None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not (e.is_user_annotation() or name == LABEL or
                        name.startswith(('rollout.', 'fit.'))):
                    self.device.append((name, e.start_ns(), e.end_ns()))
            elif name == LABEL:
                self.start, self.end = e.start_ns(), e.end_ns()
            else:
                self.host.append((name, e.start_ns(), e.end_ns()))
        self.wall_s = wall_s
        self.launches = {}
        self.work = {}
        self._merged = None

    def count(self, kernel):
        return sum(kernel in name for name, _, _ in self.device)

    def seconds(self, kernel=''):
        """Summed device time of the activities whose name holds kernel."""
        return sum(e - s for name, s, e in self.device
                   if kernel in name) / 1e9

    def merged(self):
        """The device's busy intervals: the union of all activities."""
        if self._merged is None:
            out = []
            for _, s, e in sorted(self.device, key=lambda d: d[1]):
                if out and s <= out[-1][1]:
                    if e > out[-1][1]:
                        out[-1][1] = e
                else:
                    out.append([s, e])
            self._merged = out
        return self._merged

    def busy_s(self):
        return sum(e - s for s, e in self.merged()) / 1e9

    def window_s(self):
        return (self.end - self.start) / 1e9

    def gaps(self):
        """(start ns, end ns) of the device's idle gaps in the window."""
        out, t = [], self.start
        for s, e in self.merged():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out

    def breakdown(self, top=10):
        """The device operations that took most time, by name, and the idle
        time by what the host was doing in it (the innermost host event
        open at each gap's middle), in seconds."""
        ops = {}
        for name, s, e in self.device:
            ops[name] = ops.get(name, 0) + (e - s) / 1e9
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        idle = {}
        for s, e in self.gaps():
            mid = (s + e) // 2
            doing = 'python'
            # the latest-starting host event still open at mid, among the
            # 4,000 that started last before it
            last = bisect.bisect_right(starts, mid) - 1
            for j in range(last, max(last - 4000, -1), -1):
                if host[j][2] >= mid:
                    doing = host[j][0]
                    break
            idle[doing] = idle.get(doing, 0) + (e - s) / 1e9
        order = (lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top])
        return dict(device_ops=[[k[:160], v] for k, v in order(ops)],
                    idle_gaps=[[k[:160], v] for k, v in order(idle)])


def _counts():
    from learning_to_adapt_torch.models import captured
    return captured.kernel_counts()


def profile(fn, tries=3):
    """Window of fn() (one whole call) under torch.profiler, its launches
    checked against the kernel counters; run again up to `tries` times
    when the trace lost some, then LostLaunches."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for attempt in range(1, tries + 1):
        before = _counts()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(LABEL):
                out = fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = _counts()
        win = Window(prof, wall)
        launched = {k: after[k] - before[k] for k in KERNELS}
        seen = {k: win.count(KERNELS[k]) for k in KERNELS}
        if win.device and win.start is not None and seen == launched:
            win.launches = launched
            return win, out
        print(f'port_bench: profiler window {attempt} of {tries} recorded '
              f'{seen} of the launches {launched}; run again', flush=True)
    raise LostLaunches(f'{tries} profiler windows lost kernel launches')
