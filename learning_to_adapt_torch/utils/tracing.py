"""Spans and counters of the port (utils/tracing.py): one recorder for the
host's phases and for the parts of the steps that replay as CUDA graphs.

    span(name)        a context manager: always a torch.profiler range of
                      that name (what --profile's device_trace shows); with
                      tracing on, also one record
    call(name)        a span that opens a call (a sampling call, a fit):
                      the spans inside it share its call id, and the device
                      stamps of its replays are read at its end; calls(name)
                      decorates a function whose calls are such spans
    count(name, n=1)  adds n to a counter; counters are always kept, with
                      tracing on or off (they sit on host events that a
                      replay does not repeat: a graph's capture, a
                      recurrent op's call; 'fused_mlp.wgmma_launches'
                      and 'physics.passes' count the launches and the
                      dynamics passes of each replay, as
                      models/captured.py StepGraph adds them), but not in
                      a capture's warm-ups (`quiet`)
    enable(on), enabled(), records(), totals(), counters(), reset()

Tracing is off by default, and the benchmark measures it off: a span is
then the record_function range it has always been, and nothing is
recorded, built, captured or launched for it. On, each span is one record,
`Span(name, clock, start, end, parent, call)`: start and end in ns, the
parent an index into records() (None at the top), the call id of the call
it belongs to (None outside one).

Inside a step that models/captured.py StepGraph captures, a span with
tracing on is stamped on the device: a one-thread kernel
(csrc/span_stamp.cu) captured into the graph, on the stream the span runs
on, writes the global timer and its slot into a ring in device memory at
every replay. A stamp carries the span edges at its place in the step (the
step's begin, a span's open, a span's close, the step's end); edges on one
stream with nothing launched between them share one stamp (the capture is
asked for that stream's tail), so each stamp closes one part and opens the
next: a train step has 4 (its three spans end it; a recurrent model's 2
more a layer and TBPTT chunk, for 'rnn.seq' inside 'fit.loss'), a
validation step 2 (the recurrent model's 4), an MB-MPC sampling step 9
(the copies of the carry follow its last span), a GrBAL one more after its
adaptation gate (its adaptation and pack nest in the plan). Of those, the
engine's spans take 5 a step with Euler and 14 with the Ant's RK4: each
dynamics pass 'physics.qacc' opens and closes on stamps of its own and
holds a 'physics.smooth' (the smooth-dynamics launch) that opens on the
pass's open stamp and closes on one of its own, and the step's forward
pass is a 'physics.smooth' with its own two.
A call reads the ring at its end in one copy and turns the stamps into
records of clock 'device': the step itself from its first stamp to its
last, its parent the host span around the replay, and each span inside
it. A step's stamps on streams that run at once (models/rnn.py's TBPTT
chunks) reach the ring in the order they ran: a replay's stamps are
matched to its slots stream by stream, in their captured order on each
stream and in any order across streams, and its edges taken in their
captured order. On the CPU, on the eager paths and in everything outside
a graph, spans are timed by the host (clock 'host'); the warm-ups before
a capture record nothing.
The spans inside the captured steps: 'fit.loss', 'fit.grad', 'fit.optim'
(every fit's train step), 'rnn.seq' (models/rnn.py: each call of the
recurrent layer op, in 'fit.loss' and in the validation step),
'rollout.plan' (with 'rollout.adapt' and 'rollout.pack' inside) and
'rollout.env_step' (with 'physics.qacc' inside, physics/engine.py's
dynamics passes: one a physics step with Euler, four with RK4; and
'physics.smooth', the smooth-dynamics launch, in each pass and around the
step's forward pass).

One clock: every start and end is on the clock of the profiler's host
events, CLOCK_REALTIME (time.time_ns(); the check on the card is in
PERF.md §3), so a span can be read against a trace. The device's global
timer is put on it by one offset a call, measured when the call starts
(the closest of a few stamps launched alone between two host readings):
the two clocks drift apart by less than the offset's own error over a
sampling call (PERF.md §6).

StepGraph, CompiledRollout and CompiledEpoch key their graphs by the
tracing state at capture: turning tracing on captures stamped copies and
leaves the graphs captured with it off as they were.
"""
import ctypes
import functools
import time
from collections import namedtuple

import torch
from torch.profiler import record_function

Span = namedtuple('Span', 'name clock start end parent call')
#: a calibration: host ns - global timer ns, and the bound of its error
#: (half the round trip around the stamp it was read from)
Clock = namedtuple('Clock', 'offset error')

#: stamps the device ring of a device holds between two reads
RING_SIZE = 1 << 16
#: stamps launched to measure the device clock's offset
CALIBRATION = 16

_state = dict(on=False, quiet=0, call=None, calls=0, capture=None)
_records = []       # [name, clock, start, end, parent, call]
_stack = []         # indices of the open host spans
_counters = {}
_slots = []         # slot -> [(edge, name)]: what each stamp marks
_slot_streams = {}  # slot -> the stream it was stamped on (None: one)
_rings = {}         # device -> _Ring
_lib = []


def now():
    """ns on the clock of the profiler's host events."""
    return time.time_ns()


def enable(on=True):
    _state['on'] = bool(on)


def enabled():
    return _state['on']


def count(name, n=1):
    if not _state['quiet']:
        _counters[name] = _counters.get(name, 0) + n


def counters():
    return dict(_counters)


class _Span:
    __slots__ = ('name', 'opens_call', 'range', 'idx', 'owns')

    def __init__(self, name, opens_call):
        self.name = name
        self.opens_call = opens_call

    def __enter__(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        self.idx = self.owns = None
        cap = _state['capture']
        if cap is not None:
            cap.edge('open', self.name)
        elif not _state['quiet']:
            if self.opens_call and _state['call'] is None:
                _state['calls'] += 1
                _state['call'] = self.owns = _state['calls']
                for ring in _rings.values():
                    if not ring.count:
                        ring.clock = ring.calibrate()
            self.idx = len(_records)
            _records.append([self.name, 'host', now(), None,
                             _stack[-1] if _stack else None, _state['call']])
            _stack.append(self.idx)
        return self

    def __exit__(self, *exc):
        cap = _state['capture']
        if cap is not None:
            cap.edge('close', self.name)
        elif self.idx is not None:
            _records[self.idx][3] = now()
            _stack.pop()
            if self.owns is not None:
                try:
                    for ring in _rings.values():
                        ring.read()
                finally:
                    _state['call'] = None
        self.range.__exit__(*exc)
        return False


def span(name):
    """A span: record_function(name) with tracing off, else that range and
    one record (host-timed, or stamped inside a step being captured)."""
    return _Span(name, False) if _state['on'] else record_function(name)


def call(name):
    """A span that opens a call id for the spans inside it (unless a call
    is open already) and reads the device stamps of its replays at its
    end."""
    return _Span(name, True) if _state['on'] else record_function(name)


def calls(name):
    """Decorator: each call of the function is the call span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with call(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


class quiet:
    """Spans inside record nothing and counts count nothing (a capture's
    warm-ups)."""

    def __enter__(self):
        _state['quiet'] += 1

    def __exit__(self, *exc):
        _state['quiet'] -= 1
        return False


def records():
    return [Span(*r) for r in _records]


def totals():
    """{clock: {name: dict(count, total_ns, self_ns)}} of the records; a
    span's self time is its own less that of its children on its clock."""
    out = {}
    child = [0] * len(_records)
    for r in _records:
        p = r[4]
        if p is not None and r[3] is not None and _records[p][1] == r[1]:
            child[p] += r[3] - r[2]
    for i, (name, clock, start, end, _, _) in enumerate(_records):
        if end is None:
            continue
        t = out.setdefault(clock, {}).setdefault(
            name, dict(count=0, total_ns=0, self_ns=0))
        t['count'] += 1
        t['total_ns'] += end - start
        t['self_ns'] += end - start - child[i]
    return out


def reset():
    """Reads what the device rings hold, then clears the records (the
    counters stay)."""
    if _stack:
        raise RuntimeError('tracing.reset inside an open span')
    for ring in _rings.values():
        ring.read()
    _records.clear()


# ------------------------------------------------------------ the device
def _library():
    if not _lib:
        from learning_to_adapt_torch.ops import build
        lib = build.load('span_stamp')
        lib.span_stamp.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                                   ctypes.c_ulonglong, ctypes.c_void_p]
        lib.span_capture_tail.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_ulonglong)]
        lib.span_calibrate.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_longlong)]
        for fn in (lib.span_stamp, lib.span_capture_tail,
                   lib.span_calibrate):
            fn.restype = ctypes.c_int
        _lib.append(lib)
    return _lib[0]


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f'span stamp: {what} failed: cudaError {rc}')


def _stream(device):
    """The device's current stream (its handle)."""
    return torch.cuda.current_stream(device).cuda_stream


def _device(device):
    """The device with its index (rings are kept by device)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


class _Ring:
    """A device's ring of stamps and the stamped replays since its last
    read: (the graph's slots, the host span around the replay, the
    call)."""

    def __init__(self, device):
        self.device = device
        self.buf = torch.zeros(1 + 2 * RING_SIZE, dtype=torch.int64,
                               device=device)
        self.calib = torch.zeros(1 + 2 * CALIBRATION, dtype=torch.int64,
                                 device=device)
        self.replays = []
        self.count = 0
        self.clock = self.calibrate()

    def calibrate(self):
        """The Clock of the calibration stamp with the shortest round
        trip (the stream waits for the card first)."""
        host = (ctypes.c_longlong * (2 * CALIBRATION))()
        self.calib[0].zero_()
        _check(_library().span_calibrate(
            ctypes.c_void_p(self.calib.data_ptr()), CALIBRATION,
            ctypes.c_void_p(_stream(self.device)), host), 'calibration')
        stamps = self.calib[1::2].tolist()
        best = min(range(CALIBRATION),
                   key=lambda i: host[2 * i + 1] - host[2 * i])
        lo, hi = host[2 * best], host[2 * best + 1]
        return Clock((lo + hi) // 2 - stamps[best], (hi - lo + 1) // 2)

    def replayed(self, slots):
        if self.count + len(slots) > RING_SIZE:
            self.read()
        self.replays.append((slots, _stack[-1] if _stack else None,
                             _state['call']))
        self.count += len(slots)

    def read(self):
        """One copy of the stamps written since the last read, turned into
        device records on the host clock by the call's offset."""
        if not self.count:
            return
        n = self.count
        host = self.buf[:1 + 2 * n].cpu()
        self.buf[0].zero_()
        replays, self.replays, self.count = self.replays, [], 0
        head = int(host[0])
        if head != n:
            raise RuntimeError(f'the device ring holds {head} stamps; the '
                               f'replays since its last read wrote {n}')
        decode(host[1::2].tolist(), host[2::2].tolist(), replays,
               self.clock.offset)


def _by_stream(slots):
    """{stream: its slots in order} of a sequence of slots."""
    out = {}
    for slot in slots:
        out.setdefault(_slot_streams.get(slot), []).append(slot)
    return out


def decode(times, slots, replays, offset):
    """Appends the records of stamped replays: times and slots as the ring
    holds them, replays as (expected slots, host parent, call), offset the
    host ns less the global timer ns."""
    i = 0
    for expect, parent, call_id in replays:
        got = slots[i:i + len(expect)]
        # stamps on concurrent streams reach the ring in the order they
        # ran, each stream's in its captured order; their edges are taken
        # in the order they were captured
        if _by_stream(got) != _by_stream(expect):
            raise RuntimeError(f'device stamps {got} where a replay writes '
                               f'{list(expect)}')
        at = dict(zip(got, times[i:i + len(expect)]))
        stack = []
        for slot in expect:
            t = at[slot] + offset
            for edge, name in _slots[slot]:
                if edge == 'open':
                    stack.append(len(_records))
                    _records.append([name, 'device', t, None,
                                     stack[-2] if len(stack) > 1 else parent,
                                     call_id])
                else:
                    _records[stack.pop()][3] = t
        if stack:
            raise RuntimeError('a stamped replay left spans open')
        i += len(expect)


def prepare(device):
    """The device's ring and the stamp kernel, built and loaded (and
    launched once) before a capture needs them."""
    device = _device(device)
    if device not in _rings:
        _library()
        _rings[device] = _Ring(device)
    return _rings[device]


class _Capture:
    """The stamps of a step being captured: slots, in order."""

    def __init__(self, device):
        self.device = device
        self.ring = _rings[device]
        self.slots = []
        self.stream = self.tail = None

    def _tail(self, stream):
        node, n = ctypes.c_ulonglong(), ctypes.c_ulonglong()
        _check(_library().span_capture_tail(
            ctypes.c_void_p(stream), ctypes.byref(node), ctypes.byref(n)),
            'capture info')
        return node.value if n.value == 1 else None

    def edge(self, edge, name):
        """Stamps an edge on the current stream (a step's spans may run on
        streams forked from the capture's), or marks it by the last stamp
        where that was on this stream and nothing was launched since."""
        stream = _stream(self.device)
        tail = self._tail(stream)
        if (self.slots and stream == self.stream and tail is not None and
                tail == self.tail):
            _slots[self.slots[-1]].append((edge, name))
            return
        slot = len(_slots)
        _slots.append([(edge, name)])
        _check(_library().span_stamp(
            ctypes.c_void_p(self.ring.buf.data_ptr()), RING_SIZE, slot,
            ctypes.c_void_p(stream)), 'launch')
        _slot_streams[slot] = stream
        self.slots.append(slot)
        self.stream, self.tail = stream, self._tail(stream)


class stamps:
    """Around a step's function under graph capture: with tracing on, the
    step's begin and end and every span inside are stamped into the graph;
    `slots` then holds the stamps' slots (empty with tracing off). Call
    prepare(device) before the capture starts."""

    def __init__(self, name, device):
        self.name = name
        self.device = device
        self.slots = ()
        self.cap = None

    def __enter__(self):
        if _state['on']:
            self.cap = _Capture(_device(self.device))
            _state['capture'] = self.cap
            self.cap.edge('open', self.name)
        return self

    def __exit__(self, *exc):
        if self.cap is not None:
            try:
                if exc[0] is None:
                    self.cap.edge('close', self.name)
                    self.slots = tuple(self.cap.slots)
            finally:
                _state['capture'] = None
        return False


def replayed(device, slots):
    """A stamped graph was replayed on device: its stamps are read with
    the call's."""
    _rings[_device(device)].replayed(slots)
