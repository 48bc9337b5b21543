"""Device ms a train step spends in the recurrent layer op's forward: the
stamped 'rnn.seq' spans (models/rnn.py, one a layer and TBPTT chunk)
inside the captured train step, over the stamped train steps of the
spans' fit calls (lib/spans.py). The validation step's 'rnn.seq' is left
out. A program without the span reads None."""
from port_bench.lib import spans


def _in_train_step(recs, r):
    while r.parent is not None:
        r = recs[r.parent]
        if r.clock != 'device':
            return False
        if r.name == 'fit.train_step':
            return True
    return False


def read(ctx, window, out):
    if window is None:
        return None
    snap = spans.snapshot(ctx)
    if snap is None:
        return None
    recs = snap['records']
    steps = [r for r in recs if r.clock == 'device' and
             r.name == 'fit.train_step']
    seq = [r for r in recs if r.clock == 'device' and r.name == 'rnn.seq'
           and _in_train_step(recs, r)]
    if not steps or not seq:
        return None
    return sum(r.end - r.start for r in seq) / len(steps) / 1e6
