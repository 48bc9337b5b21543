"""Device time a train step of the traced fit call: the union of the
card's activities (train and validation replays, the epoch's draws and
copies) over its train steps."""


def read(ctx, window, out):
    if window is None or 'train_steps' not in window.work:
        return None
    return window.busy_s() * 1e3 / window.work['train_steps']
