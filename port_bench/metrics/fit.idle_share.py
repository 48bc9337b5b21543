"""Share of the traced fit call in which the card ran nothing."""


def read(ctx, window, out):
    if window is None or 'train_steps' not in window.work:
        return None
    return 100.0 * (1.0 - window.busy_s() / window.window_s())
