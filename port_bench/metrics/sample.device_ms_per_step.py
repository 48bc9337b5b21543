"""Device time a policy env step of the traced sampling call: the union
of the card's activities (not their sum) over the env steps."""


def read(ctx, window, out):
    if window is None or 'env_steps' not in window.work:
        return None
    return window.busy_s() * 1e3 / window.work['env_steps']
