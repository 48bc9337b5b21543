"""Kernels launched a rollout step (one step of every env) in the traced
sampling call; copies and sets are not counted."""


def read(ctx, window, out):
    if window is None or 'steps' not in window.work:
        return None
    kernels = sum(not name.startswith(('Memcpy', 'Memset'))
                  for name, _, _ in window.device)
    return kernels / window.work['steps']
