"""Share of the traced fit call's device time in the optimizer's
_foreach kernels (models/optim.py ClipAdam.step_: the clip's norms and
Adam's updates run as multi_tensor_apply kernels)."""


def read(ctx, window, out):
    if window is None or 'train_steps' not in window.work:
        return None
    return 100.0 * window.seconds('multi_tensor_apply') / window.seconds()
