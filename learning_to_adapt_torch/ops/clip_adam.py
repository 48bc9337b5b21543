"""Clip by global norm, then Adam, over every leaf of a parameter tree at
once, in place: the CUDA kernel and its plain version.

optax.chain(clip_by_global_norm(max_norm), adam(learning_rate)), as the JAX
models' optimizer, on leaf lists in JAX's order: the global norm clip
`g if norm < max_norm else g / norm * max_norm`, then Adam with optax's
bias correction. models/optim.py ClipAdam.step_ calls `clip_adam_`.

`clip_adam_plain` defines the arithmetic with torch._foreach_* ops: each
product and sum rounded on its own, in optax's order, the clip a select on
the device. `clip_adam_` takes it only for tensors on the CPU; on CUDA
tensors it launches the kernel, csrc/clip_adam.cu (two launches a step,
`LAUNCHES_PER_STEP`), or raises. Where the clip does not fire the kernel's
step is the plain version's on the card bit for bit; it sums the norm's
squares in another order, deterministically. Nothing here reads a device
value on the host, so a step can be captured into a CUDA graph.
"""
import ctypes

import torch

from learning_to_adapt_torch.ops import build

#: kernel launches a step: the norm's partial sums, then the update
LAUNCHES_PER_STEP = 2


@torch.no_grad()
def clip_adam_plain(params, grads, count, mu, nu, learning_rate, max_norm,
                    b1, b2, eps):
    """One step in place: params, mu and nu are lists of leaves (any
    layout, the same for all four lists), grads the gradients (overwritten:
    clipped), count the int32 0-d step count. Returns the global norm (0-d,
    on the device)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    # g / 1 * 1 when kept, else optax's g / norm * max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, sq)
    count.add_(1)
    c = count.to(norm.dtype)
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)
    # p - lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, learning_rate)
    torch._foreach_sub_(params, upd)
    return norm


# ---------------------------------------------------------------- kernel
def _lib():
    lib = build.load('clip_adam')
    if not getattr(lib, '_typed', False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.clip_adam.argtypes = [i, p, p, p, p, p, p, p, i] + [f] * 7 + [p]
        lib.clip_adam.restype = i
        lib.clip_adam_blocks.argtypes = [ctypes.c_longlong, p]
        lib.clip_adam_blocks.restype = i
        lib._typed = True
    return lib


#: leaves one launch takes (csrc/clip_adam.cu kMaxLeaves)
MAX_LEAVES = 48


def _check(params, grads, count, mu, nu):
    """Raise unless the kernel takes these: as many f32 leaves in each
    list, at most MAX_LEAVES, each leaf contiguous and shaped alike in all
    four, and an int32 0-d count, all on one device."""
    n = len(params)
    if not 1 <= n <= MAX_LEAVES or not len(grads) == len(mu) == len(nu) == n:
        raise ValueError(f'clip_adam: {n} params, {len(grads)} grads, '
                         f'{len(mu)} mu and {len(nu)} nu leaves (1 to '
                         f'{MAX_LEAVES} of each)')
    dev = count.device
    if count.dtype != torch.int32 or count.ndim != 0:
        raise TypeError(f'clip_adam: count must be a 0-d int32 tensor, got '
                        f'{count.dtype} of shape {tuple(count.shape)}')
    for i, leaf in enumerate(zip(params, grads, mu, nu)):
        for name, t in zip(('params', 'grads', 'mu', 'nu'), leaf):
            if t.device != dev:
                raise ValueError(f'clip_adam: {name}[{i}] on {t.device}, '
                                 f'count on {dev}')
            if t.dtype != torch.float32:
                raise TypeError(f'clip_adam: {name}[{i}] is {t.dtype}, not '
                                'float32')
            if t.shape != leaf[0].shape:
                raise ValueError(f'clip_adam: {name}[{i}] of shape '
                                 f'{tuple(t.shape)} against params[{i}] of '
                                 f'{tuple(leaf[0].shape)}')
            if not t.is_contiguous():
                raise ValueError(f'clip_adam: {name}[{i}] is not contiguous')


def clip_adam_cuda(params, grads, count, mu, nu, learning_rate, max_norm,
                   b1, b2, eps):
    """Launch the kernel on the current stream: the step of
    `clip_adam_plain` with grads only read. Returns the global norm (0-d
    f32, on the device)."""
    _check(params, grads, count, mu, nu)
    dev = count.device
    if dev.type != 'cuda':
        raise ValueError(f'clip_adam: the kernel takes CUDA tensors, not '
                         f'{dev}')
    lib = _lib()
    n = len(params)
    ptrs = [(ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])
            for ts in (params, grads, mu, nu)]
    numel = (ctypes.c_longlong * n)(*[t.numel() for t in params])
    units = sum((t.numel() + 3) // 4 for t in params)
    blocks = ctypes.c_int()
    with torch.cuda.device(dev):
        build.check(lib.clip_adam_blocks(units, ctypes.byref(blocks)),
                    'clip_adam')
        # the blocks' partial sums, then the norm in the first 4 bytes
        partial = torch.empty(blocks.value + 1, dtype=torch.float64,
                              device=dev)
        rc = lib.clip_adam(
            n, *ptrs, numel, count.data_ptr(), partial.data_ptr(),
            blocks.value, learning_rate, max_norm, b1, b2, 1 - b1, 1 - b2,
            eps, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, 'clip_adam')
    clip_adam_.launches += LAUNCHES_PER_STEP
    return partial.view(torch.float32)[2 * blocks.value]


def clip_adam_(params, grads, count, mu, nu, learning_rate, max_norm, b1,
               b2, eps):
    """One clip + Adam step in place (see `clip_adam_plain`). CUDA
    tensors go to the kernel, which only reads grads; CPU tensors to the
    plain version, which clips them in place. Returns the global norm."""
    args = (params, grads, count, mu, nu, learning_rate, max_norm, b1, b2,
            eps)
    if count.is_cuda:
        return clip_adam_cuda(*args)
    if count.device.type != 'cpu':
        raise ValueError(f'clip_adam: unsupported device {count.device}')
    return clip_adam_plain(*args)


#: kernel launches since the count was last set to 0
clip_adam_.launches = 0
