"""Projected-Jacobi constraint solve: the CUDA kernel and its plain version.

Counterpart of learning_to_adapt_tpu/ops/pallas_jacobi.py (`jacobi_solve`
and its XLA twin `jacobi_solve_xla`). The kernel, csrc/jacobi.cu, takes the
env batch directly: one block per env, all sweeps in one launch, A held in
registers with each row split over a few threads (launch tiers by N).

`jacobi_solve` is what the engine calls. On CUDA tensors it launches the
kernel (float32 only) or raises; only tensors on the CPU take the plain
version, `jacobi_solve_plain`.
"""
import ctypes

import torch

from learning_to_adapt_torch.ops import build

#: launch tiers, smallest first: (threads per row, columns of A per thread,
#: rows per thread). A tier takes N <= threads per row * columns;
#: csrc/jacobi.cu builds one instantiation of its kernel for each.
TIERS = ((4, 8, 1), (4, 16, 2), (4, 20, 4), (4, 32, 2), (4, 56, 2))
MAX_ROWS = TIERS[-1][0] * TIERS[-1][1]


def jacobi_solve_plain(A, b, aii_inv, omega, n_sweeps):
    """A (E, N, N), b/aii_inv (E, N), omega (E,). Returns f (E, N):
    n_sweeps of f <- max(f - omega * (A f + b) * aii_inv, 0) from f = 0
    (the loop of engine.py constraint_forces, in the same operation order)."""
    f = torch.zeros_like(b)
    w = omega[:, None]
    for _ in range(n_sweeps):
        r = (A @ f[..., None])[..., 0] + b
        f = torch.clamp(f - w * r * aii_inv, min=0.0)
    return f


def launch_shape(n):
    """(threads per row, columns per thread, rows per thread, threads per
    block) of the kernel for an N-row system: the smallest tier that takes
    N, and enough whole warps for its row groups. Raises ValueError above
    MAX_ROWS."""
    for per_row, cols, rows in TIERS:
        if n <= per_row * cols:
            groups, per_warp = -(-n // rows), 32 // per_row
            return per_row, cols, rows, -(-groups // per_warp) * 32
    raise ValueError(f'jacobi_solve: N={n} rows exceed the largest launch '
                     f'tier ({MAX_ROWS} rows)')


def _lib():
    lib = build.load('jacobi')
    if not getattr(lib, '_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jacobi_solve.argtypes = [p, p, p, p, p] + [i] * 7 + [p]
        lib.jacobi_solve.restype = i
        lib._typed = True
    return lib


def jacobi_solve_cuda(A, b, aii_inv, omega, n_sweeps):
    """Launch the kernel. All inputs float32 on one CUDA device."""
    tensors = (A, b, aii_inv, omega)
    if any(t.device != A.device for t in tensors):
        raise ValueError('jacobi_solve: inputs on different devices')
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError('jacobi_solve: the CUDA kernel takes float32 only, '
                        f'got {[str(t.dtype) for t in tensors]}')
    n_envs, n = b.shape
    if A.shape != (n_envs, n, n) or aii_inv.shape != (n_envs, n) or \
            omega.shape != (n_envs,):
        raise ValueError(f'jacobi_solve: shapes A {tuple(A.shape)}, '
                         f'b {tuple(b.shape)}, aii_inv '
                         f'{tuple(aii_inv.shape)}, omega {tuple(omega.shape)}')
    shape = launch_shape(n)
    if b.numel() == 0:                   # nothing to solve, nothing launched
        return torch.empty_like(b)
    lib = _lib()
    A, b, aii_inv, omega = (t.contiguous() for t in tensors)
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        rc = lib.jacobi_solve(A.data_ptr(), b.data_ptr(), aii_inv.data_ptr(),
                              omega.data_ptr(), out.data_ptr(), n_envs, n,
                              int(n_sweeps), *shape, stream)
    build.check(rc, 'jacobi_solve')
    jacobi_solve.launches += 1
    return out


def jacobi_solve(A, b, aii_inv, omega, n_sweeps):
    """Projected Jacobi over an env batch; see `jacobi_solve_plain`.
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if A.is_cuda:
        return jacobi_solve_cuda(A, b, aii_inv, omega, n_sweeps)
    if A.device.type != 'cpu':
        raise ValueError(f'jacobi_solve: unsupported device {A.device}')
    return jacobi_solve_plain(A, b, aii_inv, omega, n_sweeps)


#: kernel launches since the count was last set to 0
jacobi_solve.launches = 0
