"""Projected-Jacobi constraint solve: the CUDA kernel and its plain version.

Counterpart of learning_to_adapt_tpu/ops/pallas_jacobi.py (`jacobi_solve`
and its XLA twin `jacobi_solve_xla`). The kernels, csrc/jacobi.cu, take the
env batch directly, all sweeps in one launch. Up to MAX_ROWS rows: one block
per env, A held in registers with each row split over a few threads (launch
tiers by N). Above: one thread-block cluster per env, each block streaming
its share of A's rows from L2 every sweep and gathering f from the others
through distributed shared memory (`jacobi_solve_cluster`), up to
MAX_CLUSTER_ROWS rows, where the f buffers fill a block's shared memory.

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

#: threads per block of the cluster kernel: a warp per row of A
CLUSTER_THREADS = 512


def _cluster_smem(n, cluster):
    """Bytes of shared memory a cluster block takes: the gathered f (n
    floats) and its own rows' f, double-buffered."""
    return 4 * (n + 2 * -(-n // cluster))


def _max_cluster_rows():
    lo, hi = 1, build.SMEM_LIMIT // 4
    while lo < hi:                       # the portable cluster of 8 is the
        mid = (lo + hi + 1) // 2         # smallest, so it needs the most
        if _cluster_smem(mid, 8) <= build.SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


#: the largest N the cluster kernel takes
MAX_CLUSTER_ROWS = _max_cluster_rows()


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


def cluster_shape(n, n_envs, n_sms):
    """(blocks per cluster, threads per block, rows per block, bytes of
    shared memory per block) of the cluster kernel for n_envs systems of N
    rows on a card of n_sms SMs: 16 blocks per env while every env's
    cluster fits the card at once, else the portable 8. Raises ValueError
    above MAX_CLUSTER_ROWS."""
    if n > MAX_CLUSTER_ROWS:
        raise ValueError(f'jacobi_solve: N={n} rows exceed the largest the '
                         f'cluster kernel takes ({MAX_CLUSTER_ROWS} rows: '
                         'its f buffers fill shared memory)')
    cluster = 16 if n_envs * 16 <= n_sms else 8
    return (cluster, CLUSTER_THREADS, -(-n // cluster),
            _cluster_smem(n, cluster))


def route(n):
    """Which kernel takes an N-row system: 'tiers' (N <= MAX_ROWS) or
    'cluster' (N <= MAX_CLUSTER_ROWS); raises ValueError above."""
    if n <= MAX_ROWS:
        return 'tiers'
    cluster_shape(n, 1, 1)
    return 'cluster'


_SMS = {}


def _sm_count(device):
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _lib():
    lib = build.load('jacobi')
    if not getattr(lib, '_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jacobi_solve.argtypes = [p, p, p, p, p] + [i] * 7 + [p]
        lib.jacobi_solve.restype = i
        lib.jacobi_solve_cluster.argtypes = [p, p, p, p, p] + [i] * 6 + [p]
        lib.jacobi_solve_cluster.restype = i
        lib.jacobi_cluster_occupancy.argtypes = [i] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.jacobi_cluster_occupancy.restype = i
        lib._typed = True
    return lib


def _check(A, b, aii_inv, omega):
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
    return n_envs, n


def jacobi_solve_cuda(A, b, aii_inv, omega, n_sweeps):
    """Launch the kernel for N: the launch tiers up to MAX_ROWS, the
    cluster kernel above. All inputs float32 on one CUDA device."""
    n_envs, n = _check(A, b, aii_inv, omega)
    if route(n) == 'cluster':
        return jacobi_solve_cluster(A, b, aii_inv, omega, n_sweeps)
    shape = launch_shape(n)
    if b.numel() == 0:                   # nothing to solve, nothing launched
        return torch.empty_like(b)
    lib = _lib()
    A, b, aii_inv, omega = (t.contiguous() for t in (A, b, aii_inv, omega))
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        rc = lib.jacobi_solve(A.data_ptr(), b.data_ptr(), aii_inv.data_ptr(),
                              omega.data_ptr(), out.data_ptr(), n_envs, n,
                              int(n_sweeps), *shape, stream)
    build.check(rc, 'jacobi_solve')
    jacobi_solve.launches += 1
    return out


def jacobi_solve_cluster(A, b, aii_inv, omega, n_sweeps):
    """Launch the cluster kernel, for any N up to MAX_CLUSTER_ROWS (the
    engine reaches it through jacobi_solve for N > MAX_ROWS only). All
    inputs float32 on one CUDA device."""
    n_envs, n = _check(A, b, aii_inv, omega)
    cluster, threads, _, _ = cluster_shape(
        n, n_envs, _sm_count(A.device) if A.is_cuda else 1)
    if b.numel() == 0:                   # nothing to solve, nothing launched
        return torch.empty_like(b)
    lib = _lib()
    A, b, aii_inv, omega = (t.contiguous() for t in (A, b, aii_inv, omega))
    vec = 4 if n % 4 == 0 and A.data_ptr() % 16 == 0 else 1
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        rc = lib.jacobi_solve_cluster(
            A.data_ptr(), b.data_ptr(), aii_inv.data_ptr(), omega.data_ptr(),
            out.data_ptr(), n_envs, n, int(n_sweeps), cluster, threads, vec,
            stream)
    build.check(rc, 'jacobi_solve_cluster')
    jacobi_solve_cluster.launches += 1
    return out


def cluster_occupancy(n, cluster, vec, device):
    """Clusters of the cluster kernel's shape for N rows the card holds at
    once (cudaOccupancyMaxActiveClusters); 0: the shape cannot launch."""
    lib = _lib()
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        build.check(lib.jacobi_cluster_occupancy(
            n, cluster, CLUSTER_THREADS, vec, ctypes.byref(active)),
            'jacobi_cluster_occupancy')
    return active.value


def jacobi_solve(A, b, aii_inv, omega, n_sweeps):
    """Projected Jacobi over an env batch; see `jacobi_solve_plain`.
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if A.is_cuda:
        return jacobi_solve_cuda(A, b, aii_inv, omega, n_sweeps)
    if A.device.type != 'cpu':
        raise ValueError(f'jacobi_solve: unsupported device {A.device}')
    return jacobi_solve_plain(A, b, aii_inv, omega, n_sweeps)


#: launches of the tier kernel since the count was last set to 0
jacobi_solve.launches = 0
#: launches of the cluster kernel since the count was last set to 0
jacobi_solve_cluster.launches = 0
