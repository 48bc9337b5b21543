"""Projected-Jacobi constraint solve: the CUDA kernel and its plain version.

Counterpart of learning_to_adapt_tpu/ops/pallas_jacobi.py (`jacobi_solve`
and its XLA twin `jacobi_solve_xla`). The kernels, csrc/jacobi.cu, take the
env batch directly, all sweeps in one launch. Up to MAX_ROWS rows: one block
per env, A held in registers with each row split over a few threads (launch
tiers by N). Above: one thread-block cluster per env
(`jacobi_solve_cluster`) that reads A once, finds the rows that can move
(`live_rows`), and sweeps only those: in one block when they are few, else
over the cluster with their rows of A held on chip and f pushed
between the blocks through distributed shared memory; up to
MAX_CLUSTER_ROWS rows (`cluster_shape`).

`jacobi_solve` is what the engine calls. On CUDA tensors it launches the
kernel (float32 only) or raises; only tensors on the CPU take the plain
version, `jacobi_solve_plain`.
"""
import collections
import ctypes

import torch

from learning_to_adapt_torch.ops import build

#: launch tiers, smallest first: (threads per row, columns of A per thread,
#: rows per thread). A tier takes N <= threads per row * columns;
#: csrc/jacobi.cu builds one instantiation of its kernel for each.
TIERS = ((4, 8, 1), (4, 16, 2), (4, 20, 4), (4, 32, 2), (4, 56, 2))
MAX_ROWS = TIERS[-1][0] * TIERS[-1][1]

#: threads per block of the cluster kernel
CLUSTER_THREADS = 512
#: the most live rows the cluster kernel solves in one block
SMALL_MAX = 224

#: columns of a row the cluster kernel holds in registers (8 float4 a lane)
REGISTER_COLS = 1024

#: the cluster kernel's plan for N rows: blocks per cluster, threads per
#: block, rows of A each block scans, of them held in shared memory, in
#: registers (one a warp) and streamed from L2 each sweep when every row is
#: live, the most live rows solved in one block, bytes of shared memory per
#: block
ClusterPlan = collections.namedtuple(
    'ClusterPlan', 'cluster threads rows held in_registers streamed small '
    'smem')


def _round4(x):
    return -(-x // 4) * 4


def _plan(n, cluster):
    """The plan of csrc/jacobi.cu cluster_layout: 32 bytes (mbarrier,
    counts), the live list L (n4 ints), four arrays of the block's rows
    (flags, its live list, b and aii_inv), then one region: f double-
    buffered (2 n4 floats) and the held rows of A (n4 floats each), or, for
    the one-block path, A[L, L] in rows of m | 1 floats with b, aii_inv and
    f twice (4 m floats). None when not even the f buffers fit."""
    n4, rows = _round4(n), -(-n // cluster)
    fixed = 32 + 4 * n4 + 16 * _round4(rows)
    room = build.SMEM_LIMIT - fixed
    if room < 8 * n4:
        return None
    held = min(rows, (room - 8 * n4) // (4 * n4))
    regs = min(CLUSTER_THREADS // 32, rows - held) if n4 <= REGISTER_COLS \
        else 0
    small = SMALL_MAX
    while 4 * (small * (small + 1) + 4 * small) > room:
        small -= 1
    smem = fixed + max(4 * (2 + held) * n4,
                       4 * (small * (small + 1) + 4 * small))
    return ClusterPlan(cluster, CLUSTER_THREADS, rows, held, regs,
                       rows - held - regs, small, smem)


def _max_cluster_rows():
    lo, hi = 1, build.SMEM_LIMIT // 4
    while lo < hi:                       # the portable cluster of 8 is the
        mid = (lo + hi + 1) // 2         # smallest, so it needs the most
        if _plan(mid, 8) is not None:
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


def live_rows(A, b, aii_inv, omega):
    """(E, N) bool: the rows the cluster kernel sweeps. Row j is dead when
    b_j == 0 and every A_jk (k != j) == 0: from f = 0 its f stays exactly 0
    and adds exactly 0 to every other row, so the sweeps over the live rows
    alone give the dense result. An env with any value of A, b, aii_inv or
    omega that is not finite has every row live."""
    n = b.shape[-1]
    off = A.masked_fill(torch.eye(n, dtype=torch.bool, device=A.device), 0)
    live = (off != 0).any(-1) | (b != 0)
    finite = (torch.isfinite(A).all(-1).all(-1) & torch.isfinite(b).all(-1)
              & torch.isfinite(aii_inv).all(-1) & torch.isfinite(omega))
    return live | ~finite[:, None]


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


def cluster_shape(n, cluster=16):
    """The ClusterPlan of the cluster kernel for N-row systems in clusters
    of `cluster` blocks (16, or 8: `cluster_size`). Raises ValueError above
    MAX_CLUSTER_ROWS."""
    if n > MAX_CLUSTER_ROWS:
        raise ValueError(f'jacobi_solve: N={n} rows exceed the largest the '
                         f'cluster kernel takes ({MAX_CLUSTER_ROWS} rows: '
                         'its f buffers fill shared memory)')
    return _plan(n, cluster)


def route(n):
    """Which kernel takes an N-row system: 'tiers' (N <= MAX_ROWS) or
    'cluster' (N <= MAX_CLUSTER_ROWS); raises ValueError above."""
    if n <= MAX_ROWS:
        return 'tiers'
    cluster_shape(n)
    return 'cluster'


_CLUSTER = {}


def cluster_size(n, device):
    """Blocks per cluster for N rows on `device`: 16 where the card can hold
    a cluster of 16 of the plan's blocks at once (a non-portable size; one
    block an SM, as each takes most of an SM's shared memory), else the
    portable 8. Asked of the card once per N and device."""
    key = (n, str(device))
    if key not in _CLUSTER:
        _CLUSTER[key] = 16 if cluster_occupancy(n, 16, device) > 0 else 8
    return _CLUSTER[key]


def _lib():
    lib = build.load('jacobi')
    if not getattr(lib, '_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jacobi_solve.argtypes = [p, p, p, p, p] + [i] * 7 + [p]
        lib.jacobi_solve.restype = i
        lib.jacobi_solve_cluster.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
        lib.jacobi_solve_cluster.restype = i
        lib.jacobi_cluster_occupancy.argtypes = [i] * 5 + [
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
    cluster_shape(n)                     # raises above MAX_CLUSTER_ROWS
    if b.numel() == 0:                   # nothing to solve, nothing launched
        return torch.empty_like(b)
    plan = cluster_shape(n, cluster_size(n, A.device))
    lib = _lib()
    A, b, aii_inv, omega = (t.contiguous() for t in (A, b, aii_inv, omega))
    bulk = int(n % 4 == 0 and A.data_ptr() % 16 == 0)
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        rc = lib.jacobi_solve_cluster(
            A.data_ptr(), b.data_ptr(), aii_inv.data_ptr(), omega.data_ptr(),
            out.data_ptr(), n_envs, n, int(n_sweeps), plan.cluster,
            plan.rows, plan.held, plan.in_registers, plan.small, bulk,
            stream)
    build.check(rc, 'jacobi_solve_cluster')
    jacobi_solve_cluster.launches += 1
    return out


def cluster_occupancy(n, cluster, device):
    """Clusters of the cluster kernel's plan for N rows the card holds at
    once (cudaOccupancyMaxActiveClusters); 0: the plan cannot launch."""
    plan = cluster_shape(n, cluster)
    lib = _lib()
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        build.check(lib.jacobi_cluster_occupancy(
            n, cluster, plan.rows, plan.held, plan.small,
            ctypes.byref(active)), 'jacobi_cluster_occupancy')
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
