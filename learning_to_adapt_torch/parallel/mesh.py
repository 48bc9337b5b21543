"""Scale-out over ranks of torch.distributed (parallel/mesh.py).

Counterpart of learning_to_adapt_tpu/parallel/mesh.py, with one process per
rank where the JAX package has one device per mesh position. The mesh has
the same two axes:

  axis 'env'   environment instances / rollouts / fit paths and rows
  axis 'model' dynamics-ensemble members

Rank r sits at env index r // n_model and model index r % n_model, as
device r of the JAX mesh's (n_env, n_model) array does.

Where the JAX package shards an array with a NamedSharding and lets GSPMD
insert the collectives, here every rank holds its slice of the leading axis
on its own device and the code calls the collectives itself:

  make_mesh            joins the process group (under torchrun) or starts
                       a 1-rank group on a local TCP store
  replicate /          rank 0's values on every rank, one broadcast (the
  stage_model_state    replicated NamedSharding; the JAX module's `stage`
                       of a replicated tree is replicate)
  shard_batch /        the rank's slice of a leading axis on its device
  stage_fit_data       (the P('env') sharding)
  take_rows            rows at global indices of an env-sharded axis, on
                       every rank, in one all_reduce (the gather GSPMD
                       inserts into the sharded epochs)
  gather               all-gathers env-sharded tensors into host numpy on
                       every rank (process_allgather)
  data_parallel_grad_step, psum_normalizer_stats
                       one all_reduce of a flat buffer each (pmean, psum)
  spawn                runs a function on W local ranks (processes started
                       by spawn), the way torchrun would start them

sharded_rollout_fn and jit_epoch_sharded have no counterpart here. They
are the `mesh=` path of samplers/rollout.py and the `model.mesh` path of
the three models' train and validation steps, which call shard_rows,
take_rows, batch_share and all_reduce below. Those helpers take mesh None
for a run without one (the whole axis, plain indexing, no collective), so
each fit has one code path. Over nccl a fit captures its steps with their
collectives as CUDA graphs (models/captured.py, the port's jit); over gloo
it runs them eagerly.

Each collective wrapper counts its calls (all_reduce.calls,
all_gather.calls, broadcast.calls), as the kernel wrappers count their
launches: collective_counts() reads them. A captured step's collectives
count once a replay (count_collectives), not at its capture or warm-ups.

The backend is nccl on CUDA devices and gloo on the CPU unless the caller
names one; gloo also runs on CUDA tensors (all_gather through the host),
which is how two ranks share one card. Nothing switches backend or device
on its own.
"""
import dataclasses
import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.models.optim import (
    tree_leaves, tree_map, tree_unflatten)

#: how long a collective may wait for the other ranks
TIMEOUT = datetime.timedelta(minutes=10)
_OPS = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX}
_TORCHRUN_VARS = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


class Mesh:
    """This rank's place on an (n_env, n_model) grid of ranks: its device,
    the backend, and the process group along each axis through it."""

    def __init__(self, rank, world_size, n_env, n_model, device,
                 backend=None, groups=None, owns_group=False):
        self.rank = rank
        self.world_size = world_size
        self.shape = {'env': n_env, 'model': n_model}
        self.device = device
        self.backend = backend
        self._groups = groups or {}
        self._owns_group = owns_group

    def index(self, axis):
        """This rank's coordinate on `axis`."""
        return (self.rank // self.shape['model'] if axis == 'env'
                else self.rank % self.shape['model'])

    def group(self, axis):
        """The process group of the ranks along `axis` through this one."""
        return self._groups[axis]

    def close(self):
        """Destroys the process group if make_mesh started it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False


def make_mesh(n_env=None, n_model=1, device='cuda', backend=None):
    """The mesh over every rank of the process group, joined or started
    here. Under torchrun (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT
    set) the group is joined through env://, where jax.distributed
    .initialize() would read COORDINATOR_ADDRESS; 'cuda' then means
    cuda:LOCAL_RANK. Without them a 1-rank group starts on a local TCP
    store, so the same collectives run. An already initialised group is
    used as it is.

    backend: 'nccl' (the default on CUDA) or 'gloo' (the default on the
    CPU, and the one way to put several ranks on one card). nccl needs a
    card per rank and raises otherwise. n_env defaults to the world size
    over n_model."""
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    dev = resolve_device(dev)
    if dev.type == 'cuda' and dev.index >= torch.cuda.device_count():
        raise ValueError(f'{dev} does not exist: {torch.cuda.device_count()} '
                         'card(s) visible')
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f"backend {backend!r} is not 'nccl' or 'gloo'")
    if backend == 'nccl' and dev.type != 'cuda':
        raise ValueError(f"backend 'nccl' needs a CUDA device, not {dev}; "
                         "use backend='gloo' on the CPU")
    owns = not dist.is_initialized()
    if not owns and dist.get_backend() != backend:
        raise ValueError(f'the process group runs {dist.get_backend()}, '
                         f'not {backend}')
    if owns:
        torchrun = all(k in os.environ for k in _TORCHRUN_VARS)
        world = int(os.environ['WORLD_SIZE']) if torchrun else 1
    else:
        world = dist.get_world_size()
    if n_env is None:
        n_env = world // n_model
    if n_env * n_model != world:
        raise ValueError(f'a mesh of {n_env} x {n_model} needs '
                         f'{n_env * n_model} ranks, the group has {world}')
    if backend == 'nccl' and world > torch.cuda.device_count():
        raise ValueError(
            f"backend 'nccl' needs a card per rank: {world} ranks, "
            f"{torch.cuda.device_count()} card(s); use backend='gloo' to "
            'put several ranks on one card')
    if dev.type == 'cuda' and backend == 'nccl':
        torch.cuda.set_device(dev)
    if owns:
        if torchrun:
            dist.init_process_group(backend, init_method='env://',
                                    timeout=TIMEOUT)
        else:
            store = dist.TCPStore('localhost', 0, 1, is_master=True,
                                  timeout=TIMEOUT)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1, timeout=TIMEOUT)
    rank = dist.get_rank()
    # every rank creates every group, in the same order
    groups = {}
    for axis, size, other in (('env', n_env, n_model),
                              ('model', n_model, n_env)):
        for j in range(other):
            ranks = [(i * n_model + j if axis == 'env' else j * n_model + i)
                     for i in range(size)]
            g = dist.group.WORLD if other == 1 else dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(rank, world, n_env, n_model, dev, backend, groups, owns)


# ------------------------------------------------------------ collectives
def all_reduce(mesh, tensor, op='sum', axis='env'):
    """tensor reduced in place over the ranks along `axis` ('sum' or
    'max'); returns it (as it is without a mesh)."""
    if mesh is None:
        return tensor
    all_reduce.calls += 1
    dist.all_reduce(tensor, op=_OPS[op], group=mesh.group(axis))
    return tensor


def all_gather(mesh, tensor, axis='env'):
    """[tensor of each rank along `axis`], in rank order."""
    all_gather.calls += 1
    out = [torch.empty_like(tensor) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, tensor, group=mesh.group(axis))
    return out


def broadcast(mesh, tensor, src=0):
    """tensor overwritten in place with rank src's, over the whole mesh."""
    broadcast.calls += 1
    dist.broadcast(tensor, src)
    return tensor


all_reduce.calls = all_gather.calls = broadcast.calls = 0


def collective_counts():
    return dict(all_reduce=all_reduce.calls, all_gather=all_gather.calls,
                broadcast=broadcast.calls)


def count_collectives(counts):
    """Adds counts (as collective_counts() gives them) to the counters: a
    captured step's collectives at each replay (models/captured.py)."""
    for fn in (all_reduce, all_gather, broadcast):
        fn.calls += counts[fn.__name__]


def all_reduce_flat(mesh, tensors, axis='env'):
    """Tensors of one dtype summed over `axis` with one all_reduce of a
    flat buffer; returns them reduced, in order (views of the buffer), or
    as they are without a mesh."""
    if mesh is None:
        return list(tensors)
    flat = all_reduce(mesh, torch.cat([t.reshape(-1) for t in tensors]),
                      axis=axis)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def _to_bytes(tensors):
    """One uint8 buffer holding the tensors' bytes, each at an 8-byte
    aligned offset, and the (offset, bytes, dtype, shape) of each."""
    parts, layout, off = [], [], 0
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % 8
        parts += [b, torch.zeros(pad, dtype=torch.uint8, device=b.device)]
        layout.append((off, b.numel(), t.dtype, t.shape))
        off += b.numel() + pad
    return torch.cat(parts), layout


def _from_bytes(buf, layout):
    return [buf[off:off + n].view(dtype).reshape(shape)
            for off, n, dtype, shape in layout]


# ---------------------------------------------------- replicated state
def replicate(mesh, tree):
    """tree with rank 0's values on every rank: one broadcast of its
    leaves' bytes (any dtypes), the counterpart of the replicated
    NamedSharding."""
    leaves = tree_leaves(tree)
    buf, layout = _to_bytes(leaves)
    broadcast(mesh, buf)
    return tree_unflatten(tree, [x.clone() for x in _from_bytes(buf,
                                                                layout)])


def stage_model_state(model):
    """Replaces model.params, .opt_state and .normalizer by rank 0's (no-op
    without model.mesh): the learner's state is the same on every rank
    when a fit starts, in one broadcast."""
    mesh = model.mesh
    if mesh is None:
        return
    norm = model.normalizer
    names = [f.name for f in dataclasses.fields(norm)]
    params, opt_state, norm_leaves = replicate(
        mesh, (model.params, model.opt_state,
               [getattr(norm, f) for f in names]))
    model.params, model.opt_state = params, opt_state
    model.normalizer = type(norm)(**dict(zip(names, norm_leaves)))


# ---------------------------------------------------------- env-sharded
def shard_rows(mesh, n, axis='env'):
    """The slice of a leading axis of n rows that this rank holds (all of
    it without a mesh); raises when n does not divide over `axis`."""
    if mesh is None:
        return slice(0, n)
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(
            f'a leading axis of {n} (rollouts, or a fit capacity: a multiple '
            f'of PATH_CHUNK / PAD_CHUNK) does not divide over the mesh '
            f'{axis!r} axis ({size})')
    per = n // size
    start = mesh.index(axis) * per
    return slice(start, start + per)


def shard_batch(mesh, tree, axis_name='env'):
    """Tensors of this rank's slice of every leaf's leading axis, on the
    mesh's device; raises when an axis does not divide over `axis_name`."""
    return tree_map(lambda x: torch.as_tensor(
        x[shard_rows(mesh, x.shape[0], axis_name)], device=mesh.device),
        tree)


def stage_fit_data(model, tree):
    """numpy fit data on model.device: with model.mesh, the rank's slice of
    each leading axis (paths or padded rows; raises when a capacity does
    not divide over 'env'), else the whole array."""
    if model.mesh is None:
        return tree_map(lambda a: torch.as_tensor(a, device=model.device),
                        tree)
    return shard_batch(model.mesh, tree)


def take_rows(mesh, tensors, idx, *rest):
    """[t[idx, *rest] for t in tensors] on every rank, where idx are global
    indices into a leading axis that the 'env' ranks hold in equal slices
    (stage_fit_data), the same on every rank: each rank writes the rows it
    holds and zeros elsewhere, and one all_reduce of a flat buffer sums
    them (adding zeros is exact). Plain indexing without a mesh."""
    if mesh is None:
        return [t[(idx,) + rest] for t in tensors]
    n_local = tensors[0].shape[0]
    local = idx - mesh.index('env') * n_local
    held = (local >= 0) & (local < n_local)
    local = local.clamp(0, n_local - 1)
    out = []
    for t in tensors:
        x = t[(local,) + rest]
        mask = held.reshape(held.shape + (1,) * (x.dim() - held.dim()))
        out.append(torch.where(mask, x, 0.0))
    return all_reduce_flat(mesh, out)


def batch_share(mesh, n):
    """The positions [r*n // W, (r+1)*n // W) of a batch of n that rank r
    of the W on 'env' computes (all n without a mesh); raises when n < W,
    which would leave a rank without rows."""
    if mesh is None:
        return slice(0, n)
    size, r = mesh.shape['env'], mesh.index('env')
    if n < size:
        raise ValueError(f"a batch of {n} does not cover the mesh 'env' "
                         f'axis ({size})')
    return slice(r * n // size, (r + 1) * n // size)


def gather(mesh, tree, axis='env'):
    """Every rank's tensors of `tree`, concatenated along the leading axis
    in rank order, as host numpy on every rank (process_allgather): one
    all_gather of the leaves' bytes, on the card under nccl and on the host
    under gloo. Without a mesh, tree's tensors copied to the host."""
    if mesh is None:
        return tree_map(lambda x: x.cpu().numpy(), tree)
    leaves = tree_leaves(tree)
    if mesh.backend != 'nccl':
        leaves = [x.cpu() for x in leaves]
    buf, layout = _to_bytes(leaves)
    # one copy to the host of every rank's buffer
    parts = [_from_bytes(b, layout)
             for b in torch.stack(all_gather(mesh, buf, axis)).cpu()]
    return tree_unflatten(tree, [
        torch.cat([p[i] for p in parts]).numpy()
        for i in range(len(leaves))])


# ----------------------------------------------------- data-parallel math
def data_parallel_grad_step(mesh, loss_fn, optimizer):
    """step(params, opt_state, *local_batch) -> (params, opt_state, loss):
    each rank takes the gradient of loss_fn(params, *local_batch) on its
    shard, one all_reduce of a flat buffer of every gradient leaf and the
    loss gives their means over 'env' (pmean), and the same
    optimizer.update(grads, opt_state, params) -> (params, opt_state) runs
    on every rank."""
    n = mesh.shape['env']

    def step(params, opt_state, *batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, leaves), *batch)
            grads = torch.autograd.grad(loss, leaves)
        *grads, loss = [x / n for x in all_reduce_flat(
            mesh, list(grads) + [loss.detach()])]
        params, opt_state = optimizer.update(
            tree_unflatten(params, grads), opt_state, params)
        return params, opt_state, loss

    return step


def psum_normalizer_stats(mesh, obs, act, delta, axis_name='env'):
    """((mean, std) of obs, act, delta) over the rows of every rank along
    `axis_name`, from local row counts, sums and sums of squares in one
    all_reduce: var = max(E[x^2] - mean^2, 0)."""
    parts = []
    for x in (obs, act, delta):
        parts += [torch.tensor([x.shape[0]], dtype=x.dtype, device=x.device),
                  x.sum(0), torch.square(x).sum(0)]
    flat = all_reduce_flat(mesh, parts, axis=axis_name)
    out = []
    for n, s, ss in zip(flat[0::3], flat[1::3], flat[2::3]):
        mean = s / n
        var = torch.clamp(ss / n - torch.square(mean), min=0.0)
        out.append((mean, torch.sqrt(var)))
    return tuple(out)


# ------------------------------------------------------------ local ranks
def free_port():
    """A TCP port free on localhost now (for MASTER_PORT)."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _spawned(index, fn, world_size, port, args):
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port),
                      RANK=str(index), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(index))
    fn(*args)


def spawn(fn, world_size, args=(), timeout=600):
    """Runs fn(*args) in world_size processes started by spawn (never fork:
    the caller may have initialised CUDA), each with the variables torchrun
    sets for rank r of one local group (MASTER_ADDR localhost, a free
    MASTER_PORT, RANK = LOCAL_RANK = r, WORLD_SIZE), so make_mesh() in them
    joins one group. fn must be importable by name. Raises if a rank fails
    or the ranks outlast `timeout` seconds; no rank outlives the call."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_spawned, args=(fn, world_size, free_port(),
                                             args),
                             nprocs=world_size, join=False,
                             start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f'{world_size} ranks still running after '
                                   f'{timeout} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
