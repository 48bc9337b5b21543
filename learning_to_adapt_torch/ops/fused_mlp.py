"""Grouped fused MLP forward: the CUDA kernel, its weight pack and its plain
version.

Counterpart of learning_to_adapt_tpu/ops/fused_mlp.py (`fused_mlp_forward`)
with a group axis added: x (G, R, in) runs through group g's own weights,
which is what the planner needs once every env has its own adapted
parameters (models/meta_mlp.py `predict_adapted_fn`). Numerics: activations
and weights rounded to bf16 before each product, f32 accumulation, f32 bias,
then the hidden nonlinearity; the output layer is identity.

`pack_weights` rounds the f32 weights to bf16 once and lays them out as the
kernel's tile stream (`PackedMLP`); the planner packs once per env step and
its 10 horizon predictions reuse the pack. It is plain tensor code, the
counterpart of the JAX wrapper's `w.astype(jnp.bfloat16)` outside its
Pallas body.

`fused_mlp_forward` is what the model calls, with per-layer weight lists or
a `PackedMLP`. On CUDA tensors it launches the kernel, csrc/fused_mlp.cu,
or raises; only tensors on the CPU take the plain version,
`fused_mlp_plain`, which defines the numerics.
"""
import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from learning_to_adapt_torch.ops import build

ACTIVATIONS = ('relu', 'tanh', 'swish', 'sigmoid')

#: weight tile of the packed stream: TILE_K deep x TILE_N wide, bf16
#: (kKC and kNC of csrc/fused_mlp.cu)
TILE_K, TILE_N = 64, 128
TILE_ELEMS = TILE_K * TILE_N


def _activate(h, name):
    if name == 'relu':
        return torch.relu(h)
    if name == 'tanh':
        return torch.tanh(h)
    if name == 'swish':
        return h * torch.sigmoid(h)
    if name == 'sigmoid':
        return torch.sigmoid(h)
    raise ValueError(f'unknown hidden nonlinearity {name!r}')


def _bf16(t):
    """Round to bf16 (nearest even) and widen back: products of two such
    values are exact in f32, so an f32 matmul of them accumulates in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def fused_mlp_plain(x, ws, bs, hidden_nonlinearity='relu'):
    """x (G, R, in) f32; ws[l] (G, in_l, out_l), bs[l] (G, out_l) f32.
    Returns (G, R, out) f32."""
    h = x
    n = len(ws)
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = torch.matmul(_bf16(h), _bf16(w)) + b[:, None, :]
        if i < n - 1:
            h = _activate(h, hidden_nonlinearity)
    return h


# ------------------------------------------------------------------ pack
@dataclass(frozen=True)
class PackedMLP:
    """Weights of a grouped MLP as the kernel reads them.

    w: (G, n_tiles * TILE_ELEMS) bf16, group g's tiles in consumption order
    (layer, 128-column output chunk, 64-deep k-tile); a group stride of 0
    when one weight set serves every group. bs: the f32 biases (G, out_l)
    with contiguous rows. dims: the layer widths (in, hidden..., out)."""
    w: torch.Tensor
    bs: tuple
    dims: tuple

    @property
    def groups(self):
        return self.w.shape[0]

    @functools.cached_property
    def c_args(self):
        """The kernel's ctypes arguments (dims, bias pointers and group
        strides), made once per pack."""
        n = len(self.bs)
        return ((ctypes.c_int * (n + 1))(*self.dims),
                (ctypes.c_uint64 * n)(*[b.data_ptr() for b in self.bs]),
                (ctypes.c_int64 * n)(*[b.stride(0) for b in self.bs]))


def _n_tiles(k, n):
    return -(-k // TILE_K), -(-n // TILE_N)


def _stream_elems(dims):
    """Elements of one group's tile stream for layer widths dims."""
    return TILE_ELEMS * sum(nk * nn for nk, nn in (
        _n_tiles(k, n) for k, n in zip(dims[:-1], dims[1:])))


_SWIZZLE = {}


def _swizzle_index(device):
    """Indices (n7, a) with a[i, j] = j ^ i: the 16-byte group j of a tile
    column n holds k-group j ^ (n & 7) (csrc/fused_mlp.cu reads word q of
    column n at n * 32 + (q ^ ((n & 7) << 2))). The swizzle is its own
    inverse."""
    idx = _SWIZZLE.get(device)
    if idx is None:
        n7 = torch.arange(8, device=device)[:, None]
        idx = _SWIZZLE[device] = (n7, torch.arange(8, device=device) ^ n7)
    return idx


def _tile_layer(t, fill):
    """(G, k, n) -> (G, nn * nk * TILE_ELEMS) in the kernel's tile order,
    ragged edges filled with `fill`."""
    g, k, n = t.shape
    nk, nn = _n_tiles(k, n)
    t = F.pad(t, (0, nn * TILE_N - n, 0, nk * TILE_K - k), value=fill)
    # k = kt*64 + a*8 + e, n = nc*128 + nh*8 + n7 -> (g, nc, kt, nh, n7, a, e)
    t = t.view(g, nk, 8, 8, nn, 16, 8).permute(0, 4, 1, 5, 6, 2, 3)
    n7, a = _swizzle_index(t.device)
    return t[:, :, :, :, n7, a].reshape(g, -1)


def _untile_layer(t, k, n):
    """Inverse of `_tile_layer`: (G, tiles) -> (G, k, n)."""
    nk, nn = _n_tiles(k, n)
    t = t.reshape(t.shape[0], nn, nk, 16, 8, 8, 8)
    n7, a = _swizzle_index(t.device)
    t = t[:, :, :, :, n7, a].permute(0, 2, 5, 6, 1, 3, 4)
    return t.reshape(-1, nk * TILE_K, nn * TILE_N)[:, :k, :n]


_PACK_INDEX = {}


def _pack_index(dims, device):
    """For each element of the packed stream, its position in the
    concatenation of the flattened weights, or one past the end (a zero)
    for padding. Made on the device once per widths."""
    idx = _PACK_INDEX.get((dims, device))
    if idx is None:
        sizes = [k * n for k, n in zip(dims[:-1], dims[1:])]
        pos = torch.arange(sum(sizes), device=device)
        parts, off = [], 0
        for k, n in zip(dims[:-1], dims[1:]):
            parts.append(_tile_layer(pos[off:off + k * n].view(1, k, n),
                                     fill=sum(sizes)))
            off += k * n
        idx = _PACK_INDEX[(dims, device)] = torch.cat(parts, dim=1)[0].to(
            torch.int32)
    return idx


_ZERO = {}


def _dims(ws, bs):
    if len(ws) != len(bs) or not ws:
        raise ValueError('fused_mlp: need one bias per weight, >= 1 layer')
    g = ws[0].shape[0]
    dims = [int(ws[0].shape[1])]
    for w, b in zip(ws, bs):
        if w.ndim != 3 or w.shape[0] != g or w.shape[1] != dims[-1] or \
                tuple(b.shape) != (g, w.shape[2]):
            raise ValueError(f'fused_mlp: layer shapes W {tuple(w.shape)}, '
                             f'b {tuple(b.shape)} after width {dims[-1]}')
        dims.append(int(w.shape[2]))
    return tuple(dims)


def pack_weights(ws, bs):
    """Round ws[l] (G, k_l, n_l) f32 to bf16 (nearest even) and pack them
    into the kernel's tile stream; bs[l] (G, n_l) stay f32. Weights that are
    one set broadcast over the groups (stride 0, as `broadcast_params`
    gives) pack one group and keep stride 0. Three tensor ops: concatenate,
    round, gather into tile order."""
    dims = _dims(ws, bs)
    dev = ws[0].device
    for t_ in list(ws) + list(bs):
        if t_.dtype != torch.float32 or t_.device != dev:
            raise TypeError('fused_mlp: weights must be float32 on '
                            f'{dev}, got {t_.dtype} on {t_.device}')
    g = ws[0].shape[0]
    shared = all(w.shape[0] == 1 or w.stride(0) == 0 for w in ws)
    rows = 1 if shared else g
    zero = _ZERO.get(dev)
    if zero is None:
        zero = _ZERO[dev] = torch.zeros((1, 1), device=dev)
    flat = torch.cat([w[:rows].reshape(rows, -1) for w in ws] +
                     [zero.expand(rows, 1)], dim=1).to(torch.bfloat16)
    w = flat.index_select(1, _pack_index(dims, dev))
    bs = tuple(b if b.stride(1) == 1 else b.contiguous() for b in bs)
    pack_weights.calls += 1
    return PackedMLP(w.expand(g, -1), bs, dims)


#: packs since the count was last set to 0
pack_weights.calls = 0


def unpack_weights(packed):
    """The bf16 weights (G, k_l, n_l) read back from a PackedMLP; a shared
    set comes back as a stride-0 view."""
    w = packed.w
    g = w.shape[0]
    src = w[:1] if w.stride(0) == 0 else w
    out, off = [], 0
    for k, n in zip(packed.dims[:-1], packed.dims[1:]):
        nk, nn = _n_tiles(k, n)
        size = nk * nn * TILE_ELEMS
        out.append(_untile_layer(src[:, off:off + size], k, n).expand(g, k, n))
        off += size
    return out


def _check_packed(x, packed):
    """Raise unless `packed` holds a whole tile stream and one bias per
    layer for its widths (the kernel reads as many tiles as the widths give,
    with no bound of its own), packed for x's groups and input width."""
    dims, g = packed.dims, packed.groups
    if packed.w.ndim != 2 or packed.w.shape[1] != _stream_elems(dims) or \
            len(packed.bs) != len(dims) - 1 or \
            any(tuple(b.shape) != (g, n) for b, n in zip(packed.bs, dims[1:])):
        raise ValueError(f'fused_mlp: packed weights {tuple(packed.w.shape)} '
                         f'and {len(packed.bs)} biases are not a tile stream '
                         f'for widths {dims}')
    if x.ndim != 3 or x.shape[0] != packed.groups or \
            x.shape[2] != packed.dims[0]:
        raise ValueError(f'fused_mlp: x {tuple(x.shape)} against weights '
                         f'packed for {packed.groups} groups, widths '
                         f'{packed.dims}')


# ---------------------------------------------------------------- kernel
def _lib():
    lib = build.load('fused_mlp')
    if not getattr(lib, '_typed', False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fused_mlp_forward.argtypes = [
            p, p, i, i, i, p, p, ctypes.c_int64, p, p, i, p]
        lib.fused_mlp_forward.restype = i
        lib.fused_mlp_smem_bytes.argtypes = [i, p]
        lib.fused_mlp_smem_bytes.restype = i
        lib.fused_mlp_max_layers.argtypes = []
        lib.fused_mlp_max_layers.restype = i
        lib.fused_mlp_tile_bytes.argtypes = []
        lib.fused_mlp_tile_bytes.restype = i
        if lib.fused_mlp_tile_bytes() != 2 * TILE_ELEMS:
            raise RuntimeError('fused_mlp: the kernel tile differs from '
                               f'{TILE_K}x{TILE_N} bf16')
        lib._typed = True
    return lib


def fused_mlp_cuda(x, ws, bs=None, hidden_nonlinearity='relu'):
    """Launch the kernel. x float32 on a CUDA device; ws a PackedMLP (bs
    None) or per-layer float32 weights and biases, which are then packed
    here on every call (and counted in pack_weights.calls): callers that
    reuse weights pack them once."""
    if hidden_nonlinearity not in ACTIVATIONS:
        raise ValueError(f'unknown hidden nonlinearity {hidden_nonlinearity!r}')
    if x.dtype != torch.float32:
        raise TypeError(f'fused_mlp: x must be float32, got {x.dtype}')
    packed = ws if isinstance(ws, PackedMLP) else pack_weights(ws, bs)
    _check_packed(x, packed)
    w = packed.w
    if w.device != x.device or w.dtype != torch.bfloat16 or \
            w.stride(1) != 1 or w.data_ptr() % 16 or w.stride(0) % 8:
        raise TypeError('fused_mlp: packed weights must be a bf16 tile '
                        f'stream on {x.device}, 16-byte aligned')
    lib = _lib()
    c_dims, b_ptrs, b_gs = packed.c_args
    n_layers = len(packed.bs)
    if n_layers > lib.fused_mlp_max_layers():
        raise ValueError(f'fused_mlp: {n_layers} layers is too many')
    if lib.fused_mlp_smem_bytes(n_layers, c_dims) > build.SMEM_LIMIT:
        raise ValueError(f'fused_mlp: widths {packed.dims} do not fit in '
                         'shared memory')
    x = x.contiguous()
    g, r, _ = x.shape
    out = torch.empty((g, r, packed.dims[-1]), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fused_mlp_forward(
            x.data_ptr(), out.data_ptr(), g, r, n_layers, c_dims,
            w.data_ptr(), 2 * w.stride(0), b_ptrs, b_gs,
            ACTIVATIONS.index(hidden_nonlinearity), stream)
    build.check(rc, 'fused_mlp')
    fused_mlp_forward.launches += 1
    return out


def fused_mlp_forward(x, ws, bs=None, hidden_nonlinearity='relu'):
    """Grouped MLP forward; see `fused_mlp_plain`. ws: per-layer weights
    with their biases bs, or a PackedMLP (bs None). CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if isinstance(ws, PackedMLP) and bs is not None:
        raise ValueError('fused_mlp: a PackedMLP carries its biases')
    if x.is_cuda:
        return fused_mlp_cuda(x, ws, bs, hidden_nonlinearity)
    if x.device.type != 'cpu':
        raise ValueError(f'fused_mlp: unsupported device {x.device}')
    if isinstance(ws, PackedMLP):
        _check_packed(x, ws)
        return fused_mlp_plain(x, unpack_weights(ws), ws.bs,
                               hidden_nonlinearity)
    return fused_mlp_plain(x, ws, bs, hidden_nonlinearity)


#: kernel launches since the count was last set to 0
fused_mlp_forward.launches = 0
