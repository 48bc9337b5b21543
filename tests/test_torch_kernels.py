"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card (the kernels have
no CPU or interpret mode). On a machine with one:

    python -m pytest tests/test_torch_kernels.py -m cuda -q
"""
import dataclasses

import pytest
import torch

from learning_to_adapt_torch.ops import fused_mlp, jacobi

pytestmark = pytest.mark.cuda

MLP_TOL = dict(rtol=2e-2, atol=2e-2)     # bf16 roundings may flip
JACOBI_TOL = dict(rtol=1e-4, atol=1e-5)  # f32, other summation order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _mlp(dev, g, r, dims, seed, shared=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((g, r, dims[0]), generator=gen, device=dev)
    ws, bs = [], []
    for k, n in zip(dims[:-1], dims[1:]):
        w = (torch.rand((1 if shared else g, k, n), generator=gen,
                        device=dev) * 2 - 1) * (6.0 / (k + n)) ** 0.5
        b = 0.1 * torch.randn((1 if shared else g, n), generator=gen,
                              device=dev)
        ws.append(w.expand(g, k, n))
        bs.append(b.expand(g, n))
    return x, ws, bs


@pytest.mark.parametrize('g,r,dims,act', [
    (5, 500, (26, 512, 512, 512, 20), 'relu'),   # the planner's shape
    (3, 33, (26, 64, 20), 'tanh'),               # ragged rows and widths
    (2, 70, (7, 130, 300, 5), 'swish'),
    (1, 16, (26, 64, 20), 'sigmoid'),
])
@pytest.mark.parametrize('shared', [False, True])
@pytest.mark.parametrize('packed', [False, True])
def test_fused_mlp_kernel_matches_plain(dev, g, r, dims, act, shared, packed):
    x, ws, bs = _mlp(dev, g, r, dims, seed=len(dims) + r, shared=shared)
    weights = (fused_mlp.pack_weights(ws, bs), None) if packed else (ws, bs)
    if packed and shared:
        assert weights[0].w.stride(0) == 0 or g == 1
    before = fused_mlp.fused_mlp_forward.launches
    out = fused_mlp.fused_mlp_forward(x, *weights, act)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    ref = fused_mlp.fused_mlp_plain(x, ws, bs, act)
    torch.testing.assert_close(out, ref, **MLP_TOL)


def test_fused_mlp_kernel_refuses_float64(dev):
    x, ws, bs = _mlp(dev, 2, 8, (26, 32, 20), seed=0)
    with pytest.raises(TypeError):
        fused_mlp.fused_mlp_forward(x.double(), ws, bs)


def test_fused_mlp_kernel_refuses_other_widths(dev):
    x, ws, bs = _mlp(dev, 2, 8, (26, 32, 20), seed=0)
    other = fused_mlp.pack_weights(*_mlp(dev, 2, 8, (20, 32, 20), seed=1)[1:])
    with pytest.raises(ValueError, match='packed for'):
        fused_mlp.fused_mlp_forward(x, other)
    three = fused_mlp.pack_weights(*_mlp(dev, 3, 8, (26, 32, 20), seed=1)[1:])
    with pytest.raises(ValueError, match='packed for'):
        fused_mlp.fused_mlp_forward(x, three)
    assert fused_mlp.fused_mlp_forward(x, fused_mlp.pack_weights(ws, bs)) \
        .shape == (2, 8, 20)


def test_fused_mlp_kernel_refuses_short_stream(dev):
    """The kernel reads as many tiles as the widths give: a stream one tile
    short, or one bias short, is refused before any launch."""
    x, ws, bs = _mlp(dev, 2, 8, (26, 130, 20), seed=0)
    packed = fused_mlp.pack_weights(ws, bs)
    before = fused_mlp.fused_mlp_forward.launches
    for bad in (dataclasses.replace(
                    packed, w=packed.w[:, :-fused_mlp.TILE_ELEMS]),
                dataclasses.replace(packed, bs=packed.bs[:-1])):
        with pytest.raises(ValueError, match='not a tile stream'):
            fused_mlp.fused_mlp_forward(x, bad)
    assert fused_mlp.fused_mlp_forward.launches == before


def _system(dev, n_envs, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn((n_envs, n, n), generator=gen, device=dev)
    a = m @ m.transpose(-1, -2) + n * torch.eye(n, device=dev)
    b = torch.randn((n_envs, n), generator=gen, device=dev)
    aii_inv = 1.0 / torch.diagonal(a, dim1=-2, dim2=-1)
    rho = torch.amax(a.abs().sum(-1) * aii_inv, dim=-1)
    return a, b, aii_inv, torch.clamp(1.8 / rho, max=1.0)


@pytest.mark.parametrize('n_envs,n', [(5, 76), (3, 7), (2, 200)])
def test_jacobi_kernel_matches_plain(dev, n_envs, n):
    args = _system(dev, n_envs, n, seed=n)
    before = jacobi.jacobi_solve.launches
    out = jacobi.jacobi_solve(*args, 60)
    torch.cuda.synchronize()
    assert jacobi.jacobi_solve.launches == before + 1
    torch.testing.assert_close(out, jacobi.jacobi_solve_plain(*args, 60),
                               **JACOBI_TOL)
    assert (out >= 0).all()


def test_jacobi_kernel_refuses_float64(dev):
    args = [a.double() for a in _system(dev, 2, 8, seed=0)]
    with pytest.raises(TypeError):
        jacobi.jacobi_solve(*args, 10)
