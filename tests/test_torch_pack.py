"""The fused-MLP weight pack (learning_to_adapt_torch.ops.fused_mlp
pack_weights): its tile layout, read back two independent ways, the plain
path through a packed object against the list path and the Pallas kernel,
and one pack per planner step."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.models import MetaMLPDynamicsModel as PortMetaMLP
from learning_to_adapt_torch.ops import fused_mlp as port_fused
from learning_to_adapt_torch.policies import MPCController as PortMPC
from learning_to_adapt_torch.samplers.rollout import (
    make_rollout_fn as port_rollout_fn)

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

WIDTHS = [(26, 512, 512, 512, 20),   # the planner's
          (7, 130, 300, 5),          # ragged in every layer
          (26, 64, 20)]
# bf16 products with f32 sums taken in another order (tests/test_torch_models)
BF16_TOL = dict(rtol=2e-3, atol=2e-3)


def _mlp(dims, groups, shared, seed):
    """Weights and biases (expanded to `groups` when shared) from numpy."""
    rng = np.random.RandomState(seed)
    n_sets = 1 if shared else groups
    ws = [t(rng.randn(n_sets, k, n) * (2.0 / k) ** 0.5)
          for k, n in zip(dims[:-1], dims[1:])]
    bs = [t(0.1 * rng.randn(n_sets, n)) for n in dims[1:]]
    return ([w.expand(groups, -1, -1) for w in ws],
            [b.expand(groups, -1) for b in bs])


@pytest.mark.parametrize('dims', WIDTHS)
@pytest.mark.parametrize('shared', [False, True])
def test_pack_round_trip(dims, shared):
    ws, bs = _mlp(dims, 3, shared, seed=len(dims))
    before = port_fused.pack_weights.calls
    packed = port_fused.pack_weights(ws, bs)
    assert port_fused.pack_weights.calls == before + 1
    tiles = sum(-(-k // 64) * -(-n // 128)
                for k, n in zip(dims[:-1], dims[1:]))
    assert packed.w.dtype == torch.bfloat16
    assert tuple(packed.w.shape) == (3, tiles * 64 * 128)
    assert packed.w.stride(0) == (0 if shared else tiles * 64 * 128)
    assert packed.dims == dims
    for got, w in zip(port_fused.unpack_weights(packed), ws):
        assert torch.equal(got, w.to(torch.bfloat16))   # round to nearest even
    # every element outside the weights is padding, and all of it is zero
    stored = packed.w[:1] if shared else packed.w
    assert int(torch.count_nonzero(stored)) == sum(
        int(torch.count_nonzero((w[:1] if shared else w).to(torch.bfloat16)))
        for w in ws)


def test_pack_layout_matches_kernel_reads():
    """Read the stream as csrc/fused_mlp.cu does, in numpy: tiles in order
    (layer, 128-column chunk, 64-deep k-tile); in a tile, word q (k pair
    2q, 2q+1) of column n at n * 32 + (q ^ ((n & 7) << 2)), low half first."""
    dims = (7, 130, 300, 5)
    ws, bs = _mlp(dims, 2, False, seed=1)
    stream = port_fused.pack_weights(ws, bs).w[1].contiguous()
    words = stream.view(torch.int32).numpy().view(np.uint32)
    tile = 0
    for w, (k, n) in zip(ws, zip(dims[:-1], dims[1:])):
        nk, nn = -(-k // 64), -(-n // 128)
        dense = np.zeros((nk * 64, nn * 128), np.uint32)
        for nc in range(nn):
            for kc in range(nk):
                words_t = words[tile * 4096:(tile + 1) * 4096]
                tile += 1
                col = np.arange(128)[:, None]
                q = np.arange(32)[None, :]
                wd = words_t[col * 32 + (q ^ ((col & 7) << 2))]   # (n, q)
                block = dense[kc * 64:(kc + 1) * 64, nc * 128:(nc + 1) * 128]
                block[0::2] = (wd & 0xffff).T
                block[1::2] = (wd >> 16).T
        want = w[1].to(torch.bfloat16).view(torch.int16).numpy()
        np.testing.assert_array_equal(dense[:k, :n],
                                      want.astype(np.uint32) & 0xffff)
        assert not dense[k:].any() and not dense[:, n:].any()
    assert tile * 4096 == words.size


@pytest.mark.parametrize('shared', [False, True])
@pytest.mark.parametrize('act', ['relu', 'sigmoid'])
def test_packed_plain_path_equals_list_path(shared, act):
    dims = (7, 130, 300, 5)
    ws, bs = _mlp(dims, 3, shared, seed=2)
    x = t(np.random.RandomState(3).randn(3, 11, dims[0]))
    packed = port_fused.pack_weights(ws, bs)
    got = port_fused.fused_mlp_forward(x, packed, None, act)
    want = port_fused.fused_mlp_forward(x, ws, bs, act)
    assert torch.equal(got, want)
    assert port_fused.fused_mlp_forward.launches == 0


def test_packed_plain_path_matches_pallas_interpret():
    """Each group through a packed object against the Pallas kernel run in
    interpret mode (as tests/test_ops.py runs it) with that group's
    weights."""
    from jax.experimental.pallas import tpu as pltpu
    from learning_to_adapt_tpu.ops import fused_mlp as jax_fused
    dims = (26, 64, 64, 20)
    ws, bs = _mlp(dims, 3, False, seed=4)
    x = np.random.RandomState(5).randn(3, 40, dims[0]).astype(np.float32)
    got = port_fused.fused_mlp_forward(
        t(x), port_fused.pack_weights(ws, bs), None, 'tanh')
    for g in range(3):
        params = {'w': [jnp.asarray(w[g].numpy()) for w in ws],
                  'b': [jnp.asarray(b[g].numpy()) for b in bs]}
        with pltpu.force_tpu_interpret_mode():
            want = jax_fused.fused_mlp_forward(params, jnp.asarray(x[g]),
                                               'tanh')
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want),
                                   **BF16_TOL)


def test_packed_refuses_what_it_was_not_packed_for():
    ws, bs = _mlp((26, 64, 20), 2, False, seed=6)
    packed = port_fused.pack_weights(ws, bs)
    x = torch.zeros((2, 4, 26))
    with pytest.raises(ValueError, match='packed for'):
        port_fused.fused_mlp_forward(torch.zeros((2, 4, 20)), packed)
    with pytest.raises(ValueError, match='packed for'):
        port_fused.fused_mlp_forward(torch.zeros((3, 4, 26)), packed)
    with pytest.raises(ValueError, match='carries its biases'):
        port_fused.fused_mlp_forward(x, packed, bs)
    with pytest.raises(TypeError):
        port_fused.pack_weights([w.double() for w in ws], bs)
    with pytest.raises(ValueError):
        port_fused.pack_weights(ws, bs[:1])
    assert port_fused.fused_mlp_forward(x, packed).shape == (2, 4, 20)


@pytest.mark.parametrize('cut', ['tile', 'bias'])
def test_packed_refuses_a_short_stream(cut):
    """A PackedMLP whose stream is shorter than its widths give (the kernel
    would read past it) or that lacks a bias is refused."""
    ws, bs = _mlp((26, 130, 20), 2, False, seed=7)
    packed = port_fused.pack_weights(ws, bs)
    bad = (dataclasses.replace(packed,
                               w=packed.w[:, :-port_fused.TILE_ELEMS])
           if cut == 'tile' else dataclasses.replace(packed,
                                                     bs=packed.bs[:-1]))
    with pytest.raises(ValueError, match='not a tile stream'):
        port_fused.fused_mlp_forward(torch.zeros((2, 4, 26)), bad)


def test_rollout_step_packs_once():
    """Every planner step packs the params once (before and after the
    adaptation gate), and its horizon's predictions reuse the pack."""
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task=None, reset_every_episode=True, device='cpu'))
    model = PortMetaMLP('dyn', env, hidden_sizes=(16,), batch_size=2,
                        inner_learning_rate=0.01, device='cpu')
    policy = PortMPC('policy', env, model, n_candidates=4, horizon=3)
    fn = port_rollout_fn(env, policy, model, 2, 8, adapt_batch_size=2)
    gen = torch.Generator().manual_seed(0)
    carry = fn.init_carry(gen, 0)
    packs = []
    real = model.predict_adapted_fn

    def spy(params, *args):
        packs.append(params)
        return real(params, *args)

    model.predict_adapted_fn = spy
    for step in range(6):                     # the gate opens at step 4
        before = port_fused.pack_weights.calls
        carry, out = fn.step_fn(model.params, model.normalizer, carry, step,
                                gen)
        assert port_fused.pack_weights.calls == before + 1
        assert len(packs) == 3 * (step + 1)   # horizon 3
        assert all(p is packs[-1] for p in packs[-3:])
        assert isinstance(packs[-1], port_fused.PackedMLP)
        assert torch.isfinite(out['actions']).all()
    assert port_fused.fused_mlp_forward.launches == 0
