"""Which of the two fused-MLP kernels a launch takes (ops/fused_mlp.py
`wgmma_path`), and the packed tile as the warpgroup-MMA kernel reads it.

Plain functions of the launch's shape: no card needed. The kernels
themselves are held against the plain version in tests/test_torch_kernels.py
on the card.
"""
import numpy as np
import pytest
import torch

from learning_to_adapt_torch.ops import build
from learning_to_adapt_torch.ops import fused_mlp

SMS = 132                                   # an H100 SXM
MB_MPC = (26, 512, 512, 20)                 # run_mb_mpc.py's model
GRBAL = (26, 512, 512, 512, 20)             # run_grbal.py's meta-MLP
ANT_MB_MPC = (49, 512, 512, 41)
THRESHOLD = fused_mlp.WGMMA_MIN_ROWS_PER_SM * SMS


def _path(groups, rows, dims, shared=True, sms=SMS):
    """The rule for a launch whose weights are one set (stride 0) or one
    set a group (the strides pack_weights gives)."""
    w_gstride = 0 if shared else fused_mlp._stream_elems(dims)
    b_gstrides = [0 if shared else n for n in dims[1:]]
    return fused_mlp.wgmma_path(groups, rows, w_gstride, b_gstrides, dims,
                                sms)


@pytest.mark.parametrize('groups,rows,dims,shared,want', [
    # MB-MPC's planner: 10 envs x 2000 candidates in one group
    (1, 20000, MB_MPC, True, True),
    (1, 20000, ANT_MB_MPC, True, True),
    (1, 20000, GRBAL, True, True),
    # GrBAL's planner: 5 envs x 500 candidates on per-env adapted weights,
    # and on the shared set before adaptation (2,500 rows)
    (5, 500, GRBAL, False, False),
    (5, 500, GRBAL, True, False),
    # the entry point's example: one group of 2,500 rows
    (1, 2500, GRBAL, True, False),
    # many rows, but a weight set a group: the 16-row kernel
    (4, 5000, MB_MPC, False, False),
    # groups sharing one set count their rows together
    (4, 5000, MB_MPC, True, True),
])
def test_wgmma_path_on_the_planners_launches(groups, rows, dims, shared,
                                              want):
    assert _path(groups, rows, dims, shared) is want


def test_wgmma_path_threshold_edges():
    assert THRESHOLD == 8448
    assert not _path(1, THRESHOLD - 1, MB_MPC)
    assert _path(1, THRESHOLD, MB_MPC)
    assert _path(1, THRESHOLD + 1, MB_MPC)
    # the groups' rows together: 2 x 4,224 reach it, 2 x 4,223 do not
    assert _path(2, THRESHOLD // 2, MB_MPC)
    assert not _path(2, THRESHOLD // 2 - 1, MB_MPC)
    # rows per SM: a card with fewer SMs reaches it with fewer rows
    assert _path(1, 64 * 114, MB_MPC, sms=114)
    assert not _path(1, 64 * 114 - 1, MB_MPC, sms=114)


def test_wgmma_path_one_group_needs_no_zero_strides():
    # one group: its own strides do not matter, there is one weight set
    assert fused_mlp.wgmma_path(1, 20000, 123456, [512, 512, 20], MB_MPC,
                                SMS)
    # more groups: the weights and every bias must be shared
    assert not fused_mlp.wgmma_path(2, 20000, 0, [0, 512, 0], MB_MPC, SMS)
    assert not fused_mlp.wgmma_path(2, 20000, 16, [0, 0, 0], MB_MPC, SMS)


@pytest.mark.parametrize('dims,fits', [
    (MB_MPC, True),                      # two 64 KB buffers and the rings
    ((26, 513, 20), False),              # a 640-wide hidden layer
    ((26, 1024, 20), False),
    ((512, 64, 20), True),               # the input sets the width
    ((513, 64, 20), False),
    ((26, 2048), True),                  # the output layer needs no buffer
    ((7, 130, 300, 5), True),
])
def test_wgmma_path_widths_that_fit(dims, fits):
    assert (fused_mlp.wgmma_smem_bytes(dims) <= build.SMEM_LIMIT) is fits
    assert _path(1, 20000, dims) is fits


def test_wgmma_smem_bytes_at_mb_mpc_widths():
    # 1 KB of alignment, a ring of 3 x 32 KB, 2 x 64 rows x 512 bf16, and 2
    # mbarriers a stage
    assert fused_mlp.wgmma_smem_bytes(MB_MPC) == \
        1024 + 3 * 32768 + 2 * 64 * 512 * 2 + 48 == 230448


def test_packed_tile_is_the_wgmma_b_operand_image():
    """Each 64 x 128 tile of the stream is warpgroup MMA's K-major B operand
    in the 128-byte swizzle: column n's 64 k as a 128-byte row at n * 128,
    with the hardware's swizzle (address bits 4-6 XOR bits 7-9) applied
    from a 1,024-aligned base."""
    dims = (26, 130, 20)
    gen = torch.Generator().manual_seed(3)
    ws = [torch.randn((1, k, n), generator=gen)
          for k, n in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros((1, n)) for n in dims[1:]]
    stream = fused_mlp.pack_weights(ws, bs).w[0].contiguous()
    raw = stream.view(torch.int16).numpy().view(np.uint16)
    tile = 0
    for w, (k, n) in zip(ws, zip(dims[:-1], dims[1:])):
        nk, nn = -(-k // 64), -(-n // 128)
        dense = np.zeros((nk * 64, nn * 128), np.uint16)
        col = np.arange(128)[:, None]
        kk = np.arange(64)[None, :]
        logical = col * 128 + kk * 2                       # bytes in the tile
        physical = logical ^ (((logical >> 7) & 7) << 4)
        for nc in range(nn):
            for kc in range(nk):
                t_ = raw[tile * 8192:(tile + 1) * 8192]
                tile += 1
                dense[kc * 64:(kc + 1) * 64, nc * 128:(nc + 1) * 128] = \
                    t_[physical // 2].T
        want = w[0].to(torch.bfloat16).view(torch.int16).numpy().view(
            np.uint16)
        np.testing.assert_array_equal(dense[:k, :n], want)
        assert not dense[k:].any() and not dense[:, n:].any()
    assert tile * 8192 == raw.size


def test_cpu_launches_count_no_kernel():
    dims = (26, 64, 20)
    x = torch.randn((1, 9000, dims[0]))
    ws = [torch.randn((1, k, n)) for k, n in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros((1, n)) for n in dims[1:]]
    before = (fused_mlp.fused_mlp_forward.launches,
              fused_mlp.fused_mlp_forward.wgmma_launches)
    fused_mlp.fused_mlp_forward(x, fused_mlp.pack_weights(ws, bs))
    assert (fused_mlp.fused_mlp_forward.launches,
            fused_mlp.fused_mlp_forward.wgmma_launches) == before
