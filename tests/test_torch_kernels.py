"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card (the kernels have
no CPU or interpret mode). On a machine with one:

    python -m pytest tests/test_torch_kernels.py -m cuda -q
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from learning_to_adapt_torch.ops import clip_adam, fused_mlp, jacobi

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


def test_fused_mlp_kernel_mb_mpc_shape(dev):
    """MB-MPC's planner launch: 10 envs x 2000 candidates = 20,000 rows in
    one group, 26->512->512->20, one weight set packed once."""
    x, ws, bs = _mlp(dev, 1, 20000, (26, 512, 512, 20), seed=6, shared=True)
    packed = fused_mlp.pack_weights(ws, bs)
    before = fused_mlp.fused_mlp_forward.launches
    out = fused_mlp.fused_mlp_forward(x, packed)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    torch.testing.assert_close(out, fused_mlp.fused_mlp_plain(x, ws, bs),
                               **MLP_TOL)


@pytest.mark.parametrize('shared', [False, True])
def test_fused_mlp_kernel_ant_widths(dev, shared):
    """GrBAL's planner launch on the Ant: 5 envs x 500 candidates,
    49->512x3->41 (obs 41 + act 8), packed per env or one shared set."""
    x, ws, bs = _mlp(dev, 5, 500, (49, 512, 512, 512, 41), seed=8,
                     shared=shared)
    packed = fused_mlp.pack_weights(ws, bs)
    before = fused_mlp.fused_mlp_forward.launches
    out = fused_mlp.fused_mlp_forward(x, packed)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    torch.testing.assert_close(out, fused_mlp.fused_mlp_plain(x, ws, bs),
                               **MLP_TOL)


def test_fused_mlp_kernel_ensemble_grouping(dev):
    """An ensemble through the kernel as MLPDynamicsModel.predict_fn runs
    it: the member axis as the group axis, every row repeated per member
    (a stride-0 input), then the member mean."""
    from learning_to_adapt_torch.models import MLPDynamicsModel

    class Env:
        obs_dim, act_dim = 20, 6
    model = MLPDynamicsModel('dyn', Env(), hidden_sizes=(64, 64),
                             n_members=3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    obs = torch.randn((700, 20), generator=gen, device=dev)
    act = torch.rand((700, 6), generator=gen, device=dev) * 2 - 1
    before = fused_mlp.fused_mlp_forward.launches
    got = model.predict_fn(model.pack(model.params), model.normalizer, obs,
                           act)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    x = torch.cat([obs, act], -1).expand(3, -1, -1)
    want = obs + fused_mlp.fused_mlp_plain(x, model.params['w'],
                                           model.params['b']).mean(0)
    torch.testing.assert_close(got, want, **MLP_TOL)


def _launched(x, packed, act='relu'):
    """One forward, and whether it took the warpgroup-MMA kernel."""
    before = (fused_mlp.fused_mlp_forward.launches,
              fused_mlp.fused_mlp_forward.wgmma_launches)
    out = fused_mlp.fused_mlp_forward(x, packed, None, act)
    torch.cuda.synchronize()
    launches = fused_mlp.fused_mlp_forward.launches - before[0]
    wgmma = fused_mlp.fused_mlp_forward.wgmma_launches - before[1]
    assert launches == 1 and wgmma in (0, 1)
    return out, bool(wgmma)


def _threshold(dev):
    return fused_mlp.WGMMA_MIN_ROWS_PER_SM * \
        torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize('act', fused_mlp.ACTIVATIONS)
def test_fused_mlp_wgmma_kernel_mb_mpc_shape(dev, act):
    """MB-MPC's launch, 1 x 20,000 rows, 26->512->512->20, takes the
    warpgroup-MMA kernel, for every activation."""
    x, ws, bs = _mlp(dev, 1, 20000, (26, 512, 512, 20), seed=20, shared=True)
    out, wgmma = _launched(x, fused_mlp.pack_weights(ws, bs), act)
    assert wgmma
    torch.testing.assert_close(out, fused_mlp.fused_mlp_plain(x, ws, bs, act),
                               **MLP_TOL)


@pytest.mark.parametrize('edge', ['below', 'at', 'past_a_tile', 'ragged'])
def test_fused_mlp_wgmma_kernel_ragged_rows(dev, edge):
    """One row either side of the dispatch threshold (a whole number of
    64-row tiles), one row past a tile, and a ragged count."""
    thr = _threshold(dev)
    rows = dict(below=thr - 1, at=thr, past_a_tile=thr + 1,
                ragged=thr + 64 * 7 + 29)[edge]
    x, ws, bs = _mlp(dev, 1, rows, (26, 512, 512, 20), seed=rows,
                     shared=True)
    out, wgmma = _launched(x, fused_mlp.pack_weights(ws, bs), 'tanh')
    assert wgmma is (edge != 'below')
    torch.testing.assert_close(
        out, fused_mlp.fused_mlp_plain(x, ws, bs, 'tanh'), **MLP_TOL)


@pytest.mark.parametrize('g,r,dims', [
    (1, 20000, (49, 512, 512, 41)),          # MB-MPC on the Ant (N = 48)
    (1, 20000, (26, 512, 512, 512, 20)),     # three hidden layers
    (1, 20000, (30, 512, 512, 23)),          # the arm's widths
    (4, 5000, (26, 512, 512, 20)),           # groups sharing one set
    (1, 9000, (7, 130, 300, 5)),             # ragged in every layer
    (1, 9000, (26, 512, 512, 200)),          # output chunks 128 and 72
    (1, 9000, (130, 256, 20)),               # an input 3 k-tiles deep
    (1, 9000, (26, 300)),                    # one layer: a pair, then N = 48
])
def test_fused_mlp_wgmma_kernel_widths(dev, g, r, dims):
    x, ws, bs = _mlp(dev, g, r, dims, seed=sum(dims), shared=True)
    out, wgmma = _launched(x, fused_mlp.pack_weights(ws, bs), 'swish')
    assert wgmma
    torch.testing.assert_close(
        out, fused_mlp.fused_mlp_plain(x, ws, bs, 'swish'), **MLP_TOL)


@pytest.mark.parametrize('shared', [False, True])
def test_fused_mlp_grbal_launch_keeps_the_16_row_kernel(dev, shared):
    """GrBAL's planner launch, 5 envs x 500 candidates on per-env adapted
    weights or on the shared set before adaptation, and a wide layer that
    does not fit the warpgroup-MMA block: the 16-row kernel."""
    x, ws, bs = _mlp(dev, 5, 500, (26, 512, 512, 512, 20), seed=5,
                     shared=shared)
    out, wgmma = _launched(x, fused_mlp.pack_weights(ws, bs))
    assert not wgmma
    torch.testing.assert_close(out, fused_mlp.fused_mlp_plain(x, ws, bs),
                               **MLP_TOL)
    x, ws, bs = _mlp(dev, 1, _threshold(dev), (26, 1024, 20), seed=6,
                     shared=True)
    out, wgmma = _launched(x, fused_mlp.pack_weights(ws, bs))
    assert not wgmma
    torch.testing.assert_close(out, fused_mlp.fused_mlp_plain(x, ws, bs),
                               **MLP_TOL)


def test_fused_mlp_wgmma_smem_bytes_match_the_source(dev):
    lib = fused_mlp._lib()
    for dims in [(26, 512, 512, 20), (49, 512, 512, 41), (7, 130, 300, 5),
                 (26, 512, 512, 200), (26, 640, 20), (26, 2048)]:
        c_dims = (ctypes.c_int * len(dims))(*dims)
        assert lib.fused_mlp_wgmma_smem_bytes(len(dims) - 1, c_dims) == \
            fused_mlp.wgmma_smem_bytes(dims)


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


#: one N or more in every launch tier of ops/jacobi.py TIERS, and its edges
JACOBI_NS = (7, 64, 76, 128, 200, jacobi.MAX_ROWS)


@pytest.mark.parametrize('n_envs', [1, 5, 512])
@pytest.mark.parametrize('n', JACOBI_NS)
def test_jacobi_kernel_matches_plain(dev, n_envs, n):
    args = _system(dev, n_envs, n, seed=n)
    before = jacobi.jacobi_solve.launches
    out = jacobi.jacobi_solve(*args, 60)
    torch.cuda.synchronize()
    assert jacobi.jacobi_solve.launches == before + 1
    torch.testing.assert_close(out, jacobi.jacobi_solve_plain(*args, 60),
                               **JACOBI_TOL)
    assert (out >= 0).all()


def _special_system(dev, case):
    """N = 76, 5 envs: omega = 1 on a strongly diagonal system; b >= 0, so
    f stays 0; or row and column 3 zero, as an inactive contact row
    leaves them (b = 0 and aii_inv from the clamped diagonal)."""
    a, b, aii_inv, omega = _system(dev, 5, 76, seed=3)
    if case == 'omega_one':
        gen = torch.Generator(device=dev).manual_seed(4)
        m = torch.randn((5, 76, 76), generator=gen, device=dev)
        a = m @ m.transpose(-1, -2) / 76 + 76 * torch.eye(76, device=dev)
        aii_inv = 1.0 / torch.diagonal(a, dim1=-2, dim2=-1)
        omega = torch.ones(5, device=dev)
    elif case == 'b_nonnegative':
        b = b.abs()
    else:
        a = a.clone()
        a[:, 3, :] = 0
        a[:, :, 3] = 0
        b = b.clone()
        b[:, 3] = 0
        aii_inv = 1.0 / torch.clamp(torch.diagonal(a, dim1=-2, dim2=-1),
                                    min=1e-12)
    return a, b, aii_inv, omega


def test_jacobi_kernel_on_ant_contact_systems(dev):
    """One RK4 physics step of 5 Ants after 30 random-action steps: four
    tier-kernel launches on 116-row contact systems, each held against the
    plain version on the same inputs."""
    from learning_to_adapt_torch import envs
    from learning_to_adapt_torch.physics import engine
    env = envs.normalize(envs.AntEnv(task='cripple', reset_every_episode=True,
                                     device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    state = env.reset(5, 1, gen)

    def random_step(state):
        act = 2 * torch.rand((5, 8), generator=gen, device=dev) - 1
        return env.step(state, act)[0]
    for _ in range(30):
        state = random_step(state)
    captured, solve = [], engine.jacobi_solve

    def capture(*args):
        out = solve(*args)
        captured.append((args, out))
        return out
    engine.jacobi_solve = capture
    try:
        before = jacobi.jacobi_solve.launches
        random_step(state)
        torch.cuda.synchronize()
    finally:
        engine.jacobi_solve = solve
    assert jacobi.jacobi_solve.launches == before + 4 == before + len(captured)
    for (A, b, aii_inv, omega, n_sweeps), out in captured:
        assert A.shape == (5, 116, 116) and n_sweeps == 60
        assert (b != 0).any()
        torch.testing.assert_close(
            out, jacobi.jacobi_solve_plain(A, b, aii_inv, omega, n_sweeps),
            **JACOBI_TOL)


@pytest.mark.parametrize('case', ['omega_one', 'b_nonnegative', 'zero_row'])
def test_jacobi_kernel_special_systems(dev, case):
    args = _special_system(dev, case)
    before = jacobi.jacobi_solve.launches
    out = jacobi.jacobi_solve(*args, 60)
    torch.cuda.synchronize()
    assert jacobi.jacobi_solve.launches == before + 1
    torch.testing.assert_close(out, jacobi.jacobi_solve_plain(*args, 60),
                               **JACOBI_TOL)
    assert (out >= 0).all()
    if case == 'b_nonnegative':
        assert (out == 0).all()
    if case == 'zero_row':
        assert (out[:, 3] == 0).all()


def _launches():
    return jacobi.jacobi_solve.launches, jacobi.jacobi_solve_cluster.launches


#: the cluster kernel's N on chip_smoke.py's path: just above the tiers,
#: the blocks env's system, and two powers of two
CLUSTER_NS = (225, 988, 1024, 2048)


@pytest.mark.parametrize('n_envs', [1, 5])
@pytest.mark.parametrize('n', CLUSTER_NS)
def test_jacobi_cluster_kernel_matches_plain(dev, n_envs, n):
    """Above 224 rows jacobi_solve launches the cluster kernel, once."""
    args = _system(dev, n_envs, n, seed=n + n_envs)
    before = _launches()
    out = jacobi.jacobi_solve(*args, 60)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1)
    torch.testing.assert_close(out, jacobi.jacobi_solve_plain(*args, 60),
                               **JACOBI_TOL)
    assert (out >= 0).all()


def test_jacobi_cluster_kernel_at_512_envs(dev):
    """The blocks system size at the saturated sampling width: clusters of
    16 blocks (the card holds one at once), more than the card holds at
    once."""
    args = _system(dev, 512, 988, seed=9)
    assert jacobi.cluster_size(988, dev) == 16
    out = jacobi.jacobi_solve(*args, 60)
    torch.testing.assert_close(out, jacobi.jacobi_solve_plain(*args, 60),
                               **JACOBI_TOL)


def _dead_system(dev, n_envs, n, n_live, seed, symmetric=True):
    """Random SPD systems with all but n_live rows an env (drawn at random)
    dead as the engine leaves an inactive contact: row and column zeroed
    (the row only, symmetric=False), diagonal 1, b = 0."""
    a, b, _, _ = _system(dev, n_envs, n, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    order = torch.argsort(torch.rand((n_envs, n), generator=gen, device=dev))
    dead = torch.zeros((n_envs, n), dtype=torch.bool, device=dev).scatter_(
        1, order[:, n_live:], True)
    a = a.masked_fill(dead[:, :, None], 0)
    if symmetric:
        a = a.masked_fill(dead[:, None, :], 0)
    a = a + torch.diag_embed(dead.float())
    b = b.masked_fill(dead, 0)
    aii_inv = 1.0 / torch.diagonal(a, dim1=-2, dim2=-1)
    rho = torch.amax(a.abs().sum(-1) * aii_inv, dim=-1)
    return a, b, aii_inv, torch.clamp(1.8 / rho, max=1.0)


@pytest.mark.parametrize('n_envs,n_live,symmetric', [
    (5, 99, True), (5, 10, True), (512, 99, True), (512, 10, True),
    (5, 224, True), (5, 225, True), (5, 300, True), (5, 0, True),
    (5, 10, False), (5, 300, False)])
def test_jacobi_cluster_kernel_skips_dead_rows(dev, n_envs, n_live,
                                               symmetric):
    """988 rows with 90 % and 99 % of them dead, 224 and 225 live (the two
    sides of the one-block path), a dense path over part of the rows, none
    live, and a non-symmetric A whose dead rows keep their columns: one
    launch, the plain result, dead rows exactly 0."""
    args = _dead_system(dev, n_envs, 988, n_live, seed=n_live + n_envs,
                        symmetric=symmetric)
    live = jacobi.live_rows(*args)
    assert (live.sum(-1) == n_live).all()
    before = _launches()
    out = jacobi.jacobi_solve(*args, 60)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1)
    torch.testing.assert_close(out, jacobi.jacobi_solve_plain(*args, 60),
                               **JACOBI_TOL)
    assert (out[~live] == 0).all() and (out >= 0).all()


def _fmax_sweeps(A, b, aii_inv, omega, n_sweeps):
    """The dense sweeps with the kernels' projection, fmaxf(x, 0), which
    gives 0 for a NaN x where the plain version's clamp keeps the NaN."""
    f = torch.zeros_like(b)
    for _ in range(n_sweeps):
        r = (A @ f[..., None])[..., 0] + b
        f = torch.fmax(f - omega[:, None] * r * aii_inv,
                       torch.zeros_like(f))
    return f


def test_jacobi_cluster_kernel_non_finite_env_is_all_live(dev):
    """A NaN in a dead row's column of one env: the dense sweeps see it (the
    row that holds it totals NaN, so its f is 0 every sweep), which the
    live rows alone would not. The kernel takes every row of that env as
    live and gives the dense sweeps' result; the other envs keep their
    rule and the plain result."""
    args = list(_dead_system(dev, 3, 988, 10, seed=5))
    live = jacobi.live_rows(*args)
    j = int((~live[1]).nonzero()[0, 0])
    k = int(live[1].nonzero()[0, 0])
    args[0] = args[0].clone()
    args[0][1, k, j] = float('nan')
    assert jacobi.live_rows(*args)[1].all()
    out = jacobi.jacobi_solve(*args, 60)
    ref = _fmax_sweeps(*args, 60)
    torch.testing.assert_close(out, ref, **JACOBI_TOL)
    assert out[1, k] == 0
    torch.testing.assert_close(out[[0, 2]], jacobi.jacobi_solve_plain(
        *[a[[0, 2]] for a in args], 60), **JACOBI_TOL)


def test_jacobi_cluster_kernel_on_blocks_contact_systems(dev):
    """One physics step of 5 blocks envs after 30 random-action steps: one
    cluster launch on 988-row contact systems, held against the plain
    version on the same inputs, dead rows exactly 0."""
    from learning_to_adapt_torch import envs
    from learning_to_adapt_torch.physics import engine
    env = envs.normalize(envs.HalfCheetahBlocksEnv(
        task='damping', reset_every_episode=True, device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    state = env.reset(5, 1, gen)

    def random_step(state):
        act = 2 * torch.rand((5, env.act_dim), generator=gen, device=dev) - 1
        return env.step(state, act)[0]
    for _ in range(30):
        state = random_step(state)
    captured, solve = [], engine.jacobi_solve

    def capture(*args):
        out = solve(*args)
        captured.append((args, out))
        return out
    engine.jacobi_solve = capture
    try:
        before = _launches()
        random_step(state)
        torch.cuda.synchronize()
    finally:
        engine.jacobi_solve = solve
    assert _launches() == (before[0], before[1] + 1) and len(captured) == 1
    (A, b, aii_inv, omega, n_sweeps), out = captured[0]
    assert A.shape == (5, 988, 988) and n_sweeps == 60
    live = jacobi.live_rows(A, b, aii_inv, omega)
    assert (live.sum(-1) <= jacobi.SMALL_MAX).all() and live.any()
    torch.testing.assert_close(
        out, jacobi.jacobi_solve_plain(A, b, aii_inv, omega, n_sweeps),
        **JACOBI_TOL)
    assert (out[~live] == 0).all()


@pytest.mark.parametrize('case', ['omega_one', 'b_nonnegative', 'zero_row'])
def test_jacobi_cluster_kernel_special_systems(dev, case):
    """The special systems above through the cluster kernel (at N = 76, any
    N being its to take), and an N that is not a multiple of 4 (scalar
    loads of A)."""
    args = _special_system(dev, case)
    out = jacobi.jacobi_solve_cluster(*args, 60)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, jacobi.jacobi_solve_plain(*args, 60),
                               **JACOBI_TOL)
    if case == 'b_nonnegative':
        assert (out == 0).all()
    if case == 'zero_row':
        assert (out[:, 3] == 0).all()
    odd = _system(dev, 3, 301, seed=1)
    torch.testing.assert_close(jacobi.jacobi_solve_cluster(*odd, 60),
                               jacobi.jacobi_solve_plain(*odd, 60),
                               **JACOBI_TOL)


def test_jacobi_cluster_shapes_launch_on_this_card(dev):
    """Clusters of 16 and of 8 blocks of the plan fit the card (a cluster of
    16 is non-portable), at the blocks env's N and the largest."""
    for n in (988, jacobi.MAX_CLUSTER_ROWS):
        for cluster in (16, 8):
            assert jacobi.cluster_occupancy(n, cluster, dev) > 0


def test_jacobi_kernel_refuses_n_above_largest_tier(dev):
    """Above the largest N the cluster kernel takes: ValueError, nothing
    launched (A a broadcast view: only shapes are read)."""
    n = jacobi.MAX_CLUSTER_ROWS + 1
    a = torch.ones((1, 1, 1), device=dev).expand(2, n, n)
    b = torch.zeros((2, n), device=dev)
    before = _launches()
    with pytest.raises(ValueError, match='largest the cluster kernel'):
        jacobi.jacobi_solve(a, b, b + 1, torch.ones(2, device=dev), 60)
    assert _launches() == before


def test_jacobi_kernel_refuses_float64(dev):
    args = [a.double() for a in _system(dev, 2, 8, seed=0)]
    with pytest.raises(TypeError):
        jacobi.jacobi_solve(*args, 10)


# ------------------------------------------------------------ clip + Adam
# ClipAdam's defaults: learning rate, max_norm, b1, b2, eps
HYPER = (1e-3, 100.0, 0.9, 0.999, 1e-8)


def _mlp_leaves(dims, members=()):
    """An MLP's leaf shapes in JAX's order: the biases, then the weights."""
    m = tuple(members)
    return ([m + (n,) for n in dims[1:]] +
            [m + (k, n) for k, n in zip(dims[:-1], dims[1:])])


#: leaf shapes (JAX's order) of the models the fits step
LEAF_SETS = {
    'mb_mpc': _mlp_leaves((26, 512, 512, 20)),
    'grbal': _mlp_leaves((26, 512, 512, 512, 20)),
    'ensemble': _mlp_leaves((26, 512, 512, 20), (3,)),
    # ReBAL's LSTM (256,) as its fit holds it: [b, wh.T, wi.T], then the
    # output layer's b and w
    'lstm': [(1024,), (1024, 256), (1024, 26), (20,), (256, 20)],
    # slices of one buffer: three leaves off 16-byte alignment, tails of 1-3
    'ragged': [(1,), (3,), (5,), (65537,)],
}


def _leaves(dev, shapes, gen, scale, ragged):
    if not ragged:
        return [torch.randn(s, generator=gen, device=dev) * scale
                for s in shapes]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=dev) * scale
    return [x.view(s) for x, s in zip(flat.split(sizes), shapes)]


def _adam_state(dev, name, count, seed=0):
    """params, mu, nu (nu >= 0) and a count for LEAF_SETS[name], and
    grads(scale): gradients of global norm ~ scale."""
    shapes = LEAF_SETS[name]
    ragged = name == 'ragged'
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _leaves(dev, shapes, gen, 0.1, ragged)
    mu = _leaves(dev, shapes, gen, 1e-3, ragged)
    nu = [x.abs() for x in _leaves(dev, shapes, gen, 1e-6, ragged)]
    if ragged:       # abs() made new storage: slices of one buffer again
        flat = torch.cat([x.flatten() for x in nu])
        nu = [x.view(s) for x, s in zip(
            flat.split([x.numel() for x in nu]), shapes)]
    n = sum(int(np.prod(s)) for s in shapes)

    def grads(norm):
        return _leaves(dev, shapes, gen, norm / n ** 0.5, ragged)
    return (params, mu, nu, torch.tensor(count, dtype=torch.int32,
                                         device=dev)), grads


def _copy(state):
    params, mu, nu, count = state
    return ([x.clone() for x in params], [x.clone() for x in mu],
            [x.clone() for x in nu], count.clone())


def _kernel_step(state, g):
    params, mu, nu, count = state
    before = clip_adam.clip_adam_.launches
    norm = clip_adam.clip_adam_(params, g, count, mu, nu, *HYPER)
    assert clip_adam.clip_adam_.launches == before + \
        clip_adam.LAUNCHES_PER_STEP
    return norm


def _plain_step(state, g):
    params, mu, nu, count = state
    return clip_adam.clip_adam_plain(params, [x.clone() for x in g], count,
                                     mu, nu, *HYPER)


def _ulps(a, b):
    """Largest |a - b| in units of b's last place."""
    b = b.abs()
    ulp = torch.nextafter(b, torch.full_like(b, float('inf'))) - b
    return float(((a.abs() - b).abs() / ulp).max())


def _assert_equal(got, want):
    for xs, ys in zip(got, want):
        if torch.is_tensor(xs):
            assert torch.equal(xs, ys)
        else:
            for x, y in zip(xs, ys):
                assert torch.equal(x, y)


@pytest.mark.parametrize('count', [0, 999, 99999])
@pytest.mark.parametrize('name', list(LEAF_SETS))
def test_clip_adam_kernel_matches_plain_unclipped(dev, name, count):
    """Four steps of the kernel and of the plain chain from one state, the
    global norm under max_norm: params, mu, nu and count bit for bit; the
    two norms within 2 ulp."""
    state, grads = _adam_state(dev, name, count)
    plain = _copy(state)
    for _ in range(4):
        g = grads(50.0)
        norm = _kernel_step(state, g)
        want = _plain_step(plain, g)
        torch.cuda.synchronize()
        assert float(norm) < 100.0 and _ulps(norm, want) <= 2
        _assert_equal(state, plain)
    assert int(state[3]) == count + 4


@pytest.mark.parametrize('name', list(LEAF_SETS))
def test_clip_adam_kernel_clipped(dev, name, monkeypatch):
    """Two steps with the global norm over max_norm: the same decision to
    clip; the kernel's norm within 2 ulp of the plain chain's and within 1
    of the f64 norm of the same f32 squares; and the plain chain given the
    kernel's norm equal to the kernel bit for bit, so that only the norm's
    summation order parts the two steps. (Elementwise, the steps then part
    by as many ulps as the norm's gap gives: a moment that cancels to near
    0 keeps the gap at the scale of its terms, and nu holds g^2.)"""
    state, grads = _adam_state(dev, name, 0)
    plain = _copy(state)
    for step in range(2):
        g = grads(400.0)
        given = _copy(state)
        norm = _kernel_step(state, g)
        want = _plain_step(plain, g)
        with monkeypatch.context() as m:   # the chain on the kernel's norm
            m.setattr(torch.linalg, 'vector_norm', lambda x: norm.clone())
            _plain_step(given, g)
        exact = torch.stack([(x * x).double().sum() for x in g]).sum().sqrt()
        torch.cuda.synchronize()
        assert float(norm) >= 100.0 and float(want) >= 100.0
        gap = _ulps(norm, want)
        assert gap <= 2 and _ulps(norm, exact.float()) <= 1
        _assert_equal(state, given)
        worst = {k: max(_ulps(a, b) for a, b in zip(state[i], plain[i]))
                 for i, k in enumerate(('params', 'mu', 'nu'))}
        print(f'clip_adam {name} clipped step {step}: norm {float(norm)!r}, '
              f'plain {float(want)!r} ({gap:g} ulp), f64 {float(exact)!r}; '
              f'elementwise ulps from the plain step {worst}')
        plain = _copy(state)


def test_clip_adam_kernel_repeats_itself(dev):
    """Two runs from one state give the same bits, clipped or not."""
    runs = []
    for _ in range(2):
        state, grads = _adam_state(dev, 'grbal', 7, seed=3)
        norms = [_kernel_step(state, grads(norm)) for norm in (50.0, 400.0)]
        torch.cuda.synchronize()
        runs.append((state, norms))
    _assert_equal(runs[0][0], runs[1][0])
    _assert_equal(runs[0][1], runs[1][1])


def test_clip_adam_kernel_in_a_cuda_graph(dev):
    """A step captured once (models/captured.py StepGraph) and replayed
    with new gradients copied in between equals the eager steps bit for
    bit; the counter counts the step's launches at each replay."""
    from learning_to_adapt_torch.models import captured
    from learning_to_adapt_torch.models.optim import ClipAdam
    state, grads = _adam_state(dev, 'mb_mpc', 0)
    start, eager = _copy(state), _copy(state)
    g_static = [torch.zeros_like(x) for x in state[0]]
    adam = ClipAdam(*HYPER)
    params, mu, nu, count = state

    def reset():
        for dst, src in zip(state, start):
            if torch.is_tensor(dst):
                dst.copy_(src)
            else:
                for d, s in zip(dst, src):
                    d.copy_(s)
    graph = captured.StepGraph(
        lambda: adam.step_(params, g_static, count, mu, nu), dev)
    graph.capture(reset)
    assert graph.kernels == dict(
        {k: 0 for k in captured.kernel_counts()},
        clip_adam=clip_adam.LAUNCHES_PER_STEP)
    before = captured.kernel_counts()['clip_adam']
    for norm in (50.0, 400.0, 50.0):
        g = grads(norm)
        for d, s in zip(g_static, g):
            d.copy_(s)
        graph()
        _kernel_step(eager, g)
    torch.cuda.synchronize()
    _assert_equal(state, eager)
    assert captured.kernel_counts()['clip_adam'] == before + \
        3 * clip_adam.LAUNCHES_PER_STEP + 3 * clip_adam.LAUNCHES_PER_STEP


@pytest.mark.parametrize('case', ['float64', 'transposed', 'device'])
def test_clip_adam_kernel_refuses(dev, case):
    """On the card: a float64 leaf, a transposed one, a count on the CPU:
    an error, nothing launched."""
    state, grads = _adam_state(dev, 'mb_mpc', 0)
    params, mu, nu, count = state
    g = grads(50.0)
    if case == 'float64':
        g[0] = g[0].double()
    elif case == 'transposed':
        params[3] = params[3].T.contiguous().T
    else:
        count = count.cpu()
    before = clip_adam.clip_adam_.launches
    with pytest.raises((TypeError, ValueError), match='clip_adam'):
        clip_adam.clip_adam_cuda(params, g, count, mu, nu, *HYPER)
    assert clip_adam.clip_adam_.launches == before
