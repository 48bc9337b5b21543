"""The live-row rule of the cluster Jacobi kernel (csrc/jacobi.cu
jacobi_cluster_kernel), on the plain path: a row with b = 0 and a zero row
of A off the diagonal stays exactly 0 from f = 0 and adds exactly 0 to every
other row, so the sweeps over the live rows alone give the dense solve.
Held on the blocks env's real contact systems (the port's CPU engine, 5
envs after 30 seeded random-action steps, f64 and f32) against the dense
plain solve and the JAX package's jacobi_solve_xla and Pallas kernel, on
synthetic systems for each side of the rule, and with the cluster kernel's
shared-memory plan (ops/jacobi.py cluster_shape)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import capture_solves, t
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.ops import build
from learning_to_adapt_torch.ops import jacobi as port_jacobi
from learning_to_adapt_tpu.ops import pallas_jacobi

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

N_ENVS, WARM_STEPS, SWEEPS = 5, 30, 60
DTYPES = {'f64': (torch.float64, True), 'f32': (torch.float32, False)}
# the restricted solve against the dense one and the JAX solves: the same
# sweeps over fewer (exactly zero) terms, summed in another order
TOL = {'f64': dict(rtol=1e-12, atol=1e-14), 'f32': dict(rtol=1e-4, atol=1e-5)}


@pytest.fixture(scope='module')
def blocks_systems():
    """{precision: (A, b, aii_inv, omega, n_sweeps)} of the 31st physics step
    of 5 HalfCheetahBlocksEnv envs (task damping, drawn in episode 1) under
    seeded random actions."""
    out = {}
    for name, (dtype, _) in DTYPES.items():
        env = port_envs.HalfCheetahBlocksEnv(
            task='damping', reset_every_episode=True, device='cpu',
            dtype=dtype)
        gen = torch.Generator().manual_seed(1)
        state = env.reset(N_ENVS, 1, gen)
        rng = np.random.RandomState(0)
        acts = rng.uniform(-1, 1, (WARM_STEPS + 1, N_ENVS, env.act_dim))
        for a in acts[:-1]:
            state = env.step(state, t(a, dtype))[0]
        _, solves = capture_solves(lambda: env.step(state, t(acts[-1],
                                                               dtype)))
        assert len(solves) == 1
        out[name] = solves[0]
    return out


def _restricted(A, b, aii_inv, omega, n_sweeps):
    """The plain sweeps over each env's live rows alone, zero elsewhere."""
    live = port_jacobi.live_rows(A, b, aii_inv, omega)
    f = torch.zeros_like(b)
    for e in range(b.shape[0]):
        idx = live[e].nonzero()[:, 0]
        sub = A[e][idx][:, idx]
        f[e, idx] = port_jacobi.jacobi_solve_plain(
            sub[None], b[e, idx][None], aii_inv[e, idx][None],
            omega[e:e + 1], n_sweeps)[0]
    return f, live


@pytest.mark.parametrize('precision', list(DTYPES))
def test_blocks_dead_rows_stay_zero_in_the_dense_solve(blocks_systems,
                                                       precision):
    """A few live rows an env (the inactive contacts' rows are dead), and
    the dense plain solve leaves every dead row exactly 0."""
    A, b, aii_inv, omega, n_sweeps = blocks_systems[precision]
    assert A.shape == (N_ENVS, 988, 988) and n_sweeps == SWEEPS
    live = port_jacobi.live_rows(A, b, aii_inv, omega)
    counts = live.sum(-1)
    assert (counts > 0).all() and (counts <= 32).all(), counts
    f = port_jacobi.jacobi_solve_plain(A, b, aii_inv, omega, n_sweeps)
    assert (f[~live] == 0).all()
    assert (f[live] > 0).any()
    # the rule: a dead row has b = 0 and nothing off the diagonal
    assert (b[~live] == 0).all()
    off = A - torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1))
    assert (off.abs().sum(-1)[~live] == 0).all()


@pytest.mark.parametrize('precision', list(DTYPES))
def test_blocks_live_solve_matches_dense(blocks_systems, precision):
    A, b, aii_inv, omega, n_sweeps = blocks_systems[precision]
    got, live = _restricted(A, b, aii_inv, omega, n_sweeps)
    want = port_jacobi.jacobi_solve_plain(A, b, aii_inv, omega, n_sweeps)
    torch.testing.assert_close(got[live], want[live], **TOL[precision])
    assert (got[~live] == 0).all()


@pytest.mark.parametrize('precision', list(DTYPES))
def test_blocks_live_solve_matches_xla(blocks_systems, precision):
    """The restricted solve against JAX jacobi_solve_xla, env by env, on
    the whole 988-row systems."""
    A, b, aii_inv, omega, n_sweeps = blocks_systems[precision]
    got, _ = _restricted(A, b, aii_inv, omega, n_sweeps)
    with jax.enable_x64(DTYPES[precision][1]):
        for e in range(N_ENVS):
            want = pallas_jacobi.jacobi_solve_xla(
                jnp.asarray(A[e].numpy()), jnp.asarray(b[e].numpy()),
                jnp.asarray(aii_inv[e].numpy()),
                jnp.asarray(omega[e].numpy()), n_sweeps)
            np.testing.assert_allclose(got[e].numpy(), np.asarray(want),
                                       **TOL[precision])


def test_blocks_live_solve_matches_pallas_interpret(blocks_systems):
    """The restricted solve of env 0 (f32) against the Pallas kernel in
    interpret mode (padded to 1024 rows)."""
    A, b, aii_inv, omega, n_sweeps = blocks_systems['f32']
    got, _ = _restricted(A, b, aii_inv, omega, n_sweeps)
    want = pallas_jacobi.jacobi_solve(
        jnp.asarray(A[0].numpy()), jnp.asarray(b[0].numpy()),
        jnp.asarray(aii_inv[0].numpy()), float(omega[0]), n_sweeps,
        interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                               **TOL['f32'])


def _synthetic(n=12, seed=0):
    """A and b of one env of a random SPD system."""
    rng = np.random.RandomState(seed)
    m = rng.randn(n, n)
    return (m @ m.T + n * np.eye(n))[None], rng.randn(n)[None]


def _omega(a, aii_inv):
    rho = (np.abs(a).sum(-1) * aii_inv).max(-1)
    return np.minimum(1.8 / rho, 1.0)


def _kill(a, b, j, column=True):
    """Row j as an inactive contact leaves it: b_j = 0, nothing off the
    diagonal in row j (and in column j unless column=False), A_jj = 1."""
    a, b = a.copy(), b.copy()
    a[:, j, :] = 0
    if column:
        a[:, :, j] = 0
    a[:, j, j] = 1
    b[:, j] = 0
    return a, b


@pytest.mark.parametrize('case', ['b_nonzero', 'off_diagonal', 'column',
                                  'none_live', 'nan'])
def test_live_rule(case):
    """b != 0 with a zero row off the diagonal: live; b = 0 with one
    off-diagonal entry: live; a non-symmetric A whose dead row has a
    non-zero column: dead, and the restricted solve is the dense one; every
    row dead: zeros; a NaN anywhere in an env: every row of it live (the
    other env keeps its rule)."""
    a, b = _synthetic()
    j = 3
    if case == 'b_nonzero':
        a, _ = _kill(a, b, j)
        want_live = np.ones(12, bool)
    elif case == 'off_diagonal':
        a, b = _kill(a, b, j)
        a[0, j, 7] = 0.5
        want_live = np.ones(12, bool)
    elif case == 'column':
        a, b = _kill(a, b, j, column=False)
        assert (a[0, :, j] != 0).sum() > 1
        want_live = np.arange(12) != j
    elif case == 'none_live':
        for k in range(12):
            a, b = _kill(a, b, k)
        want_live = np.zeros(12, bool)
    else:
        a, b = _kill(a, b, j)
        a2, b2 = a.copy(), b.copy()
        a2[0, 5, 9] = np.nan
        a, b = np.concatenate([a, a2]), np.concatenate([b, b2])
        want_live = np.stack([np.arange(12) != j, np.ones(12, bool)])
    aii_inv = 1.0 / np.diagonal(a, axis1=1, axis2=2)
    omega = _omega(np.nan_to_num(a), aii_inv)
    args = tuple(t(x, torch.float64) for x in (a, b, aii_inv, omega))
    live = port_jacobi.live_rows(*args)
    np.testing.assert_array_equal(live.numpy(),
                                  np.broadcast_to(want_live, live.shape))
    dense = port_jacobi.jacobi_solve_plain(*args, SWEEPS)
    got, _ = _restricted(*args, SWEEPS)
    if case == 'nan':
        assert torch.isnan(dense[1]).any()
    if case == 'none_live':
        assert (dense == 0).all() and (got == 0).all()
    torch.testing.assert_close(got, dense, equal_nan=True, **TOL['f64'])
    assert (dense[0][~live[0]] == 0).all()


CLUSTER_NS = (225, 988, 1024, 2048, port_jacobi.MAX_CLUSTER_ROWS)


@pytest.mark.parametrize('cluster', [16, 8])
@pytest.mark.parametrize('n', CLUSTER_NS)
def test_cluster_plan(n, cluster):
    """The cluster kernel's plan fits a block's shared memory; the rows a
    block scans are held on chip (in shared memory, or in registers, one a
    warp, up to 1024 columns) or streamed; the one-block path takes 224
    live rows while its A[L, L] fits beside the fixed arrays."""
    plan = port_jacobi.cluster_shape(n, cluster)
    assert plan.cluster == cluster and plan.threads == 512
    assert plan.rows == -(-n // cluster)
    assert plan.held + plan.in_registers + plan.streamed == plan.rows
    assert plan.held >= 0 and plan.streamed >= 0
    assert 0 <= plan.in_registers <= 16
    assert plan.in_registers == 0 or n <= port_jacobi.REGISTER_COLS
    if n <= port_jacobi.REGISTER_COLS and cluster == 16:
        assert plan.streamed == 0
    assert plan.smem <= build.SMEM_LIMIT
    n4, r4 = -(-n // 4) * 4, -(-plan.rows // 4) * 4
    fixed = 32 + 4 * n4 + 16 * r4
    assert plan.smem == fixed + max(
        4 * (2 + plan.held) * n4,
        4 * (plan.small * (plan.small + 1) + 4 * plan.small))
    # one more held row, or one more live row in one block, would not fit
    assert (plan.held == plan.rows or
            fixed + 4 * (3 + plan.held) * n4 > build.SMEM_LIMIT)
    s = plan.small + 1
    assert (plan.small == port_jacobi.SMALL_MAX or
            fixed + 4 * (s * (s + 1) + 4 * s) > build.SMEM_LIMIT)
    if n <= 2048:
        assert plan.small == port_jacobi.SMALL_MAX
