"""Parity of the port's physics (learning_to_adapt_torch.physics, ops.jacobi)
with the JAX package: the compiled models of the five envs, batched
engine.step and engine.forward at float64 and float32 (on HalfCheetah
here; the terrain, blocks and arm models in tests/test_torch_envs_euler.py,
the Ant in tests/test_torch_ant.py), the plane-capsule collider (every
collider in tests/test_torch_collision.py) and the projected-Jacobi solve's
plain version, its launch tiers and its cluster path above 224 rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    F32_STEP_TOL, F64_STEP_TOL, assert_models_equal, capture_solves,
    contact_states, t)
from learning_to_adapt_torch.envs.model_defs import get_model as port_model
from learning_to_adapt_torch.ops import jacobi as port_jacobi
from learning_to_adapt_torch.physics import collision as port_coll
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_tpu.envs.model_defs import get_model as jax_model
from learning_to_adapt_tpu.ops import pallas_jacobi
from learning_to_adapt_tpu.physics import collision as jax_coll
from learning_to_adapt_tpu.physics import engine as jax_engine
from learning_to_adapt_tpu.physics import spec as jax_spec

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

N_ENVS = 3
N_STEPS = 50
# dtype -> (numpy dtype, torch dtype, jax x64 flag, per-step tol, 50-step tol)
DTYPES = {
    'f64': (np.float64, torch.float64, True, F64_STEP_TOL,
            dict(rtol=1e-9, atol=1e-9)),
    # f32 over 50 contact-rich steps: op-order differences grow to ~1e-4 on
    # joint speeds of ~5 rad/s
    'f32': (np.float32, torch.float32, False, F32_STEP_TOL,
            dict(rtol=1e-3, atol=2e-3)),
}


#: the models of the five envs
MODELS = ('half_cheetah', 'half_cheetah_hfield', 'half_cheetah_blocks',
          'ant', 'arm_7dof')


def test_compiled_model_fields_match():
    """Every PhysicsModel field of get_model(name) for each of MODELS
    (box masses and inertias, the hfield size, the block slide joints, the
    Ant's free root and RK4, the arm's geoms), including the compile-time
    invweights computed by each package's own engine."""
    for name in MODELS:
        assert_models_equal(port_model(name), jax_model(name), name)


def _jax_traj(jm, dt, x64, qpos, qvel, ctrls):
    with jax.enable_x64(x64):
        mm = jax.tree.map(jnp.asarray, jax_spec.default_mutable(jm, dt))
        step = jax.jit(jax.vmap(lambda q, v, c: jax_engine.step(
            jm, mm, jax_engine.PhysicsState(q, v), c)))
        fwd = jax.jit(jax.vmap(lambda q, v, c: jax_engine.forward(
            jm, mm, jax_engine.PhysicsState(q, v), c)))
        q, v = jnp.asarray(qpos, dt), jnp.asarray(qvel, dt)
        states, datas = [(np.asarray(q), np.asarray(v))], []
        for c in ctrls:
            datas.append(jax.tree.map(np.asarray, fwd(q, v, jnp.asarray(c,
                                                                        dt))))
            s = step(q, v, jnp.asarray(c, dt))
            q, v = s.qpos, s.qvel
            states.append((np.asarray(q), np.asarray(v)))
    return states, datas


@pytest.mark.parametrize('precision', ['f64', 'f32'])
def test_step_and_forward_match_jax(precision):
    """engine.step per step (from JAX's own state) and over 50 free-running
    steps, and engine.forward at every state, for 3 batched envs."""
    dt, tdt, x64, step_tol, traj_tol = DTYPES[precision]
    pm, jm = port_model('half_cheetah'), jax_model('half_cheetah')
    qpos, qvel = contact_states(jm, N_ENVS, seed=0)
    ctrls = np.random.RandomState(1).uniform(-1, 1, (N_STEPS, N_ENVS, jm.nu))
    states, datas = _jax_traj(jm, dt, x64, qpos, qvel, ctrls)

    mm = port_spec.batched_mutable(port_spec.default_mutable(pm, dt), N_ENVS,
                                   'cpu', tdt)
    free = port_engine.PhysicsState(t(states[0][0], tdt),
                                    t(states[0][1], tdt))
    for i, c in enumerate(ctrls):
        ctrl = t(c, tdt)
        st = port_engine.PhysicsState(t(states[i][0], tdt),
                                      t(states[i][1], tdt))
        data = port_engine.forward(pm, mm, st, ctrl)
        for f in ('xpos', 'xquat', 'subtree_com', 'subtree_comvel',
                  'qfrc_actuator'):
            np.testing.assert_allclose(getattr(data, f).numpy(),
                                       getattr(datas[i], f), **step_tol,
                                       err_msg=f'forward {f} at step {i}')
        one = port_engine.step(pm, mm, st, ctrl)
        np.testing.assert_allclose(one.qpos.numpy(), states[i + 1][0],
                                   **step_tol, err_msg=f'qpos step {i}')
        np.testing.assert_allclose(one.qvel.numpy(), states[i + 1][1],
                                   **step_tol, err_msg=f'qvel step {i}')
        free = port_engine.step(pm, mm, free, ctrl)
    np.testing.assert_allclose(free.qpos.numpy(), states[-1][0], **traj_tol)
    np.testing.assert_allclose(free.qvel.numpy(), states[-1][1], **traj_tol)


def test_states_exercise_contacts_and_limits():
    """The parity states above do reach the constraint solver with active
    contact rows, so the Jacobi path is under test."""
    pm = port_model('half_cheetah')
    qpos, qvel = contact_states(pm, N_ENVS, seed=0)
    mm = port_spec.batched_mutable(port_spec.default_mutable(pm), N_ENVS,
                                   'cpu', torch.float32)
    st = port_engine.PhysicsState(t(qpos), t(qvel))
    _, captured = capture_solves(lambda: port_engine.step(
        pm, mm, st, torch.zeros((N_ENVS, pm.nu))))
    (A, b, _, _, n_sweeps), = captured
    assert A.shape == (N_ENVS, 76, 76) and n_sweeps == 60
    assert int((b[:, 12:] != 0).sum()) > 0   # contact rows after 12 limits


def test_plane_capsule_matches_jax():
    rng = np.random.RandomState(3)
    plane_pos = np.zeros(3)
    plane_mat = np.eye(3)
    cap_pos = rng.randn(4, 3)
    q = rng.randn(4, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    from learning_to_adapt_tpu.physics import maths as jax_maths
    cap_mat = np.asarray(jax_maths.quat_to_mat(jnp.asarray(q, jnp.float32)))
    r, hl = rng.uniform(.02, .1, 4), rng.uniform(.05, .2, 4)
    want = jax.vmap(jax_coll.plane_capsule, (None, None, 0, 0, 0, 0))(
        jnp.asarray(plane_pos, jnp.float32), jnp.asarray(plane_mat,
                                                         jnp.float32),
        jnp.asarray(cap_pos, jnp.float32), jnp.asarray(cap_mat),
        jnp.asarray(r, jnp.float32), jnp.asarray(hl, jnp.float32))
    got = port_coll.plane_capsule(t(plane_pos), t(plane_mat), t(cap_pos),
                                  t(cap_mat), t(r), t(hl))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _random_system(n, n_envs, seed, dtype):
    """Diagonally heavy PSD systems, as tests/test_ops.py builds one."""
    rng = np.random.RandomState(seed)
    m = rng.randn(n_envs, n, n)
    a = m @ np.swapaxes(m, 1, 2) + np.eye(n) * n
    b = rng.randn(n_envs, n)
    aii_inv = 1.0 / np.diagonal(a, axis1=1, axis2=2)
    rho = np.max(np.sum(np.abs(a), axis=2) * aii_inv, axis=1)
    omega = np.minimum(1.0, 1.8 / rho)
    return tuple(x.astype(dtype) for x in (a, b, aii_inv, omega))


@pytest.mark.parametrize('precision', ['f64', 'f32'])
def test_jacobi_plain_matches_xla_loop(precision):
    dt, tdt, x64, _, _ = DTYPES[precision]
    a, b, aii_inv, omega = _random_system(76, 2, 0, dt)
    got = port_jacobi.jacobi_solve(t(a, tdt), t(b, tdt), t(aii_inv, tdt),
                                   t(omega, tdt), 60)
    with jax.enable_x64(x64):
        for e in range(2):
            want = pallas_jacobi.jacobi_solve_xla(
                jnp.asarray(a[e]), jnp.asarray(b[e]), jnp.asarray(aii_inv[e]),
                jnp.asarray(omega[e]), 60)
            tol = (dict(rtol=1e-12, atol=1e-14) if precision == 'f64'
                   else dict(rtol=1e-5, atol=1e-6))
            np.testing.assert_allclose(got[e].numpy(), np.asarray(want),
                                       **tol)
    assert (got >= 0).all()


def test_jacobi_plain_matches_pallas_interpret():
    """Against the Pallas kernel itself, run in interpret mode as
    tests/test_ops.py runs it (float32, zero-padded to 128 rows)."""
    a, b, aii_inv, omega = _random_system(76, 1, 0, np.float32)
    want = pallas_jacobi.jacobi_solve(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(aii_inv[0]),
        float(omega[0]), 60, interpret=True)
    got = port_jacobi.jacobi_solve(t(a), t(b), t(aii_inv), t(omega), 60)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_jacobi_wrapper_uses_plain_version_on_cpu_only():
    a, b, aii_inv, omega = (t(x) for x in _random_system(8, 2, 1,
                                                         np.float32))
    before = port_jacobi.jacobi_solve.launches
    got = port_jacobi.jacobi_solve(a, b, aii_inv, omega, 10)
    want = port_jacobi.jacobi_solve_plain(a, b, aii_inv, omega, 10)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert port_jacobi.jacobi_solve.launches == before


def test_jacobi_kernel_entry_raises_without_toolkit():
    """The kernel entry has no fallback: without nvcc it raises rather than
    computing, and it refuses float64 before anything is built."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: tests/test_torch_kernels.py applies')
    a, b, aii_inv, omega = (t(x) for x in _random_system(8, 2, 1,
                                                         np.float32))
    with pytest.raises(TypeError, match='float32'):
        port_jacobi.jacobi_solve_cuda(a.double(), b, aii_inv, omega, 10)
    with pytest.raises(RuntimeError, match='nvcc|cudaError'):
        port_jacobi.jacobi_solve_cuda(a, b, aii_inv, omega, 10)


def _launches():
    return (port_jacobi.jacobi_solve.launches,
            port_jacobi.jacobi_solve_cluster.launches)


def test_jacobi_kernel_entry_refuses_n_above_largest_tier_before_build():
    """An N above the largest the cluster kernel takes (its f buffers would
    overflow shared memory) raises ValueError before either kernel is built
    or launched, with or without a toolkit. A is a broadcast view: the
    check reads shapes only."""
    n = port_jacobi.MAX_CLUSTER_ROWS + 1
    a = torch.ones((1, 1, 1)).expand(1, n, n)
    b, aii_inv, omega = torch.zeros((1, n)), torch.ones((1, n)), \
        torch.ones(1)
    before = _launches()
    for entry in (port_jacobi.jacobi_solve_cuda,
                  port_jacobi.jacobi_solve_cluster):
        with pytest.raises(ValueError, match='largest the cluster kernel'):
            entry(a, b, aii_inv, omega, 10)
    with pytest.raises(ValueError, match='largest the cluster kernel'):
        port_jacobi.route(n)
    assert _launches() == before


@pytest.mark.parametrize('n', [225, 988, port_jacobi.MAX_CLUSTER_ROWS])
def test_jacobi_large_n_selects_the_cluster_kernel(n, monkeypatch):
    """Above the largest launch tier (224 rows) the kernel entry hands the
    system to the cluster kernel, the only kernel it launches there; the
    tiers take every N up to 224."""
    assert port_jacobi.route(n) == 'cluster'
    assert port_jacobi.route(port_jacobi.MAX_ROWS) == 'tiers'
    a = torch.ones((1, 1, 1)).expand(2, n, n)
    b, aii_inv, omega = torch.zeros((2, n)), torch.ones((2, n)), \
        torch.ones(2)
    taken = []
    monkeypatch.setattr(port_jacobi, 'jacobi_solve_cluster',
                        lambda *args: taken.append(args[0].shape))
    port_jacobi.jacobi_solve_cuda(a, b, aii_inv, omega, 10)
    assert taken == [(2, n, n)]
    with pytest.raises(ValueError, match='largest launch tier'):
        port_jacobi.launch_shape(n)


def test_jacobi_kernel_entry_launches_nothing_for_an_empty_batch():
    """No envs: the entry returns an empty result without building or
    launching the kernel."""
    a, b, aii_inv, omega = (t(x) for x in _random_system(8, 2, 1,
                                                         np.float32))
    before = port_jacobi.jacobi_solve.launches
    out = port_jacobi.jacobi_solve_cuda(a[:0], b[:0], aii_inv[:0],
                                        omega[:0], 10)
    assert out.shape == (0, 8)
    assert port_jacobi.jacobi_solve.launches == before


@pytest.mark.parametrize('n,shape', [
    (1, (4, 8, 1, 32)), (7, (4, 8, 1, 32)), (32, (4, 8, 1, 128)),
    (33, (4, 16, 2, 96)), (64, (4, 16, 2, 128)), (76, (4, 20, 4, 96)),
    (80, (4, 20, 4, 96)), (81, (4, 32, 2, 192)), (128, (4, 32, 2, 256)),
    (129, (4, 56, 2, 288)), (200, (4, 56, 2, 416)), (224, (4, 56, 2, 448)),
    (225, (16, 512, 15, 15, 0, 0, 224, 206384)),
    (988, (16, 512, 62, 55, 7, 0, 224, 230272)),
])
def test_jacobi_launch_tier(n, shape):
    """N -> (threads per row, columns per thread, rows per thread, threads
    per block) up to 224 rows; above, the cluster kernel's plan in clusters
    of 16 (blocks per cluster, threads per block, rows of A a block scans,
    of them held in shared memory, in registers and streamed, the most live
    rows one block solves, bytes of shared memory: the one-block path's
    A[L, L] of 224 x 225 floats at 225 rows; at 988, 55 rows of 988 floats
    in shared memory and 7 in registers)."""
    if n <= port_jacobi.MAX_ROWS:
        assert port_jacobi.launch_shape(n) == shape
    else:
        assert port_jacobi.cluster_shape(n) == shape


@pytest.mark.parametrize('n,active16,cluster', [
    (225, 7, 16), (988, 8, 16), (988, 1, 16), (988, 0, 8), (2048, 0, 8),
    (port_jacobi.MAX_CLUSTER_ROWS, 7, 16)])
def test_jacobi_cluster_size(n, active16, cluster, monkeypatch):
    """16 blocks per env wherever the card holds one cluster of 16 of the
    plan's blocks at once (cudaOccupancyMaxActiveClusters, asked once per N
    and device), else the portable 8; the plan fits a block's 227 KB up to
    MAX_CLUSTER_ROWS, and one row more does not fit even its f buffers."""
    asked = []
    monkeypatch.setattr(port_jacobi, '_CLUSTER', {})
    monkeypatch.setattr(port_jacobi, 'cluster_occupancy',
                        lambda n, c, dev: asked.append(c) or active16)
    assert port_jacobi.cluster_size(n, 'cuda:0') == cluster
    assert port_jacobi.cluster_size(n, 'cuda:0') == cluster
    assert asked == [16]
    got = port_jacobi.cluster_shape(n, cluster)
    assert got.cluster == cluster and got.rows == -(-n // cluster)
    top = port_jacobi.cluster_shape(port_jacobi.MAX_CLUSTER_ROWS, cluster)
    assert top.smem <= 232448
    n4 = -(-(port_jacobi.MAX_CLUSTER_ROWS + 1) // 4) * 4
    r4 = -(-(-(-(port_jacobi.MAX_CLUSTER_ROWS + 1) // 8)) // 4) * 4
    assert 32 + 4 * n4 + 16 * r4 + 8 * n4 > 232448


@pytest.mark.parametrize('precision', ['f64', 'f32'])
def test_jacobi_plain_matches_xla_loop_at_blocks_size(precision):
    """N = 988, the blocks env's system size, against jacobi_solve_xla
    (f32: rtol 1e-4, atol 1e-5, the summation order of 988-term rows)."""
    dt, tdt, x64, _, _ = DTYPES[precision]
    a, b, aii_inv, omega = _random_system(988, 1, 7, dt)
    got = port_jacobi.jacobi_solve(t(a, tdt), t(b, tdt), t(aii_inv, tdt),
                                   t(omega, tdt), 60)
    with jax.enable_x64(x64):
        want = pallas_jacobi.jacobi_solve_xla(
            jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(aii_inv[0]),
            jnp.asarray(omega[0]), 60)
    tol = (dict(rtol=1e-12, atol=1e-14) if precision == 'f64'
           else dict(rtol=1e-4, atol=1e-5))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **tol)
    assert (got > 0).any() and (got == 0).any()


def test_jacobi_plain_matches_pallas_interpret_at_blocks_size():
    """N = 988 against the Pallas kernel in interpret mode (float32, padded
    to 1024 rows), tolerance as above."""
    a, b, aii_inv, omega = _random_system(988, 1, 8, np.float32)
    want = pallas_jacobi.jacobi_solve(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(aii_inv[0]),
        float(omega[0]), 60, interpret=True)
    got = port_jacobi.jacobi_solve(t(a), t(b), t(aii_inv), t(omega), 60)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_jacobi_launch_tiers_fit_every_n():
    """Every N up to MAX_ROWS gets a block of whole warps (at most 1024
    threads) whose row groups cover N rows and whose columns cover N, and
    every tier is used."""
    used = set()
    for n in range(1, port_jacobi.MAX_ROWS + 1):
        per_row, cols, rows, threads = port_jacobi.launch_shape(n)
        used.add((per_row, cols, rows))
        assert threads % 32 == 0 and threads <= 1024
        assert threads // per_row * rows >= n and per_row * cols >= n
    assert used == set(port_jacobi.TIERS)
