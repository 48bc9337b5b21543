"""Parity of the port's Ant (learning_to_adapt_torch.envs.AntEnv) and what
it brought into the physics (free joints, RK4, projected Gauss-Seidel,
energy) with the JAX package: the golden with the JAX reset state and task
draw injected (spec.mutable_from_numpy), engine.step on contact- and
limit-rich Ant states at float64 and float32, a free body falling and
spinning under RK4 with its energy, position integration and
quat_integrate, the PGS branch on HalfCheetah and the Ant, the cripple
task and the planner reward. A JAX Ant step compiles in ~10 s on the CPU,
so the JAX side steps one env a call."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    F32_STEP_TOL, F64_STEP_TOL, capture_solves, contact_states, t)
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.envs.model_defs import get_model as port_model
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import maths as port_maths
from learning_to_adapt_torch.physics import mjcf as port_mjcf
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_tpu import envs as jax_envs
from learning_to_adapt_tpu.envs.model_defs import get_model as jax_model
from learning_to_adapt_tpu.physics import engine as jax_engine
from learning_to_adapt_tpu.physics import maths as jax_maths
from learning_to_adapt_tpu.physics import mjcf as jax_mjcf
from learning_to_adapt_tpu.physics import spec as jax_spec

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

GOLDEN = os.path.join(os.path.dirname(__file__), 'goldens', 'ant.npz')
N_ENVS = 4
#: dtype -> (numpy dtype, torch dtype, jax x64 flag, one-step tolerance)
DTYPES = {'f64': (np.float64, torch.float64, True, F64_STEP_TOL),
          'f32': (np.float32, torch.float32, False, F32_STEP_TOL)}


@functools.lru_cache(maxsize=None)
def _jax_env():
    return jax_envs.AntEnv(task='cripple', reset_every_episode=True)


def _port_env(**kw):
    return port_envs.AntEnv(task='cripple', reset_every_episode=True,
                            device='cpu', **kw)


@functools.lru_cache(maxsize=None)
def _jax_resets():
    """N_ENVS episode-1 resets, the legs drawn on the JAX side."""
    reset = jax.jit(lambda k: _jax_env().reset(k, 1))
    states = [reset(k) for k in jax.random.split(jax.random.PRNGKey(5),
                                                 N_ENVS)]
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *states)


def _port_state(env, qpos, qvel, js, dtype=torch.float32):
    mm = port_spec.mutable_from_numpy(js.mm, 'cpu', dtype)
    return env.reset_to(port_engine.PhysicsState(t(qpos, dtype),
                                                 t(qvel, dtype)), mm,
                        {'cripple_mask': t(js.task['cripple_mask'], dtype)},
                        1)


def _ant_states(seed):
    """(qpos, qvel) float64 for N_ENVS Ants pressed into the floor, tilted,
    their hinges spread past their limits: contact and limit rows
    active."""
    rng = np.random.RandomState(seed)
    jm = _jax_env().model
    qpos = np.tile(jm.init_qpos, (N_ENVS, 1))
    qpos[:, :2] = rng.uniform(-1, 1, (N_ENVS, 2))
    qpos[:, 2] = rng.uniform(0.3, 0.45, N_ENVS)
    quat = np.concatenate([np.ones((N_ENVS, 1)),
                           0.15 * rng.randn(N_ENVS, 3)], axis=1)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += 0.5 * rng.randn(N_ENVS, 8)
    qvel = rng.randn(N_ENVS, jm.nv)
    return qpos, qvel


def test_golden():
    """tests/goldens/ant.npz through the port, with the JAX reset state,
    leg draw and actions injected as tests/test_goldens.py draws them, at
    its tolerances."""
    jenv = _jax_env()
    js = jenv.reset(jax.random.PRNGKey(123), episode_idx=1)
    env = _port_env()
    one = jax.tree.map(lambda a: np.asarray(a)[None], js)
    state = _port_state(env, one.phys.qpos, one.phys.qvel, one)
    np.testing.assert_allclose(state.obs[0].numpy(), np.asarray(js.obs),
                               rtol=1e-5, atol=1e-5)
    key = jax.random.PRNGKey(7)
    qpos, rew = [], []
    for _ in range(40):
        key, sub = jax.random.split(key)
        act = np.asarray(jax.random.uniform(sub, (jenv.act_dim,),
                                            minval=-1.0, maxval=1.0))
        state, obs, reward, done, _ = env.step(state, t(act)[None])
        qpos.append(state.phys.qpos[0].numpy())
        rew.append(float(reward[0]))
    gold = np.load(GOLDEN)
    np.testing.assert_allclose(np.stack(qpos), gold['qpos'], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(rew), gold['rewards'], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize('precision', ['f64', 'f32'])
def test_engine_step_matches_jax(precision):
    """engine.step (RK4, four dynamics passes) on Ants in contact, past
    their limits, each with its JAX leg draw, at float64 (rtol 1e-10) and
    float32; each pass solves a 116-row system with active contact and
    limit rows."""
    dt, tdt, x64, tol = DTYPES[precision]
    js = _jax_resets()
    qpos, qvel = _ant_states(seed=11)
    act = np.random.RandomState(12).uniform(-150, 150, (N_ENVS, 8))
    jm = _jax_env().model
    with jax.enable_x64(x64):
        step = jax.jit(lambda m, q, v, c: jax_engine.step(
            jm, m, jax_engine.PhysicsState(q, v), c))
        want = [step(jax.tree.map(lambda a: jnp.asarray(a[e], dt), js.mm),
                     jnp.asarray(qpos[e], dt), jnp.asarray(qvel[e], dt),
                     jnp.asarray(act[e], dt)) for e in range(N_ENVS)]
    pm = port_model('ant')
    mm = port_spec.mutable_from_numpy(js.mm, 'cpu', tdt)
    got, solves = capture_solves(lambda: port_engine.step(
        pm, mm, port_engine.PhysicsState(t(qpos, tdt), t(qvel, tdt)),
        t(act, tdt)))
    assert len(solves) == 4
    A, b = solves[0][:2]
    assert A.shape == (N_ENVS, 116, 116)
    assert int((b[:, :16] != 0).sum()) > 0, 'no active limit row'
    assert int((b[:, 16:] != 0).sum(-1).min()) > 0, 'an Ant without contact'
    for e, w in enumerate(want):
        np.testing.assert_allclose(got.qpos[e].numpy(), np.asarray(w.qpos),
                                   **tol)
        np.testing.assert_allclose(got.qvel[e].numpy(), np.asarray(w.qvel),
                                   **tol)


SPINNER = '''
<mujoco model="spinner">
  <option timestep="0.005" integrator="RK4" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="body" pos="0 0 2">
      <joint type="free" name="root"/>
      <geom type="box" size="0.1 0.2 0.3" density="500"/>
      <geom type="capsule" fromto="0 0 0 0.3 0.1 0" size="0.05"/>
    </body>
  </worldbody>
</mujoco>
'''


def test_free_body_falls_and_spins_as_in_jax():
    """A free asymmetric body, loaded from MJCF by each package, falling
    and spinning about all three axes: 50 RK4 steps at float64 within 1e-9
    of the JAX trajectory, its (potential, kinetic) energy as JAX computes
    it, and the total conserved to 1e-6."""
    jm = jax_mjcf.load_mjcf(xml_string=SPINNER)
    pm = port_mjcf.load_mjcf(xml_string=SPINNER)
    q0 = np.array([0., 0., 2., 0.9, 0.1, -0.3, 0.2])
    q0[3:] /= np.linalg.norm(q0[3:])
    v0 = np.array([0.3, -0.2, 1.0, 2.0, -3.0, 5.0])
    with jax.enable_x64(True):
        mm = jax.tree.map(jnp.asarray, jax_spec.default_mutable(
            jm, np.float64))
        step = jax.jit(lambda q, v: jax_engine.step(
            jm, mm, jax_engine.PhysicsState(q, v), jnp.zeros(0)))
        en = jax.jit(lambda q, v: jax_engine.energy(
            jm, mm, jax_engine.PhysicsState(q, v)))
        q, v = jnp.asarray(q0), jnp.asarray(v0)
        want, want_en = [], []
        for _ in range(50):
            s = step(q, v)
            q, v = s.qpos, s.qvel
            want.append((np.asarray(q), np.asarray(v)))
            want_en.append([float(x) for x in en(q, v)])
    pmm = port_spec.batched_mutable(port_spec.default_mutable(
        pm, np.float64), 1, 'cpu', torch.float64)
    state = port_engine.PhysicsState(t(q0, torch.float64)[None],
                                     t(v0, torch.float64)[None])
    ctrl = torch.zeros((1, 0), dtype=torch.float64)
    total = []
    for (wq, wv), (w_pot, w_kin) in zip(want, want_en):
        state = port_engine.step(pm, pmm, state, ctrl)
        np.testing.assert_allclose(state.qpos[0].numpy(), wq, rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(state.qvel[0].numpy(), wv, rtol=1e-9,
                                   atol=1e-9)
        pot, kin = port_engine.energy(pm, pmm, state)
        np.testing.assert_allclose([float(pot[0]), float(kin[0])],
                                   [w_pot, w_kin], rtol=1e-9, atol=1e-9)
        total.append(float(pot[0] + kin[0]))
    assert want[-1][0][2] < 2.0 and abs(want[-1][1][5]) > 1.0
    np.testing.assert_allclose(total, total[0], rtol=1e-6)


def test_integrate_pos_and_quat_integrate_match_jax():
    """Position integration of the Ant's 15 coordinates from 14 dofs (the
    free joint's linear part, its quaternion, the hinges one address on)
    and quat_integrate, including a zero angular velocity, at float64."""
    rng = np.random.RandomState(3)
    qpos, _ = _ant_states(seed=3)
    qvel = 3.0 * rng.randn(N_ENVS, 14)
    qvel[0, 3:6] = 0.0
    jm, pm = _jax_env().model, port_model('ant')
    mt = port_engine.model_tensors(pm, torch.device('cpu'), torch.float64)
    got = port_engine._integrate_pos(mt, t(qpos, torch.float64),
                                     t(qvel, torch.float64), 0.02)
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jax_engine._integrate_pos(
            jm, jnp.asarray(qpos[e]), jnp.asarray(qvel[e]), 0.02))
            for e in range(N_ENVS)])
        quat = rng.randn(8, 4)
        omega = rng.randn(8, 3)
        omega[0] = 0.0
        want_q = np.asarray(jax_maths.quat_integrate(
            jnp.asarray(quat), jnp.asarray(omega), 0.05))
        want_n = np.asarray(jax_maths.quat_normalize(jnp.asarray(quat)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[:, 7:].numpy(),
                               qpos[:, 7:] + 0.02 * qvel[:, 6:], rtol=1e-12)
    np.testing.assert_allclose(port_maths.quat_integrate(
        t(quat, torch.float64), t(omega, torch.float64), 0.05).numpy(),
        want_q, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port_maths.quat_normalize(
        t(quat, torch.float64)).numpy(), want_n, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('name', ['half_cheetah', 'ant'])
def test_pgs_branch_matches_jax(name):
    """engine.step with solver='pgs' (the JAX engine's Gauss-Seidel
    branch) on states with active contact rows, at float64."""
    jm = dataclasses.replace(jax_model(name), solver='pgs')
    pm = dataclasses.replace(port_model(name), solver='pgs')
    if name == 'ant':
        qpos, qvel = _ant_states(seed=21)
    else:
        qpos, qvel = contact_states(jm, N_ENVS, seed=21)
    act = np.random.RandomState(22).uniform(-1, 1, (N_ENVS, jm.nu))
    with jax.enable_x64(True):
        mm = jax.tree.map(jnp.asarray, jax_spec.default_mutable(
            jm, np.float64))
        step = jax.jit(lambda q, v, c: jax_engine.step(
            jm, mm, jax_engine.PhysicsState(q, v), c))
        want = [step(jnp.asarray(qpos[e]), jnp.asarray(qvel[e]),
                     jnp.asarray(act[e])) for e in range(N_ENVS)]
    f64 = torch.float64
    pmm = port_spec.batched_mutable(port_spec.default_mutable(
        pm, np.float64), N_ENVS, 'cpu', f64)
    got, solves = capture_solves(lambda: port_engine.step(
        pm, pmm, port_engine.PhysicsState(t(qpos, f64), t(qvel, f64)),
        t(act, f64)))
    assert solves == []                      # no Jacobi solve on this path
    for e, w in enumerate(want):
        np.testing.assert_allclose(got.qpos[e].numpy(), np.asarray(w.qpos),
                                   **F64_STEP_TOL)
        np.testing.assert_allclose(got.qvel[e].numpy(), np.asarray(w.qvel),
                                   **F64_STEP_TOL)


def test_cripple_matches_jax_sample_task():
    """For legs drawn by the JAX sample_task, the port's cripple with the
    same legs gives the same actuator mask, geom sizes and geom positions;
    sample_task draws only from cripple_set."""
    jenv = _jax_env()
    mm0 = jax.tree.map(jnp.asarray, jax_spec.default_mutable(jenv.model))
    draws = [jenv.sample_task(k, mm0, jenv.default_task())
             for k in jax.random.split(jax.random.PRNGKey(4), 12)]
    masks = np.stack([np.asarray(task['cripple_mask']) for _, task in draws])
    legs = [{(2, 3): 0, (4, 5): 1, (6, 7): 2}[tuple(np.flatnonzero(m == 0))]
            for m in masks]
    assert set(legs) == {0, 1, 2}
    env = _port_env()
    mm = port_spec.batched_mutable(env.mm0, len(legs), 'cpu', torch.float32)
    got_mm, got_task = env.cripple(mm, env.default_task(len(legs)),
                                   torch.as_tensor(legs))
    np.testing.assert_array_equal(got_task['cripple_mask'].numpy(), masks)
    for field in ('geom_size', 'geom_pos'):
        np.testing.assert_array_equal(
            getattr(got_mm, field).numpy(),
            np.stack([np.asarray(getattr(m, field)) for m, _ in draws]))
    gen = torch.Generator().manual_seed(0)
    held_out = _port_env(cripple_set=(3,))
    mask = held_out.reset(64, 1, gen).task['cripple_mask']
    assert (mask[:, :2] == 0).all() and (mask[:, 2:] == 1).all()
    mask = env.reset(64, 1, gen).task['cripple_mask']
    assert ((mask == 0).sum(1) == 2).all() and (mask[:, :2] == 1).all()
    assert len(np.unique(mask.numpy(), axis=0)) == 3
    with pytest.raises(ValueError):
        _port_env(cripple_set=(4,))


def test_reset_and_planner_reward_match_jax():
    """Obs dim 41 in both; the batched planner reward on random
    observations; a step's env reward against the JAX env.step."""
    env, jenv = _port_env(), _jax_env()
    assert env.obs_dim == jenv.obs_dim == 41
    rng = np.random.RandomState(9)
    obs, nxt = rng.randn(2, 5, 7, 41).astype(np.float32)
    act = rng.uniform(-1, 1, (5, 7, 8)).astype(np.float32)
    np.testing.assert_allclose(
        env.reward(t(obs), t(act), t(nxt)).numpy(),
        np.asarray(jenv.reward(obs, act, nxt)), rtol=1e-5, atol=1e-5)
    js = _jax_resets()
    one = jax.tree.map(lambda a: a[0], js)
    a0 = rng.uniform(-1, 1, 8).astype(np.float32)
    _, w_obs, w_rew, _, _ = jax.jit(jenv.step)(one, jnp.asarray(a0))
    state = _port_state(env, js.phys.qpos[:1], js.phys.qvel[:1],
                        jax.tree.map(lambda a: a[:1], js))
    _, obs1, rew1, _, _ = env.step(state, t(a0)[None])
    np.testing.assert_allclose(obs1[0].numpy(), np.asarray(w_obs),
                               **F32_STEP_TOL)
    np.testing.assert_allclose(float(rew1[0]), float(w_rew), rtol=1e-4,
                               atol=1e-3)
