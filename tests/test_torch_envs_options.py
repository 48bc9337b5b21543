"""Parity of the port's env options, spaces, env spec, running
normalization and MJCF loader with the JAX package: spaces.Box, Discrete,
Product and EnvSpec; frame_skip, action_noise (its normal draw taken from
the JAX env and injected), dtype=float64 and instability_recovery=False,
each against a JAX env.step on HalfCheetah; NormalizedEnv.maybe_normalize
over a sequence; physics/mjcf.py against the JAX load_mjcf on inline XML,
every PhysicsModel field."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    F32_STEP_TOL, F64_STEP_TOL, assert_models_equal, contact_states, t)
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.envs import env_spec as port_env_spec
from learning_to_adapt_torch.envs import spaces as port_spaces
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import mjcf as port_mjcf
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_tpu import envs as jax_envs
from learning_to_adapt_tpu.envs import env_spec as jax_env_spec
from learning_to_adapt_tpu.envs import spaces as jax_spaces
from learning_to_adapt_tpu.physics import engine as jax_engine
from learning_to_adapt_tpu.physics import mjcf as jax_mjcf

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores


def _space_pairs():
    """The same spaces built by each package."""
    def build(sp):
        box = sp.Box(np.array([-1., -2., 0.]), np.array([1., 2., 3.]))
        return [box, sp.Box(-0.5, 0.5, shape=(2, 3)), sp.Discrete(5),
                sp.Product(box, sp.Discrete(4)),
                sp.Product([sp.Discrete(2), sp.Box(0., 1., shape=(2,))])]
    return list(zip(build(port_spaces), build(jax_spaces)))


@pytest.mark.parametrize('i', range(5), ids=['box', 'box-shape', 'discrete',
                                             'product', 'product-list'])
def test_spaces_match_jax(i):
    """sample with a seeded generator, contains, flatten / unflatten,
    flat_dim, equality and repr, as the JAX space does them."""
    port, jax_sp = _space_pairs()[i]
    assert port.flat_dim == jax_sp.flat_dim
    if not isinstance(port, port_spaces.Product):
        assert repr(port) == repr(jax_sp)
    for seed in range(3):
        x = port.sample(np.random.RandomState(seed))
        x_jax = jax_sp.sample(np.random.RandomState(seed))
        np.testing.assert_equal(x, x_jax)
        assert port.contains(x) and jax_sp.contains(x)
        flat = port.flatten(x)
        np.testing.assert_array_equal(flat, jax_sp.flatten(x))
        assert flat.shape == (port.flat_dim,)
        np.testing.assert_equal(port.unflatten(flat), jax_sp.unflatten(flat))
    if isinstance(port, port_spaces.Box):
        out = port.high + 1.0
        assert not port.contains(out) and not jax_sp.contains(out)
        xs = np.stack([port.sample(np.random.RandomState(s))
                       for s in range(4)])
        np.testing.assert_array_equal(port.flatten_n(xs),
                                      jax_sp.flatten_n(xs))
        np.testing.assert_array_equal(
            port.unflatten_n(port.flatten_n(xs)), xs)
        assert port.bounds[0].dtype == np.float32
    elif isinstance(port, port_spaces.Discrete):
        assert not port.contains(5) and not jax_sp.contains(5)
    assert port == _space_pairs()[i][0]


def test_env_spec_and_env_spaces_match_jax():
    """EnvSpec and the envs' action_space, observation_space and spec (the
    normalized env's action space is [-1, 1])."""
    box, disc = port_spaces.Box(-1., 1., shape=(3,)), port_spaces.Discrete(2)
    spec = port_env_spec.EnvSpec(box, disc)
    jspec = jax_env_spec.EnvSpec(box, disc)
    assert spec.observation_space is jspec.observation_space is box
    assert spec.action_space is jspec.action_space is disc
    for cls in ('HalfCheetahEnv', 'AntEnv', 'Arm7DofEnv'):
        env = getattr(port_envs, cls)(device='cpu')
        jenv = getattr(jax_envs, cls)()
        for sp in ('action_space', 'observation_space'):
            a, b = getattr(env, sp), getattr(jenv, sp)
            np.testing.assert_array_equal(a.low, b.low)
            np.testing.assert_array_equal(a.high, b.high)
        assert env.spec.action_space == env.action_space
        assert env.spec.observation_space.shape == (env.obs_dim,)
        norm, jnorm = port_envs.normalize(env), jax_envs.normalize(jenv)
        for a, b in ((norm.action_space, jnorm.action_space),
                     (env.spec.action_space, jenv.spec.action_space)):
            np.testing.assert_array_equal(a.low, b.low)
            np.testing.assert_array_equal(a.high, b.high)
        np.testing.assert_array_equal(norm.action_space.high,
                                      np.ones(env.act_dim, np.float32))


@functools.lru_cache(maxsize=None)
def _jax_cheetah(**kw):
    return jax_envs.HalfCheetahEnv(task='cripple', reset_every_episode=True,
                                   **kw)


def _one_env_case(seed, dt=np.float32, qvel_set=None):
    """A JAX HalfCheetah reset (episode 1, an actuator crippled), a
    contact state (qvel_set: {dof: speed} overrides) and an action."""
    jenv = _jax_cheetah()
    js = jax.jit(lambda k: jenv.reset(k, 1))(jax.random.PRNGKey(seed))
    qpos, qvel = contact_states(_jax_cheetah().model, 1, seed)
    for k, v in (qvel_set or {}).items():
        qvel[0, k] = v
    act = np.random.RandomState(seed).uniform(-1, 1, 6).astype(dt)
    return js, qpos[0].astype(dt), qvel[0].astype(dt), act


def _both_steps(port_kw, jax_kw, seed, dt=np.float32, noise=False,
                qvel_set=None):
    """One env.step of the port's and the JAX HalfCheetah built with the
    given options, from the same state and task; with noise=True the port
    gets the JAX env's normal draw. Returns (port env, port state, port
    step, JAX step, action)."""
    js, qpos, qvel, act = _one_env_case(seed, dt, qvel_set)
    jenv = jax_envs.HalfCheetahEnv(task='cripple', reset_every_episode=True,
                                   **jax_kw)
    js = dataclasses.replace(
        jax.tree.map(lambda a: jnp.asarray(a, dt)
                     if jnp.issubdtype(a.dtype, jnp.floating) else a, js),
        phys=jax_engine.PhysicsState(jnp.asarray(qpos), jnp.asarray(qvel)))
    want = jax.jit(jenv.step)(js, jnp.asarray(act))
    tdt = torch.float64 if dt == np.float64 else torch.float32
    env = port_envs.HalfCheetahEnv(task='cripple', reset_every_episode=True,
                                   device='cpu', **port_kw)
    mm = port_spec.mutable_from_numpy(
        jax.tree.map(lambda a: np.asarray(a)[None], js.mm), 'cpu', tdt)
    state = env.reset_to(
        port_engine.PhysicsState(t(qpos, tdt)[None], t(qvel, tdt)[None]), mm,
        {'cripple_mask': t(js.task['cripple_mask'], tdt)[None]}, 1)
    drawn = None
    if noise:
        _, sub = jax.random.split(js.rng)
        drawn = t(jax.random.normal(sub, (6,), dt), tdt)[None]
    got = env.step(state, t(act, tdt)[None], noise=drawn)
    return env, state, got, jax.tree.map(np.asarray, want), t(act, tdt)


def _assert_step(got, want, tol):
    np.testing.assert_allclose(got[0].phys.qpos[0].numpy(),
                               want[0].phys.qpos, **tol)
    np.testing.assert_allclose(got[0].phys.qvel[0].numpy(),
                               want[0].phys.qvel, **tol)
    np.testing.assert_allclose(got[1][0].numpy(), want[1], **tol)
    np.testing.assert_allclose(float(got[2][0]), float(want[2]),
                               rtol=1e-4, atol=1e-3)


def test_frame_skip_matches_jax():
    """frame_skip=3 overrides the model's 1: three physics steps a call."""
    env, state, got, want, act = _both_steps(dict(frame_skip=3),
                                             dict(frame_skip=3), seed=1)
    assert env.frame_skip == 3 and env.model.frame_skip == 1
    _assert_step(got, want, F32_STEP_TOL)
    phys = state.phys
    for _ in range(3):
        phys = port_engine.step(env.model, state.mm, phys,
                                state.task['cripple_mask'] * act)
    torch.testing.assert_close(phys.qpos, got[0].phys.qpos, rtol=0, atol=0)


def test_action_noise_matches_jax():
    """action_noise=0.3 with the JAX env's normal draw injected; the noise
    moves the step; without an injected draw it comes from the reset's
    generator, carried in the state."""
    env, state, got, want, act = _both_steps(
        dict(action_noise=0.3), dict(action_noise=0.3), seed=2, noise=True)
    _assert_step(got, want, F32_STEP_TOL)
    quiet = _both_steps({}, {}, seed=2)
    assert not np.allclose(quiet[3][0].phys.qvel, want[0].phys.qvel)
    gen = torch.Generator().manual_seed(0)
    s = env.reset(2, 1, gen)
    assert s.rng is gen
    before = gen.get_state()
    drawn = env.step(s, torch.zeros((2, 6)))[0]
    replay = torch.Generator()
    replay.set_state(before)
    noise = torch.randn((2, 6), generator=replay)
    injected = env.step(s, torch.zeros((2, 6)), noise=noise)[0]
    torch.testing.assert_close(drawn.phys.qvel, injected.phys.qvel, rtol=0,
                               atol=0)


def test_float64_env_matches_jax():
    """dtype=torch.float64 against the JAX env at jnp.float64 (rtol
    1e-10): observations, state and reward in float64."""
    with jax.enable_x64(True):
        env, state, got, want, _ = _both_steps(
            dict(dtype=torch.float64), dict(dtype=jnp.float64), seed=3,
            dt=np.float64)
    assert got[1].dtype == torch.float64 == env.dtype
    assert state.mm.body_mass.dtype == torch.float64
    assert env.mm0.body_mass.dtype == np.float64
    _assert_step(got, want, F64_STEP_TOL)


#: joint speeds that drive a HalfCheetah step past the 150 rad/s bound
DIVERGING = dict(zip(range(3, 9), (300., -300., 250., -280., 300., -260.)))


def test_instability_recovery_off_matches_jax():
    """On a diverging state the default env goes back to its pre-step pose
    at rest; with instability_recovery=False the raw engine output comes
    through, as the JAX env's."""
    env, state, got, want, _ = _both_steps(
        dict(instability_recovery=False), dict(instability_recovery=False),
        seed=4, qvel_set=DIVERGING)
    assert float(got[0].phys.qvel.abs().max()) > 150.0
    _assert_step(got, want, F32_STEP_TOL)
    _, _, recovered, want_rec, _ = _both_steps({}, {}, seed=4,
                                               qvel_set=DIVERGING)
    torch.testing.assert_close(recovered[0].phys.qpos, state.phys.qpos)
    assert (recovered[0].phys.qvel == 0).all()
    _assert_step(recovered, want_rec, F32_STEP_TOL)


def test_maybe_normalize_matches_jax():
    """Running obs and reward normalization over a 50-step sequence, off
    by default; scale_reward is ignored as in the JAX wrapper."""
    rng = np.random.RandomState(5)
    obs = 3.0 + 2.0 * rng.randn(50, 20)
    rew = 1.0 + 4.0 * rng.randn(50)
    kw = dict(scale_reward=10.0, normalize_obs=True, normalize_reward=True,
              obs_alpha=0.01, reward_alpha=0.02)
    env = port_envs.NormalizedEnv(port_envs.HalfCheetahEnv(device='cpu'),
                                  **kw)
    jenv = jax_envs.NormalizedEnv(_jax_cheetah(), **kw)
    for o, r in zip(obs, rew):
        got = env.maybe_normalize(t(o, torch.float64), r)
        want = jenv.maybe_normalize(o, r)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    off = port_envs.normalize(port_envs.HalfCheetahEnv(device='cpu'))
    first = obs[0]
    o, r = off.maybe_normalize(first, rew[0])
    assert o is first and r == rew[0]


MJCF_CASES = {
    'ant-like free root': '''
<mujoco model="quad">
  <compiler angle="degree"/>
  <option timestep="0.02" integrator="RK4" iterations="20"/>
  <default>
    <joint armature="1" damping="1" limited="true"/>
    <geom conaffinity="0" condim="3" density="5.0" friction="1 0.5 0.5"
          margin="0.01"/>
    <motor ctrlrange="-150 150"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="40 40 40" conaffinity="1"/>
    <body name="torso" pos="0 0 0.75">
      <joint type="free" name="root" limited="false"/>
      <geom name="torso_geom" type="sphere" size="0.25"/>
      <body name="leg" pos="0 0 0">
        <geom type="capsule" fromto="0 0 0 0.2 0.2 0" size="0.08"/>
        <body name="aux" pos="0.2 0.2 0">
          <joint name="hip" axis="0 0 1" range="-30 30"/>
          <geom type="capsule" fromto="0 0 0 0.2 0.2 0" size="0.08"/>
          <body name="foot" pos="0.2 0.2 0">
            <joint name="ankle" axis="-1 1 0" range="30 70"/>
            <geom type="capsule" fromto="0 0 0 0.4 0.4 0" size="0.08"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="hip" gear="150"/>
    <motor joint="ankle" gear="150"/>
  </actuator>
  <custom>
    <numeric name="init_qpos" data="0 0 0.55 1 0 0 0 0 1"/>
    <numeric name="frame_skip" data="5"/>
  </custom>
</mujoco>''',
    'hinge chain with defaults': '''
<mujoco model="chain">
  <compiler angle="radian" settotalmass="14"/>
  <option timestep="0.01" gravity="0 0 -9.81"/>
  <default>
    <joint armature=".1" damping="2" limited="true" stiffness="8"
           solreflimit=".02 1" solimplimit="0 .8 .03"/>
    <geom type="capsule" condim="3" friction=".4 .1 .1" solref=".02 1"
          solimp="0 .8 .01"/>
  </default>
  <worldbody>
    <body name="root" pos="0 0 1">
      <joint type="slide" name="rootx" axis="1 0 0" limited="false"/>
      <joint type="hinge" name="rooty" axis="0 1 0" limited="false"
             springref="0.1"/>
      <geom name="torso" fromto="-.5 0 0 .5 0 0" size="0.046"/>
      <body name="thigh" pos=".5 0 0">
        <joint name="thigh" axis="0 1 0" range="-1 .7" ref="0.05"/>
        <geom axisangle="0 1 0 .52" pos="-.07 0 -.12" size=".046 .133"/>
        <body name="shin" pos="-.14 0 -.24">
          <joint name="shin" axis="0 1 0" range="-1.2 .87"/>
          <geom quat="0.9 0 0.43 0" pos=".065 0 -.09" size=".046 .106"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="thigh" gear="120" ctrlrange="-1 1"/>
    <motor joint="shin" gear="90" ctrlrange="-1 1"/>
  </actuator>
</mujoco>''',
    'plane and box': '''
<mujoco model="box_on_plane">
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1" pos="0 0 -.1"/>
    <body name="box" pos="0 0 0.3" quat="0.96 0 0 0.28">
      <joint type="slide" name="bx" axis="1 0 0"/>
      <joint type="slide" name="bz" axis="0 0 1"/>
      <geom type="box" size=".2 .1 .05" mass="3" rgba="1 0 0 1"/>
      <geom type="sphere" size=".05" pos=".2 0 -.05"/>
    </body>
  </worldbody>
</mujoco>''',
}


@pytest.mark.parametrize('name', sorted(MJCF_CASES))
def test_load_mjcf_matches_jax(name):
    """Every PhysicsModel field of the port's load_mjcf equals the JAX
    package's on the same XML (the compile-time invweights each computed
    by its own engine, to rtol 1e-9)."""
    pm = port_mjcf.load_mjcf(xml_string=MJCF_CASES[name])
    jm = jax_mjcf.load_mjcf(xml_string=MJCF_CASES[name])
    assert_models_equal(pm, jm, name)
    assert pm.nbody > 1 and pm.njnt > 0
