"""Parity of the port's terrain, blocks and arm envs
(learning_to_adapt_torch.envs HalfCheetahHFieldEnv, HalfCheetahBlocksEnv,
Arm7DofEnv) with the JAX package: the goldens, env.step and engine.step on
identical contact-rich states with the JAX side's task draws injected
(spec.mutable_from_numpy), reset, the terrain profiles, the rewards and
the arm's diagnostics. The entry points on these envs are in
tests/test_torch_entry_envs.py."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_STEP_TOL, capture_solves, t
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_torch.utils import logging as port_logger
from learning_to_adapt_tpu import envs as jax_envs
from learning_to_adapt_tpu.physics import engine as jax_engine

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'goldens')
#: (golden name, env class, task), as tests/test_goldens.py records them
GOLDENS = [('half_cheetah_hfield', 'HalfCheetahHFieldEnv', 'hfield'),
           ('half_cheetah_blocks', 'HalfCheetahBlocksEnv', 'damping'),
           ('arm_7dof', 'Arm7DofEnv', 'force')]


@functools.lru_cache(maxsize=None)
def _jax_env(cls, task):
    return getattr(jax_envs, cls)(task=task, reset_every_episode=True)


#: the task of each class's golden, whose JAX env instance the tests share
TASK = {cls: task for _, cls, task in GOLDENS}


@functools.lru_cache(maxsize=None)
def _jax_step(cls):
    """One compiled env.step per env class: the step reads the task from
    the state, so every task family shares it."""
    return jax.jit(_jax_env(cls, TASK[cls]).step)


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *trees)


@functools.lru_cache(maxsize=None)
def _jax_resets(cls, task):
    """Four episode-1 resets, the task drawn on the JAX side (one env a
    call: the vmapped programs of these models take a minute to compile on
    the CPU)."""
    jenv = _jax_env(cls, task)
    reset = jax.jit(lambda k: jenv.reset(k, 1))
    return _stack([reset(k) for k in jax.random.split(jax.random.PRNGKey(3),
                                                      len(ARM_FAMILIES))])


def _numpy_tree(x, batch):
    return jax.tree.map(lambda a: np.asarray(a) if batch
                        else np.asarray(a)[None], x)


def _port_state(env, qpos, qvel, js, batch=True):
    """The port's EnvState at (qpos, qvel) with the JAX state's task (its
    MutableModel through mutable_from_numpy and its cripple mask)."""
    mm = port_spec.mutable_from_numpy(_numpy_tree(js.mm, batch), 'cpu',
                                      torch.float32)
    mask = _numpy_tree(js.task['cripple_mask'], batch)
    return env.reset_to(port_engine.PhysicsState(t(qpos), t(qvel)), mm,
                        {'cripple_mask': t(mask)}, 1)


def _port_env(cls, task):
    return getattr(port_envs, cls)(task=task, reset_every_episode=True,
                                   device='cpu')


@pytest.mark.parametrize('name,cls,task', GOLDENS, ids=[g[0] for g in GOLDENS])
def test_golden(name, cls, task):
    """tests/goldens/<name>.npz through the port, with the JAX reset state,
    task draw and actions injected as tests/test_goldens.py draws them, at
    its tolerances."""
    jenv = _jax_env(cls, task)
    js = jenv.reset(jax.random.PRNGKey(123), episode_idx=1)
    env = _port_env(cls, task)
    state = _port_state(env, np.asarray(js.phys.qpos)[None],
                        np.asarray(js.phys.qvel)[None], js, batch=False)
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
    gold = np.load(os.path.join(GOLDEN_DIR, f'{name}.npz'))
    np.testing.assert_allclose(np.stack(qpos), gold['qpos'], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(rew), gold['rewards'], rtol=2e-3,
                               atol=2e-3)


def _contact_states(cls, js, seed):
    """(qpos, qvel) float64 with contact and limit rows active: the cheetah
    lowered onto its terrain (hfield) or onto the blocks, the blocks moved
    past their limits; the arm anywhere in its joint ranges."""
    rng = np.random.RandomState(seed)
    jm = _jax_env(cls, TASK[cls]).model
    qpos = np.asarray(js.phys.qpos, np.float64).copy()
    n_envs = qpos.shape[0]
    qvel = rng.randn(n_envs, jm.nv)
    if cls == 'HalfCheetahHFieldEnv':
        rows = np.asarray(js.mm.hfield_row)
        size = np.asarray(js.mm.hfield_size)
        x = rng.uniform(0.0, 3.0, n_envs)
        col = np.clip(((x + size[:, 0]) / (2 * size[:, 0]) * 499).astype(int),
                      0, 499)
        surf = rows[np.arange(n_envs), col] * size[:, 2]
        qpos = jm.qpos0[None] + 0.1 * rng.randn(n_envs, jm.nq)
        qpos[:, 0], qpos[:, 1] = x, surf - 0.4 + 0.02 * rng.randn(n_envs)
    elif cls == 'HalfCheetahBlocksEnv':
        qpos = jm.qpos0[None] + 0.1 * rng.randn(n_envs, jm.nq)
        qpos[:, :8] = rng.uniform(-0.2, 0.2, (n_envs, 8))
        qpos[:, 8] = rng.uniform(-1.0, 3.0, n_envs)
        qpos[:, 9] = 0.05 + 0.02 * rng.randn(n_envs)
    else:
        lo, hi = jm.jnt_range[:7, 0], jm.jnt_range[:7, 1]
        qpos[:, :7] = rng.uniform(lo, hi, (n_envs, 7))
        qvel = 0.3 * qvel
        qvel[:, -3:] = 0.0
    return qpos, qvel


#: one float32 arm step: its light wrist links (armature 0.04) amplify the
#: op-order noise of qacc = M^-1 f to ~1.1e-4 on qvel, where float64 agrees
#: to 3e-13 on the same states (test_engine_step_matches_jax)
ARM_F32_TOL = dict(rtol=1e-4, atol=3e-4)
#: the arm's four task families, one env of the batch each
ARM_FAMILIES = ('cripple', 'damping', 'mass', 'force')
STEP_CASES = [('HalfCheetahHFieldEnv', 'hfield'),
              ('HalfCheetahBlocksEnv', 'damping'),
              ('Arm7DofEnv', ARM_FAMILIES)]


def _step_case(cls, task, seed=4):
    """JAX resets (a tuple of tasks: env e drawn from task[e]), contact
    states and actions. A JAX arm step takes ~3 s on the CPU, so the arm's
    batch puts one task family in each env."""
    if isinstance(task, tuple):
        js = _stack([jax.tree.map(lambda a, e=e: a[e], _jax_resets(cls, k))
                     for e, k in enumerate(task)])
    else:
        js = _jax_resets(cls, task)
    qpos, qvel = _contact_states(cls, js, seed)
    act = np.random.RandomState(seed + 1).uniform(
        -1, 1, js.task['cripple_mask'].shape).astype(np.float32)
    return js, qpos, qvel, act


@pytest.mark.parametrize('cls,task', STEP_CASES,
                         ids=['hfield', 'blocks', 'arm-every-family'])
def test_step_matches_jax(cls, task):
    """One batched env.step against the JAX env.step of each env on the
    same float32 states, with the JAX task draws injected (the arm's batch
    holds one env of each task family: cripple, damping, mass, force); the
    states reach the constraint solver with active contact rows."""
    js, qpos, qvel, act = _step_case(cls, task)
    q32, v32 = qpos.astype(np.float32), qvel.astype(np.float32)
    n_envs = len(q32)
    step = _jax_step(cls)
    want = []
    for e in range(n_envs):
        one = jax.tree.map(lambda a: a[e], js)
        one = dataclasses.replace(one, phys=jax_engine.PhysicsState(
            jnp.asarray(q32[e]), jnp.asarray(v32[e])))
        want.append(jax.tree.map(np.asarray, step(one, jnp.asarray(act[e]))))

    env = _port_env(cls, TASK[cls])
    state = _port_state(env, q32, v32, js)
    out, captured = capture_solves(lambda: env.step(state, t(act)))
    A, b = captured[0][:2]
    nlim = 2 * int(np.sum(env.model.jnt_limited))
    assert int((b[:, nlim:] != 0).sum()) > 0, 'no active contact row'
    assert A.shape[-1] == {'HalfCheetahHFieldEnv': 76,
                           'HalfCheetahBlocksEnv': 988,
                           'Arm7DofEnv': 26}[cls]

    tol = ARM_F32_TOL if cls == 'Arm7DofEnv' else F32_STEP_TOL
    for e, w in enumerate(want):
        new, obs, rew = w[0], w[1], w[2]
        np.testing.assert_allclose(out[0].phys.qpos[e].numpy(),
                                   new.phys.qpos, **tol)
        np.testing.assert_allclose(out[0].phys.qvel[e].numpy(),
                                   new.phys.qvel, **tol)
        np.testing.assert_allclose(out[1][e].numpy(), obs, **tol)
        np.testing.assert_allclose(float(out[2][e]), rew, rtol=1e-4,
                                   atol=1e-3)
    assert out[0].t.tolist() == [1] * n_envs
    if cls == 'Arm7DofEnv':         # each family's draw reached its env
        mm = state.mm
        assert (state.task['cripple_mask'][0] == 0).sum() == 1
        assert (mm.dof_damping[1] != mm.dof_damping[0]).any()
        assert (mm.xfrc_applied[3] != 0).any()
        assert not (mm.xfrc_applied[:3] != 0).any()


@pytest.mark.parametrize('cls,task', STEP_CASES,
                         ids=['hfield', 'blocks', 'arm-every-family'])
@pytest.mark.parametrize('precision', ['f64', 'f32'])
def test_engine_step_matches_jax(cls, task, precision):
    """engine.step and engine.forward of each model on the same states and
    task data, at float64 (rtol 1e-10) and float32 (one step, other op
    order)."""
    dt, tdt, x64, tol = {
        'f64': (np.float64, torch.float64, True,
                dict(rtol=1e-10, atol=1e-10)),
        'f32': (np.float32, torch.float32, False,
                ARM_F32_TOL if cls == 'Arm7DofEnv' else F32_STEP_TOL),
    }[precision]
    js, qpos, qvel, act = _step_case(cls, task, seed=6)
    jm = _jax_env(cls, TASK[cls]).model
    pm = _port_env(cls, TASK[cls]).model
    mm_np = _numpy_tree(js.mm, True)
    with jax.enable_x64(x64):
        step = jax.jit(lambda m, q, v, c: jax_engine.step(
            jm, m, jax_engine.PhysicsState(q, v), c))
        new = _stack([step(jax.tree.map(lambda a: jnp.asarray(a[e], dt),
                                        mm_np),
                           jnp.asarray(qpos[e], dt), jnp.asarray(qvel[e], dt),
                           jnp.asarray(act[e], dt))
                      for e in range(len(qpos))])
    mm = port_spec.mutable_from_numpy(mm_np, 'cpu', tdt)
    got = port_engine.step(pm, mm, port_engine.PhysicsState(
        t(qpos, tdt), t(qvel, tdt)), t(act, tdt))
    np.testing.assert_allclose(got.qpos.numpy(), new.qpos, **tol)
    np.testing.assert_allclose(got.qvel.numpy(), new.qvel, **tol)


def test_mutable_from_numpy_carries_every_field():
    """The JAX side's draws arrive field for field: terrain, damping, mass,
    force."""
    for cls, task, field in (('HalfCheetahHFieldEnv', 'hfield', 'hfield_row'),
                             ('HalfCheetahBlocksEnv', 'damping',
                              'dof_damping'),
                             ('Arm7DofEnv', 'mass', 'body_mass'),
                             ('Arm7DofEnv', 'force', 'xfrc_applied')):
        js = _jax_resets(cls, task)
        mm = port_spec.mutable_from_numpy(_numpy_tree(js.mm, True), 'cpu',
                                          torch.float32)
        for name in ('body_mass', 'dof_damping', 'geom_size', 'geom_pos',
                     'xfrc_applied', 'hfield_size', 'hfield_row'):
            np.testing.assert_array_equal(getattr(mm, name).numpy(),
                                          np.asarray(getattr(js.mm, name)))
        assert getattr(mm, field).shape[0] == len(ARM_FAMILIES)
        if task != 'mass':        # draws from {1, 2, 3} may repeat
            assert len(np.unique(np.asarray(getattr(js.mm, field)),
                                 axis=0)) == len(ARM_FAMILIES), cls


@pytest.mark.parametrize('cls,task,dim', [
    ('HalfCheetahHFieldEnv', 'hfield', 20),
    ('HalfCheetahBlocksEnv', 'damping', 20), ('Arm7DofEnv', 'force', 23)])
def test_reset_observation_dims_and_task_draws(cls, task, dim):
    """Obs dims 20 / 20 / 23 as in JAX; reset draws the nominal task in
    episode 0 and a task per env after, from the env's generator."""
    env = _port_env(cls, task)
    assert env.obs_dim == _jax_env(cls, task).obs_dim == dim
    gen = torch.Generator().manual_seed(0)
    s0, s1 = env.reset(4, 0, gen), env.reset(4, 1, gen)
    assert s0.obs.shape == s1.obs.shape == (4, dim)
    mm0 = port_spec.batched_mutable(env.mm0, 4, 'cpu', torch.float32)
    field = {'HalfCheetahHFieldEnv': 'hfield_row',
             'HalfCheetahBlocksEnv': 'dof_damping',
             'Arm7DofEnv': 'xfrc_applied'}[cls]
    np.testing.assert_array_equal(getattr(s0.mm, field).numpy(),
                                  getattr(mm0, field).numpy())
    drawn = getattr(s1.mm, field).reshape(4, -1).numpy()
    assert len(np.unique(drawn, axis=0)) == 4
    if cls == 'HalfCheetahBlocksEnv':
        assert (drawn[:, :8] >= 0).all() and (drawn[:, :8] <= 10).all()
        np.testing.assert_array_equal(
            drawn[:, 8:], np.broadcast_to(env.mm0.dof_damping[8:], (4, 9)))
    elif cls == 'Arm7DofEnv':
        obj = env.model.body_id('object')
        g = -drawn.reshape(4, -1, 6)[:, obj, 2] / env.mm0.body_mass[obj]
        assert ((g >= 0.1 - 1e-6) & (g <= 2.0 + 1e-6)).all()
        np.testing.assert_allclose(s1.phys.qpos[:, -3:].numpy(),
                                   np.tile([0.3, 0.15, 0.0], (4, 1)))
        assert (s1.phys.qvel[:, -3:] == 0).all()
        assert (s1.phys.qvel.abs() <= 0.005).all()
    else:
        np.testing.assert_allclose(drawn.min(1), 0.0, atol=1e-6)
        np.testing.assert_allclose(drawn.max(1), 1.0, atol=1e-6)
        size = s1.mm.hfield_size.numpy()
        assert ((size[:, 2] >= 0.2) & (size[:, 2] <= 1.0)).all()


@pytest.mark.parametrize('name', ['basin', 'hill', 'gentle', 'steep'])
def test_named_terrain_profiles_match_jax(name):
    """The named terrains, and a named task and terrain_set drawing them."""
    jenv = _jax_env('HalfCheetahHFieldEnv', 'hfield')
    env = _port_env('HalfCheetahHFieldEnv', name)
    row, size = env._named_profile(name)
    jrow, jsize = jenv._named_profile(name)
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(size.numpy(), np.asarray(jsize))
    gen = torch.Generator().manual_seed(1)
    s = env.reset(2, 1, gen)
    np.testing.assert_array_equal(s.mm.hfield_row.numpy(),
                                  np.tile(row.numpy(), (2, 1)))
    held_out = port_envs.HalfCheetahHFieldEnv(
        task='hfield', reset_every_episode=True, device='cpu',
        terrain_set=(name, 'gentle'))
    rows = held_out.reset(16, 1, gen).mm.hfield_row.numpy()
    named = {n: held_out._named_profile(n)[0].numpy()
             for n in (name, 'gentle')}
    assert all(any(np.array_equal(r, v) for v in named.values())
               for r in rows)


def test_random_terrain_profile_matches_jax():
    """_profile on given walls and heights (the 'hfield' task's closed
    form)."""
    rng = np.random.RandomState(2)
    walls = rng.permutation([255., 265., 275., 285., 295., 305.])
    h = rng.uniform(0.2, 0.6, 6) * np.r_[1, 1, np.sign(rng.randn(4))]
    env = _port_env('HalfCheetahHFieldEnv', 'hfield')
    got = env._profile(t(walls)[None], t(h)[None], 10.0)[0]
    want = _jax_env('HalfCheetahHFieldEnv', 'hfield')._profile(
        jnp.asarray(walls, jnp.float32), jnp.asarray(h, jnp.float32), 10.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('cls,task,obs_dim,act_dim', [
    ('HalfCheetahHFieldEnv', 'hfield', 20, 6),
    ('HalfCheetahBlocksEnv', 'damping', 20, 6),
    ('Arm7DofEnv', 'force', 23, 7)])
def test_planner_reward_matches_jax(cls, task, obs_dim, act_dim):
    """The batched planner-side reward(obs, act, next_obs)."""
    rng = np.random.RandomState(9)
    obs, nxt = rng.randn(2, 5, 7, obs_dim).astype(np.float32)
    act = rng.uniform(-1, 1, (5, 7, act_dim)).astype(np.float32)
    got = _port_env(cls, task).reward(t(obs), t(act), t(nxt))
    want = _jax_env(cls, task).reward(obs, act, nxt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_arm_step_reward_is_the_planner_reward():
    """The arm's env reward at a step is its planner reward on the step's
    observations (both read the object-target vector of the new state)."""
    js, qpos, qvel, act = _step_case('Arm7DofEnv', 'force')
    env = _port_env('Arm7DofEnv', 'force')
    state = _port_state(env, qpos.astype(np.float32),
                        qvel.astype(np.float32), js)
    nxt, obs, rew, _, _ = env.step(state, t(act))
    torch.testing.assert_close(rew, env.reward(state.obs, t(act), obs),
                               rtol=1e-6, atol=1e-6)


def test_arm_log_diagnostics(tmp_path):
    """AverageFinalDistance and MinFinalDistance, as the JAX env writes
    them (results/grbal_arm7dof_force_tpu_r4.csv carries both)."""
    rng = np.random.RandomState(3)
    paths = dict(observations=rng.randn(4, 10, 23))
    port_logger.configure(dir=str(tmp_path), format_strs=[])
    try:
        _port_env('Arm7DofEnv', 'force').log_diagnostics(paths, 'EnvTrajs-')
        kvs = dict(port_logger._current().name2val)
    finally:
        port_logger.Logger.CURRENT.close()
    dist = np.linalg.norm(paths['observations'][:, -1, -3:], axis=-1)
    assert kvs == {'EnvTrajs-AverageFinalDistance': float(dist.mean()),
                   'EnvTrajs-MinFinalDistance': float(dist.min())}


def test_unknown_tasks_and_ranges_are_refused():
    for make in (lambda: _port_env('HalfCheetahHFieldEnv', 'cripple'),
                 lambda: _port_env('HalfCheetahBlocksEnv', 'hfield'),
                 lambda: _port_env('Arm7DofEnv', 'hfield'),
                 lambda: port_envs.HalfCheetahHFieldEnv(
                     terrain_set=('moon',), device='cpu'),
                 lambda: port_envs.HalfCheetahBlocksEnv(
                     damping_range=(3, 1), device='cpu'),
                 lambda: port_envs.Arm7DofEnv(force_range=(3, 1),
                                              device='cpu')):
        with pytest.raises(ValueError):
            make()
