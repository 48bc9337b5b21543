"""The port's crippled-leg Ant (envs/ant.py AntEnv, eager on the CPU) held
against the plain reference of port_bench/reference/ant.py, which the
benchmark's grbal_sample_ant cell judges the card's paths by: the reset's
draws, the crippled geometry and actuator mask from one generator; one
and ten env steps of the f64 C++ reference against the port's AntEnv at
f64 (qpos, qvel, obs, reward) from Ants pressed into the floor with the
crippled leg in contact; and the reference's Ant planner returns against
the port's planner on a tiny seeded meta-MLP, with shared and adapted
weights, in f32 with bf16 products. This file imports no JAX."""
import numpy as np
import pytest
import torch

from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.models import MetaMLPDynamicsModel
from learning_to_adapt_torch.models.normalizer import Normalizer
from learning_to_adapt_torch.ops.fused_mlp import pack_weights
from learning_to_adapt_torch.physics import engine, maths
from learning_to_adapt_torch.policies import planners
from port_bench.lib.precision import RoundedProducts
from port_bench.reference import ant as ref
from port_bench.reference import models as ref_models

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

CONFIG = dict(run_config=dict(task='cripple'),
              physics=dict(model='ant', cripple_set=[0, 1, 2],
                           reset_every_episode=True))
N_ENVS = 6
#: ant_env.py's cripple_leg, leg by leg: the actuators it zeroes and the
#: geoms it shrinks (upper, lower), by index
PUBLISHED = {0: ((2, 3), (3, 4)), 1: ((4, 5), (6, 7)),
             2: ((6, 7), (9, 10)), 3: ((0, 1), (12, 13))}
#: the direction of each leg from the torso (ant.xml)
LEG_DIRECTIONS = {0: (1.0, 1.0), 1: (-1.0, 1.0), 2: (-1.0, -1.0),
                  3: (1.0, -1.0)}
# f64 on both sides, the same RK4 and 60 projected Jacobi sweeps a pass,
# summed in other orders: qpos, qvel, obs and reward agree to a few ulp
# (<= 2e-15 of 1 + |value| over ten steps on these states)
STEP_TOL = dict(rtol=1e-12, atol=1e-12)
# the geometry is the nominal f32 model's, scaled and copied in f32 by the
# port and in f64 by the reference
GEOM_TOL = dict(rtol=1e-6, atol=1e-7)
# f32 with bf16 products on both sides, the same products in the same
# order: the returns agree bit for bit on these inputs; the margin is for an
# f32 sum taken in another order (a few ulp of |returns| ~ 3), far under a
# wrong reward's 0.05 a step
RETURNS_TOL = dict(rtol=1e-5, atol=1e-5)


def _env(dtype=torch.float32):
    return port_envs.AntEnv(task='cripple', reset_every_episode=True,
                            device='cpu', dtype=dtype)


def _reference():
    return ref.Ant(CONFIG, 'cpu')


def test_published_legs():
    """The reference's legs, named in ant.xml, are ant_env.py's indices."""
    r = _reference()
    for leg, (acts, geoms) in PUBLISHED.items():
        assert tuple(np.flatnonzero(r.masks[leg] == 0)) == acts
        hip, ankle, upper, lower = ref.LEGS[leg]
        assert (r.model.geom_id(upper), r.model.geom_id(lower)) == geoms


@pytest.mark.parametrize('episode', [0, 1])
def test_reset_draws_geometry_and_mask(episode):
    """One generator's reset: the port's qpos and qvel bit for bit the
    reference's, and each env's actuator mask and crippled geom sizes and
    positions those of the leg the reference drew (none in episode 0)."""
    env, r = _env(), _reference()
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(11)
    g2.manual_seed(11)
    state = env.reset(N_ENVS, episode, g1)
    qpos, qvel, legs = r.reset_draws(g2, N_ENVS, episode)
    assert torch.equal(state.phys.qpos, qpos)
    assert torch.equal(state.phys.qvel, qvel)
    assert torch.equal(g1.get_state(), g2.get_state())
    if episode == 0:
        assert (legs == ref.NONE).all()
    else:
        assert set(legs.tolist()) <= {0, 1, 2}
        assert len(set(legs.tolist())) > 1
    for e, leg in enumerate(legs.tolist()):
        np.testing.assert_array_equal(state.task['cripple_mask'][e].numpy(),
                                      r.masks[leg])
        np.testing.assert_allclose(state.mm.geom_size[e].numpy(),
                                   r.mms[leg].geom_size, **GEOM_TOL)
        np.testing.assert_allclose(state.mm.geom_pos[e].numpy(),
                                   r.mms[leg].geom_pos, **GEOM_TOL)
    np.testing.assert_allclose(state.obs.double().numpy(),
                               r.observe(qpos, qvel).numpy(), rtol=1e-6,
                               atol=1e-6)


def _pressed(env, seed):
    """An f64 port state of N_ENVS crippled Ants pressed into the floor,
    hinges spread, each tilted by 0.5 rad towards its crippled leg so that
    the leg, shrunk and level with the torso, reaches the floor; with its
    reference legs."""
    r = _reference()
    g = torch.Generator()
    g.manual_seed(seed)
    base = env.reset(N_ENVS, 1, g)
    g.manual_seed(seed)
    _, _, legs = r.reset_draws(g, N_ENVS, 1)
    rng = np.random.RandomState(seed)
    qpos = np.tile(env.model.init_qpos, (N_ENVS, 1))
    qpos[:, :2] = rng.uniform(-1, 1, (N_ENVS, 2))
    qpos[:, 2] = rng.uniform(0.22, 0.25, N_ENVS)
    for e, leg in enumerate(legs.tolist()):
        # leg l is body leg_{l+1}, along (+-1, +-1, 0) from the torso
        d = np.array(LEG_DIRECTIONS[leg] + (0.0,)) / np.sqrt(2)
        axis = np.cross([0.0, 0.0, 1.0], d)
        qpos[e, 3:7] = np.concatenate([[np.cos(0.25)],
                                       np.sin(0.25) * axis])
    qpos[:, 7:] += 0.3 * rng.randn(N_ENVS, 8)
    qvel = rng.randn(N_ENVS, env.model.nv)
    phys = engine.PhysicsState(torch.as_tensor(qpos),
                               torch.as_tensor(qvel))
    state = env.reset_to(phys, base.mm, base.task, 1)
    return state, legs


def _crippled_in_contact(env, state, legs):
    """Whether each env's crippled leg has a geom into the floor (z = 0):
    the lower end of a capsule, its centre less its half-length along its
    axis, under its radius."""
    model, mm = env.model, state.mm
    mt = engine._mt(model, state.phys.qpos)
    xpos, xquat, _ = engine._fk(model, mt, state.phys.qpos)
    gpos, gmat = engine._geom_frames(mt, mm, xpos, maths.quat_to_mat(xquat))
    radius, half = mm.geom_size[..., 0], mm.geom_size[..., 1]
    low = gpos[..., 2] - half * gmat[..., 2, 2].abs() - radius
    return [bool((low[e, list(PUBLISHED[leg][1])] < 0).any())
            for e, leg in enumerate(legs.tolist())]


@pytest.mark.parametrize('steps', [1, 10])
def test_env_steps_match_the_reference(steps):
    """The port's AntEnv.step at f64 against the reference's f64 C++ step
    from the same states with the same actions, each side on its own
    states: qpos, qvel, obs and reward after `steps` steps."""
    env = port_envs.normalize(_env(torch.float64))
    r = _reference()
    state, legs = _pressed(env.wrapped_env, 3)
    assert all(_crippled_in_contact(env.wrapped_env, state, legs))
    rng = np.random.RandomState(4)
    qpos, qvel = state.phys.qpos, state.phys.qvel
    for _ in range(steps):
        act = torch.as_tensor(rng.uniform(-1, 1, (N_ENVS, 8)))
        state, obs, reward, _, _ = env.step(state, act)
        qpos, qvel, r_obs, r_reward = r.step(qpos, qvel, act, legs)
    for got, want in ((state.phys.qpos, qpos), (state.phys.qvel, qvel),
                      (obs, r_obs), (reward, r_reward)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **STEP_TOL)


@pytest.mark.parametrize('adapted', [False, True])
def test_planner_returns_match_the_reference(adapted):
    """Random shooting's returns on a tiny seeded meta-MLP ((32, 32), 8
    candidates, horizon 3, 2 envs): the port's planner through the
    model's packed weights (adapted per env on a window of 4 transitions,
    or the shared set), against reference/ant.py's returns on
    reference/models.py's adaptation, both in f32 with bf16 products."""
    env = port_envs.normalize(_env())
    model = MetaMLPDynamicsModel('d', env, hidden_sizes=(32, 32),
                                 meta_batch_size=2, batch_size=4,
                                 inner_learning_rate=0.01, seed=0,
                                 device='cpu')
    g = torch.Generator()
    g.manual_seed(7)
    dims = [49, 32, 32, 41]
    ws = [(torch.rand((a, b), generator=g) * 2 - 1) * np.sqrt(6 / (a + b))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(b, generator=g) for b in dims[1:]]
    d = 41
    stats = dict(obs_mean=torch.rand(d, generator=g) - 0.5,
                 obs_std=0.5 + torch.rand(d, generator=g),
                 act_mean=torch.zeros(8), act_std=torch.full((8,), 0.577),
                 delta_mean=0.02 * (torch.rand(d, generator=g) - 0.5),
                 delta_std=0.02 + 0.05 * torch.rand(d, generator=g))
    params = {'w': [w.clone() for w in ws], 'b': [b.clone() for b in bs]}
    norm = Normalizer(**{k: v.clone() for k, v in stats.items()})
    m, n, h, k = 2, 8, 3, 4
    obs0 = torch.randn((m, d), generator=g)
    cands = torch.rand((h, m * n, 8), generator=g) * 2 - 1
    h_obs = torch.randn((m, k + 1, d), generator=g)
    h_act = torch.rand((m, k, 8), generator=g) * 2 - 1
    if adapted:
        merged = model.adapt_fn(params, norm, h_obs[:, :-1], h_act,
                                h_obs[:, 1:])
        rw, rb = ref_models.adapt(ws, bs, stats, h_obs[:, :-1], h_act,
                                  h_obs[:, 1:], 0.01, 'relu')
    else:
        merged = model.broadcast_params(params, m)
        rw = [w.unsqueeze(0).expand(m, *w.shape) for w in ws]
        rb = [b.unsqueeze(0).expand(m, *b.shape) for b in bs]
    packed = pack_weights(merged['w'], merged['b'])

    def predict(o_rows, a_rows):
        out = model.predict_adapted_fn(packed, norm,
                                       o_rows.reshape(m, n, -1),
                                       a_rows.reshape(m, n, -1))
        return out.reshape(o_rows.shape[0], -1)
    _, got = planners.random_shooting(
        predict, env.reward, obs0, None, n_candidates=n, horizon=h,
        act_dim=8, candidates=cands)
    with RoundedProducts('bf16'):
        want = ref.planner_returns(rw, rb, stats, obs0,
                                   cands.reshape(h, m, n, 8), env.dt, 1.0,
                                   'relu')
    assert got.shape == want.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **RETURNS_TOL)
    assert want.std() > 0.1     # the candidates' returns differ
