"""Parity of the port's planner and rollout (learning_to_adapt_torch.policies,
.samplers) with the JAX package, a small end-to-end Sampler run, import
hygiene of the port, and the no-silent-CPU rule of its entry points."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params_numpy, t
from learning_to_adapt_torch import envs as port_envs
from learning_to_adapt_torch.envs.base import EnvState
from learning_to_adapt_torch.models import (
    MetaMLPDynamicsModel as PortMetaMLP, Normalizer as PortNormalizer,
    normalizer_from_numpy, params_from_numpy)
from learning_to_adapt_torch.ops import fused_mlp as port_fused
from learning_to_adapt_torch.physics import engine as port_engine
from learning_to_adapt_torch.physics import spec as port_spec
from learning_to_adapt_torch.policies import MPCController as PortMPC
from learning_to_adapt_torch.policies import planners as port_planners
from learning_to_adapt_torch.samplers import (
    ModelSampleProcessor as PortProcessor, Sampler as PortSampler)
from learning_to_adapt_torch.samplers.rollout import (
    make_rollout_fn as port_rollout_fn)
from learning_to_adapt_torch.utils import logging as port_log
from learning_to_adapt_tpu import envs as jax_envs
from learning_to_adapt_tpu.models import MetaMLPDynamicsModel as JaxMetaMLP
from learning_to_adapt_tpu.models.normalizer import Normalizer as JaxNorm
from learning_to_adapt_tpu.policies import MPCController as JaxMPC
from learning_to_adapt_tpu.policies import planners as jax_planners
from learning_to_adapt_tpu.samplers.rollout import (
    make_rollout_fn as jax_rollout_fn)

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = (64, 64)
A_BS = 4
# returns are sums of (delta COM x)/dt over the horizon of bf16 model
# predictions: ~3e-7 relative apart in practice, bounded here
RET_TOL = dict(rtol=1e-3, atol=5e-2)


def _pair(task=None):
    """JAX and port env + GrBAL model with identical params/normalizer."""
    jenv = jax_envs.normalize(jax_envs.HalfCheetahEnv(
        task=task, reset_every_episode=True))
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task=task, reset_every_episode=True, device='cpu'))
    jm = JaxMetaMLP('dyn', jenv, hidden_sizes=HIDDEN, batch_size=A_BS,
                    inner_learning_rate=0.01)
    pm = PortMetaMLP('dyn', env, hidden_sizes=HIDDEN, batch_size=A_BS,
                     inner_learning_rate=0.01, device='cpu')
    rng = np.random.RandomState(5)
    obs, act, nxt = (rng.randn(4, 30, d).astype(np.float32)
                     for d in (20, 6, 20))
    jm.normalizer = JaxNorm.fit(jnp.asarray(obs), jnp.asarray(act),
                                jnp.asarray(nxt - obs))
    pm.params = params_from_numpy(jax_params_numpy(jm.params), 'cpu')
    pm.normalizer = normalizer_from_numpy(jax.device_get(jm.normalizer),
                                          'cpu')
    return jenv, env, jm, pm


def _safe_envs(returns):
    """Envs whose best candidate beats the runner-up by more than the
    returns' tolerance, so both packages must pick the same one."""
    top2 = np.sort(returns, axis=1)[:, -2:]
    tol = RET_TOL['atol'] + RET_TOL['rtol'] * np.abs(top2[:, 1])
    return np.nonzero(top2[:, 1] - top2[:, 0] > 2 * tol)[0]


def test_random_shooting_matches_jax():
    jenv, env, jm, pm = _pair()
    m, n, h = 3, 32, 5
    obs = np.random.RandomState(6).randn(m, 20).astype(np.float32)
    key = jax.random.PRNGKey(3)
    j_act, j_ret = jax_planners.random_shooting(
        lambda o, a: jm.predict_fn(jm.params, jm.normalizer, o, a),
        jenv.reward, jnp.asarray(obs), key, n_candidates=n, horizon=h,
        act_dim=6)
    # the candidates JAX drew (planners.py:34), injected into the port
    cand = jax.random.uniform(key, (h, n * m, 6), jnp.float32, -1.0, 1.0)
    p_act, p_ret = port_planners.random_shooting(
        lambda o, a: pm.predict_fn(pm.params, pm.normalizer, o, a),
        env.reward, t(obs), None, n_candidates=n, horizon=h, act_dim=6,
        candidates=t(cand))
    j_ret = np.asarray(j_ret)
    np.testing.assert_allclose(p_ret.numpy(), j_ret, **RET_TOL)
    safe = _safe_envs(j_ret)
    assert safe.size
    np.testing.assert_array_equal(p_act.numpy()[safe],
                                  np.asarray(j_act)[safe])
    # env-major layout: env g's first actions come from rows g*n..(g+1)*n
    for g in range(m):
        assert any(np.array_equal(p_act[g].numpy(), c)
                   for c in np.asarray(cand[0, g * n:(g + 1) * n]))


def test_rollout_step_matches_jax():
    """One GrBAL rollout step (adaptation active, cripple tasks drawn) from
    an identical carry, with the planner's candidates drawn by JAX."""
    jenv, env, jm, pm = _pair(task='cripple')
    m, n, h = 3, 16, 3
    t0 = A_BS + 2                                   # past the adapt gate
    jpol = JaxMPC('p', jenv, jm, n_candidates=n, horizon=h)
    ppol = PortMPC('p', env, pm, n_candidates=n, horizon=h)
    jfn = jax_rollout_fn(jenv, jpol, jm, m, t0 + 1, adapt_batch_size=A_BS,
                         segment_len=1)
    states, _, _, key = jfn.init_jit(jax.random.PRNGKey(8), 1)
    rng = np.random.RandomState(9)
    h_obs = (np.asarray(states.obs)[:, None] +
             0.1 * rng.randn(m, A_BS + 1, 20)).astype(np.float32)
    h_act = rng.uniform(-1, 1, (m, A_BS, 6)).astype(np.float32)
    carry = (states, (jnp.asarray(h_obs), jnp.asarray(h_act)), None, key)
    (j_states, (j_hobs, j_hact), _, _), j_out = jfn.segment_jit(
        jm.params, jm.normalizer, carry, jnp.asarray(t0, jnp.int32))

    # the planner's draw and its returns, as the JAX step computes them
    _, k_plan = jax.random.split(key)
    cand = jax.random.uniform(k_plan, (h, n * m, 6), jnp.float32, -1.0, 1.0)
    adapted = jm.adapt_fn(jm.params, jm.normalizer, jnp.asarray(h_obs[:, :-1]),
                          jnp.asarray(h_act), jnp.asarray(h_obs[:, 1:]))
    _, j_ret = jax_planners.random_shooting(
        lambda o, a: jm.predict_adapted_fn(
            adapted, jm.normalizer, o.reshape(m, n, -1),
            a.reshape(m, n, -1)).reshape(m * n, -1),
        jenv.reward, states.obs, k_plan, n_candidates=n, horizon=h,
        act_dim=6)
    safe = _safe_envs(np.asarray(j_ret))
    assert safe.size

    base = env.wrapped_env
    p_states = EnvState(
        phys=port_engine.PhysicsState(t(states.phys.qpos),
                                      t(states.phys.qvel)),
        mm=port_spec.batched_mutable(base.mm0, m, 'cpu', torch.float32),
        task={'cripple_mask': t(states.task['cripple_mask'])},
        obs=t(states.obs), t=torch.zeros(m, dtype=torch.int32),
        episode=torch.ones(m, dtype=torch.int32))
    assert (np.asarray(states.task['cripple_mask']) == 0).sum() == m
    pfn = port_rollout_fn(env, ppol, pm, m, t0 + 1, adapt_batch_size=A_BS)
    (p_states, (p_hobs, p_hact)), p_out = pfn.step_fn(
        pm.params, pm.normalizer, (p_states, (t(h_obs), t(h_act))), t0,
        None, candidates=t(cand))

    np.testing.assert_array_equal(p_out['observations'].numpy(),
                                  np.asarray(j_out['observations'][:, 0]))
    np.testing.assert_array_equal(p_out['actions'].numpy()[safe],
                                  np.asarray(j_out['actions'][safe, 0]))
    for k in ('next_observations', 'rewards', 'qpos', 'qvel'):
        np.testing.assert_allclose(p_out[k].numpy()[safe],
                                   np.asarray(j_out[k][safe, 0]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(p_hobs.numpy()[safe],
                               np.asarray(j_hobs)[safe], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(p_hact.numpy()[safe],
                                  np.asarray(j_hact)[safe])


def test_sampler_small_run_shapes_and_chain(tmp_path):
    """2 envs x 30 steps, 8 candidates x horizon 3, hidden (32,), adapt
    window 4: random then policy sampling, as tests/test_e2e.py checks, and
    the keys that sampler and sample processor log."""
    env = port_envs.normalize(port_envs.HalfCheetahEnv(
        task='cripple', reset_every_episode=True, device='cpu'))
    model = PortMetaMLP('dyn', env, hidden_sizes=(32,), batch_size=4,
                        inner_learning_rate=0.01, device='cpu')
    policy = PortMPC('policy', env, model, n_candidates=8, horizon=3)
    sampler = PortSampler(env, policy, num_rollouts=2, max_path_length=30,
                          adapt_batch_size=4, device='cpu')
    for random in (True, False):
        paths = sampler.obtain_samples(random=random)
        assert paths['observations'].shape == (2, 30, 20)
        assert paths['actions'].shape == (2, 30, 6)
        assert paths['rewards'].shape == (2, 30)
        for v in paths.values():
            assert np.isfinite(np.asarray(v)).all()
        np.testing.assert_allclose(paths['next_observations'][:, :-1],
                                   paths['observations'][:, 1:], rtol=1e-5)
        assert np.abs(paths['actions']).max() <= 1.0
        if random:
            obs, act, nxt = (torch.as_tensor(paths[k]) for k in
                             ('observations', 'actions', 'next_observations'))
            model.normalizer = PortNormalizer.fit(obs, act, nxt - obs)
    assert sampler.total_timesteps_sampled == 2 * 2 * 30
    assert port_fused.fused_mlp_forward.launches == 0
    samples = PortProcessor(recurrent=True).process_samples(paths)
    np.testing.assert_allclose(samples['returns'], paths['rewards'].sum(1))
    flat = PortProcessor(recurrent=False).process_samples(paths)
    assert flat['observations'].shape == (60, 20)
    port_log.configure(dir=str(tmp_path), format_strs=[])
    paths = sampler.obtain_samples(log=True, log_prefix='EnvSampler-')
    PortProcessor(recurrent=True).process_samples(paths, log=True,
                                                  log_prefix='EnvTrajs-')
    kvs = port_log.dumpkvs()
    assert list(kvs) == [
        'EnvSampler-TimeStepsCtr', 'EnvSampler-PolicyExecTime',
        'EnvSampler-EnvExecTime', 'EnvTrajs-AverageReturn',
        'EnvTrajs-MaxReturn', 'EnvTrajs-MinReturn', 'EnvTrajs-StdReturn']
    assert kvs['EnvSampler-TimeStepsCtr'] == 3 * 2 * 30
    assert kvs['EnvSampler-PolicyExecTime'] == sampler.last_seconds > 0
    assert kvs['EnvSampler-EnvExecTime'] == 0.0
    ret = paths['rewards'].sum(1)
    assert (kvs['EnvTrajs-AverageReturn'], kvs['EnvTrajs-MaxReturn'],
            kvs['EnvTrajs-MinReturn'], kvs['EnvTrajs-StdReturn']) == (
        float(ret.mean()), float(ret.max()), float(ret.min()),
        float(ret.std()))


def test_port_imports_no_jax():
    """Every port module and chip_smoke.py import without loading jax or
    the JAX package."""
    pkg = os.path.join(REPO, 'learning_to_adapt_torch')
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, '.').replace('.__init__', ''))
    code = ('import importlib, sys\n'
            f'for m in {sorted(mods) + ["chip_smoke"]!r}:\n'
            '    importlib.import_module(m)\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "learning_to_adapt_tpu")]\n'
            'assert not bad, bad\n'
            'print(len(sys.modules))\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20


def test_sampler_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is usable')
    env = port_envs.normalize(port_envs.HalfCheetahEnv(task=None,
                                                       device='cpu'))
    model = PortMetaMLP('dyn', env, hidden_sizes=(8,), device='cpu')
    policy = PortMPC('policy', env, model, n_candidates=4, horizon=2)
    with pytest.raises(RuntimeError, match='cuda'):
        PortSampler(env, policy, num_rollouts=1, max_path_length=5)
