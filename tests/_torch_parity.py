"""Shared set-up of the parity tests between the JAX package and its
PyTorch port (tests/test_torch_*.py): both packages get the same inputs,
made with numpy from a seed, and random draws are taken from the JAX side.
"""
import dataclasses

import numpy as np
import torch

from learning_to_adapt_torch.physics import engine as port_engine

F32_STEP_TOL = dict(rtol=1e-4, atol=1e-4)  # one f32 step, other op order
F64_STEP_TOL = dict(rtol=1e-10, atol=1e-10)


def contact_states(model, n_envs, seed):
    """(qpos, qvel) float64 arrays near the reference pose, lowered so the
    cheetah's capsules touch the floor (contact and limit rows active)."""
    rng = np.random.RandomState(seed)
    qpos = model.qpos0[None] + 0.1 * rng.randn(n_envs, model.nq)
    qpos[:, 1] = -0.05 + 0.02 * rng.randn(n_envs)
    qvel = rng.randn(n_envs, model.nv)
    return qpos, qvel


def jax_params_numpy(params):
    return {k: [np.asarray(a) for a in params[k]] for k in ('w', 'b')}


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def capture_solves(fn):
    """(fn(), the arguments of every engine.jacobi_solve call it made)."""
    captured = []
    solve = port_engine.jacobi_solve

    def capture(*args):
        captured.append(args)
        return solve(*args)
    port_engine.jacobi_solve = capture
    try:
        out = fn()
    finally:
        port_engine.jacobi_solve = solve
    return out, captured


def assert_models_equal(pm, jm, name):
    """Every PhysicsModel field of the port's model equals the JAX
    package's: floats to rtol 1e-9 (the compile-time invweights come from
    each package's own engine), the rest exactly."""
    for f in dataclasses.fields(jm):
        a, b = getattr(pm, f.name), getattr(jm, f.name)
        msg = f'{name}: {f.name}'
        if f.name == 'pair_groups':
            assert [k for k, _ in a] == [k for k, _ in b], msg
            for (_, pa), (_, pb) in zip(a, b):
                np.testing.assert_array_equal(pa, pb, err_msg=msg)
        elif isinstance(b, np.ndarray) and b.dtype.kind == 'f':
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                       err_msg=msg)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=msg)
        else:
            assert a == b, msg


def tiny_snapshot(root, algo, exp_name='tiny', **kw):
    """Trains a port snapshot at test size through its entry point on the
    CPU (2 envs x 20 steps, 8 candidates x horizon 3, 2 iterations; GrBAL
    with a (32, 32) meta-MLP and a 4-step window, MB-MPC with (32,), ReBAL
    with an LSTM (16,)) in root/data/<algo>_torch/<exp_name>, and returns
    that directory. kw overrides the config (e.g. cripple_set)."""
    import importlib
    import os
    from learning_to_adapt_torch.utils import logging as port_log
    module = importlib.import_module(f'learning_to_adapt_torch.run_{algo}')
    size = {'grbal': dict(hidden_sizes_model=(32, 32), adapt_batch_size=4,
                          meta_batch_size=4),
            'mb_mpc': dict(hidden_sizes=(32,), batch_size=16),
            'rebal': dict(hidden_sizes=(16,), batch_size=2,
                          backprop_steps=10)}[algo]
    cfg = dict(module.config, task='cripple', device='cpu', exp_name=exp_name,
               n_itr=2, max_path_length=20, num_rollouts=2, n_candidates=8,
               horizon=3, dynamic_model_epochs=2, **size)
    cfg.update(kw)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        module.run_experiment(cfg)
    finally:
        port_log.Logger.CURRENT.close()
        port_log.Logger.CURRENT = None
        os.chdir(cwd)
    return os.path.join(root, 'data', module.ENTRY.exp_name, exp_name)


def recorded_rollouts(monkeypatch, module):
    """Wraps module.rollout: returns the list that gains, for every call,
    (the model's inner learning rate or None, the paths)."""
    calls = []
    inner = module.rollout

    def rollout(env, policy, model, **kw):
        paths = inner(env, policy, model, **kw)
        calls.append((getattr(model, 'inner_learning_rate', None), paths))
        return paths
    monkeypatch.setattr(module, 'rollout', rollout)
    return calls
