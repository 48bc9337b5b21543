"""The smooth-dynamics kernel (ops/smooth_dynamics.py, csrc/
smooth_dynamics.cu) and its dispatch in physics/engine.py.

On the CPU (tier-1): CPU tensors take the plain tensor code with no
launch, bit for bit; a model over the kernel's static limits raises
ValueError before anything is built or launched; the model table and the
wrapper's input layouts; the 'physics.smooth' spans. Marked `cuda` (skip
without a card; no jax imported here): the kernel against the plain tensor
code on the card for every model of envs/model_defs.py, both variants, E
in {1, 5, 64}, float32 and float64, and inside a captured env step (its
launches counted once a replay, no host sync). On a machine with a card:

    python -m pytest --noconftest tests/test_torch_smooth_kernel.py -m cuda -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from learning_to_adapt_torch.envs.model_defs import get_model
from learning_to_adapt_torch.ops import smooth_dynamics as smooth_kernel
from learning_to_adapt_torch.physics import engine, spec
from learning_to_adapt_torch.utils import tracing

MODELS = ['half_cheetah', 'half_cheetah_hfield', 'half_cheetah_blocks',
          'arm_7dof', 'ant']
AUX = ('xpos', 'xquat', 'ximat', 'cdof', 'xipos', 'body_vel',
       'qfrc_actuator')
FORWARD = ('xpos', 'xquat', 'ximat', 'subtree_com', 'subtree_comvel',
           'qfrc_actuator')
# largest difference, over the largest magnitude of the tensor (at least
# 1), between the kernel and the plain tensor code on the same inputs:
# the same formulas, summed in another order and with fused multiply-adds,
# a few dozen roundings of 2^-24 in float32 and of 2^-53 in float64 (an
# H100 read at most 7.6e-7 and 1.1e-15 over these cases)
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _state(model, n_envs, dtype, device, seed):
    """Random qpos, qvel and ctrl around the reference pose (ctrl partly
    outside the control range), and a MutableModel perturbed per env as a
    task writes it: body masses scaled, damping raised, wrenches applied."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    qpos = t(model.qpos0[None] + 0.5 * rng.normal(size=(n_envs, model.nq)))
    qvel = t(3.0 * rng.normal(size=(n_envs, model.nv)))
    ctrl = t(1.5 * rng.normal(size=(n_envs, model.nu)))
    mm = spec.batched_mutable(spec.default_mutable(model), n_envs, device,
                              dtype)
    mm = dataclasses.replace(
        mm, body_mass=mm.body_mass * t(rng.uniform(
            0.5, 1.5, size=(n_envs, model.nbody))),
        dof_damping=mm.dof_damping + t(rng.uniform(
            0.0, 2.0, size=(n_envs, model.nv))),
        xfrc_applied=t(rng.normal(size=(n_envs, model.nbody, 6))))
    return engine.PhysicsState(qpos, qvel), ctrl, mm


def _chain(n_bodies):
    """A chain of n_bodies - 1 hinged capsules below the world."""
    body = None
    for k in reversed(range(n_bodies - 1)):
        body = spec.BodySpec(
            name=f'b{k}', pos=(0.0, 0.0, -0.1),
            joints=[spec.JointSpec(type=spec.HINGE, name=f'j{k}',
                                   axis=(0.0, 1.0, 0.0))],
            geoms=[spec.GeomSpec(type=spec.CAPSULE, size=(0.02,),
                                 fromto=(0, 0, 0, 0, 0, -0.1))],
            children=[body] if body is not None else [])
    return spec.compile_spec(spec.ModelSpec(name=f'chain{n_bodies}',
                                            bodies=[body]))


# ------------------------------------------------------------- the CPU
@pytest.mark.parametrize('name', MODELS)
def test_cpu_tensors_take_the_plain_path(name):
    """On the CPU engine.smooth_dynamics and engine.forward are the tensor
    code, bit for bit, and nothing is launched."""
    model = get_model(name)
    state, ctrl, mm = _state(model, 3, torch.float64, 'cpu', seed=1)
    before = smooth_kernel.smooth_dynamics.launches
    got = engine.smooth_dynamics(model, mm, state, ctrl)
    want = engine._smooth_plain(model, mm, state, ctrl)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].keys() == want[2].keys() == set(AUX)
    for k in AUX:
        assert torch.equal(got[2][k], want[2][k])
    for c in (ctrl, None):
        fwd = engine.forward(model, mm, state, c)
        ref = engine._forward_plain(model, mm, state, c)
        for k in FORWARD:
            assert torch.equal(getattr(fwd, k), getattr(ref, k))
    assert smooth_kernel.smooth_dynamics.launches == before


@pytest.mark.parametrize('n_bodies', [33, 40])
def test_models_over_the_limits_raise_before_any_launch(n_bodies):
    """A tree over the kernel's 32 bodies or dofs raises ValueError from
    the wrapper and from the table, before any build or launch; the
    engine's CPU path still runs it; the largest model fits."""
    model = _chain(n_bodies)
    assert model.nbody == n_bodies and model.nv == n_bodies - 1
    mt = engine.model_tensors(model, 'cpu', torch.float32)
    state, ctrl, mm = _state(model, 2, torch.float32, 'cpu', seed=2)
    before = smooth_kernel.smooth_dynamics.launches
    with pytest.raises(ValueError, match='limit of 32'):
        smooth_kernel.smooth_dynamics(model, mt, mm, state.qpos, state.qvel,
                                      ctrl)
    with pytest.raises(ValueError, match='limit of 32'):
        smooth_kernel.table(model, mt)
    assert mt.smooth_table is None
    assert smooth_kernel.smooth_dynamics.launches == before
    mass_mat, _, _ = engine.smooth_dynamics(model, mm, state, ctrl)
    assert mass_mat.shape == (2, n_bodies - 1, n_bodies - 1)
    smooth_kernel.check_model(_chain(32))
    for name in MODELS:
        smooth_kernel.check_model(get_model(name))


def test_the_kernel_takes_cuda_tensors_only():
    """The wrapper refuses tensors that are not on a card."""
    model = get_model('ant')
    mt = engine.model_tensors(model, 'cpu', torch.float32)
    state, ctrl, mm = _state(model, 2, torch.float32, 'cpu', seed=3)
    before = smooth_kernel.smooth_dynamics.launches
    with pytest.raises(ValueError, match='CUDA tensors'):
        smooth_kernel.smooth_dynamics(model, mt, mm, state.qpos, state.qvel,
                                      ctrl, forward=True)
    assert smooth_kernel.smooth_dynamics.launches == before


@pytest.mark.parametrize('name', MODELS)
def test_model_table(name):
    """The table the kernel reads (built on the CPU here, as on the card):
    every body once in the level order, each after its parent; each body's
    joints in order; the masks as bit sets of the model's bool matrices;
    the constants at their places."""
    model = get_model(name)
    mt = engine.model_tensors(model, 'cpu', torch.float64)
    raw = smooth_kernel.table(model, mt)
    assert smooth_kernel.table(model, mt) is raw
    tab = smooth_kernel._TABLE_TYPES[torch.float64].from_buffer_copy(
        raw.numpy().tobytes())
    assert (tab.nbody, tab.nv, tab.nq, tab.nu) == (
        model.nbody, model.nv, model.nq, model.nu)
    order = list(tab.level_body)[:model.nbody - 1]
    assert sorted(order) == list(range(1, model.nbody))
    starts = list(tab.level_start)[:tab.nlevel + 1]
    assert starts[0] == 0 and starts[-1] == model.nbody - 1
    level = {b: lv for lv in range(tab.nlevel)
             for b in order[starts[lv]:starts[lv + 1]]}
    for b in order:
        p = int(model.body_parent[b])
        assert p == tab.parent[b] and (p == 0 or level[p] < level[b])
    for b in range(model.nbody):
        js = range(tab.body_jadr[b], tab.body_jadr[b] + tab.body_jnum[b])
        assert [tab.jnt_qadr[j] for j in js] == [
            int(model.jnt_qposadr[ji]) for ji in mt.body_joints[b]]

    def bits(field, n):
        return np.array([[(getattr(tab, field)[i] >> j) & 1
                          for j in range(n)] for i in range(
                              len(getattr(tab, field)))], bool)
    nb, nv = model.nbody, model.nv
    assert (bits('body_dofs', nv)[:nb] == model.body_dof).all()
    assert (bits('body_subtree', nb)[:nb] == model.body_ancestor).all()
    assert (bits('dof_bodies', nb)[:nv] == model.body_dof.T).all()
    assert (bits('dof_upper', nv)[:nv] == model.dof_ancestor.T).all()
    assert np.array_equal(np.ctypeslib.as_array(tab.body_inertia)[:nb],
                          model.body_inertia.reshape(-1, 9))
    assert np.array_equal(np.ctypeslib.as_array(tab.a_grav)[3:],
                          -model.gravity)
    assert np.array_equal(np.ctypeslib.as_array(tab.act_gear)[:model.nu],
                          model.act_gear)


def test_input_layouts():
    """_rows keeps a row shared by every env (stride 0) and dense rows,
    copies other layouts, and refuses a wrong shape, dtype or device."""
    dense = torch.arange(12.0).reshape(3, 4)
    shared = torch.arange(4.0)[None].expand(3, 4)
    sliced = torch.arange(24.0).reshape(3, 8)[:, ::2]
    x, s = smooth_kernel._rows(dense, 3, (4,), torch.float32, dense.device,
                               'x')
    assert x is dense and s == 4
    x, s = smooth_kernel._rows(shared, 3, (4,), torch.float32, dense.device,
                               'x')
    assert x is shared and s == 0
    x, s = smooth_kernel._rows(sliced, 3, (4,), torch.float32, dense.device,
                               'x')
    assert x.is_contiguous() and torch.equal(x, sliced) and s == 4
    x, s = smooth_kernel._rows(sliced[:1], 1, (4,), torch.float32,
                               dense.device, 'x')
    assert x.is_contiguous() and s == 0
    frc = torch.zeros(5, 6)[None].expand(3, 5, 6)   # batched_mutable's
    assert smooth_kernel._rows(frc, 3, (5, 6), torch.float32, frc.device,
                               'x') == (frc, 0)
    frc = torch.zeros(6)[None, None].expand(3, 5, 6)  # rows not dense
    x, s = smooth_kernel._rows(frc, 3, (5, 6), torch.float32, frc.device,
                               'x')
    assert x.is_contiguous() and s == 30
    with pytest.raises(ValueError, match='shape'):
        smooth_kernel._rows(dense, 3, (5,), torch.float32, dense.device, 'x')
    with pytest.raises(TypeError, match='float64'):
        smooth_kernel._rows(dense.double(), 3, (4,), torch.float32,
                            dense.device, 'x')
    with pytest.raises(ValueError, match='meta'):
        smooth_kernel._rows(dense.to('meta'), 3, (4,), torch.float32,
                            dense.device, 'x')


@pytest.fixture
def traced():
    tracing.reset()
    tracing.enable(True)
    yield
    tracing.enable(False)
    tracing.reset()


def test_smooth_spans(traced):
    """Each dynamics pass holds one 'physics.smooth' span and the env's
    forward pass is one: 5 an Ant env step (RK4), 4 of them in
    'physics.qacc'; 2 a HalfCheetah one (Euler)."""
    from learning_to_adapt_torch import envs
    for cls, passes in ((envs.AntEnv, 4), (envs.HalfCheetahEnv, 1)):
        env = cls(device='cpu')
        state = env.reset(2)
        tracing.reset()
        env.step(state, torch.zeros((2, env.act_dim)))
        recs = tracing.records()
        smooth = [r for r in recs if r.name == 'physics.smooth']
        parents = [recs[r.parent].name if r.parent is not None else None
                   for r in smooth]
        assert parents.count('physics.qacc') == passes
        assert len(smooth) == passes + 1


# ------------------------------------------------------------- the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _close(got, want, dtype, what):
    err = float((got - want).abs().max() /
                want.abs().max().clamp(min=1.0)) if want.numel() else 0.0
    assert err <= TOL[dtype], f'{what}: {err:.3g} > {TOL[dtype]}'
    return err


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_envs', [1, 5, 64])
@pytest.mark.parametrize('name', MODELS)
def test_kernel_matches_plain(dev, name, n_envs, dtype):
    """Both variants against the plain tensor code on the same CUDA
    tensors: M, qfrc_smooth and every aux tensor; every ForwardData
    tensor, with ctrl and without. One launch each."""
    model = get_model(name)
    state, ctrl, mm = _state(model, n_envs, dtype, dev, seed=n_envs)
    before = smooth_kernel.smooth_dynamics.launches
    mass_mat, qfrc, aux = engine.smooth_dynamics(model, mm, state, ctrl)
    torch.cuda.synchronize(dev)
    assert smooth_kernel.smooth_dynamics.launches == before + 1
    ref_m, ref_f, ref_aux = engine._smooth_plain(model, mm, state, ctrl)
    errs = {'mass_mat': _close(mass_mat, ref_m, dtype, 'mass_mat'),
            'qfrc_smooth': _close(qfrc, ref_f, dtype, 'qfrc_smooth')}
    assert aux.keys() == ref_aux.keys()
    for k in AUX:
        assert aux[k].shape == ref_aux[k].shape and aux[k].is_contiguous()
        errs[k] = _close(aux[k], ref_aux[k], dtype, k)
    for c in (ctrl, None):
        fwd = engine.forward(model, mm, state, c)
        ref = engine._forward_plain(model, mm, state, c)
        for k in FORWARD:
            errs['fwd.' + k] = _close(getattr(fwd, k), getattr(ref, k),
                                      dtype, 'forward ' + k)
    torch.cuda.synchronize(dev)
    assert smooth_kernel.smooth_dynamics.launches == before + 3
    worst = max(errs, key=errs.get)
    print(f'{name} E={n_envs} {dtype}: worst {worst} {errs[worst]:.3g}')


@pytest.mark.cuda
@pytest.mark.parametrize('name,launches', [('AntEnv', 5),
                                           ('HalfCheetahEnv', 2)])
def test_captured_env_step(dev, name, launches):
    """An env step captured as a CUDA graph (models/captured.py StepGraph)
    launches the kernel once a dynamics pass and once for its forward (the
    Ant's RK4: 5; HalfCheetah's Euler: 2), counted at each replay; neither
    the eager step nor the replays wait for the card; a replay gives the
    eager step's result."""
    from learning_to_adapt_torch import envs
    from learning_to_adapt_torch.models import captured
    env = getattr(envs, name)(task='cripple', device=dev)
    state = env.reset(5, episode_idx=1,
                      generator=torch.Generator(dev).manual_seed(0))
    action = torch.rand((5, env.act_dim), device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    action = 2 * action - 1
    out = {}

    def step():
        out['obs'] = env.step(state, action)[1]
    step()                          # builds the table and the kernel
    want = out['obs'].clone()
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode('error')
    try:
        before = smooth_kernel.smooth_dynamics.launches
        step()
        assert smooth_kernel.smooth_dynamics.launches == before + launches
    finally:
        torch.cuda.set_sync_debug_mode('default')
    graph = captured.StepGraph(step, dev)
    graph.capture(lambda: None)
    assert graph.kernels['smooth_dynamics'] == launches
    before = captured.kernel_counts()['smooth_dynamics']
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(3):
            graph()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert captured.kernel_counts()['smooth_dynamics'] == \
        before + 3 * launches
    torch.cuda.synchronize(dev)
    torch.testing.assert_close(out['obs'], want, rtol=0, atol=0)
