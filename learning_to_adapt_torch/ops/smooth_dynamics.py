"""The smooth dynamics of a physics step as one CUDA launch.

csrc/smooth_dynamics.cu runs, for every env of a batch in one launch (one
block an env), what physics/engine.py's tensor code runs in ~1,000 small
launches: forward kinematics, mass properties, body velocities, RNE bias
forces, the CRBA mass matrix, and passive, actuator and applied forces
(`smooth_dynamics`, a dynamics pass), or forward kinematics and the
subtree COM quantities (`forward=True`, engine.forward). It replaces no
TPU kernel: the JAX package leaves this phase to XLA.

The plain version is the engine's tensor code (`engine._smooth_plain`,
`engine._forward_plain`); engine.smooth_dynamics and engine.forward send
CUDA tensors here and CPU tensors there. The kernel reads the model
through a table of its constants (`table`), built once per model, device
and dtype and kept on its ModelTensors; it takes trees up to MAX_BODIES
bodies (and as many dofs, joints, actuators and springs), and raises
ValueError above them before anything is built or launched.
"""
import ctypes

import numpy as np
import torch

from learning_to_adapt_torch.ops import build
from learning_to_adapt_torch.physics.spec import FREE, HINGE, SLIDE

#: the kernel's static limit on bodies (world included), dofs, joints,
#: actuators and stiff joints (csrc/smooth_dynamics.cu kMax)
MAX_BODIES = 32

#: the kernel's outputs, in the order of its C entry; the first nine are a
#: dynamics pass's, FORWARD_OUTPUTS forward's
OUTPUTS = ('xpos', 'xquat', 'ximat', 'xipos', 'body_vel', 'cdof',
           'qfrc_actuator', 'mass_mat', 'qfrc_smooth', 'subtree_com',
           'subtree_comvel')
FORWARD_OUTPUTS = ('xpos', 'xquat', 'ximat', 'qfrc_actuator', 'subtree_com',
                   'subtree_comvel')

_SCALARS = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def _table_type(scalar):
    """ctypes mirror of csrc/smooth_dynamics.cu Table<T>."""
    k = MAX_BODIES
    fields = [(n, ctypes.c_int) for n in (
        'nbody', 'nv', 'nq', 'nu', 'nstiff', 'nlevel')]
    fields += [('parent', ctypes.c_int * k),
               ('level_start', ctypes.c_int * (k + 1))]
    fields += [(n, ctypes.c_int * k) for n in (
        'level_body', 'body_jadr', 'body_jnum', 'jnt_type', 'jnt_qadr',
        'jnt_dadr')]
    fields += [(n, ctypes.c_uint32 * k) for n in (
        'body_dofs', 'body_subtree', 'dof_bodies', 'dof_upper')]
    fields += [(n, ctypes.c_int * k) for n in (
        'dof_vsrc', 'dof_body', 'stiff_dadr', 'stiff_qadr', 'act_dadr')]
    fields += [(n, scalar * w * k) for n, w in (
        ('body_pos', 3), ('body_quat', 4), ('body_ipos', 3),
        ('body_inertia', 9), ('jnt_axis', 3), ('jnt_pos', 3))]
    fields += [('jnt_ref', scalar * k), ('armature', scalar * k),
               ('a_grav', scalar * 6)]
    fields += [(n, scalar * k) for n in (
        'stiff_k', 'stiff_ref', 'act_lo', 'act_hi', 'act_gear')]
    return type('Table', (ctypes.Structure,), {'_fields_': fields})


_TABLE_TYPES = {dt: _table_type(c) for dt, c in _SCALARS.items()}


def check_model(model):
    """Raises ValueError where the model exceeds the kernel's limits."""
    stiff = sum(1 for ji in range(model.njnt) if
                model.jnt_stiffness[ji] > 0 and model.jnt_type[ji] != FREE)
    sizes = dict(nbody=model.nbody, nv=model.nv, njnt=model.njnt,
                 nu=model.nu, stiff_joints=stiff)
    over = {k: n for k, n in sizes.items() if n > MAX_BODIES}
    if over:
        raise ValueError(f'smooth_dynamics: {model.name} exceeds the '
                         f'kernel\'s limit of {MAX_BODIES} bodies, dofs, '
                         f'joints, actuators and stiff joints: {over}')
    bad = set(int(j) for j in model.jnt_type) - {FREE, HINGE, SLIDE}
    if bad:
        raise ValueError(f'smooth_dynamics: joint types {sorted(bad)}')


def _levels(model):
    depth = np.zeros(model.nbody, np.int64)
    for b in range(1, model.nbody):
        depth[b] = depth[int(model.body_parent[b])] + 1
    order = [b for d in range(1, int(depth.max(initial=0)) + 1)
             for b in range(1, model.nbody) if depth[b] == d]
    starts = np.searchsorted(depth[order], np.arange(1, depth.max(
        initial=0) + 2))
    return order, starts


def _bits(rows):
    """One bit set per row: bit j of entry i set where rows[i, j]."""
    return [sum(1 << int(j) for j in np.flatnonzero(r)) for r in
            np.asarray(rows, bool)]


def table(model, mt):
    """The model's Table on mt's device in mt's dtype (a uint8 tensor),
    built on first use and kept on mt."""
    tab = getattr(mt, 'smooth_table', None)
    if tab is not None:
        return tab
    check_model(model)
    tab = _TABLE_TYPES[mt.dtype]()

    def put(field, values):
        values = np.asarray(values)
        if values.size:
            dst = np.ctypeslib.as_array(getattr(tab, field))
            dst[:len(values)] = values

    tab.nbody, tab.nv = int(model.nbody), int(model.nv)
    tab.nq, tab.nu = int(model.nq), int(model.nu)
    order, starts = _levels(model)
    tab.nlevel = len(starts) - 1
    put('parent', model.body_parent)
    put('level_start', starts)
    put('level_body', order)
    joints = [ji for b in range(model.nbody) for ji in mt.body_joints[b]]
    put('body_jnum', [len(js) for js in mt.body_joints])
    put('body_jadr', np.cumsum([0] + [len(js) for js in mt.body_joints])[:-1])
    put('jnt_type', model.jnt_type[joints])
    put('jnt_qadr', model.jnt_qposadr[joints])
    put('jnt_dadr', model.jnt_dofadr[joints])
    put('jnt_axis', model.jnt_axis[joints])
    put('jnt_pos', model.jnt_pos[joints])
    put('jnt_ref', model.jnt_ref[joints])
    put('body_dofs', _bits(model.body_dof))
    put('body_subtree', _bits(model.body_ancestor))
    put('dof_bodies', _bits(np.asarray(model.body_dof).T))
    put('dof_upper', _bits(np.asarray(model.dof_ancestor).T))
    put('dof_vsrc', model.dof_vsrc)
    put('dof_body', model.dof_body)
    stiff = [ji for ji in range(model.njnt) if model.jnt_stiffness[ji] > 0
             and model.jnt_type[ji] != FREE]
    tab.nstiff = len(stiff)
    put('stiff_dadr', model.jnt_dofadr[stiff])
    put('stiff_qadr', model.jnt_qposadr[stiff])
    put('stiff_k', model.jnt_stiffness[stiff])
    put('stiff_ref', model.jnt_springref[stiff])
    put('act_dadr', model.act_dofadr)
    put('act_lo', model.act_ctrlrange[:, 0])
    put('act_hi', model.act_ctrlrange[:, 1])
    put('act_gear', model.act_gear)
    put('body_pos', model.body_pos)
    put('body_quat', model.body_quat)
    put('body_ipos', model.body_ipos)
    put('body_inertia', np.reshape(model.body_inertia, (-1, 9)))
    put('armature', model.dof_armature)
    put('a_grav', np.concatenate([np.zeros(3), -np.asarray(model.gravity,
                                                           np.float64)]))
    raw = torch.frombuffer(bytearray(bytes(tab)), dtype=torch.uint8)
    mt.smooth_table = raw.to(mt.device)
    return mt.smooth_table


def _lib():
    lib = build.load('smooth_dynamics')
    if not getattr(lib, '_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smooth_dynamics.argtypes = [p, i, i, i] + [p] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(p), p]
        lib.smooth_dynamics.restype = i
        lib.smooth_table_bytes.argtypes = [i]
        lib.smooth_table_bytes.restype = i
        for dt, tab_type in _TABLE_TYPES.items():
            size = lib.smooth_table_bytes(torch.finfo(dt).bits // 8)
            if size != ctypes.sizeof(tab_type):
                raise RuntimeError(f'smooth_dynamics: the kernel\'s table is '
                                   f'{size} bytes in {dt}, the wrapper\'s '
                                   f'{ctypes.sizeof(tab_type)}')
        lib._typed = True
    return lib


def _rows(x, n_envs, shape, dtype, device, name):
    """x as the kernel reads it, and its env stride in elements: each env's
    row contiguous, and one row every env shares (stride 0) or one an env
    (other layouts are copied)."""
    if tuple(x.shape) != (n_envs,) + shape:
        raise ValueError(f'smooth_dynamics: {name} has shape '
                         f'{tuple(x.shape)}, not {(n_envs,) + shape}')
    if x.dtype != dtype:
        raise TypeError(f'smooth_dynamics: {name} is {x.dtype}, qpos {dtype}')
    if x.device != device:
        raise ValueError(f'smooth_dynamics: {name} is on {x.device}, qpos '
                         f'on {device}')
    inner = int(np.prod(shape))
    dense, step = True, 1
    for n, st in zip(reversed(shape), reversed(x.stride()[1:])):
        dense &= n == 1 or st == step
        step *= n
    if not (dense and (n_envs == 1 or x.stride(0) in (0, inner))):
        x = x.contiguous()
    return x, (x.stride(0) if n_envs > 1 else 0)


def smooth_dynamics(model, mt, mm, qpos, qvel, ctrl, forward=False):
    """One launch for the env batch of qpos (E, nq) and qvel (E, nv) on a
    CUDA device, float32 or float64, with ctrl (E, nu) (None: no actuator
    force) and mm's body_mass, dof_damping and xfrc_applied. Returns the
    dict of OUTPUTS (dynamics pass) or FORWARD_OUTPUTS (forward=True), in
    the shapes of the tensor code's."""
    tab = table(model, mt)      # raises above the limits
    if not qpos.is_cuda:
        raise ValueError(f'smooth_dynamics: the kernel takes CUDA tensors, '
                         f'qpos is on {qpos.device}')
    dtype, device = qpos.dtype, qpos.device
    if dtype not in _SCALARS:
        raise TypeError(f'smooth_dynamics: the kernel takes float32 or '
                        f'float64, qpos is {dtype}')
    n_envs, nb, nv = qpos.shape[0], model.nbody, model.nv
    ins = [_rows(qpos, n_envs, (model.nq,), dtype, device, 'qpos'),
           _rows(qvel, n_envs, (nv,), dtype, device, 'qvel'),
           (None, 0) if ctrl is None else
           _rows(ctrl, n_envs, (model.nu,), dtype, device, 'ctrl'),
           _rows(mm.body_mass, n_envs, (nb,), dtype, device, 'body_mass'),
           _rows(mm.dof_damping, n_envs, (nv,), dtype, device,
                 'dof_damping'),
           _rows(mm.xfrc_applied, n_envs, (nb, 6), dtype, device,
                 'xfrc_applied')]
    shapes = dict(xpos=(nb, 3), xquat=(nb, 4), ximat=(nb, 3, 3),
                  xipos=(nb, 3), body_vel=(nb, 6), cdof=(nv, 6),
                  qfrc_actuator=(nv,), mass_mat=(nv, nv), qfrc_smooth=(nv,),
                  subtree_com=(nb, 3), subtree_comvel=(nb, 3))
    names = FORWARD_OUTPUTS if forward else OUTPUTS[:9]
    out = {k: torch.empty((n_envs,) + shapes[k], dtype=dtype, device=device)
           for k in names}
    if n_envs == 0:                      # nothing to compute or launch
        return out
    lib = _lib()
    p = ctypes.c_void_p
    ptrs = [None if x is None else x.data_ptr() for x, _ in ins]
    strides = (ctypes.c_longlong * 6)(*(s for _, s in ins))
    outs = (p * len(OUTPUTS))(*(out[k].data_ptr() if k in out else None
                                for k in OUTPUTS))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = lib.smooth_dynamics(tab.data_ptr(), torch.finfo(dtype).bits // 8,
                                 int(forward), n_envs, *ptrs, strides, outs,
                                 stream)
    build.check(rc, 'smooth_dynamics')
    smooth_dynamics.launches += 1
    return out


#: launches since the count was last set to 0 (both variants)
smooth_dynamics.launches = 0
