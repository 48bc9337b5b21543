"""Articulated rigid-body dynamics, batched over a leading env axis.

Counterpart of learning_to_adapt_tpu/physics/engine.py: free, hinge and
slide joints, every narrow-phase pair kind of physics/collision.py,
MuJoCo-style soft constraints solved by projected Jacobi (the kernels in
ops/jacobi.py) or, where a model asks for it, projected Gauss-Seidel in
plain tensor ops, and the semi-implicit Euler and RK4 integrators. Where
the JAX engine is written for one env and vmapped, every function here
takes (E, ...) tensors: qpos (E, nq), qvel (E, nv), ctrl (E, nu) and a
MutableModel whose fields carry the env axis too.

Pipeline per step (world-frame Pluecker spatial algebra, about the origin):
  1. forward kinematics -> body frames, per-dof motion subspace `cdof`
  2. body spatial velocities, bias forces (RNE), mass matrix (CRBA)
  3. narrow-phase collisions on the static candidate-pair list
  4. soft-constraint assembly (contacts + joint limits) and projected Jacobi
  5. semi-implicit Euler with implicit joint damping, or RK4 (1-4 run four
     times a step)
Steps 1-2 with the passive, actuator and applied forces (`smooth_dynamics`),
and the forward pass the envs read (`forward`), are one launch each of the
kernel of ops/smooth_dynamics.py on CUDA tensors; on CPU tensors they are
the tensor code `_smooth_plain` and `_forward_plain`, the kernel's plain
version.

Everything static about a model — its constants as device tensors and the
row structure of its constraint system, which the JAX engine builds in
numpy at trace time — is built once per (model, device, dtype) by
`model_tensors` and cached, so a step does no host-side work beyond issuing
its tensor operations and never waits for the device.

Each dynamics pass (`_qacc`: smooth dynamics, the constraint solve, the
Cholesky solve) is the span 'physics.qacc' (utils/tracing.py; stamped on
the device inside a captured step), its smooth dynamics and each forward
pass the span 'physics.smooth'; a pass counts one in the counter
'physics.passes': at its call where it runs eagerly, at every replay of a
captured step that holds it (models/captured.py StepGraph), as the
passes the step's capture made (`_qacc.passes` counts every call).
"""
import weakref
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from learning_to_adapt_torch.ops import smooth_dynamics as smooth_kernel
from learning_to_adapt_torch.ops.jacobi import jacobi_solve
from learning_to_adapt_torch.physics import collision as coll
from learning_to_adapt_torch.physics import maths
from learning_to_adapt_torch.physics.spec import (
    EULER, FREE, HINGE, RK4, SLIDE, MutableModel, PhysicsModel)
from learning_to_adapt_torch.utils import tracing


#: dynamics passes per physics step by integrator, each with its constraint
#: solve (one Jacobi launch)
PASSES = {EULER: 1, RK4: 4}


@dataclass
class PhysicsState:
    qpos: Any  # (E, nq)
    qvel: Any  # (E, nv)


@dataclass
class ForwardData:
    """Quantities derived from (qpos, qvel) that envs read for obs/reward."""
    xpos: Any           # (E, nbody, 3) body frame origins, world
    xquat: Any          # (E, nbody, 4)
    ximat: Any          # (E, nbody, 3, 3) rotation matrices
    subtree_com: Any    # (E, nbody, 3)
    subtree_comvel: Any # (E, nbody, 3)
    qfrc_actuator: Any  # (E, nv)


class ModelTensors:
    """A PhysicsModel's constants on one device in one dtype, plus the
    static structure of its constraint rows (MuJoCo pyramidal contacts and
    joint limits), in the row order of engine.py constraint_forces: limit
    rows, then frictionless contacts, then 4 pyramid facets per contact."""

    def __init__(self, model: PhysicsModel, device, dtype):
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def ix(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.device, self.dtype = device, dtype
        self.body_pos = t(model.body_pos)
        self.body_quat = t(model.body_quat)
        self.jnt_axis = t(model.jnt_axis)
        self.jnt_pos = t(model.jnt_pos)
        self.body_joints = [[] for _ in range(model.nbody)]
        for ji in range(model.njnt):
            self.body_joints[int(model.jnt_body[ji])].append(ji)
        self.body_ipos = t(model.body_ipos)
        self.body_inertia = t(model.body_inertia)
        self.body_dof = t(model.body_dof)
        self.body_ancestor = t(model.body_ancestor)
        self.dof_ancestor = t(model.dof_ancestor)
        self.dof_armature = torch.diag(t(model.dof_armature))
        self.dof_vsrc = ix(model.dof_vsrc)
        self.dof_body = ix(model.dof_body)
        self.a_grav = torch.cat([torch.zeros(3, dtype=dtype, device=device),
                                 -t(model.gravity)])
        stiff = [ji for ji in range(model.njnt)
                 if model.jnt_stiffness[ji] > 0 and model.jnt_type[ji] != FREE]
        self.stiff_dadr = ix([model.jnt_dofadr[ji] for ji in stiff])
        self.stiff_qadr = ix([model.jnt_qposadr[ji] for ji in stiff])
        self.stiff_k = t([model.jnt_stiffness[ji] for ji in stiff])
        self.stiff_ref = t([model.jnt_springref[ji] for ji in stiff])
        self.act_lo = t(model.act_ctrlrange[:, 0])
        self.act_hi = t(model.act_ctrlrange[:, 1])
        self.act_gear = t(model.act_gear)
        self.act_dofadr = ix(model.act_dofadr)
        self.geom_body = ix(model.geom_body)
        self.geom_mat = maths.quat_to_mat(t(model.geom_quat))
        # constants a step needs: kept here because torch.tensor(..., device=
        # 'cuda') inside a step would copy from the host and wait for the card
        self.quat_identity = t([1., 0., 0., 0.])
        self.unit_x, self.unit_y = t([1., 0., 0.]), t([0., 1., 0.])
        self.free_cdof_lin = torch.cat([torch.zeros((3, 3), dtype=dtype,
                                                    device=device),
                                        torch.eye(3, dtype=dtype,
                                                  device=device)], dim=-1)
        # position integration in qpos order: a free joint's 7 coordinates
        # take 6 dofs, so the addresses split at each free joint into runs
        # of scalar (hinge, slide) joints, each a gather of its dofs
        self.q_runs = []
        for ji in np.argsort(model.jnt_qposadr, kind='stable'):
            qadr, dadr = int(model.jnt_qposadr[ji]), int(model.jnt_dofadr[ji])
            if model.jnt_type[ji] == FREE:
                self.q_runs.append((FREE, qadr, dadr))
            elif self.q_runs and self.q_runs[-1][0] != FREE:
                self.q_runs[-1][2].append(dadr)
            else:
                self.q_runs.append((HINGE, qadr, [dadr]))
        self.q_runs = [(kind, qadr, d if kind == FREE else ix(d))
                       for kind, qadr, d in self.q_runs]
        # the constraint rows need the compile-time weights, which
        # spec._with_invweights computes with smooth_dynamics alone
        #: the smooth-dynamics kernel's model table, built at its first
        #: launch (ops/smooth_dynamics.py table)
        self.smooth_table = None
        self.nrows = None
        if model.dof_invweight0 is not None:
            self._constraint_structure(model, t, ix)

    def _constraint_structure(self, model, t, ix):
        # joint limit rows: two per limited joint; J is a constant +-one-hot
        lim_qadr, lim_sign, lim_bound, lim_j, lim_dadr = [], [], [], [], []
        solref, solimp, da = [], [], []
        for ji in range(model.njnt):
            if not model.jnt_limited[ji] or model.jnt_type[ji] == FREE:
                continue
            qadr, dadr = int(model.jnt_qposadr[ji]), int(model.jnt_dofadr[ji])
            lo, hi = model.jnt_range[ji]
            for sign, bound in ((1.0, lo), (-1.0, hi)):
                lim_qadr.append(qadr)
                lim_sign.append(sign)
                lim_bound.append(bound)
                lim_dadr.append(dadr)
                row = np.zeros(model.nv)
                row[dadr] = sign
                lim_j.append(row)
                solref.append(model.jnt_solref_limit[ji])
                solimp.append(model.jnt_solimp_limit[ji])
                da.append(model.dof_invweight0[dadr])
        self.nlim = len(lim_qadr)
        self.lim_qadr = ix(lim_qadr)
        self.lim_sign = t(lim_sign)
        self.lim_bound = t(lim_bound)
        self.lim_j = t(np.reshape(lim_j, (-1, model.nv)))

        # contact candidates: per pair group, its geoms and points per pair
        self.pair_groups = []
        meta = dict(body1=[], body2=[], mu=[], solref=[], solimp=[],
                    margin=[], condim=[])
        for kind, pairs in model.pair_groups:
            n_pts = coll.POINTS[kind]
            self.pair_groups.append((kind, ix(pairs[:, 0]), ix(pairs[:, 1])))
            for g1, g2 in pairs:
                g1, g2 = int(g1), int(g2)
                for _ in range(n_pts):
                    meta['body1'].append(int(model.geom_body[g1]))
                    meta['body2'].append(int(model.geom_body[g2]))
                    meta['mu'].append(max(model.geom_friction[g1][0],
                                          model.geom_friction[g2][0]))
                    meta['solref'].append(0.5 * (model.geom_solref[g1] +
                                                 model.geom_solref[g2]))
                    meta['solimp'].append(0.5 * (model.geom_solimp[g1] +
                                                 model.geom_solimp[g2]))
                    meta['margin'].append(model.geom_margin[g1] +
                                          model.geom_margin[g2])
                    meta['condim'].append(max(int(model.geom_condim[g1]),
                                              int(model.geom_condim[g2])))
        meta = {k: np.asarray(v) for k, v in meta.items()}
        self.ncon = len(meta['body1'])
        if self.ncon:
            bd = model.body_dof.astype(np.float64)
            self.mask_diff = t(bd[meta['body2']] - bd[meta['body1']])
            self.margin = t(meta['margin'])
            w12 = (model.body_invweight0[meta['body1']] +
                   model.body_invweight0[meta['body2']])
            one_c = np.nonzero(meta['condim'] < 3)[0]
            pyr_c = np.nonzero(meta['condim'] >= 3)[0]
            self.one_c = ix(one_c) if one_c.size else None
            self.pyr_c = ix(pyr_c) if pyr_c.size else None
            if one_c.size:
                solref.extend(list(meta['solref'][one_c]))
                solimp.extend(list(meta['solimp'][one_c]))
                da.extend(list(w12[one_c]))
            if pyr_c.size:
                self.mu_pyr = t(meta['mu'][pyr_c])[:, None]
                solref.extend(list(np.repeat(meta['solref'][pyr_c], 4,
                                             axis=0)))
                solimp.extend(list(np.repeat(meta['solimp'][pyr_c], 4,
                                             axis=0)))
                mu = meta['mu'][pyr_c]
                da.extend(list(np.repeat(
                    2.0 * mu ** 2 * (1.0 + mu ** 2) * w12[pyr_c], 4)))
        self.nrows = len(da)
        self.solref = t(np.reshape(solref, (-1, 2)))
        self.solimp = t(np.reshape(solimp, (-1, 3)))
        self.dA = t(np.asarray(da, np.float64))


_TENSOR_CACHE = weakref.WeakKeyDictionary()


def model_tensors(model: PhysicsModel, device, dtype) -> ModelTensors:
    """The model's ModelTensors for (device, dtype), built on first use."""
    per_model = _TENSOR_CACHE.setdefault(model, {})
    key = (torch.device(device), dtype)
    mt = per_model.get(key)
    if mt is None:
        mt = ModelTensors(model, key[0], dtype)
        per_model[key] = mt
    return mt


def _mt(model, ref):
    return model_tensors(model, ref.device, ref.dtype)


def _fk(model: PhysicsModel, mt: ModelTensors, qpos):
    """Forward kinematics. Returns xpos (E,nbody,3), xquat (E,nbody,4),
    cdof (E,nv,6) world-frame motion subspaces."""
    n_env = qpos.shape[0]
    dtype, device = qpos.dtype, qpos.device
    zeros3 = torch.zeros((n_env, 3), dtype=dtype, device=device)
    xpos = [zeros3]
    xquat = [mt.quat_identity.expand(n_env, 4)]
    cdof = [None] * model.nv

    for b in range(1, model.nbody):
        p = int(model.body_parent[b])
        pos = xpos[p] + maths.quat_rotate(xquat[p], mt.body_pos[b])
        quat = maths.quat_mul(xquat[p], mt.body_quat[b])
        for ji in mt.body_joints[b]:
            jt = int(model.jnt_type[ji])
            qadr = int(model.jnt_qposadr[ji])
            dadr = int(model.jnt_dofadr[ji])
            if jt == FREE:
                pos = qpos[:, qadr:qadr + 3]
                quat = maths.quat_normalize(qpos[:, qadr + 3:qadr + 7])
                r = maths.quat_to_mat(quat)
                for k in range(3):  # translational dofs, world axes
                    cdof[dadr + k] = mt.free_cdof_lin[k].expand(n_env, 6)
                for k in range(3):  # rotational dofs, body-local axes
                    axis_w = r[..., k]
                    cdof[dadr + 3 + k] = torch.cat(
                        [axis_w, maths.cross3(pos, axis_w)], dim=-1)
            elif jt == SLIDE:
                axis_w = maths.quat_rotate(quat, mt.jnt_axis[ji])
                pos = pos + axis_w * (qpos[:, qadr:qadr + 1] -
                                      model.jnt_ref[ji])
                cdof[dadr] = torch.cat([zeros3, axis_w], dim=-1)
            elif jt == HINGE:
                axis_l = mt.jnt_axis[ji]
                axis_w = maths.quat_rotate(quat, axis_l)
                anchor_w = pos + maths.quat_rotate(quat, mt.jnt_pos[ji])
                angle = qpos[:, qadr] - model.jnt_ref[ji]
                quat = maths.quat_mul(
                    quat, maths.axis_angle_to_quat(axis_l, angle))
                pos = anchor_w - maths.quat_rotate(quat, mt.jnt_pos[ji])
                cdof[dadr] = torch.cat(
                    [axis_w, maths.cross3(anchor_w, axis_w)], dim=-1)
            else:
                raise ValueError(f'joint type {jt}')
        xpos.append(pos.expand(n_env, 3))
        xquat.append(quat.expand(n_env, 4))

    cdof = (torch.stack(cdof, dim=1) if model.nv
            else torch.zeros((n_env, 0, 6), dtype=dtype, device=device))
    return torch.stack(xpos, dim=1), torch.stack(xquat, dim=1), cdof


def _geom_frames(mt: ModelTensors, mm, xpos, ximat):
    """World frames of all geoms (geom_pos is runtime data)."""
    b = mt.geom_body
    gpos = xpos[:, b] + torch.einsum('egij,egj->egi', ximat[:, b],
                                     mm.geom_pos)
    gmat = ximat[:, b] @ mt.geom_mat
    return gpos, gmat


def _mass_properties(mt: ModelTensors, mm, xpos, ximat):
    """World COM positions and world-frame spatial inertias per body."""
    xipos = xpos + torch.einsum('ebij,bj->ebi', ximat, mt.body_ipos)
    inertia_w = ximat @ mt.body_inertia @ ximat.transpose(-1, -2)
    ispatial = maths.spatial_inertia(mm.body_mass, xipos, inertia_w)
    return xipos, ispatial


def _contacts(mt: ModelTensors, mm, gpos, gmat):
    """All narrow-phase candidates over the static pair list: dist (E,n),
    pos (E,n,3), normal (E,n,3), thint (E,n,3) — the friction-frame tangent
    hint (capsule long axis for capsule contacts, else zeros)."""
    dists, poss, normals, hints = [], [], [], []
    for kind, i1, i2 in mt.pair_groups:
        p1, m1, s1 = gpos[:, i1], gmat[:, i1], mm.geom_size[:, i1]
        p2, m2, s2 = gpos[:, i2], gmat[:, i2], mm.geom_size[:, i2]
        if kind == 'plane_sphere':
            d, p, n = coll.plane_sphere(p1, m1, p2, s2[..., 0])
        elif kind == 'plane_capsule':
            d, p, n = coll.plane_capsule(p1, m1, p2, m2, s2[..., 0],
                                         s2[..., 1])
        elif kind in ('hfield_sphere', 'hfield_capsule'):
            # each env's terrain, seen by each of its pairs
            batch = p1.shape[:2]
            hf = (p1, mm.hfield_size[:, None].expand(batch + (4,)),
                  mm.hfield_row[:, None].expand(
                      batch + (mm.hfield_row.shape[-1],)))
            if kind == 'hfield_sphere':
                d, p, n = coll.hfield_sphere(*hf, p2, s2[..., 0])
            else:
                d, p, n = coll.hfield_capsule(*hf, p2, m2, s2[..., 0],
                                              s2[..., 1])
        elif kind == 'sphere_sphere':
            d, p, n = coll.sphere_sphere(p1, s1[..., 0], p2, s2[..., 0])
        elif kind == 'sphere_capsule':
            d, p, n = coll.sphere_capsule(p1, s1[..., 0], p2, m2, s2[..., 0],
                                          s2[..., 1])
        elif kind == 'capsule_capsule':
            d, p, n = coll.capsule_capsule(p1, m1, s1[..., 0], s1[..., 1],
                                           p2, m2, s2[..., 0], s2[..., 1])
        elif kind == 'capsule_box':
            d, p, n = coll.capsule_box(p1, m1, s1[..., 0], s1[..., 1], p2,
                                       m2, s2[..., :3])
        elif kind == 'sphere_box':
            d, p, n = coll.sphere_box(p1, s1[..., 0], p2, m2, s2[..., :3])
        elif kind == 'box_box':
            d, p, n = coll.box_box(p1, m1, s1[..., :3], p2, m2, s2[..., :3])
        else:
            raise ValueError(kind)
        n_env, n_pairs, n_pts = d.shape
        dists.append(d.reshape(n_env, -1))
        poss.append(p.reshape(n_env, -1, 3))
        normals.append(n.reshape(n_env, -1, 3))
        if kind in ('plane_capsule', 'hfield_capsule'):
            h = m2[..., :, 2][:, :, None, :].expand(n_env, n_pairs, n_pts, 3)
        else:
            h = torch.zeros_like(p)
        hints.append(h.reshape(n_env, -1, 3))
    return (torch.cat(dists, 1), torch.cat(poss, 1), torch.cat(normals, 1),
            torch.cat(hints, 1))


def _point_jacobian(model, cdof, body, point):
    """(E,nv,3) jacobian of world `point` (E,3) fixed to `body`."""
    lin = cdof[..., 3:] + maths.cross3(cdof[..., :3], point[:, None, :])
    mask = torch.as_tensor(model.body_dof[body], dtype=lin.dtype,
                           device=lin.device)
    return lin * mask[:, None]


def _impedance(solimp, r):
    """MuJoCo impedance d(r) in (0,1), solimp power curve with midpoint 0.5
    and power 2 (engine.py _impedance)."""
    dmin, dmax, width = solimp[..., 0], solimp[..., 1], solimp[..., 2]
    mid, p = 0.5, 2.0
    x = torch.clamp(-r / torch.clamp(width, min=1e-10), 0.0, 1.0)
    a_c = 1.0 / mid ** (p - 1.0)
    b_c = 1.0 / (1.0 - mid) ** (p - 1.0)
    s = torch.where(x <= mid, a_c * x ** p, 1.0 - b_c * (1.0 - x) ** p)
    return torch.clamp(dmin + (dmax - dmin) * s, 1e-4, 0.9999)


def _kb(solref, solimp, d, dt):
    """Stiffness/damping of the virtual constraint spring (MuJoCo solref
    semantics, timeconst clamped to >= 2*timestep)."""
    tc, dr = solref[..., 0], solref[..., 1]
    tc = torch.clamp(tc, min=2.0 * dt)
    dmax = solimp[..., 1]
    b = 2.0 / torch.clamp(dmax * tc, min=1e-8)
    k = d / torch.clamp(dmax * dmax * tc * tc * dr * dr, min=1e-10)
    return k, b


def _tangent_frame(mt: ModelTensors, n):
    """Two unit tangents orthogonal to n, branch-free."""
    ref = torch.where(torch.abs(n[..., 0:1]) < 0.5, mt.unit_x, mt.unit_y)
    t1 = maths.cross3(n, ref)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True)
    t2 = maths.cross3(n, t1)
    return t1, t2


def _actuator_force(mt: ModelTensors, n_env, nv, ctrl):
    """Generalized actuator force: motor gear torque with ctrl clamped to
    ctrlrange, scattered onto the actuated dofs (mj qfrc_actuator)."""
    qfrc = torch.zeros((n_env, nv), dtype=mt.dtype, device=mt.device)
    if mt.act_dofadr.numel():
        torque = torch.clamp(ctrl, mt.act_lo, mt.act_hi) * mt.act_gear
        qfrc = qfrc.index_add(1, mt.act_dofadr, torque)
    return qfrc


def smooth_dynamics(model: PhysicsModel, mm: MutableModel, state: PhysicsState,
                    ctrl):
    """Everything except constraints: returns (M (E,nv,nv), qfrc_smooth
    (E,nv), aux dict). CUDA tensors take the kernel of
    ops/smooth_dynamics.py (one launch), CPU tensors the tensor code
    (`_smooth_plain`); either is the span 'physics.smooth'."""
    with tracing.span('physics.smooth'):
        if state.qpos.is_cuda:
            out = smooth_kernel.smooth_dynamics(
                model, _mt(model, state.qpos), mm, state.qpos, state.qvel,
                ctrl)
            return out.pop('mass_mat'), out.pop('qfrc_smooth'), out
        return _smooth_plain(model, mm, state, ctrl)


def _smooth_plain(model: PhysicsModel, mm: MutableModel, state: PhysicsState,
                  ctrl):
    """smooth_dynamics in tensor ops: the kernel's plain version."""
    qpos, qvel = state.qpos, state.qvel
    mt = _mt(model, qpos)
    n_env = qpos.shape[0]

    xpos, xquat, cdof = _fk(model, mt, qpos)
    ximat = maths.quat_to_mat(xquat)
    xipos, ispatial = _mass_properties(mt, mm, xpos, ximat)

    # body spatial velocities
    vel_dof = cdof * qvel[..., None]                     # (E,nv,6)
    body_vel = mt.body_dof @ vel_dof                     # (E,nbody,6)

    # bias accelerations & forces (RNE with qacc=0, gravity as base accel);
    # d(cdof)/dt = v x cdof with v the velocity of the frame the dof's axis
    # is fixed in (engine.py smooth_dynamics)
    vdot_dof = maths.motion_cross(body_vel[:, mt.dof_vsrc], vel_dof)
    body_acc = mt.body_dof @ vdot_dof + mt.a_grav        # (E,nbody,6)
    iv = torch.einsum('ebij,ebj->ebi', ispatial, body_vel)
    f_bias = (torch.einsum('ebij,ebj->ebi', ispatial, body_acc) +
              maths.motion_cross_force(body_vel, iv))
    qfrc_bias = torch.einsum('bk,ebi,eki->ek', mt.body_dof, f_bias, cdof)

    # CRBA mass matrix
    ic = torch.einsum('ab,ebij->eaij', mt.body_ancestor, ispatial)
    f_crb = torch.einsum('ekij,ekj->eki', ic[:, mt.dof_body], cdof)
    m_raw = cdof @ f_crb.transpose(-1, -2)                # (E,nv,nv)
    m_upper = m_raw * mt.dof_ancestor
    mass_mat = (m_upper + m_upper.transpose(-1, -2) -
                torch.diag_embed(torch.diagonal(m_upper, dim1=-2, dim2=-1)))
    mass_mat = mass_mat + mt.dof_armature

    # passive: joint springs + damping
    qfrc_passive = -mm.dof_damping * qvel
    if mt.stiff_dadr.numel():
        spring = -mt.stiff_k * (qpos[:, mt.stiff_qadr] - mt.stiff_ref)
        qfrc_passive = qfrc_passive.index_add(1, mt.stiff_dadr, spring)

    qfrc_actuator = _actuator_force(mt, n_env, model.nv, ctrl)

    # external wrenches: (force, torque) at body COM
    frc = mm.xfrc_applied[..., :3]
    trq = mm.xfrc_applied[..., 3:]
    f_ext = torch.cat([trq + maths.cross3(xipos, frc), frc], dim=-1)
    qfrc_applied = torch.einsum('bk,ebi,eki->ek', mt.body_dof, f_ext, cdof)

    qfrc_smooth = qfrc_actuator + qfrc_passive + qfrc_applied - qfrc_bias

    aux = dict(xpos=xpos, xquat=xquat, ximat=ximat, cdof=cdof, xipos=xipos,
               body_vel=body_vel, qfrc_actuator=qfrc_actuator)
    return mass_mat, qfrc_smooth, aux


def constraint_forces(model: PhysicsModel, mm: MutableModel,
                      state: PhysicsState, mass_mat, qfrc_smooth, aux):
    """Joint limits + contacts as MuJoCo-style soft constraints, solved by
    projected Jacobi. Returns qfrc_constraint (E,nv)."""
    qvel = state.qvel
    mt = _mt(model, qvel)
    n_env, nv = qvel.shape
    cdof = aux['cdof']
    if mt.nrows is None:
        raise ValueError(f'{model.name}: model has no compile-time '
                         'constraint weights (compile it with compile_spec)')
    if mt.nrows == 0:
        return torch.zeros_like(qvel)

    rows_j, rows_r, rows_active = [], [], []
    if mt.nlim:
        r_lim = mt.lim_sign * (state.qpos[:, mt.lim_qadr] - mt.lim_bound)
        rows_j.append(mt.lim_j.expand(n_env, mt.nlim, nv))
        rows_r.append(r_lim)
        rows_active.append(r_lim < 0.0)

    if mt.ncon:
        gpos, gmat = _geom_frames(mt, mm, aux['xpos'], aux['ximat'])
        dist, pos, normal, thint = _contacts(mt, mm, gpos, gmat)
        # point jacobians of all contacts at once:
        # Jp[e, c, k, :] = (cdof_lin[k] + cdof_ang[k] x pos[c]) * mask[c, k]
        jp = (cdof[:, None, :, 3:] +
              maths.cross3(cdof[:, None, :, :3], pos[:, :, None, :]))
        jp = jp * mt.mask_diff[None, :, :, None]          # (E,ncon,nv,3)
        j_n = torch.einsum('ecki,eci->eck', jp, normal)  # (E,ncon,nv)
        r_con = dist - mt.margin
        act_con = r_con < 0.0

        if mt.one_c is not None:
            rows_j.append(j_n[:, mt.one_c])
            rows_r.append(r_con[:, mt.one_c])
            rows_active.append(act_con[:, mt.one_c])

        if mt.pyr_c is not None:
            n_p = normal[:, mt.pyr_c]
            t1, t2 = _tangent_frame(mt, n_p)
            # align t1 with the collider's tangent hint where there is one
            h = thint[:, mt.pyr_c]
            hp = h - torch.sum(h * n_p, -1, keepdim=True) * n_p
            hn = torch.linalg.norm(hp, dim=-1, keepdim=True)
            t1 = torch.where(hn > 1e-6, hp / torch.clamp(hn, min=1e-12), t1)
            t2 = maths.cross3(n_p, t1)
            jp_f = jp[:, mt.pyr_c]
            j_t1 = torch.einsum('ecki,eci->eck', jp_f, t1)
            j_t2 = torch.einsum('ecki,eci->eck', jp_f, t2)
            jn_p = j_n[:, mt.pyr_c]
            mu = mt.mu_pyr
            facets = torch.stack(
                [jn_p + mu * j_t1, jn_p - mu * j_t1,
                 jn_p + mu * j_t2, jn_p - mu * j_t2], dim=2)  # (E,npyr,4,nv)
            rows_j.append(facets.reshape(n_env, -1, nv))
            rows_r.append(r_con[:, mt.pyr_c].repeat_interleave(4, dim=1))
            rows_active.append(
                act_con[:, mt.pyr_c].repeat_interleave(4, dim=1))

    J = torch.cat(rows_j, dim=1)                 # (E, nrows, nv)
    r_pos = torch.cat(rows_r, dim=1)
    active = torch.cat(rows_active, dim=1)
    activef = active.to(J.dtype)

    J = J * activef[..., None]
    chol, _ = torch.linalg.cholesky_ex(mass_mat)
    minv_jt = _cho_solve(chol, J.transpose(-1, -2))      # (E,nv,nrows)

    # impedance, spring params
    d = _impedance(mt.solimp, r_pos)
    k, b = _kb(mt.solref, mt.solimp, d, model.timestep)
    vel = (J @ qvel[..., None])[..., 0]
    aref = (-b * vel - k * r_pos) * activef

    # A = J M^-1 J^T + diag(R), R from impedance and compile-time weights
    A = J @ minv_jt
    R = torch.clamp((1.0 - d) / torch.clamp(d, min=1e-10) * mt.dA, min=1e-12)
    R = torch.where(active, R, torch.ones_like(R))
    A = A + torch.diag_embed(R)
    a_ii_inv = 1.0 / torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1),
                                 min=1e-12)

    qacc_smooth = _cho_solve(chol, qfrc_smooth[..., None])[..., 0]
    b_vec = ((J @ qacc_smooth[..., None])[..., 0] - aref) * activef

    if model.solver == 'jacobi':
        # projected Jacobi with adaptive under-relaxation: omega = 1/rho with
        # rho the row-sum bound on the spectral radius of D^-1 A
        rho = torch.amax(torch.sum(torch.abs(A), dim=-1) * a_ii_inv, dim=-1)
        omega = torch.clamp(1.8 / torch.clamp(rho, min=1e-10), max=1.0)
        f = jacobi_solve(A, b_vec, a_ii_inv, omega, 2 * model.iterations)
    else:
        f = _pgs(A, b_vec, a_ii_inv, model.iterations)
    f = f * activef
    return (J.transpose(-1, -2) @ f[..., None])[..., 0]


def _pgs(A, b, a_ii_inv, iterations):
    """Projected Gauss-Seidel from f = 0: `iterations` sweeps, each a pass
    over the rows in order that updates f in place (the JAX engine's
    lax.scan branch). Plain tensor ops, a few small launches a row: no
    model selects it, and the Jacobi kernels stay the solve on the card."""
    f = torch.zeros_like(b)
    for _ in range(iterations):
        for i in range(b.shape[-1]):
            fi = f[:, i] - (torch.sum(A[:, i] * f, dim=-1) + b[:, i]) * \
                a_ii_inv[:, i]
            f[:, i] = torch.clamp(fi, min=0.0)
    return f


def _cho_solve(chol, rhs):
    """M^-1 rhs from the lower Cholesky factor of M (the JAX engine's
    cho_solve). The factor comes from cholesky_ex, which skips the info
    check, and the solve is two triangular solves: torch.cholesky_solve
    waits for the card (a stream sync per call on CUDA), these do not."""
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y,
                                         upper=True)


def _integrate_pos(mt: ModelTensors, qpos, qvel, dt):
    """qpos <- qpos (+) dt*qvel: linear for hinge, slide and a free joint's
    position, quat_integrate for a free joint's orientation (its angular
    velocity is in the body frame)."""
    parts = []
    for kind, qadr, dof in mt.q_runs:
        if kind == FREE:
            parts.append(qpos[:, qadr:qadr + 3] +
                         dt * qvel[:, dof:dof + 3])
            parts.append(maths.quat_integrate(
                qpos[:, qadr + 3:qadr + 7], qvel[:, dof + 3:dof + 6],
                dt))
        else:
            n = dof.shape[0]
            parts.append(qpos[:, qadr:qadr + n] + dt * qvel[:, dof])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _qacc(model, mm, state, ctrl, implicit_damping):
    """Generalized acceleration of one dynamics pass: smooth dynamics, the
    constraint solve, and a Cholesky solve with M + h*D (Euler's implicit
    joint damping) or M (RK4)."""
    _qacc.passes += 1
    if not (state.qpos.is_cuda and torch.cuda.is_current_stream_capturing()):
        # a captured pass counts at each replay (models/captured.py)
        tracing.count('physics.passes')
    with tracing.span('physics.qacc'):
        mass_mat, qfrc_smooth, aux = smooth_dynamics(model, mm, state, ctrl)
        qfrc_con = constraint_forces(model, mm, state, mass_mat, qfrc_smooth,
                                     aux)
        if implicit_damping:
            mass_mat = mass_mat + model.timestep * torch.diag_embed(
                mm.dof_damping)
        chol, _ = torch.linalg.cholesky_ex(mass_mat)
        return _cho_solve(chol, (qfrc_smooth + qfrc_con)[..., None])[..., 0]


#: dynamics passes since the count was last set to 0, captures included
_qacc.passes = 0


def step(model: PhysicsModel, mm: MutableModel, state: PhysicsState,
         ctrl) -> PhysicsState:
    """Advance one physics timestep (the `mj_step` equivalent): Euler with
    implicit joint damping, (M + h*D) qacc = qfrc, or classic RK4 (four
    dynamics passes, each with its constraint solve)."""
    h = model.timestep
    mt = _mt(model, state.qpos)
    if model.integrator == EULER:
        qacc = _qacc(model, mm, state, ctrl, implicit_damping=True)
        qvel = state.qvel + h * qacc
        return PhysicsState(qpos=_integrate_pos(mt, state.qpos, qvel, h),
                            qvel=qvel)
    if model.integrator == RK4:
        def deriv(s):
            return s.qvel, _qacc(model, mm, s, ctrl, implicit_damping=False)
        v1, a1 = deriv(state)
        v2, a2 = deriv(PhysicsState(
            _integrate_pos(mt, state.qpos, v1, 0.5 * h),
            state.qvel + 0.5 * h * a1))
        v3, a3 = deriv(PhysicsState(
            _integrate_pos(mt, state.qpos, v2, 0.5 * h),
            state.qvel + 0.5 * h * a2))
        v4, a4 = deriv(PhysicsState(
            _integrate_pos(mt, state.qpos, v3, h), state.qvel + h * a3))
        v_avg = (v1 + 2 * v2 + 2 * v3 + v4) / 6.0
        a_avg = (a1 + 2 * a2 + 2 * a3 + a4) / 6.0
        return PhysicsState(qpos=_integrate_pos(mt, state.qpos, v_avg, h),
                            qvel=state.qvel + h * a_avg)
    raise ValueError(f'integrator {model.integrator}')


def energy(model: PhysicsModel, mm: MutableModel, state: PhysicsState):
    """(potential (E,), kinetic (E,)), the mj_energy pair: potential =
    -sum_i m_i g . com_i + 0.5 sum_j k_j (q_j - springref_j)^2 over
    non-free joints; kinetic = 0.5 qvel^T M qvel (armature included)."""
    mt = _mt(model, state.qpos)
    ctrl = torch.zeros((state.qpos.shape[0], model.nu), dtype=mt.dtype,
                       device=mt.device)
    mass_mat, _, aux = smooth_dynamics(model, mm, state, ctrl)
    pot = -torch.sum(mm.body_mass * (aux['xipos'] @ -mt.a_grav[3:]), dim=-1)
    if mt.stiff_qadr.numel():
        dq = state.qpos[:, mt.stiff_qadr] - mt.stiff_ref
        pot = pot + torch.sum(0.5 * mt.stiff_k * dq * dq, dim=-1)
    qv = state.qvel[..., None]
    kin = 0.5 * (qv.transpose(-1, -2) @ mass_mat @ qv)[..., 0, 0]
    return pot, kin


def forward(model: PhysicsModel, mm: MutableModel,
            state: PhysicsState, ctrl=None) -> ForwardData:
    """Position/velocity-stage forward pass (the `mj_forward` subset envs
    consume for observations and rewards). Omitted ctrl means zero
    actuator force. CUDA tensors take the kernel of ops/smooth_dynamics.py
    (one launch), CPU tensors the tensor code (`_forward_plain`); either
    is the span 'physics.smooth'."""
    with tracing.span('physics.smooth'):
        if state.qpos.is_cuda:
            return ForwardData(**smooth_kernel.smooth_dynamics(
                model, _mt(model, state.qpos), mm, state.qpos, state.qvel,
                ctrl, forward=True))
        return _forward_plain(model, mm, state, ctrl)


def _forward_plain(model: PhysicsModel, mm: MutableModel,
                   state: PhysicsState, ctrl=None) -> ForwardData:
    """forward in tensor ops: the kernel's plain version."""
    qpos, qvel = state.qpos, state.qvel
    mt = _mt(model, qpos)
    n_env = qpos.shape[0]
    xpos, xquat, cdof = _fk(model, mt, qpos)
    ximat = maths.quat_to_mat(xquat)
    xipos, _ = _mass_properties(mt, mm, xpos, ximat)
    body_vel = mt.body_dof @ (cdof * qvel[..., None])

    mass = mm.body_mass
    subtree_mass = mass @ mt.body_ancestor.T
    safe_mass = torch.clamp(subtree_mass, min=1e-10)
    subtree_com = (mt.body_ancestor @ (mass[..., None] * xipos)) / \
        safe_mass[..., None]
    vcom = maths.point_velocity(body_vel, xipos)
    subtree_comvel = (mt.body_ancestor @ (mass[..., None] * vcom)) / \
        safe_mass[..., None]

    qfrc_act = (torch.zeros((n_env, model.nv), dtype=qpos.dtype,
                            device=qpos.device) if ctrl is None
                else _actuator_force(mt, n_env, model.nv, ctrl))
    return ForwardData(xpos=xpos, xquat=xquat, ximat=ximat,
                       subtree_com=subtree_com, subtree_comvel=subtree_comvel,
                       qfrc_actuator=qfrc_act)
