# Frozen copy of learning_to_adapt_torch/physics/spec.py at commit 0fd707d,
# kept as the benchmark's model compiler: it is not edited with the
# program. Changed from the original: `_with_invweights` takes the mass
# matrix from the reference's C++ physics (reference/oracle.py).
"""Model specification DSL and host-side compiler.

A small Python spec (bodies / joints / geoms / actuators) is *compiled
host-side with numpy* into:

  * ``PhysicsModel`` — static numpy arrays + tree metadata, which the
    reference's C++ physics (reference/oracle.py) takes in, and
  * ``MutableModel`` — the runtime-variable subset (masses, damping, geom
    size/pos, heightfield, applied wrenches). Tasks are *data*: a dynamics
    perturbation is a ``MutableModel`` value passed to ``step``.

This is the same compiler as learning_to_adapt_tpu/physics/spec.py; only
``_with_invweights`` differs (see the note at the top).
Builtin environment models are defined programmatically (envs/model_defs.py).
"""
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# enums
# ---------------------------------------------------------------------------

FREE, HINGE, SLIDE = 0, 1, 2  # joint types
PLANE, HFIELD, SPHERE, CAPSULE, BOX = 0, 1, 2, 3, 4  # geom types

EULER, RK4 = 0, 1  # integrators

_JOINT_NQ = {FREE: 7, HINGE: 1, SLIDE: 1}
_JOINT_NV = {FREE: 6, HINGE: 1, SLIDE: 1}


# ---------------------------------------------------------------------------
# user-facing spec dataclasses
# ---------------------------------------------------------------------------

@dataclass
class GeomSpec:
    type: int = CAPSULE
    name: str = ''
    size: Tuple[float, ...] = ()          # sphere:(r,) capsule:(r,hl) box:(hx,hy,hz)
    pos: Tuple[float, float, float] = (0., 0., 0.)
    quat: Tuple[float, float, float, float] = (1., 0., 0., 0.)
    fromto: Optional[Tuple[float, ...]] = None   # overrides pos/quat for capsules
    axisangle: Optional[Tuple[float, float, float, float]] = None
    density: float = 1000.0
    mass: Optional[float] = None          # overrides density-derived mass
    friction: Tuple[float, float, float] = (1.0, 0.005, 0.0001)
    margin: float = 0.0
    solref: Tuple[float, float] = (0.02, 1.0)
    solimp: Tuple[float, float, float] = (0.9, 0.95, 0.001)
    condim: int = 3
    contype: int = 1
    conaffinity: int = 1
    rgba: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)
    hfield: Optional[str] = None          # name of hfield asset for HFIELD geoms


@dataclass
class JointSpec:
    type: int = HINGE
    name: str = ''
    pos: Tuple[float, float, float] = (0., 0., 0.)
    axis: Tuple[float, float, float] = (0., 0., 1.)
    range: Tuple[float, float] = (0., 0.)
    limited: bool = False
    damping: float = 0.0
    armature: float = 0.0
    stiffness: float = 0.0
    springref: float = 0.0
    ref: float = 0.0                      # reference qpos offset (slide/hinge)
    solref_limit: Tuple[float, float] = (0.02, 1.0)
    solimp_limit: Tuple[float, float, float] = (0.9, 0.95, 0.001)


@dataclass
class BodySpec:
    name: str = ''
    pos: Tuple[float, float, float] = (0., 0., 0.)
    quat: Tuple[float, float, float, float] = (1., 0., 0., 0.)
    joints: List[JointSpec] = field(default_factory=list)
    geoms: List[GeomSpec] = field(default_factory=list)
    children: List['BodySpec'] = field(default_factory=list)


@dataclass
class ActuatorSpec:
    joint: str = ''                       # joint name (motor on its first dof)
    gear: float = 1.0
    ctrlrange: Tuple[float, float] = (-1.0, 1.0)
    name: str = ''


@dataclass
class HFieldSpec:
    name: str = 'floor'
    nrow: int = 1
    ncol: int = 1
    size: Tuple[float, float, float, float] = (1., 1., 1., 0.1)  # rx, ry, z_top, z_base
    # data is runtime (MutableModel); compile seeds zeros


@dataclass
class OptionSpec:
    timestep: float = 0.01
    gravity: Tuple[float, float, float] = (0., 0., -9.81)
    integrator: int = EULER
    iterations: int = 30                  # constraint-solver sweeps
    solver: str = 'jacobi'                # 'jacobi' (batched) | 'pgs'


@dataclass
class ModelSpec:
    name: str = 'model'
    option: OptionSpec = field(default_factory=OptionSpec)
    world_geoms: List[GeomSpec] = field(default_factory=list)
    bodies: List[BodySpec] = field(default_factory=list)      # children of world
    actuators: List[ActuatorSpec] = field(default_factory=list)
    hfields: List[HFieldSpec] = field(default_factory=list)
    settotalmass: Optional[float] = None
    init_qpos: Optional[Tuple[float, ...]] = None             # <custom numeric>
    frame_skip: int = 1


# ---------------------------------------------------------------------------
# compiled model containers
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class PhysicsModel:
    """Static compiled model. All arrays are numpy; the engine copies what
    it needs to the device once per (model, device, dtype)."""
    name: str
    # sizes
    nq: int; nv: int; nu: int; nbody: int; ngeom: int; njnt: int
    # options
    timestep: float
    gravity: np.ndarray            # (3,)
    integrator: int
    iterations: int
    solver: str
    frame_skip: int
    # bodies (index 0 = world)
    body_parent: np.ndarray        # (nbody,) int
    body_pos: np.ndarray           # (nbody,3) frame offset in parent frame
    body_quat: np.ndarray          # (nbody,4)
    body_mass0: np.ndarray         # (nbody,)   (runtime copy in MutableModel)
    body_ipos: np.ndarray          # (nbody,3)  COM in body frame
    body_inertia: np.ndarray       # (nbody,3,3) about COM, body frame
    # joints
    jnt_type: np.ndarray           # (njnt,)
    jnt_body: np.ndarray           # (njnt,)
    jnt_pos: np.ndarray            # (njnt,3)
    jnt_axis: np.ndarray           # (njnt,3)
    jnt_range: np.ndarray          # (njnt,2)
    jnt_limited: np.ndarray        # (njnt,) bool
    jnt_stiffness: np.ndarray      # (njnt,)
    jnt_springref: np.ndarray      # (njnt,)
    jnt_ref: np.ndarray            # (njnt,)
    jnt_solref_limit: np.ndarray   # (njnt,2)
    jnt_solimp_limit: np.ndarray   # (njnt,3)
    jnt_qposadr: np.ndarray        # (njnt,)
    jnt_dofadr: np.ndarray         # (njnt,)
    # dofs
    dof_jnt: np.ndarray            # (nv,) joint index of each dof
    dof_body: np.ndarray           # (nv,) body owning each dof
    dof_vsrc: np.ndarray           # (nv,) body whose velocity rotates the axis
    dof_damping0: np.ndarray       # (nv,)
    dof_armature: np.ndarray       # (nv,)
    # geoms
    geom_type: np.ndarray          # (ngeom,)
    geom_body: np.ndarray          # (ngeom,)
    geom_pos0: np.ndarray          # (ngeom,3)
    geom_quat: np.ndarray          # (ngeom,4)
    geom_size0: np.ndarray         # (ngeom,3)
    geom_friction: np.ndarray      # (ngeom,3)
    geom_margin: np.ndarray        # (ngeom,)
    geom_solref: np.ndarray        # (ngeom,2)
    geom_solimp: np.ndarray        # (ngeom,3)
    geom_condim: np.ndarray        # (ngeom,)
    geom_rgba: np.ndarray          # (ngeom,4)
    # actuators
    act_dofadr: np.ndarray         # (nu,)
    act_gear: np.ndarray           # (nu,)
    act_ctrlrange: np.ndarray      # (nu,2)
    # masks (precomputed tree structure)
    body_ancestor: np.ndarray      # (nbody,nbody) bool: [a,b] a is ancestor-or-self of b
    dof_ancestor: np.ndarray       # (nv,nv) bool: [i,j] dof i on ancestor-or-self body chain of dof j AND i<=j chainwise
    body_dof: np.ndarray           # (nbody,nv) bool: dof k in the ancestor chain of body b
    # collision pairs, grouped by kind: dict kind -> (ncand,2) geom index pairs
    pair_groups: Any               # tuple of (kind:str, np.ndarray pairs)
    # init state
    qpos0: np.ndarray              # (nq,) reference/init pose
    init_qpos: Optional[np.ndarray]
    # hfield
    hfield_nrow: int
    hfield_ncol: int
    hfield_size0: np.ndarray       # (4,)
    # names
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    geom_names: Tuple[str, ...]
    actuator_names: Tuple[str, ...]
    # compile-time constraint-regularizer weights (MuJoCo mj_setConst
    # equivalents, computed at qpos0; runtime task edits leave them stale
    # exactly as MuJoCo does when the reference mutates body_mass etc.)
    dof_invweight0: Optional[np.ndarray] = None   # (nv,) diag(M0^-1)
    body_invweight0: Optional[np.ndarray] = None  # (nbody,) tr(Jc M0^-1 Jc^T)/3

    def body_id(self, name):
        return self.body_names.index(name)

    def joint_id(self, name):
        return self.joint_names.index(name)

    def geom_id(self, name):
        return self.geom_names.index(name)


@dataclass
class MutableModel:
    """Runtime-variable model fields (the task-as-data surface). The engine
    takes every field with a leading env axis, e.g. body_mass (E, nbody)."""
    body_mass: Any                 # (nbody,)
    dof_damping: Any               # (nv,)
    geom_size: Any                 # (ngeom,3)
    geom_pos: Any                  # (ngeom,3)
    xfrc_applied: Any              # (nbody,6) world (force, torque) at body COM
    hfield_size: Any               # (4,)
    hfield_row: Any                # (hfield_ncol,) normalized [0,1] profile along x


def default_mutable(model: PhysicsModel, dtype=np.float32) -> MutableModel:
    return MutableModel(
        body_mass=np.asarray(model.body_mass0, dtype),
        dof_damping=np.asarray(model.dof_damping0, dtype),
        geom_size=np.asarray(model.geom_size0, dtype),
        geom_pos=np.asarray(model.geom_pos0, dtype),
        xfrc_applied=np.zeros((model.nbody, 6), dtype),
        hfield_size=np.asarray(model.hfield_size0, dtype),
        hfield_row=np.zeros((max(model.hfield_ncol, 1),), dtype),
    )


# ---------------------------------------------------------------------------
# geometry helpers (host-side)
# ---------------------------------------------------------------------------

def _axisangle_to_quat(axisangle):
    ax = np.asarray(axisangle[:3], np.float64)
    ax = ax / np.linalg.norm(ax)
    half = 0.5 * axisangle[3]
    return np.concatenate([[np.cos(half)], np.sin(half) * ax])


def _quat_mul_np(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw])


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _z_align_quat(direction):
    """Quaternion rotating +z onto `direction` (unit)."""
    z = np.array([0., 0., 1.])
    d = direction / np.linalg.norm(direction)
    c = float(np.dot(z, d))
    if c > 1 - 1e-12:
        return np.array([1., 0., 0., 0.])
    if c < -1 + 1e-12:
        return np.array([0., 1., 0., 0.])  # 180deg about x
    axis = np.cross(z, d)
    axis = axis / np.linalg.norm(axis)
    angle = np.arccos(np.clip(c, -1, 1))
    return _axisangle_to_quat(np.concatenate([axis, [angle]]))


def _resolve_geom_frame(g: GeomSpec):
    """Returns (pos, quat, size(3,)) with fromto/axisangle resolved."""
    if g.fromto is not None:
        p1 = np.asarray(g.fromto[:3], np.float64)
        p2 = np.asarray(g.fromto[3:], np.float64)
        pos = 0.5 * (p1 + p2)
        quat = _z_align_quat(p2 - p1)
        r = g.size[0]
        hl = 0.5 * np.linalg.norm(p2 - p1)
        size = np.array([r, hl, 0.])
    else:
        pos = np.asarray(g.pos, np.float64)
        if g.axisangle is not None:
            quat = _axisangle_to_quat(np.asarray(g.axisangle, np.float64))
        else:
            quat = np.asarray(g.quat, np.float64)
        size = np.zeros(3)
        size[:len(g.size)] = g.size
    return pos, quat, size


def _geom_mass_inertia(gtype, size, density, mass_override):
    """(mass, inertia 3x3 about geom COM in geom frame). Plane/hfield: 0."""
    if gtype in (PLANE, HFIELD):
        return 0.0, np.zeros((3, 3))
    if gtype == SPHERE:
        r = size[0]
        vol = 4.0 / 3.0 * np.pi * r ** 3
        m = mass_override if mass_override is not None else density * vol
        i = 0.4 * m * r * r
        return m, np.diag([i, i, i])
    if gtype == CAPSULE:
        r, hl = size[0], size[1]
        v_cyl = np.pi * r * r * (2 * hl)
        v_sph = 4.0 / 3.0 * np.pi * r ** 3
        if mass_override is not None:
            density = mass_override / (v_cyl + v_sph)
        m_cyl = density * v_cyl
        m_sph = density * v_sph
        m_h = 0.5 * m_sph  # one hemisphere
        # cylinder about own COM
        ixx_cyl = m_cyl * (r * r / 4.0 + hl * hl / 3.0)
        izz_cyl = 0.5 * m_cyl * r * r
        # hemisphere about own COM then shifted to capsule COM
        d_face = 3.0 * r / 8.0
        i_hemi_com = 0.4 * m_h * r * r - m_h * d_face * d_face
        off = hl + d_face
        ixx_h = i_hemi_com + m_h * off * off
        izz_h = 0.4 * m_h * r * r
        ixx = ixx_cyl + 2 * ixx_h
        izz = izz_cyl + 2 * izz_h
        return m_cyl + m_sph, np.diag([ixx, ixx, izz])
    if gtype == BOX:
        hx, hy, hz = size
        vol = 8.0 * hx * hy * hz
        m = mass_override if mass_override is not None else density * vol
        return m, np.diag([
            m / 3.0 * (hy * hy + hz * hz),
            m / 3.0 * (hx * hx + hz * hz),
            m / 3.0 * (hx * hx + hy * hy)])
    raise ValueError(f'unknown geom type {gtype}')


# supported collision kernels, keyed by (geom_type_a, geom_type_b); a entry is
# (kind_name, swap) — swap means the pair is stored (b, a)
_PAIR_KINDS = {
    (PLANE, SPHERE): ('plane_sphere', False),
    (SPHERE, PLANE): ('plane_sphere', True),
    (PLANE, CAPSULE): ('plane_capsule', False),
    (CAPSULE, PLANE): ('plane_capsule', True),
    (HFIELD, CAPSULE): ('hfield_capsule', False),
    (CAPSULE, HFIELD): ('hfield_capsule', True),
    (HFIELD, SPHERE): ('hfield_sphere', False),
    (SPHERE, HFIELD): ('hfield_sphere', True),
    (CAPSULE, CAPSULE): ('capsule_capsule', False),
    (SPHERE, CAPSULE): ('sphere_capsule', False),
    (CAPSULE, SPHERE): ('sphere_capsule', True),
    (SPHERE, SPHERE): ('sphere_sphere', False),
    (CAPSULE, BOX): ('capsule_box', False),
    (BOX, CAPSULE): ('capsule_box', True),
    (SPHERE, BOX): ('sphere_box', False),
    (BOX, SPHERE): ('sphere_box', True),
    (BOX, BOX): ('box_box', False),
}


def compile_spec(spec: ModelSpec) -> PhysicsModel:
    """Flatten the body tree and precompute everything static.

    Mirrors what MuJoCo's model compiler does for the feature subset the five
    reference environments use (SURVEY.md section 2.1): depth-first joint/dof
    addressing, geom-derived body inertia (inertiafromgeom), settotalmass
    rescale, ancestor masks, and the static collision-pair list derived from
    contype/conaffinity with same-body and parent-child filtering.
    """
    bodies: List[BodySpec] = []
    parents: List[int] = []

    def walk(b: BodySpec, parent_idx: int):
        bodies.append(b)
        parents.append(parent_idx)
        my = len(bodies)  # +1 offset for world=0
        for c in b.children:
            walk(c, my)

    for b in spec.bodies:
        walk(b, 0)

    nbody = len(bodies) + 1
    body_parent = np.zeros(nbody, np.int32)
    body_pos = np.zeros((nbody, 3))
    body_quat = np.tile(np.array([1., 0., 0., 0.]), (nbody, 1))
    body_names = ['world']

    joints: List[Tuple[int, JointSpec]] = []   # (body_idx, spec)
    geoms: List[Tuple[int, GeomSpec]] = []
    geoms.extend((0, g) for g in spec.world_geoms)

    for i, b in enumerate(bodies):
        bi = i + 1
        body_parent[bi] = parents[i]
        body_pos[bi] = b.pos
        body_quat[bi] = b.quat
        body_names.append(b.name or f'body{bi}')
        for j in b.joints:
            joints.append((bi, j))
        for g in b.geoms:
            geoms.append((bi, g))

    # ---- joints & dofs (depth-first order == definition order) ----
    njnt = len(joints)
    jnt_type = np.zeros(njnt, np.int32)
    jnt_body = np.zeros(njnt, np.int32)
    jnt_pos = np.zeros((njnt, 3))
    jnt_axis = np.zeros((njnt, 3))
    jnt_range = np.zeros((njnt, 2))
    jnt_limited = np.zeros(njnt, bool)
    jnt_stiffness = np.zeros(njnt)
    jnt_springref = np.zeros(njnt)
    jnt_ref = np.zeros(njnt)
    jnt_solref_limit = np.zeros((njnt, 2))
    jnt_solimp_limit = np.zeros((njnt, 3))
    jnt_qposadr = np.zeros(njnt, np.int32)
    jnt_dofadr = np.zeros(njnt, np.int32)
    joint_names = []

    dof_jnt, dof_body, dof_damping, dof_armature = [], [], [], []
    dof_vsrc = []
    qpos0_list: List[float] = []
    nq = nv = 0
    for ji, (bi, j) in enumerate(joints):
        jnt_type[ji] = j.type
        jnt_body[ji] = bi
        jnt_pos[ji] = j.pos
        ax = np.asarray(j.axis, np.float64)
        jnt_axis[ji] = ax / (np.linalg.norm(ax) or 1.0)
        jnt_range[ji] = j.range
        jnt_limited[ji] = j.limited
        jnt_stiffness[ji] = j.stiffness
        jnt_springref[ji] = j.springref
        jnt_ref[ji] = j.ref
        jnt_solref_limit[ji] = j.solref_limit
        jnt_solimp_limit[ji] = j.solimp_limit
        jnt_qposadr[ji] = nq
        jnt_dofadr[ji] = nv
        joint_names.append(j.name or f'joint{ji}')
        if j.type == FREE:
            if body_parent[bi] != 0:
                raise ValueError('free joints only supported on root bodies')
            # reference pose: world frame of the body
            qpos0_list.extend(list(body_pos[bi]) + list(body_quat[bi]))
        else:
            qpos0_list.append(j.ref)
        for k in range(_JOINT_NV[j.type]):
            dof_jnt.append(ji)
            dof_body.append(bi)
            dof_damping.append(j.damping)
            dof_armature.append(j.armature)
            # axis frame: hinge + free-rotational axes are fixed in the child
            # body; slide + free-translational axes in the parent frame
            if j.type == HINGE or (j.type == FREE and k >= 3):
                dof_vsrc.append(bi)
            else:
                dof_vsrc.append(int(body_parent[bi]))
        nq += _JOINT_NQ[j.type]
        nv += _JOINT_NV[j.type]

    # ---- geoms ----
    ngeom = len(geoms)
    geom_type = np.zeros(ngeom, np.int32)
    geom_body = np.zeros(ngeom, np.int32)
    geom_pos0 = np.zeros((ngeom, 3))
    geom_quat = np.zeros((ngeom, 4))
    geom_size0 = np.zeros((ngeom, 3))
    geom_friction = np.zeros((ngeom, 3))
    geom_margin = np.zeros(ngeom)
    geom_solref = np.zeros((ngeom, 2))
    geom_solimp = np.zeros((ngeom, 3))
    geom_condim = np.zeros(ngeom, np.int32)
    geom_rgba = np.zeros((ngeom, 4))
    geom_contype = np.zeros(ngeom, np.int32)
    geom_conaffinity = np.zeros(ngeom, np.int32)
    geom_mass = np.zeros(ngeom)
    geom_inertia = np.zeros((ngeom, 3, 3))
    geom_names = []

    for gi, (bi, g) in enumerate(geoms):
        pos, quat, size = _resolve_geom_frame(g)
        geom_type[gi] = g.type
        geom_body[gi] = bi
        geom_pos0[gi] = pos
        geom_quat[gi] = quat
        geom_size0[gi] = size
        geom_friction[gi] = g.friction
        geom_margin[gi] = g.margin
        geom_solref[gi] = g.solref
        geom_solimp[gi] = g.solimp
        geom_condim[gi] = g.condim
        geom_rgba[gi] = g.rgba
        geom_contype[gi] = g.contype
        geom_conaffinity[gi] = g.conaffinity
        m, i_g = _geom_mass_inertia(g.type, size, g.density, g.mass)
        geom_mass[gi] = m
        # rotate geom inertia into body frame
        r = _quat_to_mat_np(quat)
        geom_inertia[gi] = r @ i_g @ r.T
        geom_names.append(g.name or f'geom{gi}')

    # ---- body mass properties from geoms (inertiafromgeom=true) ----
    body_mass0 = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_inertia = np.zeros((nbody, 3, 3))
    for bi in range(1, nbody):
        gids = [gi for gi in range(ngeom) if geom_body[gi] == bi]
        m_tot = sum(geom_mass[gi] for gi in gids)
        body_mass0[bi] = m_tot
        if m_tot > 0:
            com = sum(geom_mass[gi] * geom_pos0[gi] for gi in gids) / m_tot
            body_ipos[bi] = com
            itot = np.zeros((3, 3))
            for gi in gids:
                d = geom_pos0[gi] - com
                itot += geom_inertia[gi] + geom_mass[gi] * (
                    np.dot(d, d) * np.eye(3) - np.outer(d, d))
            body_inertia[bi] = itot

    if spec.settotalmass is not None:
        total = body_mass0.sum()
        if total > 0:
            scale = spec.settotalmass / total
            body_mass0 *= scale
            body_inertia *= scale

    # ---- tree masks ----
    body_ancestor = np.zeros((nbody, nbody), bool)
    for b in range(nbody):
        a = b
        while True:
            body_ancestor[a, b] = True
            if a == 0:
                break
            a = body_parent[a]

    body_dof = np.zeros((nbody, nv), bool)  # dof k drives body b
    for b in range(1, nbody):
        for k in range(nv):
            if body_ancestor[dof_body[k], b]:
                body_dof[b, k] = True

    dof_ancestor = np.zeros((nv, nv), bool)
    for j in range(nv):
        for i in range(nv):
            # dof i is on the chain from world to dof j's body (incl. same body
            # earlier dofs and itself)
            if body_dof[dof_body[j], i] and i <= j:
                dof_ancestor[i, j] = True

    # ---- collision pairs ----
    # MuJoCo-style filtering operates on welds: bodies connected without a
    # joint form one weld; same-weld and parent-weld pairs are excluded
    # (except when the parent weld is the world).
    body_has_joint = np.zeros(nbody, bool)
    for ji in range(njnt):
        body_has_joint[jnt_body[ji]] = True
    weldid = np.zeros(nbody, np.int32)
    for b in range(1, nbody):
        weldid[b] = b if body_has_joint[b] else weldid[body_parent[b]]
    weld_parent = np.zeros(nbody, np.int32)
    for b in range(1, nbody):
        weld_parent[b] = weldid[body_parent[b]]

    pair_lists = {}
    skipped = []
    for a in range(ngeom):
        for b in range(a + 1, ngeom):
            ba, bb = geom_body[a], geom_body[b]
            wa, wb = weldid[ba], weldid[bb]
            if wa == wb:
                continue
            if weld_parent[wb] == wa and wa != 0:
                continue
            if weld_parent[wa] == wb and wb != 0:
                continue
            if not ((geom_contype[a] & geom_conaffinity[b]) or
                    (geom_contype[b] & geom_conaffinity[a])):
                continue
            key = (int(geom_type[a]), int(geom_type[b]))
            if key not in _PAIR_KINDS:
                skipped.append((geom_names[a], geom_names[b]))
                continue
            kind, swap = _PAIR_KINDS[key]
            pair = (b, a) if swap else (a, b)
            pair_lists.setdefault(kind, []).append(pair)
    if skipped:
        import warnings
        warnings.warn(f'{spec.name}: skipped unsupported collision pairs '
                      f'{skipped[:5]}{"..." if len(skipped) > 5 else ""}')
    pair_groups = tuple(sorted(
        (kind, np.asarray(pairs, np.int32)) for kind, pairs in pair_lists.items()))

    # ---- actuators ----
    nu = len(spec.actuators)
    act_dofadr = np.zeros(nu, np.int32)
    act_gear = np.zeros(nu)
    act_ctrlrange = np.zeros((nu, 2))
    actuator_names = []
    for ai, a in enumerate(spec.actuators):
        ji = joint_names.index(a.joint)
        act_dofadr[ai] = jnt_dofadr[ji]
        act_gear[ai] = a.gear
        act_ctrlrange[ai] = a.ctrlrange
        actuator_names.append(a.name or a.joint)

    # ---- hfield ----
    if spec.hfields:
        hf = spec.hfields[0]
        hf_nrow, hf_ncol, hf_size = hf.nrow, hf.ncol, np.asarray(hf.size)
    else:
        hf_nrow, hf_ncol, hf_size = 0, 0, np.zeros(4)

    init_qpos = (np.asarray(spec.init_qpos, np.float64)
                 if spec.init_qpos is not None else None)

    model = PhysicsModel(
        name=spec.name,
        nq=nq, nv=nv, nu=nu, nbody=nbody, ngeom=ngeom, njnt=njnt,
        timestep=spec.option.timestep,
        gravity=np.asarray(spec.option.gravity),
        integrator=spec.option.integrator,
        iterations=spec.option.iterations,
        solver=spec.option.solver,
        frame_skip=spec.frame_skip,
        body_parent=body_parent, body_pos=body_pos, body_quat=body_quat,
        body_mass0=body_mass0, body_ipos=body_ipos, body_inertia=body_inertia,
        jnt_type=jnt_type, jnt_body=jnt_body, jnt_pos=jnt_pos,
        jnt_axis=jnt_axis, jnt_range=jnt_range, jnt_limited=jnt_limited,
        jnt_stiffness=jnt_stiffness, jnt_springref=jnt_springref,
        jnt_ref=jnt_ref, jnt_solref_limit=jnt_solref_limit,
        jnt_solimp_limit=jnt_solimp_limit,
        jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
        dof_jnt=np.asarray(dof_jnt, np.int32),
        dof_body=np.asarray(dof_body, np.int32),
        dof_vsrc=np.asarray(dof_vsrc, np.int32),
        dof_damping0=np.asarray(dof_damping),
        dof_armature=np.asarray(dof_armature),
        geom_type=geom_type, geom_body=geom_body, geom_pos0=geom_pos0,
        geom_quat=geom_quat, geom_size0=geom_size0,
        geom_friction=geom_friction, geom_margin=geom_margin,
        geom_solref=geom_solref, geom_solimp=geom_solimp,
        geom_condim=geom_condim, geom_rgba=geom_rgba,
        act_dofadr=act_dofadr, act_gear=act_gear, act_ctrlrange=act_ctrlrange,
        body_ancestor=body_ancestor, dof_ancestor=dof_ancestor,
        body_dof=body_dof,
        pair_groups=pair_groups,
        qpos0=np.asarray(qpos0_list, np.float64),
        init_qpos=init_qpos,
        hfield_nrow=hf_nrow, hfield_ncol=hf_ncol, hfield_size0=hf_size,
        body_names=tuple(body_names), joint_names=tuple(joint_names),
        geom_names=tuple(geom_names), actuator_names=tuple(actuator_names),
    )
    return _with_invweights(model)


def _with_invweights(model: PhysicsModel) -> PhysicsModel:
    """Attach MuJoCo's compile-time constraint weights (mj_setConst):
    dof_invweight0 = diag(M0^-1) and body_invweight0 = tr(Jcom M0^-1
    Jcom^T)/3 at qpos0. These feed the constraint regularizer R — MuJoCo
    uses these compile-time constants, not the current-state A diagonal
    (validated vs mj.dof_invweight0/body_invweight0 in
    tests/test_mujoco_crosscheck.py). M0 and the motion subspace come from
    the reference's C++ physics (reference/oracle.py), not from an engine
    of this folder."""
    from .. import oracle  # deferred: the binding reads this module's models

    key = (model.name, model.nq, model.nv, model.nu, model.nbody,
           model.ngeom, float(model.timestep), model.qpos0.tobytes(),
           model.body_mass0.tobytes(), model.dof_armature.tobytes(),
           model.body_inertia.tobytes())
    cached = _INVWEIGHT_CACHE.get(key)
    if cached is not None:
        return dataclasses.replace(model, dof_invweight0=cached[0],
                                   body_invweight0=cached[1])

    bare = dataclasses.replace(model, dof_invweight0=np.zeros(model.nv),
                               body_invweight0=np.zeros(model.nbody))
    mass_mat, cdof, xipos = oracle.Native(bare).smooth0(
        model.qpos0, default_mutable(model, np.float64))
    minv = np.linalg.inv(mass_mat)
    dof_inv = np.diagonal(minv).copy()
    body_inv, body_inv_rot = [0.0], [0.0]
    for b in range(1, model.nbody):
        mask = np.asarray(model.body_dof[b], np.float64)[:, None]
        jc = (cdof[:, 3:] + np.cross(cdof[:, :3], xipos[b])) * mask
        body_inv.append(float(np.trace(jc.T @ (minv @ jc))) / 3.0)
        jr = cdof[:, :3] * mask                           # (nv,3) angular
        body_inv_rot.append(float(np.trace(jr.T @ (minv @ jr))) / 3.0)
    # free-joint dofs take the body weights (isotropic), not diag(M0^-1) —
    # matches mj.dof_invweight0 for the Ant free root
    for ji in range(model.njnt):
        if model.jnt_type[ji] == FREE:
            da, b = int(model.jnt_dofadr[ji]), int(model.jnt_body[ji])
            dof_inv[da:da + 3] = body_inv[b]
            dof_inv[da + 3:da + 6] = body_inv_rot[b]
    # MuJoCo marks slide-only leaf bodies with centered inertia as "simple"
    # (body_simple==2: the spring-loaded blocks, the arm's target) and uses
    # plain 1/mass for their weights — armature excluded, no /3 dilution
    # (observed vs mj.body_simple/dof_invweight0 in the crosscheck tests)
    has_child = set(int(p) for p in model.body_parent[1:])
    for b in range(1, model.nbody):
        jis = [ji for ji in range(model.njnt)
               if int(model.jnt_body[ji]) == b]
        if (b not in has_child and jis and
                all(model.jnt_type[ji] == SLIDE for ji in jis) and
                np.allclose(model.body_ipos[b], 0.0)):
            w = 1.0 / max(float(model.body_mass0[b]), 1e-12)
            body_inv[b] = w
            for ji in jis:
                dof_inv[int(model.jnt_dofadr[ji])] = w
    body_inv = np.asarray(body_inv, np.float64)
    _INVWEIGHT_CACHE[key] = (dof_inv, body_inv)
    return dataclasses.replace(
        model, dof_invweight0=dof_inv, body_invweight0=body_inv)


_INVWEIGHT_CACHE = {}
