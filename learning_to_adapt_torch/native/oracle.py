"""ctypes binding of the native C++ physics oracle (native/ltao_physics.cc
at the repository's root; native/oracle.py of the JAX package).

The oracle is an independent float64 CPU implementation of the engine's
articulated-body pipeline: replayed trajectories are checked against it
(sim_policy.check_native). It reads the port's own PhysicsModel.

The shared library is compiled on demand with g++ into
learning_to_adapt_torch/_build/ (git-ignored), apart from the JAX binding's
native/libltao_physics.so, so the two bindings never build one file at
once. It is rebuilt when the source's content hash changes.
"""
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from learning_to_adapt_torch.physics.spec import (
    MutableModel, PhysicsModel, default_mutable)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / 'native' / 'ltao_physics.cc'
BUILD_DIR = _PKG / '_build'

# pair-kind codes: must match enum PairKind in native/ltao_physics.cc
KIND_CODES = {
    'plane_sphere': 0, 'plane_capsule': 1, 'hfield_sphere': 2,
    'hfield_capsule': 3, 'sphere_sphere': 4, 'sphere_capsule': 5,
    'capsule_capsule': 6, 'capsule_box': 7, 'sphere_box': 8, 'box_box': 9,
}

_SOLVER_CODES = {'jacobi': 0, 'pgs': 1}

_lib = None


def _build(src):
    """Path of the library for src, compiled unless the stamp beside it
    holds src's content hash (a fresh clone gives every file one mtime, so
    an mtime check could not tell a stale library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / 'libltao_physics.so'
    stamp = BUILD_DIR / 'libltao_physics.so.sha256'
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    current = stamp.read_text().strip() if stamp.exists() else None
    if not out.exists() or current != digest:
        # compile to a per-process name, then rename into place (atomic on
        # one filesystem): a concurrent build never leaves a half-written
        # library for another process to load; the stamp follows the rename
        tmp = BUILD_DIR / f'libltao_physics.so.{os.getpid()}.tmp'
        try:
            subprocess.run(
                ['g++', '-O2', '-shared', '-fPIC', '-std=c++17', '-o',
                 str(tmp), str(src)], check=True, capture_output=True)
            os.rename(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
        stamp.write_text(digest)
    return out


def load_library():
    """Compile (if stale) and load the oracle; raises if g++ is missing."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build(SOURCE)))
    lib.ltao_model_new.restype = ctypes.c_void_p
    lib.ltao_model_free.argtypes = [ctypes.c_void_p]
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.ltao_model_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, dptr,
                                   ctypes.c_long]
    lib.ltao_model_finalize.argtypes = [ctypes.c_void_p]
    lib.ltao_model_finalize.restype = ctypes.c_int
    lib.ltao_step.argtypes = ([ctypes.c_void_p] + [dptr] * 10 +
                              [ctypes.c_long, dptr, dptr])
    lib.ltao_step.restype = ctypes.c_int
    lib.ltao_forward.argtypes = [ctypes.c_void_p] + [dptr] * 8
    lib.ltao_forward.restype = ctypes.c_int
    _lib = lib
    return lib


def available():
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _as_f64(x):
    return np.ascontiguousarray(np.asarray(x, np.float64))


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativePhysics:
    """Native stepper for one compiled PhysicsModel.

    step(qpos, qvel, ctrl, mm=None)  -> (qpos', qvel')   one physics step
    forward(qpos, qvel, mm=None)     -> dict(xpos, ximat, subtree_com,
                                             subtree_comvel)
    """

    def __init__(self, model: PhysicsModel):
        self._libref = load_library()
        self.model = model
        self._h = self._libref.ltao_model_new()

        def put(name, value):
            arr = _as_f64(value).reshape(-1)
            self._libref.ltao_model_set(
                self._h, name.encode(), _ptr(arr), arr.size)

        m = model
        for name, value in [
                ('nq', m.nq), ('nv', m.nv), ('nu', m.nu), ('nbody', m.nbody),
                ('ngeom', m.ngeom), ('njnt', m.njnt),
                ('timestep', m.timestep), ('gravity', m.gravity),
                ('integrator', m.integrator), ('iterations', m.iterations),
                ('solver', _SOLVER_CODES[m.solver]),
                ('body_parent', m.body_parent), ('body_pos', m.body_pos),
                ('body_quat', m.body_quat), ('body_ipos', m.body_ipos),
                ('body_inertia', m.body_inertia),
                ('jnt_type', m.jnt_type), ('jnt_body', m.jnt_body),
                ('jnt_pos', m.jnt_pos), ('jnt_axis', m.jnt_axis),
                ('jnt_range', m.jnt_range),
                ('jnt_limited', m.jnt_limited.astype(np.float64)),
                ('jnt_stiffness', m.jnt_stiffness),
                ('jnt_springref', m.jnt_springref), ('jnt_ref', m.jnt_ref),
                ('jnt_solref_limit', m.jnt_solref_limit),
                ('jnt_solimp_limit', m.jnt_solimp_limit),
                ('jnt_qposadr', m.jnt_qposadr), ('jnt_dofadr', m.jnt_dofadr),
                ('dof_body', m.dof_body), ('dof_vsrc', m.dof_vsrc),
                ('dof_armature', m.dof_armature),
                ('geom_body', m.geom_body), ('geom_quat', m.geom_quat),
                ('geom_friction', m.geom_friction),
                ('geom_margin', m.geom_margin),
                ('geom_solref', m.geom_solref),
                ('geom_solimp', m.geom_solimp),
                ('geom_condim', m.geom_condim),
                ('act_dofadr', m.act_dofadr), ('act_gear', m.act_gear),
                ('act_ctrlrange', m.act_ctrlrange),
                ('body_ancestor', m.body_ancestor.astype(np.float64)),
                ('dof_ancestor', m.dof_ancestor.astype(np.float64)),
                ('body_dof', m.body_dof.astype(np.float64)),
                ('dof_invweight0', m.dof_invweight0),
                ('body_invweight0', m.body_invweight0),
        ]:
            put(name, value)

        # candidate pairs flattened in the engine's order (model.pair_groups
        # in turn), so the constraint rows, and with them the solver's
        # trajectory, are laid out as the engine lays them out
        kinds, g1s, g2s = [], [], []
        for kind, pairs in m.pair_groups:
            for a, b in pairs:
                kinds.append(KIND_CODES[kind])
                g1s.append(int(a))
                g2s.append(int(b))
        if kinds:
            put('pair_kind', kinds)
            put('pair_g1', g1s)
            put('pair_g2', g2s)

        if self._libref.ltao_model_finalize(self._h) != 0:
            raise RuntimeError('ltao_model_finalize failed: missing fields')

    def __del__(self):
        if getattr(self, '_h', None) and getattr(self, '_libref', None):
            self._libref.ltao_model_free(self._h)
            self._h = None

    def _mm(self, mm):
        if mm is None:
            mm = default_mutable(self.model, np.float64)
        return mm

    def step(self, qpos, qvel, ctrl, mm: MutableModel = None):
        mm = self._mm(mm)
        qpos = _as_f64(qpos)
        qvel = _as_f64(qvel)
        ctrl = _as_f64(ctrl) if self.model.nu else np.zeros(1)
        bm = _as_f64(mm.body_mass)
        dd = _as_f64(mm.dof_damping)
        gs = _as_f64(mm.geom_size)
        gp = _as_f64(mm.geom_pos)
        xf = _as_f64(mm.xfrc_applied)
        hs = _as_f64(mm.hfield_size)
        hr = _as_f64(mm.hfield_row)
        out_qpos = np.empty(self.model.nq, np.float64)
        out_qvel = np.empty(self.model.nv, np.float64)
        rc = self._libref.ltao_step(
            self._h, _ptr(qpos), _ptr(qvel), _ptr(ctrl), _ptr(bm), _ptr(dd),
            _ptr(gs), _ptr(gp), _ptr(xf), _ptr(hs), _ptr(hr), hr.size,
            _ptr(out_qpos), _ptr(out_qvel))
        if rc != 0:
            raise RuntimeError(f'ltao_step failed rc={rc}')
        return out_qpos, out_qvel

    def forward(self, qpos, qvel, mm: MutableModel = None):
        mm = self._mm(mm)
        qpos = _as_f64(qpos)
        qvel = _as_f64(qvel)
        bm = _as_f64(mm.body_mass)
        gp = _as_f64(mm.geom_pos)
        nb = self.model.nbody
        xpos = np.empty((nb, 3), np.float64)
        ximat = np.empty((nb, 3, 3), np.float64)
        com = np.empty((nb, 3), np.float64)
        comvel = np.empty((nb, 3), np.float64)
        rc = self._libref.ltao_forward(
            self._h, _ptr(qpos), _ptr(qvel), _ptr(bm), _ptr(gp),
            _ptr(xpos), _ptr(ximat), _ptr(com), _ptr(comvel))
        if rc != 0:
            raise RuntimeError(f'ltao_forward failed rc={rc}')
        return dict(xpos=xpos, ximat=ximat, subtree_com=com,
                    subtree_comvel=comvel)
