"""ctypes binding of the reference physics, native/ltao_physics.cc beside
this file: an f64 C++ implementation of the articulated-body step written
apart from the port's engine. It reads a PhysicsModel of the frozen model
compiler (reference/physics/spec.py).

The library is compiled with g++ on first use into port_bench/_build/ in
the checkout, and again only when the source's content hash changes.
Written after the port's binding of the same library
(learning_to_adapt_torch/native/oracle.py at commit 0fd707d).
"""
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / 'native' / 'ltao_physics.cc'
BUILD_DIR = HERE.parent / '_build'

# pair-kind codes: must match enum PairKind in native/ltao_physics.cc
KIND_CODES = {
    'plane_sphere': 0, 'plane_capsule': 1, 'hfield_sphere': 2,
    'hfield_capsule': 3, 'sphere_sphere': 4, 'sphere_capsule': 5,
    'capsule_capsule': 6, 'capsule_box': 7, 'sphere_box': 8, 'box_box': 9,
}
SOLVER_CODES = {'jacobi': 0, 'pgs': 1}
# mantissa bits of the products' operands for each rounding (TF32 keeps 10)
ROUNDING_BITS = {None: 0, 'tf32': 10}

_lib = None


def _build():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / 'libltao_physics.so'
    stamp = BUILD_DIR / 'libltao_physics.so.sha256'
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()
    if out.exists() and stamp.exists() and stamp.read_text() == digest:
        return out
    tmp = BUILD_DIR / f'libltao_physics.so.{os.getpid()}.tmp'
    try:
        subprocess.run(['g++', '-O2', '-shared', '-fPIC', '-std=c++17',
                        '-o', str(tmp), str(SOURCE)], check=True,
                       capture_output=True)
        os.rename(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    stamp.write_text(digest)
    return out


def library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        d = ctypes.POINTER(ctypes.c_double)
        lib.ltao_model_new.restype = ctypes.c_void_p
        lib.ltao_model_free.argtypes = [ctypes.c_void_p]
        lib.ltao_model_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, d,
                                       ctypes.c_long]
        lib.ltao_model_finalize.argtypes = [ctypes.c_void_p]
        lib.ltao_step.argtypes = ([ctypes.c_void_p] + [d] * 10 +
                                  [ctypes.c_long, d, d])
        lib.ltao_forward.argtypes = [ctypes.c_void_p] + [d] * 8
        lib.ltao_smooth0.argtypes = [ctypes.c_void_p] + [d] * 9
        lib.ltao_set_rounding.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _f64(x):
    return np.ascontiguousarray(np.asarray(x, np.float64))


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class Native:
    """The C++ physics of one compiled model. mm: a MutableModel of f64
    arrays (spec.default_mutable)."""

    def __init__(self, model):
        self.lib = library()
        self.model = m = model
        self.h = self.lib.ltao_model_new()
        fields = [
            'nq', 'nv', 'nu', 'nbody', 'ngeom', 'njnt', 'timestep',
            'gravity', 'integrator', 'iterations', 'body_parent',
            'body_pos', 'body_quat', 'body_ipos', 'body_inertia',
            'jnt_type', 'jnt_body', 'jnt_pos', 'jnt_axis', 'jnt_range',
            'jnt_limited', 'jnt_stiffness', 'jnt_springref', 'jnt_ref',
            'jnt_solref_limit', 'jnt_solimp_limit', 'jnt_qposadr',
            'jnt_dofadr', 'dof_body', 'dof_vsrc', 'dof_armature',
            'geom_body', 'geom_quat', 'geom_friction', 'geom_margin',
            'geom_solref', 'geom_solimp', 'geom_condim', 'act_dofadr',
            'act_gear', 'act_ctrlrange', 'body_ancestor', 'dof_ancestor',
            'body_dof', 'dof_invweight0', 'body_invweight0']
        for name in fields:
            self._put(name, getattr(m, name))
        self._put('solver', SOLVER_CODES[m.solver])
        # candidate pairs in the model's order, as its constraint rows are
        pairs = [(KIND_CODES[kind], a, b) for kind, group in m.pair_groups
                 for a, b in group]
        if pairs:
            for i, name in enumerate(('pair_kind', 'pair_g1', 'pair_g2')):
                self._put(name, [p[i] for p in pairs])
        if self.lib.ltao_model_finalize(self.h) != 0:
            raise RuntimeError('the C++ physics lacks a field of the model')

    def _put(self, name, value):
        a = _f64(value).reshape(-1)
        self.lib.ltao_model_set(self.h, name.encode(), _ptr(a), a.size)

    def __del__(self):
        if getattr(self, 'h', None):
            self.lib.ltao_model_free(self.h)
            self.h = None

    def step(self, qpos, qvel, ctrl, mm, rounding=None):
        """One physics step of one env: (qpos', qvel')."""
        qpos, qvel = _f64(qpos), _f64(qvel)
        ctrl = _f64(ctrl) if self.model.nu else np.zeros(1)
        args = [_f64(getattr(mm, k)) for k in (
            'body_mass', 'dof_damping', 'geom_size', 'geom_pos',
            'xfrc_applied', 'hfield_size', 'hfield_row')]
        out_q = np.empty(self.model.nq)
        out_v = np.empty(self.model.nv)
        self.lib.ltao_set_rounding(ROUNDING_BITS[rounding])
        try:
            self.lib.ltao_step(self.h, _ptr(qpos), _ptr(qvel), _ptr(ctrl),
                               *(_ptr(a) for a in args), args[-1].size,
                               _ptr(out_q), _ptr(out_v))
        finally:
            self.lib.ltao_set_rounding(0)
        return out_q, out_v

    def forward(self, qpos, qvel, mm):
        """(subtree COM, subtree COM velocity), each (nbody, 3)."""
        nb = self.model.nbody
        xpos, ximat = np.empty((nb, 3)), np.empty((nb, 3, 3))
        com, comvel = np.empty((nb, 3)), np.empty((nb, 3))
        bm, gp = _f64(mm.body_mass), _f64(mm.geom_pos)
        self.lib.ltao_forward(self.h, _ptr(_f64(qpos)), _ptr(_f64(qvel)),
                              _ptr(bm), _ptr(gp), _ptr(xpos), _ptr(ximat),
                              _ptr(com), _ptr(comvel))
        return com, comvel

    def smooth0(self, qpos, mm):
        """(mass matrix (nv, nv), motion subspace (nv, 6), body COMs
        (nbody, 3)) at qpos, at rest."""
        m = self.model
        mass = np.empty((m.nv, m.nv))
        cdof = np.empty((m.nv, 6))
        xipos = np.empty((m.nbody, 3))
        args = [_f64(getattr(mm, k)) for k in (
            'body_mass', 'dof_damping', 'geom_size', 'geom_pos',
            'xfrc_applied')]
        self.lib.ltao_smooth0(self.h, _ptr(_f64(qpos)),
                              *(_ptr(a) for a in args), _ptr(mass),
                              _ptr(cdof), _ptr(xipos))
        return mass, cdof, xipos
