"""Parity of the port's narrow-phase colliders
(learning_to_adapt_torch.physics.collision) with the JAX package's: every
collider on seeded numpy configurations, batched over (env, pair) in the
port and vmapped in JAX, at float64 and float32.

Tolerances: float64 1e-9 (the two differ only in summation order); float32
2e-5 relative and absolute (a few ulps of the unit-scale inputs through
norms, divisions and 3x3 products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_to_adapt_torch.physics import collision as port
from learning_to_adapt_tpu.physics import collision as ref

torch.set_num_threads(2)  # the suite runs 6 workers on 8 cores

E, P = 2, 6                       # the port's (env, pair) batch
NCOL = 500
TOL = {'f64': dict(rtol=1e-9, atol=1e-9), 'f32': dict(rtol=2e-5, atol=2e-5)}
DTYPES = {'f64': (np.float64, torch.float64, True),
          'f32': (np.float32, torch.float32, False)}


def _rot(rng, n, scale=np.pi):
    """n rotation matrices about random axes by angles up to `scale`."""
    ax = rng.randn(n, 3)
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = rng.uniform(-scale, scale, n)
    k = np.zeros((n, 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -ax[:, 2], ax[:, 1], -ax[:, 0]
    k = k - np.swapaxes(k, 1, 2)
    s, c = np.sin(ang)[:, None, None], np.cos(ang)[:, None, None]
    return np.eye(3) + s * k + (1 - c) * (k @ k)


def _axis_rot(axis, angle):
    k = np.zeros((3, 3))
    k[0, 1], k[0, 2], k[1, 2] = -axis[2], axis[1], -axis[0]
    k = k - k.T
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _profile(rng, cliff=False):
    if cliff:
        row = (np.arange(NCOL) >= 250).astype(np.float64)
    else:
        row = np.cumsum(rng.uniform(-1, 1, NCOL))
    return (row - row.min()) / (row.max() - row.min())


# ---- configurations: name -> (collider, args as float64 numpy) ----------
# every array has a leading axis of E * P configurations, except hf_row,
# which has one row per env (E, NCOL)

def _spheres(rng, coincident=False):
    n = E * P
    c1 = rng.randn(n, 3) * 0.3
    c2 = c1.copy() if coincident else c1 + rng.randn(n, 3) * 0.2
    return 'sphere_sphere', (c1, rng.uniform(.02, .1, n), c2,
                             rng.uniform(.02, .1, n))


def _plane(rng, capsule=False):
    n = E * P
    args = (rng.randn(n, 3) * 0.1, _rot(rng, n, 0.4))
    if capsule:
        return 'plane_capsule', args + (rng.randn(n, 3) * 0.2, _rot(rng, n),
                                        rng.uniform(.02, .1, n),
                                        rng.uniform(.05, .2, n))
    return 'plane_sphere', args + (rng.randn(n, 3) * 0.2,
                                   rng.uniform(.02, .1, n))


def _hfield(rng, where, capsule=False):
    n = E * P
    rows = np.stack([_profile(rng, cliff=where == 'rim')
                     for _ in range(E)])
    size = np.tile([50., 5., 0.8, 0.1], (n, 1))
    size[:, 2] = rng.uniform(0.2, 1.0, n)
    hf_pos = np.zeros((n, 3))
    dx = 100.0 / (NCOL - 1)
    x = {'random': rng.uniform(-45, 45, n),
         'col0': rng.uniform(-53, -49.9, n),
         'col499': rng.uniform(49.9, 53, n),
         'rim': 250 * dx - 50 + rng.uniform(-0.3, 0.3, n),
         'depth_cap': rng.uniform(-40, 40, n)}[where]
    col = np.clip(((x + 50) / dx).astype(int), 0, NCOL - 1)
    env = np.repeat(np.arange(E), P)
    surf = rows[env, col] * size[:, 2]
    dz = {'depth_cap': rng.uniform(-0.6, -0.2, n),
          'rim': rng.uniform(-0.1, 0.15, n)}.get(
        where, rng.uniform(-0.08, 0.12, n))
    c = np.stack([x, rng.uniform(-1, 1, n), surf + dz], axis=1)
    r = rng.uniform(.04, .1, n)
    if capsule:
        return 'hfield_capsule', (hf_pos, size, rows, c, _rot(rng, n), r,
                                  rng.uniform(.05, .15, n))
    return 'hfield_sphere', (hf_pos, size, rows, c, r)


def _capsules(rng, near_parallel=False):
    """near_parallel: axes 0.05-0.2 rad apart (exactly parallel segments
    make the clamped closest-point parameter depend on rounding noise)."""
    n = E * P
    m1 = _rot(rng, n)
    m2 = m1 @ _rot(rng, n, 0.2) if near_parallel else _rot(rng, n)
    p1 = rng.randn(n, 3) * 0.2
    return 'capsule_capsule', (p1, m1, rng.uniform(.02, .06, n),
                               rng.uniform(.05, .2, n),
                               p1 + rng.randn(n, 3) * 0.15, m2,
                               rng.uniform(.02, .06, n),
                               rng.uniform(.05, .2, n))


def _sphere_capsule(rng):
    n = E * P
    return 'sphere_capsule', (rng.randn(n, 3) * 0.2, rng.uniform(.02, .1, n),
                              rng.randn(n, 3) * 0.2, _rot(rng, n),
                              rng.uniform(.02, .06, n),
                              rng.uniform(.05, .2, n))


def _box(rng, n):
    return rng.randn(n, 3) * 0.1, _rot(rng, n), rng.uniform(.05, .3, (n, 3))


def _near_box_surface(rng, pos, mat, half, feature):
    """Points just outside or inside a box near a face, an edge or a
    corner (box frame -> world)."""
    n = len(pos)
    sgn = np.where(rng.rand(n, 3) < 0.5, -1.0, 1.0)
    local = sgn * half * rng.uniform(0.2, 0.8, (n, 3))
    n_out = {'face': 1, 'edge': 2, 'corner': 3, 'inside': 0}[feature]
    local[:, :n_out] = sgn[:, :n_out] * (half[:, :n_out] +
                                         rng.uniform(-0.04, 0.04, (n, n_out)))
    return pos + np.einsum('nij,nj->ni', mat, local)


def _sphere_box(rng, feature):
    n = E * P
    pos, mat, half = _box(rng, n)
    c = _near_box_surface(rng, pos, mat, half, feature)
    return 'sphere_box', (c, rng.uniform(.02, .06, n), pos, mat, half)


def _capsule_box(rng, feature):
    """Both endpoint spheres of each capsule near the box's edges, corners
    or inside it."""
    n = E * P
    pos, mat, half = _box(rng, n)
    e1 = _near_box_surface(rng, pos, mat, half, feature)
    e2 = _near_box_surface(rng, pos, mat, half, feature)
    axis = e1 - e2
    hl = 0.5 * np.linalg.norm(axis, axis=1)
    z = axis / np.maximum(2 * hl, 1e-9)[:, None]
    # a frame whose third column is the capsule axis
    ref_ax = np.where(np.abs(z[:, :1]) < 0.5, [[1., 0., 0.]], [[0., 1., 0.]])
    x = np.cross(z, ref_ax)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cap_mat = np.stack([x, np.cross(z, x), z], axis=2)
    return 'capsule_box', (0.5 * (e1 + e2), cap_mat, rng.uniform(.01, .04, n),
                           hl, pos, mat, half)


def _box_box(rng, case):
    """face: a box resting tilted on another's face (reference face
    manifolds, some corners outside); edge: two boxes turned 45 degrees
    about crossing axes, edges touching; separated: apart (the face
    manifold's unused slots); random: anything."""
    n = E * P
    half1 = rng.uniform(.1, .3, (n, 3))
    half2 = rng.uniform(.05, .2, (n, 3))
    m1 = _rot(rng, n, 0.3)
    p1 = rng.randn(n, 3) * 0.1
    if case == 'face':
        m2 = m1 @ _rot(rng, n, 0.15)
        up = m1[:, :, 2]
        p2 = (p1 + up * (half1[:, 2:] + half2[:, 2:] +
                         rng.uniform(-.03, .01, (n, 1))) +
              np.einsum('nij,nj->ni', m1, rng.uniform(-.1, .1, (n, 3)) *
                        [1, 1, 0]))
    elif case == 'edge':
        rx = _axis_rot(np.array([1., 0., 0.]), np.pi / 4)
        ry = _axis_rot(np.array([0., 1., 0.]), np.pi / 4)
        m1 = np.broadcast_to(rx, (n, 3, 3)) @ _rot(rng, n, 0.05)
        m2 = np.broadcast_to(ry, (n, 3, 3)) @ _rot(rng, n, 0.05)
        # the top edge of box 1 (along x) against the bottom edge of box 2
        # (along y)
        gap = rng.uniform(-.02, .02, n)
        z1 = np.sqrt(half1[:, 1] ** 2 + half1[:, 2] ** 2)
        z2 = np.sqrt(half2[:, 0] ** 2 + half2[:, 2] ** 2)
        p2 = p1 + np.stack([rng.uniform(-.02, .02, n),
                            rng.uniform(-.02, .02, n), z1 + z2 + gap], 1)
    elif case == 'separated':
        m2 = _rot(rng, n)
        p2 = p1 + rng.randn(n, 3) * 0.1 + [[1.5, 0., 0.]]
    else:
        m2 = _rot(rng, n)
        p2 = p1 + rng.randn(n, 3) * 0.25
    return 'box_box', (p1, m1, half1, p2, m2, half2)


CASES = {
    'sphere_sphere': lambda r: _spheres(r),
    'sphere_sphere-coincident': lambda r: _spheres(r, coincident=True),
    'plane_sphere': lambda r: _plane(r),
    'plane_capsule': lambda r: _plane(r, capsule=True),
    'hfield_sphere': lambda r: _hfield(r, 'random'),
    'hfield_sphere-col0': lambda r: _hfield(r, 'col0'),
    'hfield_sphere-col499': lambda r: _hfield(r, 'col499'),
    'hfield_sphere-cliff_rim': lambda r: _hfield(r, 'rim'),
    'hfield_sphere-depth_cap': lambda r: _hfield(r, 'depth_cap'),
    'hfield_capsule': lambda r: _hfield(r, 'random', capsule=True),
    'hfield_capsule-cliff_rim': lambda r: _hfield(r, 'rim', capsule=True),
    'sphere_capsule': _sphere_capsule,
    'capsule_capsule': lambda r: _capsules(r),
    'capsule_capsule-near_parallel': lambda r: _capsules(
        r, near_parallel=True),
    'sphere_box-outside': lambda r: _sphere_box(r, 'edge'),
    'sphere_box-inside': lambda r: _sphere_box(r, 'inside'),
    'capsule_box-faces': lambda r: _capsule_box(r, 'face'),
    'capsule_box-edges': lambda r: _capsule_box(r, 'edge'),
    'capsule_box-corners': lambda r: _capsule_box(r, 'corner'),
    'capsule_box-inside': lambda r: _capsule_box(r, 'inside'),
    'box_box-face': lambda r: _box_box(r, 'face'),
    'box_box-edge': lambda r: _box_box(r, 'edge'),
    'box_box-separated': lambda r: _box_box(r, 'separated'),
    'box_box-random': lambda r: _box_box(r, 'random'),
}

HF = ('hfield_sphere', 'hfield_capsule')


def _run(kind, args, precision):
    dt, tdt, x64 = DTYPES[precision]
    if kind in HF:
        # JAX takes one terrain (hf_pos, hf_size, hf_row shared by vmap's
        # closure in the engine); vmap its row here too, one per pair
        env = np.repeat(np.arange(E), P)
        jargs = (args[0], args[1], args[2][env]) + args[3:]
        targs = (args[0], args[1],
                 np.broadcast_to(args[2][:, None], (E, P, NCOL))) + args[3:]
    else:
        jargs = targs = args
    with jax.enable_x64(x64):
        want = jax.jit(jax.vmap(getattr(ref, kind)))(
            *(jnp.asarray(a, dt) for a in jargs))
        want = [np.asarray(w) for w in want]

    def tt(a):
        a = torch.as_tensor(np.array(a), dtype=tdt)
        return a if a.dim() > 1 and a.shape[:2] == (E, P) else \
            a.reshape((E, P) + a.shape[1:])
    got = getattr(port, kind)(*(tt(a) for a in targs))
    return [g.reshape((E * P,) + g.shape[2:]).numpy() for g in got], want


@pytest.mark.parametrize('precision', ['f64', 'f32'])
@pytest.mark.parametrize('case', list(CASES))
def test_collider_matches_jax(case, precision):
    rng = np.random.RandomState(sorted(CASES).index(case))
    kind, args = CASES[case](rng)
    got, want = _run(kind, args, precision)
    names = ('dist', 'pos', 'normal')
    assert got[0].shape[1] == port.POINTS[kind] == want[0].shape[1]
    for g, w, name in zip(got, want, names):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, **TOL[precision],
                                   err_msg=f'{case} {precision} {name}')


def _active(case):
    rng = np.random.RandomState(sorted(CASES).index(case))
    kind, args = CASES[case](rng)
    return kind, _run(kind, args, 'f64')[1]


@pytest.mark.parametrize('case,what', [
    ('box_box-face', 'face manifolds with 2 or more touching points'),
    ('box_box-edge', 'edge-edge contacts with 3 inert slots'),
    ('box_box-separated', 'unused face-manifold slots at _BIG'),
    ('hfield_sphere-depth_cap', 'the depth cap'),
    ('hfield_sphere-col0', 'the first column'),
    ('hfield_sphere-col499', 'the last column'),
    ('capsule_box-inside', 'centers inside the box'),
])
def test_configurations_reach_their_branch(case, what):
    """The configurations above exercise what they are named for, so the
    parity test covers each branch of the colliders."""
    kind, (dist, pos, normal) = _active(case)
    if case == 'box_box-face':
        assert ((dist < 0).sum(1) >= 2).any(), what
    elif case == 'box_box-edge':
        inert = dist[:, 1:] >= 0.5 * port._BIG
        assert inert.all(axis=1).any() and (dist[:, 0] < 0.02).any(), what
        np.testing.assert_allclose(np.linalg.norm(normal, axis=-1), 1.0)
    elif case == 'box_box-separated':
        assert (dist >= 0.5 * port._BIG).any(), what
    elif case == 'hfield_sphere-depth_cap':
        rng = np.random.RandomState(sorted(CASES).index(case))
        r = CASES[case](rng)[1][4]
        np.testing.assert_allclose(dist[:, 0], -(r + 0.005), rtol=1e-12)
    elif case in ('hfield_sphere-col0', 'hfield_sphere-col499'):
        assert np.isfinite(dist).all() and np.isfinite(normal).all(), what
    elif case == 'capsule_box-inside':
        assert (dist < 0).all(), what


@pytest.mark.parametrize('precision', ['f64', 'f32'])
def test_hfield_surface_clip_at_last_column(precision):
    """_hfield_surface clips the sample index at ncol - 1.000001 in the
    array's dtype (499.0 in float32), so height and slope agree with JAX at
    and beyond the last column."""
    dt, tdt, x64 = DTYPES[precision]
    rng = np.random.RandomState(5)
    row = _profile(rng)
    size = np.array([50., 5., 0.7, 0.1])
    xs = np.array([49.5, 49.9, 50.0, 50.0 - 1e-7, 51.0, -50.0, -51.0])
    with jax.enable_x64(x64):
        want = jax.vmap(lambda x: ref._hfield_surface(
            jnp.zeros(3, dt), jnp.asarray(size, dt), jnp.asarray(row, dt),
            x, jnp.zeros((), dt)))(jnp.asarray(xs, dt))
    n = len(xs)
    got = port._hfield_surface(
        torch.zeros((n, 3), dtype=tdt), torch.as_tensor(size, dtype=tdt)
        .expand(n, 4), torch.as_tensor(row, dtype=tdt).expand(n, NCOL),
        torch.as_tensor(xs, dtype=tdt), torch.zeros(n, dtype=tdt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **TOL[precision])
