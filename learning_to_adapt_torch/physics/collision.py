"""Narrow-phase collision kernels.

Counterparts of every collider in learning_to_adapt_tpu/physics/collision.py
(plane, heightfield, sphere, capsule and box pairs), written over any
leading batch shape (env, pair) instead of under vmap. Every branch is a
select, so a step issues the same operations whatever the configuration
and never waits for the device.

Each contact: (dist, pos(3,), normal(3,)) with the normal pointing from
geom1 toward geom2, so d(dist)/dt = n . (v_p(body2) - v_p(body1)). A pair
kind gives a fixed number of candidate contacts per pair (`POINTS`);
inactive candidates are masked by ``dist > margin`` downstream.

The heightfield is its x-profile row (MutableModel.hfield_row, one per env)
because every terrain task generates terrain constant along y.
"""
import numpy as np
import torch

#: candidate contacts per pair of each kind
POINTS = dict(plane_sphere=1, plane_capsule=2, hfield_sphere=1,
              hfield_capsule=2, sphere_sphere=1, sphere_capsule=1,
              capsule_capsule=1, sphere_box=1, capsule_box=2, box_box=4)

#: distance of an inert box-box slot
_BIG = 1e6
HF_WINDOW = 16  # polyline cells searched each side of the sphere center

_CONSTS = {}


def _consts(like):
    """Small constant tensors on like's device in its dtype, made once: a
    copy from the host inside a step would make it wait for the card."""
    key = (like.device, like.dtype)
    c = _CONSTS.get(key)
    if c is None:
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                   device=like.device)
        c = dict(z=t([0., 0., 1.]), eye=t(np.eye(3)),
                 signs=t([[1., 1.], [1., -1.], [-1., -1.], [-1., 1.]]),
                 ar3=torch.arange(3, device=like.device))
        _CONSTS[key] = c
    return c


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mv(m, v):
    """m (..., 3, 3) @ v (..., 3)."""
    return (m @ v[..., None])[..., 0]


def _mtv(m, v):
    """m^T @ v."""
    return (m.transpose(-1, -2) @ v[..., None])[..., 0]


def _take(x, i):
    """x[..., i] with an index per batch element: x (..., n), i (...)."""
    return torch.gather(x, -1, i[..., None])[..., 0]


def _one_hot3(k, like):
    return (_consts(like)['ar3'] == k[..., None]).to(like.dtype)


def _pm1(cond, like):
    """+1 where cond, else -1, in like's dtype."""
    return torch.where(cond, 1.0, -1.0).to(like.dtype)


def _bound(x, like):
    """The Python float x as the tensor's dtype rounds it (jnp.clip's
    weakly typed bounds are cast to the array's dtype)."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}
    return float(np.asarray(x, np_dtype[like.dtype]))


def _sphere_sphere_raw(c1, r1, c2, r2):
    d = c2 - c1
    dist_c = torch.linalg.norm(d, dim=-1)
    # guard zero distance (coincident centers)
    ok = dist_c > 1e-9
    n = d / torch.where(ok, dist_c, 1.0)[..., None]
    n = torch.where(ok[..., None], n, _consts(d)['z'])
    dist = dist_c - r1 - r2
    pos = c1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, n


def _one(d, p, n):
    return d[..., None], p[..., None, :], n[..., None, :]


def plane_sphere(plane_pos, plane_mat, c, r):
    """Plane is geom1. plane_pos/c (..., 3), plane_mat (..., 3, 3), r (...).
    Returns 1 contact: dist (..., 1), pos (..., 1, 3), normal (..., 1, 3)."""
    n = plane_mat[..., :, 2]
    dist = torch.sum(n * (c - plane_pos), dim=-1) - r
    pos = c - n * (r + 0.5 * dist)[..., None]
    n = n.expand(pos.shape)
    return _one(dist, pos, n)


def _endpoints(cap_pos, cap_mat, hl):
    axis = cap_mat[..., :, 2]
    return cap_pos + axis * hl[..., None], cap_pos - axis * hl[..., None]


def _two(first, second):
    """Two 1-point contacts side by side: dist (..., 2), pos/n (..., 2, 3)."""
    (d1, p1, n1), (d2, p2, n2) = first, second
    return (torch.cat([d1, d2], dim=-1), torch.cat([p1, p2], dim=-2),
            torch.cat([n1, n2], dim=-2))


def plane_capsule(plane_pos, plane_mat, cap_pos, cap_mat, r, hl):
    """Plane is geom1. Returns 2 contacts (one per capsule endpoint):
    dist (..., 2), pos (..., 2, 3), normal (..., 2, 3)."""
    e1, e2 = _endpoints(cap_pos, cap_mat, hl)
    return _two(plane_sphere(plane_pos, plane_mat, e1, r),
                plane_sphere(plane_pos, plane_mat, e2, r))


def _hfield_surface(hf_pos, hf_size, hf_row, x, y):
    """Surface height and outward normal of the x-profile heightfield at
    world (x, y). hf_row (..., ncol) is the normalized [0,1] profile along
    x with ncol samples spanning [-size_x, size_x]."""
    ncol = hf_row.shape[-1]
    sx, sz = hf_size[..., 0], hf_size[..., 2]
    u = (x - hf_pos[..., 0] + sx) / (2 * sx) * (ncol - 1)
    u = torch.clamp(u, 0.0, _bound(ncol - 1.000001, u))
    i0 = torch.floor(u).long()
    frac = u - i0
    h0 = _take(hf_row, i0)
    h1 = _take(hf_row, torch.clamp(i0 + 1, max=ncol - 1))
    z = hf_pos[..., 2] + (h0 + (h1 - h0) * frac) * sz
    # slope dz/dx from the local cell
    dx_cell = 2 * sx / (ncol - 1)
    slope = (h1 - h0) * sz / dx_cell
    n = torch.stack([-slope, torch.zeros_like(slope),
                     torch.ones_like(slope)], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    return z, n


def hfield_sphere(hf_pos, hf_size, hf_row, c, r):
    """Heightfield is geom1: hf_pos (..., 3), hf_size (..., 4), hf_row
    (..., ncol), c (..., 3), r (...). Returns 1 contact.

    Nearest-feature distance to the terrain's x-z polyline over +-HF_WINDOW
    cells around the sphere's column (the window's start clipped to the
    row), signed by the surface height, the depth capped at r + 0.005."""
    ncol = hf_row.shape[-1]
    sx, sz = hf_size[..., 0], hf_size[..., 2]
    dx_cell = 2 * sx / (ncol - 1)
    u = (c[..., 0] - hf_pos[..., 0] + sx) / (2 * sx) * (ncol - 1)
    i_c = torch.floor(u).long()
    w = 2 * HF_WINDOW + 1
    start = torch.clamp(i_c - HF_WINDOW, 0, ncol - w)
    idx = start[..., None] + torch.arange(w, device=c.device)
    zs = torch.gather(hf_row, -1, idx) * sz[..., None] + hf_pos[..., 2:3]
    xs = (idx * dx_cell[..., None] - sx[..., None] +
          hf_pos[..., 0:1]).to(zs.dtype)
    p = torch.stack([c[..., 0], c[..., 2]], dim=-1)
    a = torch.stack([xs[..., :-1], zs[..., :-1]], dim=-1)     # (..., w-1, 2)
    ab = torch.stack([xs[..., 1:], zs[..., 1:]], dim=-1) - a
    t = torch.clamp(torch.sum((p[..., None, :] - a) * ab, dim=-1)
                    / torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12),
                    0.0, 1.0)
    q = a + t[..., None] * ab                                 # per segment
    d2 = torch.sum(torch.square(p[..., None, :] - q), dim=-1)
    k = torch.argmin(d2, dim=-1)                              # first minimum
    qk = torch.gather(q, -2, k[..., None, None].expand(
        k.shape + (1, 2)))[..., 0, :]
    diff = p - qk
    dist2d = torch.sqrt(_take(d2, k) + 1e-16)
    z_surf, n_loc = _hfield_surface(hf_pos, hf_size, hf_row, c[..., 0],
                                    c[..., 1])
    sign = -_pm1(c[..., 2] < z_surf, dist2d)
    n2 = sign[..., None] * diff / dist2d[..., None]
    # degenerate (center exactly on the surface): local cell normal
    n2 = torch.where((dist2d < 1e-9)[..., None],
                     torch.stack([n_loc[..., 0], n_loc[..., 2]], dim=-1), n2)
    n = torch.stack([n2[..., 0], torch.zeros_like(n2[..., 0]), n2[..., 1]],
                    dim=-1)
    dist = sign * dist2d - r
    # the depth saturates at the center-on-surface configuration, as the
    # JAX collider's prism-collider measurement fixes it
    dist = torch.maximum(dist, -(r + 0.005))
    pos = c - n * (r + 0.5 * dist)[..., None]
    return _one(dist, pos, n)


def hfield_capsule(hf_pos, hf_size, hf_row, cap_pos, cap_mat, r, hl):
    """Capsule vs heightfield: the endpoint spheres against the terrain
    polyline. 2 contacts."""
    e1, e2 = _endpoints(cap_pos, cap_mat, hl)
    return _two(hfield_sphere(hf_pos, hf_size, hf_row, e1, r),
                hfield_sphere(hf_pos, hf_size, hf_row, e2, r))


def _closest_on_segment(p, a, b):
    ab = b - a
    t = _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-12)
    return a + torch.clamp(t, 0.0, 1.0)[..., None] * ab


def sphere_capsule(c, r, cap_pos, cap_mat, rc, hl):
    """Sphere is geom1, capsule geom2. 1 contact."""
    e1, e2 = _endpoints(cap_pos, cap_mat, hl)
    q = _closest_on_segment(c, e2, e1)
    return _one(*_sphere_sphere_raw(c, r, q, rc))


def _segment_params(d1, d2, r):
    """Clamped parameters (s, t) of the closest points of segments
    s1a + s d1 and s2a + t d2, r = s1a - s2a (the standard algorithm)."""
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = torch.clamp(a * e - b * b, min=1e-12)
    s = torch.clamp((b * f - c * e) / denom, 0.0, 1.0)
    t = torch.clamp((b * s + f) / torch.clamp(e, min=1e-12), 0.0, 1.0)
    s = torch.clamp((b * t - c) / torch.clamp(a, min=1e-12), 0.0, 1.0)
    return s, t


def capsule_capsule(p1, m1, r1, h1, p2, m2, r2, h2):
    """Closest segment-segment points, then sphere-sphere. 1 contact."""
    s1b, s1a = _endpoints(p1, m1, h1)
    s2b, s2a = _endpoints(p2, m2, h2)
    d1 = s1b - s1a
    d2 = s2b - s2a
    s, t = _segment_params(d1, d2, s1a - s2a)
    q1 = s1a + s[..., None] * d1
    q2 = s2a + t[..., None] * d2
    return _one(*_sphere_sphere_raw(q1, r1, q2, r2))


def sphere_sphere(c1, r1, c2, r2):
    return _one(*_sphere_sphere_raw(c1, r1, c2, r2))


def _sphere_box_raw(c, r, box_pos, box_mat, half):
    """Sphere center c vs box. Returns (dist, pos, n) with n from sphere
    toward the box, handling the center-inside-box case."""
    cl = _mtv(box_mat, c - box_pos)           # center in box frame
    q = torch.minimum(torch.maximum(cl, -half), half)  # closest point
    delta = cl - q
    d_out = torch.linalg.norm(delta, dim=-1)
    outside = d_out > 1e-9
    # outside branch
    n_out = -_mv(box_mat, delta / torch.where(outside, d_out, 1.0)[..., None])
    dist_out = d_out - r
    # inside branch: push out along nearest face
    face_depth = half - torch.abs(cl)
    k = torch.argmin(face_depth, dim=-1)
    clk = _take(cl, k)
    sign = torch.sign(clk) + (clk == 0.0).to(clk.dtype)
    n_in = -_mv(box_mat, _one_hot3(k, cl) * sign[..., None])
    dist_in = -(_take(face_depth, k) + r)
    dist = torch.where(outside, dist_out, dist_in)
    n = torch.where(outside[..., None], n_out, n_in)
    pos = c + n * (r + 0.5 * dist)[..., None]
    return dist, pos, n


def sphere_box(c, r, box_pos, box_mat, half):
    return _one(*_sphere_box_raw(c, r, box_pos, box_mat, half))


def capsule_box(cap_pos, cap_mat, r, hl, box_pos, box_mat, half):
    """Capsule geom1 vs box geom2: 2 contacts from the endpoint spheres."""
    e1, e2 = _endpoints(cap_pos, cap_mat, hl)
    return _two(_one(*_sphere_box_raw(e1, r, box_pos, box_mat, half)),
                _one(*_sphere_box_raw(e2, r, box_pos, box_mat, half)))


def _face_manifold(ref_p, ref_m, ref_half, inc_p, inc_m, inc_half):
    """Face-contact manifold with `ref` as the reference box, in its local
    frame: the reference face is the one of maximum separation; candidate
    points are the 4 incident-face corners inside the reference face, the 4
    reference-face corners inside the incident quad and the 16 edge-edge
    crossings of the two face rectangles; the 4 deepest valid ones are kept
    (ties to the lower index, as lax.top_k keeps them).

    Returns (sep_best (...), dist (..., 4), pos_local (..., 4, 3) in the
    ref frame, n_local (..., 3))."""
    cst = _consts(ref_p)
    signs = cst['signs']
    eps = 1e-9
    Ri = ref_m.transpose(-1, -2) @ inc_m   # incident axes in ref frame (cols)
    ci = _mtv(ref_m, inc_p - ref_p)         # incident center in ref frame
    sep = torch.abs(ci) - (ref_half + _mv(torch.abs(Ri), inc_half))
    k = torch.argmax(sep, dim=-1)
    sep_best = _take(sep, k)
    s = _pm1(_take(ci, k) >= 0, ci)
    onek = _one_hot3(k, ci)
    n_l = s[..., None] * onek               # ref outward face normal (local)

    # incident face: most anti-parallel to n_l
    mcomp = _mtv(Ri, n_l)
    j = torch.argmax(torch.abs(mcomp), dim=-1)
    onej = _one_hot3(j, ci)
    sj = -_pm1(_take(mcomp, j) >= 0, ci)
    fc = ci + (sj * _dot(inc_half, onej))[..., None] * _mv(Ri, onej)
    onej1 = _one_hot3(torch.remainder(j + 1, 3), ci)
    onej2 = _one_hot3(torch.remainder(j + 2, 3), ci)
    a_u = _dot(inc_half, onej1)[..., None] * _mv(Ri, onej1)
    a_v = _dot(inc_half, onej2)[..., None] * _mv(Ri, onej2)

    # face-local coordinates: rows of P map local xyz -> (u, v, w=face axis)
    P = torch.stack([_one_hot3(torch.remainder(k + 1, 3), ci),
                     _one_hot3(torch.remainder(k + 2, 3), ci), onek], dim=-2)
    hu = _dot(ref_half, P[..., 0, :])
    hv = _dot(ref_half, P[..., 1, :])
    hw = _dot(ref_half, P[..., 2, :])

    # incident face corners, cyclic order, in face coords
    corners = (fc[..., None, :] + signs[:, 0:1] * a_u[..., None, :] +
               signs[:, 1:2] * a_v[..., None, :])             # (..., 4, 3)
    cf = corners @ P.transpose(-1, -2)
    # incident plane in face coords: ni_f . (x - fc_f) = 0
    ni_f = _mv(P, sj[..., None] * _mv(Ri, onej))
    fc_f = _mv(P, fc)
    niz = ni_f[..., 2]
    niw = torch.where(torch.abs(niz) < 1e-6, 1e-6 * _pm1(niz >= 0, niz),
                      niz)
    plane_c = _dot(ni_f, fc_f)

    def plane_w(u, v):
        return ((plane_c[..., None] - ni_f[..., 0:1] * u -
                 ni_f[..., 1:2] * v) / niw[..., None])

    tol = 1e-7
    # (a) incident corners: valid if inside the reference face rectangle
    ua, va, wa = cf[..., 0], cf[..., 1], cf[..., 2]
    valid_a = ((torch.abs(ua) <= (hu + tol)[..., None]) &
               (torch.abs(va) <= (hv + tol)[..., None]))

    # (b) reference face corners: valid if inside the incident 2D quad
    ub = signs[:, 0] * hu[..., None]
    vb = signs[:, 1] * hv[..., None]
    wb = plane_w(ub, vb)
    q2 = cf[..., :2]                                          # (..., 4, 2)
    e2 = torch.roll(q2, -1, dims=-2) - q2                     # quad edges
    pb = torch.stack([ub, vb], dim=-1)
    rel = pb[..., :, None, :] - q2[..., None, :, :]           # (.., 4, 4, 2)
    cross = (e2[..., None, :, 0] * rel[..., 1] -
             e2[..., None, :, 1] * rel[..., 0])
    valid_b = (torch.all(cross >= -tol, dim=-1) |
               torch.all(cross <= tol, dim=-1))

    # (c) 2D intersections: 4 rect edges x 4 quad edges
    ra = torch.stack([torch.stack([hu, -hv], dim=-1),
                      torch.stack([hu, hv], dim=-1),
                      torch.stack([-hu, hv], dim=-1),
                      torch.stack([-hu, -hv], dim=-1)], dim=-2)  # (..., 4, 2)
    rd = torch.roll(ra, -1, dims=-2) - ra
    diff = q2[..., None, :, :] - ra[..., :, None, :]          # (.., 4, 4, 2)
    denom = (rd[..., :, None, 0] * e2[..., None, :, 1] -
             rd[..., :, None, 1] * e2[..., None, :, 0])
    denom_safe = torch.where(torch.abs(denom) < eps, 1.0, denom)
    ta = (diff[..., 0] * e2[..., None, :, 1] -
          diff[..., 1] * e2[..., None, :, 0]) / denom_safe
    tb = (diff[..., 0] * rd[..., :, None, 1] -
          diff[..., 1] * rd[..., :, None, 0]) / denom_safe
    batch = ta.shape[:-2]
    valid_c = ((torch.abs(denom) >= eps) & (ta >= -tol) & (ta <= 1 + tol) &
               (tb >= -tol) & (tb <= 1 + tol)).reshape(batch + (16,))
    uc = (ra[..., :, None, 0] + ta * rd[..., :, None, 0]).reshape(
        batch + (16,))
    vc = (ra[..., :, None, 1] + ta * rd[..., :, None, 1]).reshape(
        batch + (16,))
    wc = plane_w(uc, vc)

    u_all = torch.cat([ua, ub, uc], dim=-1)
    v_all = torch.cat([va, vb, vc], dim=-1)
    w_all = torch.cat([wa, wb, wc], dim=-1)
    valid = torch.cat([valid_a, valid_b, valid_c], dim=-1)
    gap = s[..., None] * w_all - hw[..., None]         # penetration along n_l
    gap = torch.where(valid, gap, _BIG)

    idx = torch.sort(gap, dim=-1, stable=True).indices[..., :4]
    dist = torch.gather(gap, -1, idx)
    u4, v4, w4 = (torch.gather(x, -1, idx) for x in (u_all, v_all, w_all))
    # contact point: midway between the two surfaces along the face axis
    wmid = 0.5 * ((s * hw)[..., None] + w4)
    pos_local = torch.stack([u4, v4, wmid], dim=-1) @ P  # back to ref local
    return sep_best, dist, pos_local, n_l


def box_box(p1, m1, half1, p2, m2, half2):
    """Box geom1 vs box geom2 (SAT + clipped face manifold). 4 contacts.

    Face case: the deeper-face reference box wins; edge-edge case (best SAT
    axis an edge cross-product): a single contact at the closest edge
    points, the other 3 slots inert (dist _BIG, unit normal)."""
    cst = _consts(p1)
    half1 = half1[..., :3]
    half2 = half2[..., :3]
    batch = p1.shape[:-1]

    # manifold with box1 as reference and with box2 as reference
    sep_1, d1, pl1, nl1 = _face_manifold(p1, m1, half1, p2, m2, half2)
    sep_2, d2, pl2, nl2 = _face_manifold(p2, m2, half2, p1, m1, half1)
    use2 = sep_2 > sep_1 + 1e-8
    dist = torch.where(use2[..., None], d2, d1)
    pos = torch.where(use2[..., None, None],
                      pl2 @ m2.transpose(-1, -2) + p2[..., None, :],
                      pl1 @ m1.transpose(-1, -2) + p1[..., None, :])
    # normal convention: from geom1 toward geom2
    n_face = torch.where(use2[..., None], -_mv(m2, nl2), _mv(m1, nl1))

    # --- edge-edge SAT (9 cross axes, box1 frame) ---
    R = m1.transpose(-1, -2) @ m2
    t = _mtv(m1, p2 - p1)
    eye = cst['eye']
    # axes l[i, j] = cross(e_i, R[:, j])
    Rt = R.transpose(-1, -2)
    l = torch.linalg.cross(eye[:, None, :].expand(batch + (3, 3, 3)),
                           Rt[..., None, :, :].expand(batch + (3, 3, 3)),
                           dim=-1)
    lnorm = torch.linalg.norm(l, dim=-1)
    ok = lnorm > 1e-6
    lhat = l / torch.where(ok, lnorm, 1.0)[..., None]
    # orient toward box2
    tdot = torch.einsum('...ijk,...k->...ij', lhat, t)
    lhat = lhat * _pm1(tdot >= 0, t)[..., None]
    tdot = torch.abs(tdot)
    supp1 = torch.einsum('...ijk,...k->...ij', torch.abs(lhat), half1)
    supp2 = torch.einsum('...ijl,...l->...ij', torch.abs(
        torch.einsum('...ijk,...kl->...ijl', lhat, R)), half2)
    sep_e = torch.where(ok, tdot - supp1 - supp2, -_BIG)
    flat = sep_e.reshape(batch + (9,))
    eidx = torch.argmax(flat, dim=-1)
    sep_edge = _take(flat, eidx)
    i = torch.div(eidx, 3, rounding_mode='floor')
    j = torch.remainder(eidx, 3)
    le = torch.gather(lhat.reshape(batch + (9, 3)), -2,
                      eidx[..., None, None].expand(batch + (1, 3)))[..., 0, :]
    onei = _one_hot3(i, t)
    onejb = _one_hot3(j, t)
    # supporting edge on box1: corner signs toward +le on the other axes
    sgn1 = _pm1(le >= 0, t) * (1.0 - onei)
    pA = half1 * sgn1                                 # point on edge1 (local)
    hA = _dot(half1, onei)
    # supporting edge on box2: toward -le along box2 axes
    le2 = _mtv(R, le)                                 # le in box2 frame
    sgn2 = -_pm1(le2 >= 0, t) * (1.0 - onejb)
    pB = t + _mv(R, half2 * sgn2)
    dB = _mv(R, onejb)
    hB = _dot(half2, onejb)
    # closest points between the two edge segments (box1 frame)
    s1a, s1b = pA - onei * hA[..., None], pA + onei * hA[..., None]
    s2a, s2b = pB - dB * hB[..., None], pB + dB * hB[..., None]
    dd1, dd2 = s1b - s1a, s2b - s2a
    ss, tt = _segment_params(dd1, dd2, s1a - s2a)
    q1 = s1a + ss[..., None] * dd1
    q2e = s2a + tt[..., None] * dd2
    pos_edge = p1 + _mv(m1, 0.5 * (q1 + q2e))
    n_edge = _mv(m1, le)

    sep_face = torch.maximum(sep_1, sep_2)
    is_edge = sep_edge > sep_face + 1e-8
    big3 = torch.full(batch + (3,), _BIG, dtype=p1.dtype, device=p1.device)
    dist = torch.where(is_edge[..., None],
                       torch.cat([sep_edge[..., None], big3], dim=-1), dist)
    pos = torch.where(is_edge[..., None, None], torch.cat(
        [pos_edge[..., None, :], torch.zeros_like(pos[..., 1:, :])], dim=-2),
        pos)
    n = torch.where(is_edge[..., None, None], n_edge[..., None, :],
                    n_face[..., None, :]).expand(batch + (4, 3))
    # inert slots: keep normals unit to stay NaN-safe under masking
    inert = dist >= _BIG * 0.5
    n = torch.where(inert[..., None], cst['z'], n)
    return dist, pos, n
