"""Analytic 2D narrowphase: circle-circle, circle-hull (closest point, or
the least-penetrating edge when the centre is inside) and hull-hull
(separating axes and incident-edge clipping).

PyTorch counterpart of ``diffsdfsim_tpu/physics2d/narrowphase.py``
(reference 2D ``DiffContactHandler``, ``lcp_physics/physics/contacts.py:
55-210``): every edge axis and vertex support is evaluated in one
fixed-shape pass and selected by masked argmax / argmin, so no choice reads
the device. Every function takes a leading pose axis (any leading axes) on
its points and parameters: the contact search asks for R poses at once (a
probe ladder's rungs, a seed sweep's lanes).

It generates candidates for planar worlds (``SimConfig.narrowphase2d``,
``make_world_2d(narrowphase="analytic")``) in place of the Frank-Wolfe
search: up to ``K2D`` world-frame points per directed pair, which the
contact recompute projects onto body 1's surface (``physics/contacts.py``).

Conventions: CCW polygons; for a CCW edge e = v_next - v the outward normal
is ``left_orthogonal(e) = [e_y, -e_x]``.
"""

from __future__ import annotations

import torch

from ..physics.shapes import BoxShape, CylinderShape
from ..utils.quaternion import rotation_2d
from ..utils.spherical import left_orthogonal

K2D = 2  # candidates per directed pair (the hull-hull clip emits 2)


def _safe_norm(v, eps=1e-24):
    n2 = torch.sum(v * v, dim=-1)
    return torch.sqrt(torch.maximum(n2, n2.new_tensor(eps)))


def _edges(verts):
    """(..., V, 2) CCW verts -> (edge vectors, unit outward normals, lengths)."""
    e = torch.roll(verts, -1, dims=-2) - verts
    ln = _safe_norm(e)
    return e, left_orthogonal(e) / ln[..., None], ln


def _take(x, idx):
    """x (..., V, ...) at the index idx (...) of its axis after the leading ones."""
    lead = idx.dim()
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - lead))
    return torch.take_along_dim(x, idx, dim=lead).squeeze(lead)


def _one_candidate(pt, valid_like):
    """(pts (..., K2D, 2), valid (..., K2D)) holding one candidate in slot 0."""
    pts = torch.stack([pt, torch.zeros_like(pt)], dim=-2)
    valid = torch.tensor([True, False], device=pt.device).expand(valid_like.shape + (K2D,))
    return pts, valid


def circle_circle(c1, r1, c2, r2):
    """One candidate: the point of circle 1's surface toward circle 2
    (reference contacts.py:72-84). c (..., 2), r (...). Returns (pts (...,
    K2D, 2), valid (..., K2D), sep (...))."""
    d = c2 - c1
    dist = _safe_norm(d)
    dirn = d / dist[..., None]
    sep = dist - (r1 + r2)
    pts, valid = _one_candidate(c1 + r1[..., None] * dirn, sep)
    return pts, valid, sep


def circle_hull(c, r, hull_verts):
    """One candidate on the hull's boundary: the point nearest the circle's
    centre (shallow, reference contacts.py:86-118), or the centre's
    projection onto the least-penetrating edge when the centre is inside
    (deep, contacts.py:120-143). c (..., 2), r (...), hull_verts (..., V,
    2)."""
    _, n, _ = _edges(hull_verts)
    rel = c[..., None, :] - hull_verts
    d = torch.sum(n * rel, dim=-1)  # signed distance to each edge line (> 0 outside)
    inside = torch.all(d < 0.0, dim=-1)

    e = torch.roll(hull_verts, -1, dims=-2) - hull_verts
    ee = torch.sum(e * e, dim=-1)
    t = torch.sum(rel * e, dim=-1) / torch.maximum(ee, ee.new_tensor(1e-24))
    t = torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))
    q = hull_verts + t[..., None] * e
    dq = _safe_norm(c[..., None, :] - q)
    j = torch.argmin(dq, dim=-1)
    closest = _take(q, j)

    jj = torch.argmax(d, dim=-1)
    d_jj = _take(d, jj)
    proj = c - _take(n, jj) * d_jj[..., None]

    pt = torch.where(inside[..., None], proj, closest)
    sep = torch.where(inside, d_jj, _take(dq, j)) - r
    pts, valid = _one_candidate(pt, sep)
    return pts, valid, sep


def _sat_best_axis(vertsA, vertsB):
    """Best (least-penetrating) face axis of hull A against hull B: (sep,
    edge index, outward normal (..., 2), index of B's support vertex), the
    reference's test_separations (contacts.py:226-255) without its warm
    start and early exit."""
    _, n, _ = _edges(vertsA)  # (..., Va, 2)
    du = n @ vertsB.transpose(-1, -2)  # (..., Va, Vb)
    sup = torch.argmin(du, dim=-1)
    sep_i = torch.amin(du, dim=-1) - torch.sum(n * vertsA, dim=-1)
    i = torch.argmax(sep_i, dim=-1)
    return _take(sep_i, i), i, _take(n, i), _take(sup, i)


def _clip(vertsRef, iRef, nRef, vertsInc, supInc):
    """The incident edge of hull ``Inc`` (of the two edges at its support
    vertex, the one whose normal is most anti-parallel to the reference
    normal, get_incident_edge contacts.py:257-272) clipped to the reference
    edge's tangent interval. Returns (pts (..., 2, 2), their signed
    distance above the reference face)."""
    v0 = _take(vertsRef, iRef)
    v1 = _take(torch.roll(vertsRef, -1, dims=-2), iRef)
    tangent = left_orthogonal(nRef)
    Vi = vertsInc.shape[-2]
    _, nI, _ = _edges(vertsInc)
    eprev = (supInc - 1) % Vi
    use_prev = torch.sum(nRef * _take(nI, eprev), dim=-1) < torch.sum(nRef * _take(nI, supInc), dim=-1)
    ei = torch.where(use_prev, eprev, supInc)
    p0 = _take(vertsInc, ei)
    p1 = _take(torch.roll(vertsInc, -1, dims=-2), ei)

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    lo = torch.minimum(dot(tangent, v0), dot(tangent, v1))
    hi = torch.maximum(dot(tangent, v0), dot(tangent, v1))
    t0, t1 = dot(tangent, p0), dot(tangent, p1)
    dseg = torch.where(torch.abs(t1 - t0) < 1e-12, torch.full_like(t0, 1e-12), t1 - t0)
    zero, one = t0.new_zeros(()), t0.new_ones(())
    a0 = torch.minimum(torch.maximum((lo - t0) / dseg, zero), one)
    a1 = torch.minimum(torch.maximum((hi - t0) / dseg, zero), one)
    pts = torch.stack([p0 + a0[..., None] * (p1 - p0), p0 + a1[..., None] * (p1 - p0)], dim=-2)
    dist = torch.sum((pts - v0[..., None, :]) * nRef[..., None, :], dim=-1)
    return pts, dist


def hull_hull(vertsA, vertsB):
    """Up to two candidates by separating axes and incident-edge clipping
    (reference contacts.py:151-210): the reference face is that of the
    larger of the two hulls' best separations (A on a tie), the incident
    edge of the other hull is clipped to its extent. Returns (pts (..., 2,
    2) on the incident hull's edge, valid (..., 2), sep (...), dist (...,
    2))."""
    sepA, iA, nA, supA = _sat_best_axis(vertsA, vertsB)
    sepB, iB, nB, supB = _sat_best_axis(vertsB, vertsA)
    ref_is_A = sepA >= sepB
    sep = torch.maximum(sepA, sepB)
    ptsA, distA = _clip(vertsA, iA, nA, vertsB, supA)  # reference A, incident B
    ptsB, distB = _clip(vertsB, iB, nB, vertsA, supB)  # reference B, incident A
    pts = torch.where(ref_is_A[..., None, None], ptsA, ptsB)
    dist = torch.where(ref_is_A[..., None], distA, distB)
    valid = torch.ones(sep.shape + (2,), dtype=torch.bool, device=sep.device)
    return pts, valid, sep, dist


def _shape2d(bd):
    """A body's planar cross-section: ("circle", radius (...)), ("hull",
    body-frame CCW verts (..., V, 2)) or None. A lane body's parameters
    keep their lane axis, one lane per pose (``BodyDef.per_pose``). A
    Rect's half extents are dims[0] and dims[1] (dims[2] is the extrusion
    depth)."""
    from .facade import HullShape

    s = bd.shape
    if isinstance(s, CylinderShape):
        out = "circle", s.rad
    elif isinstance(s, BoxShape):
        w, h = s.dims[..., 0] / 2.0, s.dims[..., 1] / 2.0
        verts = torch.stack([torch.stack([w, h], -1), torch.stack([-w, h], -1), torch.stack([-w, -h], -1),
                             torch.stack([w, -h], -1)], dim=-2)
        out = "hull", verts
    elif isinstance(s, HullShape):
        out = "hull", s.verts2d * s.scale_[..., None, None]
    else:
        return None
    return out[0], bd.per_pose(out[1])


def supported_pair(bd1, bd2) -> bool:
    return _shape2d(bd1) is not None and _shape2d(bd2) is not None


def _theta(q):
    """Planar rotation angle of a z-axis quaternion [w, x, y, z] (..., 4)."""
    return 2.0 * torch.atan2(q[..., 3], q[..., 0])


def _world_hull(verts, q, pos):
    """Body-frame verts (..., V, 2) at poses q (R, 4), pos (R, 3)."""
    return pos[..., None, :2] + verts @ rotation_2d(_theta(q)).transpose(-1, -2)


def pair_candidates(bd1, q1, pos1, bd2, q2, pos2):
    """World-frame contact candidates of one directed pair of planar bodies
    at R poses (q (R, 4), pos (R, 3); a lane body with one lane per pose).
    Returns (pts (R, K2D, 2), valid (R, K2D), sep (R,)): the points lie on
    a body's surface near the contact (which body's depends on the case;
    the recompute projects them onto body 1's SDF), ``sep`` is the analytic
    separation (negative: penetrating)."""
    k1, a1 = _shape2d(bd1)
    k2, a2 = _shape2d(bd2)
    R = q1.shape[0]
    c1, c2 = pos1[..., :2], pos2[..., :2]

    def per_pose(r):
        return r.expand(R) if r.dim() == 0 else r

    if k1 == "circle" and k2 == "circle":
        return circle_circle(c1, per_pose(a1), c2, per_pose(a2))
    if k1 == "circle":
        return circle_hull(c1, per_pose(a1), _world_hull(a2, q2, pos2))
    hull1 = _world_hull(a1, q1, pos1)
    if k2 == "circle":
        return circle_hull(c2, per_pose(a2), hull1)
    pts, valid, sep, _ = hull_hull(hull1, _world_hull(a2, q2, pos2))
    return pts, valid, sep
