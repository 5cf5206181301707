"""Analytic signed distance functions and their gradients: the box's and
the sphere's (reference ``sdf_physics/physics3d/bodies.py:38-257``). Points and shape parameters
are in the normalized local frame (metric / body scale). Each primitive has
a hand-derived gradient with the reference's diagonal "failsafe" at edges
and corners.
"""

from __future__ import annotations

import torch

from ..utils.spherical import normalize


def _safe_norm(v, dim=-1):
    """sqrt(max(sum v^2, 1e-24)): NaN-free gradient at v = 0."""
    n2 = torch.sum(v * v, dim=dim)
    return torch.sqrt(torch.clamp(n2, min=1e-24))


def _pos(x):
    """max(x, 0) as ``jnp.maximum(x, 0.0)``: half the gradient at x = 0,
    where a clamp passes all of it."""
    return torch.maximum(x, x.new_zeros(()))


def _neg(x):
    """min(x, 0) as ``jnp.minimum(x, 0.0)``, half the gradient at x = 0."""
    return torch.minimum(x, x.new_zeros(()))


def _sign_nonzero(x):
    """sign(x) with sign(0) = 1 (reference bodies.py:56-57)."""
    one = torch.ones_like(x)
    return torch.where(x >= 0, one, -one)


def box_sdf(pts, dims):
    """Axis-aligned box of side lengths ``dims`` centered at the origin."""
    q = torch.abs(pts) - dims / 2.0
    max_dist = torch.amax(q, dim=-1)
    m = _pos(q)
    return _safe_norm(m) + _neg(max_dist)


def box_sdf_grad(pts, dims):
    """Box gradient with the diagonal failsafe at ties (reference :51-72)."""
    q = torch.abs(pts) - dims / 2.0
    signs = _sign_nonzero(pts)
    max_dist = torch.amax(q, dim=-1, keepdim=True)
    max_dirs = (q == max_dist).to(pts.dtype)
    m = _pos(q)
    grads_ov = (normalize(m) + (max_dist <= 0).to(pts.dtype) * max_dirs) * signs
    return normalize(grads_ov)


def sphere_sdf(pts, rad):
    return _safe_norm(pts) - rad


def sphere_sdf_grad(pts, rad):
    return normalize(pts)
