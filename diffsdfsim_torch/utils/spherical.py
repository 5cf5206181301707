"""Vector helpers: safe normalization, orthogonals, skew matrices, polar
coordinates and the 2D cross product.

PyTorch counterpart of ``diffsdfsim_tpu/utils/spherical.py``. ``normalize``
keeps the safe-norm form sqrt(max(sum v^2, eps^2)): its derivative is finite
at v = 0, where ``torch.linalg.norm`` has a NaN gradient that masked lanes
would otherwise turn into 0 * NaN.
"""

from __future__ import annotations

import math

import torch


def normalize(v, dim=-1, eps=1e-12):
    """L2-normalize along dim; zero vectors map to zero."""
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=eps * eps))
    return v / n


def orthogonal(v):
    """Any vector orthogonal to v (3D): cross v with the coordinate axis
    least aligned with it (reference physics3d/utils.py:247-256)."""
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    idx = torch.argmin(torch.abs(v), dim=-1)
    axis = eye[idx]
    return torch.linalg.cross(axis, v, dim=-1)


def skew_symmetric_mat(v):
    """3x3 skew matrix (reference physics3d/utils.py:259-267)."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def cart_to_spherical(v, positive=True):
    """3-vector -> (r, theta, phi) (reference physics3d/utils.py:224-235)."""
    r = torch.linalg.norm(v, dim=-1)
    phi = torch.atan2(v[..., 1], v[..., 0])
    theta = torch.atan2(v[..., 2], torch.linalg.norm(v[..., :2], dim=-1))
    if positive:
        theta = torch.where(theta < 0, theta + 2.0 * math.pi, theta)
        phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
    return r, theta, phi


def spherical_to_cart(r, theta, phi):
    rcos = r * torch.cos(theta)
    return torch.stack([rcos * torch.cos(phi), rcos * torch.sin(phi), r * torch.sin(theta)], dim=-1)


def cart_to_polar(v, positive=True):
    """2-vector -> (r, theta), theta in [0, 2 pi) when ``positive``."""
    r = torch.linalg.norm(v, dim=-1)
    theta = torch.atan2(v[..., 1], v[..., 0])
    if positive:
        theta = torch.where(theta < 0, theta + 2.0 * math.pi, theta)
    return r, theta


def polar_to_cart(r, theta):
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def left_orthogonal(v):
    """2D left-orthogonal [v_y, -v_x] (reference physics/utils.py)."""
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def cross_2d(a, b):
    """Scalar z-component of the 2D cross product."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
