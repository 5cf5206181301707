"""Vector helpers: safe normalization and orthogonals. ``normalize``
keeps the safe-norm form sqrt(max(sum v^2, eps^2)): its derivative is finite
at v = 0, where ``torch.linalg.norm`` has a NaN gradient that masked lanes
would otherwise turn into 0 * NaN.
"""

from __future__ import annotations

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
