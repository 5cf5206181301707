"""Quaternion / SO(3) helpers on tensors (wxyz, scalar first).

PyTorch counterpart of ``diffsdfsim_tpu/utils/quaternion.py``. All
functions broadcast over leading batch dimensions. The exp maps use an
even-power Taylor branch near zero, so they stay finite and smooth at the
identity.
"""

from __future__ import annotations

import torch

_SMALL = 1e-6


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _sinc_sq(x2):
    """sin(sqrt(x2))/sqrt(x2) as a smooth function of x2."""
    small = 1.0 - x2 / 6.0 + x2 * x2 / 120.0
    tiny = x2 < _SMALL**2
    x = torch.sqrt(torch.where(tiny, torch.ones_like(x2), x2))
    return torch.where(tiny, small, torch.sin(x) / x)


def _cosc_sq(x2):
    """(1 - cos(sqrt(x2)))/x2 as a smooth function of x2."""
    small = 0.5 - x2 / 24.0 + x2 * x2 / 720.0
    tiny = x2 < _SMALL**2
    safe = torch.where(tiny, torch.ones_like(x2), x2)
    return torch.where(tiny, small, (1.0 - torch.cos(torch.sqrt(safe))) / safe)


def hat(v):
    """Skew-symmetric matrix [v]x of a 3-vector."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_map(log_rot):
    """Rodrigues' formula: axis-angle 3-vector -> rotation matrix."""
    theta2 = torch.sum(log_rot * log_rot, dim=-1)
    K = hat(log_rot)
    KK = K @ K
    s = _sinc_sq(theta2)[..., None, None]
    c = _cosc_sq(theta2)[..., None, None]
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device).expand(K.shape)
    return eye + s * K + c * KK


def quat_to_matrix(q):
    """wxyz quaternion -> rotation matrix (...,3,3). Normalizes internally."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = 2.0
    return torch.stack(
        [
            torch.stack([1 - two * (y * y + z * z), two * (x * y - w * z), two * (x * z + w * y)], dim=-1),
            torch.stack([two * (x * y + w * z), 1 - two * (x * x + z * z), two * (y * z - w * x)], dim=-1),
            torch.stack([two * (x * z - w * y), two * (y * z + w * x), 1 - two * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def quat_multiply(a, b):
    """Hamilton product a*b of wxyz quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_invert(q):
    """Inverse of a unit wxyz quaternion (conjugate)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_apply(q, pts):
    """Rotate point(s) by quaternion: q (x) [0,p] (x) q^-1, broadcast over pts."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, pts)
    uuv = _cross(u, uv)
    return pts + 2.0 * (w * uv + uuv)


def quat_exp_map(omega_dt):
    """Axis-angle 3-vector -> unit quaternion exp([0, w/2])."""
    half_sq = torch.sum(omega_dt * omega_dt, dim=-1, keepdim=True) / 4.0
    tiny = half_sq < _SMALL**2
    safe = torch.where(tiny, torch.ones_like(half_sq), half_sq)
    w = torch.where(
        tiny,
        1.0 - half_sq / 2.0 + half_sq * half_sq / 24.0,
        torch.cos(torch.sqrt(safe)),
    )
    xyz = omega_dt * 0.5 * _sinc_sq(half_sq)
    return torch.cat([w, xyz], dim=-1)


def integrate_quat(q, omega, dt):
    """q_{t+dt} = exp(omega*dt) (x) q (reference Body3D.move, bodies.py:488-496)."""
    return quat_multiply(quat_exp_map(omega * dt), q)
