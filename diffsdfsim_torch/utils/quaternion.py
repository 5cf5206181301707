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


def matrix_to_quat(R):
    """Rotation matrix -> wxyz quaternion (branchless Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], dim=-1)

    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4))).squeeze(-2)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def so3_log_map(R):
    """Rotation matrix -> axis-angle 3-vector (principal branch)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    small = theta < _SMALL
    scale = torch.where(
        small,
        torch.full_like(theta, 0.5),
        theta / (2.0 * torch.sin(torch.where(small, torch.ones_like(theta), theta))),
    )
    return w * scale[..., None]


def so3_relative_angle(R1, R2):
    """The angle of R1' R2 (batched), the evaluation metric of the
    reference's optim_pointcloud.py:27."""
    R = R1.transpose(-1, -2) @ R2
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7))


def quat_from_euler(euler, style="wxyz"):
    """Euler angles (phi, the, psi) -> quaternion (reference physics3d/utils.py:207-221)."""
    phi, the, psi = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cthe, sthe = torch.cos(the), torch.sin(the)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    w = cphi * cthe * cpsi + sphi * sthe * spsi
    x = sphi * cthe * cpsi - cphi * sthe * spsi
    y = cphi * sthe * cpsi + sphi * cthe * spsi
    z = cphi * cthe * spsi - sphi * sthe * cpsi
    if style == "xyzw":
        return torch.stack([x, y, z, w], dim=-1)
    return torch.stack([w, x, y, z], dim=-1)


def random_quaternions(n: int, generator=None, dtype=torch.float64, device="cpu"):
    """Uniform random unit quaternions (wxyz, w >= 0), as pytorch3d draws
    them: normalized Gaussian 4-vectors from ``generator`` (a
    ``torch.Generator``; the draws differ from the JAX package's
    ``jax.random`` ones)."""
    q = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def rotation_2d(theta):
    """2D rotation matrices (..., 2, 2) (reference physics/utils.py rotation_matrix)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)
