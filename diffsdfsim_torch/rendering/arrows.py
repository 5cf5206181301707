"""Force and torque arrows for the renderer.

PyTorch counterpart of ``diffsdfsim_tpu/rendering/arrows.py`` (reference
``sdf_physics/physics3d/bodies.py:513-593``: ``Body3D.render(render_forces=
True, render_torques=True)`` adds a cylinder-and-cone mesh per applied force
or torque). The ray-marcher has no meshes, so an arrow is an analytic SDF (a
capped shaft cylinder and a cone head along local +z) in a render-only body
with the ``scale()`` / ``query_sdfs()`` surface the renderer reads.
``force_arrows`` builds one arrow per body whose net applied force (linear
part) or torque (angular part) is non-zero, at the body's origin along the
vector, its length the vector's norm times ``force_scale`` /
``torque_scale``, as the reference places them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..physics.engine import apply_forces


def _max(a, b):
    """``jnp.maximum``: at a tie each side gets half the gradient."""
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def _min(a, b):
    return torch.minimum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def _arrow_sdf(pts, length, shaft_r, head_r, head_len):
    """SDF of an arrow along +z: the shaft over z in [0, length], the cone
    head from z = length to length + head_len; every argument in the units of
    pts (the normalized frame)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    rho = torch.sqrt(_max(x * x + y * y, 1e-24))
    # capped cylinder (iq's exact formula)
    half = length / 2.0
    dxy = rho - shaft_r
    dz = torch.abs(z - half) - half
    outside = torch.sqrt(_max(dxy, 0.0) ** 2 + _max(dz, 0.0) ** 2)
    inside = _min(_max(dxy, dz), 0.0)
    d_shaft = outside + inside
    # cone head: the radius tapers linearly from head_r to 0; the radial
    # excess against the taper, capped axially (a render-only distance)
    t = _min(_max((z - length) / _max(head_len, 1e-9), 0.0), 1.0)
    r_at = head_r * (1.0 - t)
    d_rad = (rho - r_at) * torch.cos(torch.atan2(head_r, head_len))
    d_ax = torch.maximum(length - z, z - (length + head_len))
    d_head = torch.maximum(d_rad, d_ax)
    return torch.minimum(d_shaft, d_head)


@dataclasses.dataclass
class ArrowBody:
    """A render-only body: an arrow of world length ``length`` along its
    local +z axis, its tail at the origin. It has the renderer's body
    surface (``scale()``, ``query_sdfs()``)."""

    length: torch.Tensor
    shaft_r: torch.Tensor
    head_r: torch.Tensor
    head_len: torch.Tensor

    def scale(self):
        return torch.maximum(self.length + self.head_len, self.head_r * 2.0) * 1.05

    def _sdf_n(self, p):
        s = self.scale()
        return _arrow_sdf(p, self.length / s, self.shaft_r / s, self.head_r / s, self.head_len / s)

    def query_sdfs(self, pts_loc, return_grads=True):
        s = self.scale()
        d = self._sdf_n(pts_loc / s) * s
        if not return_grads:
            return d
        # the gradient of the normalized SDF at pts / s with respect to pts
        grad = torch.func.vmap(torch.func.grad(lambda p: self._sdf_n(p / s)))(pts_loc.reshape(-1, 3))
        return d, grad.reshape(pts_loc.shape)


def _quat_align_z(v):
    """The quaternion (wxyz) rotating +z onto the unit vector v; a half-turn
    about x where v is -z."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device)
    c = torch.dot(z, v)
    axis = torch.linalg.cross(z, v)
    an = torch.linalg.norm(axis)
    w = torch.sqrt(_max((1.0 + c) / 2.0, 0.0))
    s = torch.sqrt(_max((1.0 - c) / 2.0, 0.0))
    xyz = torch.where(an > 1e-8, axis / _max(an, 1e-12) * s,
                      torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device) * s)
    return torch.cat([w[None], xyz])


def force_arrows(bodies, forces, state_t, quat, pos, render_forces: bool = True, render_torques: bool = False,
                 force_scale: float = 0.1, torque_scale: float = 0.1, shaft_r: float = 0.05, head_r: float = 0.1,
                 head_len: float = 0.15, min_norm: float = 1e-6):
    """Arrow bodies for each body's net applied force and torque at time
    ``state_t`` (the reference's Body3D.render arms): (arrow bodies, their
    quaternions (A, 4), their positions (A, 3)), to append to a render
    call's bodies and poses. A host-side helper (it reads the norms)."""
    dtype, device = pos.dtype, pos.device
    af = apply_forces(bodies, forces, torch.as_tensor(state_t, dtype=dtype, device=device)).reshape(len(bodies), 6)
    out_bodies, out_q, out_p = [], [], []
    specs = []
    if render_forces:
        specs.append((af[:, 3:], force_scale))
    if render_torques:
        specs.append((af[:, :3], torque_scale))
    as_t = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
    for vecs, vscale in specs:
        for b in range(len(bodies)):
            v = vecs[b]
            n = float(torch.linalg.norm(v))
            if n <= min_norm:
                continue
            out_bodies.append(ArrowBody(length=as_t(n * vscale), shaft_r=as_t(shaft_r), head_r=as_t(head_r),
                                        head_len=as_t(head_len)))
            out_q.append(_quat_align_z(v / n))
            out_p.append(pos[b])
    if not out_bodies:
        return [], torch.zeros((0, 4), dtype=dtype, device=device), torch.zeros((0, 3), dtype=dtype, device=device)
    return out_bodies, torch.stack(out_q), torch.stack(out_p)
