"""2D physics as a planar configuration of the 3D core.

PyTorch counterpart of ``diffsdfsim_tpu/physics2d/facade.py``. Bodies live
in the world's x-y plane, held there by a ``PlanarConstraint`` (v_z = 0,
omega_x = omega_y = 0); 2D shapes are SDF primitives extruded along z to
unit depth:

- Circle(rad)       -> cylinder along z
- Rect(w, h)        -> box of unit depth
- Hull(verts2d)     -> extruded convex polygon (``HullShape``)
- GridSDF2D(grid)   -> extruded bilinear 2D grid SDF (``GridShape2D``)

2D generalized coordinates map as p = [theta, x, y] -> the quaternion about
z and (x, y, 0), v = [omega, vx, vy] -> ([0, 0, omega], [vx, vy, 0]);
``to_2d_state`` projects back. A Circle or Rect pair takes the Frank-Wolfe
kernel K3 on the card (cylinder and box kinds); a Hull or 2D-grid shape has
no K3 kind (``kind`` None), so its pairs take the plain search, and pairs
under ``narrowphase="analytic"`` run no search (``physics2d/narrowphase.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..ops.marching2d import bilinear_interp, marching_squares
from ..physics.bodies import make_body
from ..physics.joints import JointBase, TotalConstraint3D
from ..physics.shapes import BoxShape, CylinderShape, ShapeBase
from ..physics.world import make_world
from ..utils.quaternion import quat_apply, quat_from_euler
from ..utils.spherical import skew_symmetric_mat

_DEPTH = 1.0


def _dtype(kw):
    return kw.get("dtype") or default_dtype()


def _like(x, dtype):
    """x as a tensor of ``dtype`` (a tensor keeps its device and its tape)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype)


def _unit_rows(cols, like):
    J = torch.zeros((len(cols), 6), dtype=like.dtype, device=like.device)
    for r, c in enumerate(cols):
        J[r, c] = 1.0
    return J


@dataclasses.dataclass(frozen=True)
class PlanarConstraint(JointBase):
    """Restricts a body to planar x-y motion with rotation about z only."""

    num_constraints: int = 3

    def rows(self, state):
        return _unit_rows((0, 1, 5), state.pos), None  # omega_x, omega_y, v_z


def Circle(rad, **kw):
    """2D circle: a z-extruded cylinder (reference physics/bodies.py Circle)."""
    dtype = _dtype(kw)
    rad = _like(rad, dtype)
    return make_body(CylinderShape(rad, torch.tensor(_DEPTH, dtype=dtype, device=rad.device)), template="cube",
                     **kw)


def Rect(dims, **kw):
    """2D rectangle: a unit-depth box (reference physics/bodies.py Rect)."""
    dtype = _dtype(kw)
    dims = _like(dims, dtype)
    depth = torch.tensor([_DEPTH], dtype=dtype, device=dims.device)
    return make_body(BoxShape(torch.cat([dims, depth])), template="cube", **kw)


def _pos(x):
    return torch.maximum(x, x.new_zeros(()))


def polygon_sdf_2d(p, verts):
    """Exact signed distance to a 2D polygon (verts (V, 2), CCW), batched
    over p (..., 2): the winding / segment-distance formulation."""
    v = verts
    vj = torch.roll(verts, -1, dims=0)  # the next vertex of each edge
    e = vj - v  # (V, 2)
    w = p[..., None, :] - v  # (..., V, 2)
    ee = torch.sum(e * e, dim=-1)
    t = torch.sum(w * e, dim=-1) / torch.maximum(ee, ee.new_tensor(1e-12))
    t = torch.minimum(_pos(t), t.new_ones(()))
    b = w - t[..., None] * e
    d2 = torch.amin(torch.sum(b * b, dim=-1), dim=-1)
    # winding-parity sign
    c1 = p[..., None, 1] >= v[:, 1]
    c2 = p[..., None, 1] < vj[:, 1]
    c3 = e[:, 0] * w[..., 1] > e[:, 1] * w[..., 0]
    flip = (c1 & c2 & c3) | (~c1 & ~c2 & ~c3)
    s = 1.0 - 2.0 * (torch.sum(flip, dim=-1) % 2).to(p.dtype)
    return s * torch.sqrt(torch.maximum(d2, d2.new_tensor(1e-24)))


def _extrude(d2, z, scale):
    """The SDF of a 2D cross-section's distance d2 extruded to unit depth."""
    qz = torch.abs(z) - (_DEPTH / 2.0) / scale
    q = torch.stack([d2, qz], dim=-1)
    n2 = torch.sum(_pos(q) ** 2, dim=-1)
    return torch.sqrt(torch.maximum(n2, n2.new_tensor(1e-24))) + torch.minimum(
        torch.amax(q, dim=-1), q.new_zeros(()))


def _autodiff_grad(sdf, pts):
    """d sdf / d pts of a pointwise SDF, as the JAX package's default
    ``ShapeBase.sdf_grad`` (``jax.grad`` of the sum); differentiable in the
    shape's parameters and usable under ``torch.func.vmap``."""
    return torch.func.grad(lambda p: torch.sum(sdf(p)))(pts)


@dataclasses.dataclass
class HullShape(ShapeBase):
    """2D convex hull body (reference ``lcp_physics`` Hull): an extruded
    polygon SDF. ``verts2d`` (V, 2) normalized by ``scale_``."""

    verts2d: torch.Tensor
    scale_: torch.Tensor

    def scale(self):
        return self.scale_

    def sdf(self, pts):
        return _extrude(polygon_sdf_2d(pts[..., :2], self.verts2d), pts[..., 2], self.scale_)

    def sdf_grad(self, pts):
        return _autodiff_grad(self.sdf, pts)


def Hull(verts2d, **kw):
    """2D convex polygon body (reference physics/bodies.py Hull); ``verts2d``
    CCW, centred at the body origin."""
    v = _like(verts2d, _dtype(kw))
    scale = torch.maximum(torch.amax(torch.linalg.norm(v, dim=-1)), v.new_tensor(_DEPTH / 2.0)) * 1.5
    return make_body(HullShape(verts2d=v / scale, scale_=scale), template="cube", **kw)


@dataclasses.dataclass
class GridShape2D(ShapeBase):
    """2D grid-SDF body (reference legacy ``SDFGrid``,
    sdf_physics/physics/bodies.py:91-283): a (H, W) lattice of normalized
    signed distances over [-0.5, 0.5]^2, bilinearly interpolated and
    z-extruded to unit depth; differentiable in the grid values."""

    grid: torch.Tensor  # (H, W) signed distances normalized by scale_
    scale_: torch.Tensor
    coord_scale: torch.Tensor  # body-normalized -> grid-normalized coordinates

    def scale(self):
        return self.scale_

    def sdf(self, pts):
        return _extrude(bilinear_interp(self.grid, pts[..., :2] * self.coord_scale), pts[..., 2], self.scale_)

    def sdf_grad(self, pts):
        return _autodiff_grad(self.sdf, pts)


def GridSDF2D(grid, scale, **kw):
    """Body from a 2D SDF grid on the reference's node lattice: ``grid`` (H,
    W) holds signed distances in world units over the [-scale/2, scale/2]^2
    square. The surface mesh is the template projection onto the
    interpolated field (``contour_2d`` gives the marching-squares contour)."""
    dtype = _dtype(kw)
    g = _like(grid, dtype)
    scale = _like(scale, dtype)
    # the body frame must also cover the unit extrusion depth; grid
    # coordinates keep their own span (coord_scale maps between the two)
    eff = torch.maximum(scale, scale.new_tensor(_DEPTH)) * 1.01
    return make_body(GridShape2D(grid=g / eff, scale_=eff, coord_scale=eff / scale), template="cube", **kw)


def contour_2d(grid, scale, device=None):
    """Marching-squares iso-contour of a world-units 2D SDF grid: masked
    fixed-size segments in world coordinates (reference
    SDFGrid.marching_squares, bodies.py:117-196). A tensor grid keeps its
    device; any other goes to ``device`` (default: the card)."""
    if not isinstance(grid, torch.Tensor):
        grid = torch.as_tensor(grid, device=resolve_device(device))
    segs, valid = marching_squares(_like(grid, default_dtype()))
    return segs * scale, valid


@dataclasses.dataclass(frozen=True)
class RevoluteJoint2D(JointBase):
    """Planar hinge (reference 2D Joint, physics/constraints.py:35-75): the
    anchor points' velocities of both bodies match in the x-y plane. Anchor
    offsets are body-frame vectors (z = 0)."""

    r1_local: tuple = (0.0, 0.0)
    r2_local: tuple = (0.0, 0.0)
    num_constraints: int = 2

    def _rows(self, state, body, r_local):
        like = state.pos
        r = quat_apply(state.quat[body], torch.tensor([*r_local, 0.0], dtype=like.dtype, device=like.device))
        eye = torch.eye(3, dtype=like.dtype, device=like.device)
        return torch.cat([-skew_symmetric_mat(r), eye], dim=1)[:2]

    def rows(self, state):
        J1 = self._rows(state, self.body1, self.r1_local)
        J2 = None if self.body2 is None else -self._rows(state, self.body2, self.r2_local)
        return J1, J2


@dataclasses.dataclass(frozen=True)
class FixedJoint2D(RevoluteJoint2D):
    """Planar weld (reference FixedJoint, physics/constraints.py:78-114): the
    hinge rows and equal angular velocity about z."""

    num_constraints: int = 3

    def rows(self, state):
        J1, J2 = super().rows(state)
        rot = _unit_rows((2,), state.pos)
        return torch.cat([J1, rot]), None if J2 is None else torch.cat([J2, -rot])


def make_world_2d(bodies, poses_2d, vels_2d, joints=(), forces=(), no_contact=(), cfg=SimConfig(),
                  narrowphase="fw", device=None):
    """Build (spec, state) of a planar world: ``poses_2d`` (B, 3) = [theta,
    x, y], ``vels_2d`` (B, 3) = [omega, vx, vy] (reference 2D generalized
    coordinates). ``narrowphase="analytic"`` generates the contact
    candidates of Circle / Rect / Hull pairs by the reference's closed-form
    2D algorithms (``physics2d/narrowphase.py``); ``"fw"`` keeps the 3D
    Frank-Wolfe search on the extruded meshes. ``device=None`` means CUDA,
    as for ``make_world``. A body that a ``TotalConstraint3D`` fixes gets no
    planar rows (they would duplicate its rows)."""
    if narrowphase == "analytic":
        cfg = cfg.replace(narrowphase2d=True)
    dtype = bodies[0].verts.dtype
    dev = bodies[0].verts.device
    poses_2d = torch.as_tensor(poses_2d, dtype=dtype, device=dev)
    vels_2d = torch.as_tensor(vels_2d, dtype=dtype, device=dev)
    nb = poses_2d.shape[0]
    zero = torch.zeros((nb, 1), dtype=dtype, device=dev)
    quat = quat_from_euler(torch.cat([zero, zero, poses_2d[:, :1]], dim=-1))
    poses = torch.cat([quat, poses_2d[:, 1:], zero], dim=-1)
    vels = torch.cat([zero, zero, vels_2d[:, :1], vels_2d[:, 1:], zero], dim=-1)
    fully = {j.body1 for j in joints if isinstance(j, TotalConstraint3D)}
    joints = tuple(joints) + tuple(PlanarConstraint(body1=i) for i in range(nb) if i not in fully)
    return make_world(bodies, poses, vels, joints=joints, forces=forces, no_contact=no_contact, cfg=cfg,
                      device=device)


def to_2d_state(state):
    """A 3D WorldState's 2D coordinates: ([theta, x, y], [omega, vx, vy]);
    a seed sweep's state keeps its lane axis first."""
    q, pos, v = state.quat, state.pos, state.v
    theta = 2.0 * torch.atan2(q[..., 3], q[..., 0])
    return torch.stack([theta, pos[..., 0], pos[..., 1]], dim=-1), torch.stack([v[..., 2], v[..., 3], v[..., 4]],
                                                                                dim=-1)
