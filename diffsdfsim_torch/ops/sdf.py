"""Analytic signed distance functions and their gradients.

PyTorch counterpart of the analytic (the bowl included) and voxel-grid SDFs of
``diffsdfsim_tpu/ops/sdf.py`` (reference
``sdf_physics/physics3d/bodies.py:38-257``). Points and shape parameters
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


def _cyl_q(pts, rad, height):
    r_xy = _safe_norm(pts[..., :2])
    ps = torch.stack([r_xy, pts[..., 2]], dim=-1)
    lim = torch.stack(
        [torch.broadcast_to(rad, r_xy.shape), torch.broadcast_to(height / 2.0, r_xy.shape)],
        dim=-1,
    )
    return torch.abs(ps) - lim


def cylinder_sdf(pts, rad, height):
    """Capped cylinder along z (reference :87-100)."""
    q = _cyl_q(pts, rad, height)
    max_dist = torch.amax(q, dim=-1)
    m = _pos(q)
    return _safe_norm(m) + _neg(max_dist)


def cylinder_sdf_grad(pts, rad, height):
    """Cylinder gradient with failsafe ties (reference :103-125)."""
    q = _cyl_q(pts, rad, height)
    signs = _sign_nonzero(pts[..., 2])
    max_dist = torch.amax(q, dim=-1, keepdim=True)
    max_dirs = (q == max_dist).to(pts.dtype)
    m = _pos(q)
    g2 = normalize(m) + (max_dist <= 0).to(pts.dtype) * max_dirs
    grads = torch.cat(
        [g2[..., 0:1] * normalize(pts[..., :2]), (g2[..., 1] * signs)[..., None]], dim=-1
    )
    return normalize(grads)


def _bowl_p0(pts, r, d):
    """(z, ps_norm, p0) of the bowl: the point's z shifted by -r/2, its
    distance from the shell's center, and the shell-thickness distance
    |dist - r| - d (from the center below it, from the z axis above)."""
    z = pts[..., 2] - r / 2.0
    r_xy = _safe_norm(pts[..., :2])
    ps_norm = _safe_norm(torch.stack([r_xy, z], dim=-1))
    p0 = torch.abs(torch.where(z < 0, ps_norm, r_xy) - r) - d
    return z, ps_norm, p0


def bowl_sdf(pts, r, d):
    """Hemispherical shell (open top), thickness 2d, radius r, opening along
    +z with its center shifted by r/2 along z (reference :128-142)."""
    z, _, p0 = _bowl_p0(pts, r, d)
    q = torch.stack([p0, z], dim=-1)
    return _safe_norm(_pos(q)) + _neg(torch.amax(q, dim=-1))


def bowl_sdf_grad(pts, r, d):
    """Bowl gradient (reference :145-163): the shifted point signed by
    which side of the shell it is on, with no radial part inside the rim
    and an upward z above the center."""
    z, ps_norm, p0 = _bowl_p0(pts, r, d)
    pts_s = torch.cat([pts[..., :2], z[..., None]], dim=-1)
    grads = pts_s * _sign_nonzero(ps_norm - r)[..., None]
    inside_rim = (z >= 0) & (p0 < 0)
    gxy = torch.where(inside_rim[..., None], torch.zeros_like(grads[..., :2]), grads[..., :2])
    gz = torch.where(z >= 0, torch.abs(grads[..., 2]), grads[..., 2])
    return normalize(torch.cat([gxy, gz[..., None]], dim=-1))


def rounded_box_sdf(pts, r, inner_dims):
    """Box with corners rounded by r (reference rounded_sdf, :166-172)."""
    return box_sdf(pts, inner_dims) - r


def brick_sdf(pts, dims, r):
    """Box with rounded in-plane (xy) corners (reference :184-200)."""
    half = dims / 2.0
    half = torch.cat([half[..., :2] - r, half[..., 2:]], dim=-1)
    q = torch.abs(pts) - half
    max01 = torch.amax(q[..., :2], dim=-1)
    m01 = _pos(q[..., :2])
    sdf01 = _safe_norm(m01) + _neg(max01) - r
    q2 = torch.stack([sdf01, q[..., 2]], dim=-1)
    maxd = torch.amax(q2, dim=-1)
    m = _pos(q2)
    return _safe_norm(m) + _neg(maxd)


# --------------------------------------------------------------------------
# voxel-grid SDF (reference bodies.py:203-257), the plain version of kernel
# K5 (ops/grid_cuda.py): ``grid_interp`` of its sampler, ``grid_query`` of
# its whole query.
# --------------------------------------------------------------------------


def grid_interp(grid, inds):
    """Trilinear interpolation of ``grid`` ((C,) X, Y, Z) at fractional voxel
    indices ``inds`` (N, 3), the base corner clamped to [0, dim - 2]; returns
    (N,) or (C, N)."""
    shape = torch.tensor(grid.shape[-3:], dtype=inds.dtype, device=inds.device)
    i0 = torch.clamp(torch.floor(inds), min=torch.zeros_like(shape), max=shape - 2.0)
    frac = inds - i0
    i0 = i0.long()
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    def g(dx, dy, dz):
        return grid[..., x0 + dx, y0 + dy, z0 + dz]

    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _grid_inds(pts, res):
    shape = torch.tensor(res[-3:], dtype=pts.dtype, device=pts.device)
    inds = (pts + 1.0) * 0.5 * (shape - 1.0)
    valid = torch.all((inds <= shape - 1.0) & (inds >= 0.0), dim=-1)
    return inds, valid


def grid_sdf_raw(pts, grid):
    """Trilinear SDF sample at pts (..., 3); out-of-bounds points get sdf = 1
    (reference :203-211)."""
    inds, valid = _grid_inds(pts.reshape(-1, 3), grid.shape)
    vals = grid_interp(grid, torch.where(valid[..., None], inds, torch.zeros_like(inds)))
    return torch.where(valid, vals, torch.ones_like(vals)).reshape(pts.shape[:-1])


def grid_grad_volume(grid):
    """Central-difference gradient volume (3, X, Y, Z) (reference :224-234),
    with one-sided differences on the boundary slabs (np.gradient-style), so
    points on the grid-domain faces still project onto the surface."""

    def diff(axis):
        g = grid.movedim(axis, 0)
        d = torch.cat([g[1:2] - g[:1], (g[2:] - g[:-2]) / 2.0, g[-1:] - g[-2:-1]], dim=0)
        return d.movedim(0, axis)

    return torch.stack([diff(0), diff(1), diff(2)], dim=0)


def grid_sdf_grad(pts, grid):
    """Normalized trilinear sample of the gradient volume (reference
    :214-243); out-of-bounds points get zero gradient."""
    inds, valid = _grid_inds(pts.reshape(-1, 3), grid.shape)
    safe = torch.where(valid[..., None], inds, torch.zeros_like(inds))
    g = normalize(grid_interp(grid_grad_volume(grid), safe).T)
    return torch.where(valid[..., None], g, torch.zeros_like(g)).reshape(pts.shape)


class GridSdf(torch.autograd.Function):
    """Differentiable grid SDF: the value by trilinear interpolation; the
    vector-Jacobian product with respect to the points is the sampled
    normalized gradient volume times the cotangent, and zero for the grid,
    as the reference's ``DiffGridSDF`` (bodies.py:246-257) and the JAX
    package's ``grid_sdf`` custom_vjp."""

    @staticmethod
    def forward(ctx, pts, grid):
        ctx.save_for_backward(pts, grid)
        return grid_sdf_raw(pts, grid)

    @staticmethod
    def backward(ctx, d_sdf):
        pts, grid = ctx.saved_tensors
        d_pts = grid_sdf_grad(pts, grid) * d_sdf[..., None]
        d_grid = torch.zeros_like(grid) if ctx.needs_input_grad[1] else None
        return d_pts, d_grid


def grid_sdf(pts, grid):
    return GridSdf.apply(pts, grid)


def grid_query(pts, grid, scale=None, return_grads=True):
    """One grid-SDF query, the plain version of kernel K5's ``grid_query``.
    With ``scale`` (a 0-dim tensor): ``query_sdfs`` of a GridShape at metric
    local points (physics/shapes.py), the bounding-scale mask, the metric
    value and the normalized, masked ``grid_sdf_grad``, as ``sdfs`` or
    ``(sdfs, grads)``. Without: ``grid_sdf`` of normalized-frame points, or
    ``(grid_sdf, grid_sdf_grad)``."""
    if scale is None:
        sdfs = grid_sdf(pts, grid)
        return (sdfs, grid_sdf_grad(pts, grid)) if return_grads else sdfs
    overlap = torch.all(torch.abs(pts) <= scale, dim=-1)
    pts_in = pts / scale
    sdfs_n = grid_sdf(pts_in, grid)
    sdfs = torch.where(overlap, sdfs_n, torch.ones_like(sdfs_n)) * scale
    if not return_grads:
        return sdfs
    grads = normalize(grid_sdf_grad(pts_in, grid))
    return sdfs, torch.where(overlap[..., None], grads, torch.zeros_like(grads))
