"""2D grid-SDF ops: bilinear interpolation and marching squares.

PyTorch counterpart of ``diffsdfsim_tpu/ops/marching2d.py`` (reference
legacy 2D SDF layer, ``sdf_physics/physics/bodies.py:91-283`` ``SDFGrid``):
every cell emits a fixed two-segment buffer with a validity mask, in the JAX
package's order (all cells' first slots, then all second slots), and the
interpolation is a gather over the four corners of each point's cell,
differentiable with respect to the grid values and the points.

Grid convention as the reference's: node (i, j) sits at
(linspace(-0.5, 0.5, H)[i], linspace(-0.5, 0.5, W)[j]) in the body's
normalized frame; values are normalized signed distances.
"""

from __future__ import annotations

import torch

from ..config import default_dtype, resolve_device

# the 16-case table (reference edgeTable, bodies.py:118-133): per cell class
# up to two segments as (edge_a, edge_b) pairs, -1 an unused slot; edge k
# joins corner k and corner (k + 1) % 4
_TABLE = (
    (-1, -1, -1, -1), (2, 3, -1, -1), (1, 2, -1, -1), (1, 3, -1, -1),
    (0, 1, -1, -1), (0, 3, 1, 2), (0, 2, -1, -1), (0, 3, -1, -1),
    (0, 3, -1, -1), (0, 2, -1, -1), (0, 1, 2, 3), (0, 1, -1, -1),
    (1, 3, -1, -1), (1, 2, -1, -1), (2, 3, -1, -1), (-1, -1, -1, -1),
)


def _zero(x):
    return x.new_zeros(())


def bilinear_interp(grid, pts):
    """Bilinear interpolation of a (H, W) grid at pts (..., 2) in the
    [-0.5, 0.5]^2 normalized frame (reference SDFGrid.query, bodies.py:
    203-247). A point out of range takes the border value plus its
    component-wise distance outside, so the field keeps growing away from
    the body and far queries never report contact. ``max`` / ``min`` as
    the JAX package's ``jnp.maximum`` / ``jnp.minimum`` (half the gradient
    at a tie)."""
    H, W = grid.shape
    x = (pts[..., 0] + 0.5) * (H - 1)
    y = (pts[..., 1] + 0.5) * (W - 1)
    z = _zero(x)
    out = (
        torch.maximum(-x, z) + torch.maximum(x - (H - 1), z)
        + torch.maximum(-y, z) + torch.maximum(y - (W - 1), z)
    ) / float(max(H - 1, W - 1))
    x = torch.minimum(torch.maximum(x, z), z + (H - 1.0))
    y = torch.minimum(torch.maximum(y, z), z + (W - 1.0))
    i0 = torch.clamp(torch.floor(x).to(torch.long), 0, H - 2)
    j0 = torch.clamp(torch.floor(y).to(torch.long), 0, W - 2)
    fx = x - i0
    fy = y - j0
    g00 = grid[i0, j0]
    g01 = grid[i0, j0 + 1]
    g10 = grid[i0 + 1, j0]
    g11 = grid[i0 + 1, j0 + 1]
    v = g00 * (1 - fx) * (1 - fy) + g01 * (1 - fx) * fy + g10 * fx * (1 - fy) + g11 * fx * fy
    return v + out


def marching_squares(grid, iso=0.0):
    """The iso-contour of a (H, W) grid as masked fixed-size segments.

    Returns (segs, valid): segs ((H-1)(W-1) 2, 2, 2) segment endpoints in
    the [-0.5, 0.5]^2 frame (zero where invalid), valid bool. Every cell
    owns two slots; the 16-case table fills 0, 1 or 2 of them; the saddle
    cases (5, 10) emit both segments with the reference's pairing."""
    H, W = grid.shape
    dtype, device = grid.dtype, grid.device
    g = grid - iso
    xs = torch.linspace(-0.5, 0.5, H, dtype=dtype, device=device)
    ys = torch.linspace(-0.5, 0.5, W, dtype=dtype, device=device)
    px, py = torch.meshgrid(xs, ys, indexing="ij")
    pts = torch.stack([px, py], dim=-1)

    # cell corners in the reference's order: tl [i, j], tr [i, j+1],
    # br [i+1, j+1], bl [i+1, j]
    c = [v.reshape(-1) for v in (g[:-1, :-1], g[:-1, 1:], g[1:, 1:], g[1:, :-1])]
    p = [v.reshape(-1, 2) for v in (pts[:-1, :-1], pts[:-1, 1:], pts[1:, 1:], pts[1:, :-1])]
    n_cells = c[0].shape[0]
    cls = sum((c[k] < 0).to(torch.long) * (8 >> k) for k in range(4))

    def interp(i, j):
        """Zero crossing on the edge corner i -> corner j."""
        d = c[i] - c[j]
        t = c[i] / torch.where(torch.abs(d) < 1e-30, torch.full_like(d, 1e-30), d)
        t = torch.minimum(torch.maximum(t, _zero(t)), _zero(t) + 1.0)
        return p[i] + t[:, None] * (p[j] - p[i])

    edge_pts = torch.stack([interp(k, (k + 1) % 4) for k in range(4)])  # (4, N, 2)
    tab = torch.tensor(_TABLE, dtype=torch.long, device=device)[cls]  # (N, 4)
    cell = torch.arange(n_cells, device=device)
    segs, valids = [], []
    for s in range(2):
        ea, eb = tab[:, 2 * s], tab[:, 2 * s + 1]
        a = edge_pts[torch.clamp(ea, min=0), cell]
        b = edge_pts[torch.clamp(eb, min=0), cell]
        segs.append(torch.stack([a, b], dim=1))
        valids.append(ea >= 0)
    segs = torch.cat(segs)
    valid = torch.cat(valids)
    return torch.where(valid[:, None, None], segs, torch.zeros_like(segs)), valid


def grid_from_sdf_fn(fn, res, dtype=None, device=None):
    """A normalized-frame 2D SDF callable sampled on the reference's res x
    res node lattice (in the port's default dtype unless one is named), on
    ``device`` (default: the card)."""
    xs = torch.linspace(-0.5, 0.5, res, dtype=dtype or default_dtype(), device=resolve_device(device))
    px, py = torch.meshgrid(xs, xs, indexing="ij")
    return fn(torch.stack([px, py], dim=-1))
