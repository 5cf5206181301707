"""Isosurface extraction by marching tetrahedra.

PyTorch counterpart of ``diffsdfsim_tpu/ops/marching.py``, the mesher of
voxel-grid and learned shapes whose topology the template projection
(``ops/surface.py``) cannot represent (a torus; reference marching cubes,
``sdf_physics/physics3d/bodies.py:652-704``). Each grid cell splits into 6
tetrahedra around the cell's main diagonal; a tetrahedron's 16 sign cases
give 0, 1 or 2 triangles (``_tet_case_tables``). Vertex positions are
differentiable in the grid values through the edge-interpolation weights.

The JAX package keeps a static output shape: it sorts the valid triangles
to the front (stable, so in cell, tetrahedron and slot order), truncates at
``max_tris``, parks the rest at the origin and masks them. Here the invalid
triangles are dropped at extraction: the output holds the valid triangles
in that same order, truncated at ``max_tris``, and no other. The extraction
is a triangle soup (vertices not welded).
"""

from __future__ import annotations

import numpy as np
import torch

# the 8 corners of the unit cube, and its 6 tetrahedra sharing the main
# diagonal 0-7 (indices into the corners)
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int64
)
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], dtype=np.int64
)
# a tetrahedron's edges (pairs of its local vertex indices 0..3)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)


def _tet_case_tables():
    """The 16 sign cases of a tetrahedron (bit v set: vertex v inside).

    Returns (tri_edges (16, 2, 3) int32 edge indices into ``_TET_EDGES``,
    -1 where a case has fewer triangles, n_tris (16,)). The winding points
    from the inside (sdf < 0) outward."""
    tri_edges = -np.ones((16, 2, 3), dtype=np.int32)
    n_tris = np.zeros((16,), dtype=np.int32)

    def edge_id(a, b):
        return next(i for i, (u, v) in enumerate(_TET_EDGES) if (u, v) == (min(a, b), max(a, b)))

    for case in range(16):
        inside = [v for v in range(4) if case & (1 << v)]
        outside = [v for v in range(4) if not case & (1 << v)]
        if len(inside) == 1:
            a, (b, c, d) = inside[0], outside
            tri_edges[case, 0] = [edge_id(a, b), edge_id(a, c), edge_id(a, d)]
            n_tris[case] = 1
        elif len(inside) == 3:
            a, (b, c, d) = outside[0], inside
            tri_edges[case, 0] = [edge_id(a, b), edge_id(a, d), edge_id(a, c)]
            n_tris[case] = 1
        elif len(inside) == 2:
            (a, b), (c, d) = inside, outside
            # quad (a,c), (a,d), (b,d), (b,c) -> two triangles
            e0, e1, e2, e3 = edge_id(a, c), edge_id(a, d), edge_id(b, d), edge_id(b, c)
            tri_edges[case, 0] = [e0, e1, e2]
            tri_edges[case, 1] = [e0, e2, e3]
            n_tris[case] = 2
    return tri_edges, n_tris


_TRI_EDGES_TABLE, _N_TRIS_TABLE = _tet_case_tables()


def marching_tets(grid, iso: float = 0.0, max_tris: int | None = None):
    """The iso-surface of a voxel grid (X, Y, Z) in index coordinates:
    (n, 3, 3) triangle corners, the valid triangles in cell, tetrahedron
    and slot order, at most ``max_tris`` of them. Differentiable in
    ``grid``."""
    X, Y, Z = grid.shape
    dtype, device = grid.dtype, grid.device
    ii, jj, kk = torch.meshgrid(*(torch.arange(n - 1, device=device) for n in (X, Y, Z)), indexing="ij")
    cell_origin = torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3)  # (C, 3)
    corners = cell_origin[:, None, :] + torch.as_tensor(_CUBE_CORNERS, device=device)  # (C, 8, 3)
    corner_vals = grid[corners[..., 0], corners[..., 1], corners[..., 2]] - iso  # (C, 8)

    tets = torch.as_tensor(_TETS, device=device)
    tet_val = corner_vals[:, tets].reshape(-1, 4)  # (T, 4)
    inside = (tet_val < 0.0).to(torch.int64)
    case = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2] + 8 * inside[:, 3]
    n_tris = torch.as_tensor(_N_TRIS_TABLE, device=device)[case]
    # only the tetrahedra that fire: the order of their triangles is kept
    fire = torch.nonzero(n_tris > 0)[:, 0]
    tet_val, case, n_tris = tet_val[fire], case[fire], n_tris[fire]
    tet_pos = corners.reshape(-1, 3)[(fire // 6)[:, None] * 8 + tets[fire % 6]].to(dtype)  # (T', 4, 3)

    # the crossing points of the 6 edges, with the JAX package's 1e-12 guard
    e = torch.as_tensor(_TET_EDGES, device=device)
    va, vb = tet_val[:, e[:, 0]], tet_val[:, e[:, 1]]
    denom = va - vb
    t = va / torch.where(torch.abs(denom) > 1e-12, denom, torch.full_like(denom, 1e-12))
    t = torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))  # jnp.clip: half the gradient at 0 and 1
    pa, pb = tet_pos[:, e[:, 0], :], tet_pos[:, e[:, 1], :]
    cross_pts = pa + t[..., None] * (pb - pa)  # (T', 6, 3)

    tri_edges = torch.as_tensor(_TRI_EDGES_TABLE, device=device)[case].clamp(min=0).to(torch.int64)  # (T', 2, 3)
    rows = torch.arange(cross_pts.shape[0], device=device)[:, None, None]
    tri_pts = cross_pts[rows, tri_edges]  # (T', 2, 3 corners, 3)

    # orient every triangle outward: the SDF is affine over a tetrahedron,
    # its gradient g solves E g = dv (rows of E the edges from vertex 0);
    # flip the triangles whose normal opposes it
    E = tet_pos[:, 1:, :] - tet_pos[:, :1, :]
    dv = tet_val[:, 1:] - tet_val[:, :1]
    g = torch.linalg.solve(E + 1e-12 * torch.eye(3, dtype=dtype, device=device), dv[..., None])[..., 0]
    nrm = torch.linalg.cross(tri_pts[:, :, 1, :] - tri_pts[:, :, 0, :], tri_pts[:, :, 2, :] - tri_pts[:, :, 0, :])
    flip = torch.einsum("tkc,tc->tk", nrm, g) < 0
    tri_pts = torch.where(flip[..., None, None], tri_pts[:, :, [0, 2, 1], :], tri_pts)

    valid = torch.stack([n_tris >= 1, n_tris >= 2], dim=1).reshape(-1)
    tri = tri_pts.reshape(-1, 3, 3)[valid]
    return tri if max_tris is None else tri[:max_tris]


def grid_to_mesh(grid, scale=1.0, iso: float = 0.0, max_tris: int | None = None):
    """Marching tetrahedra in the normalized [-1, 1]^3 frame (the reference
    marching cubes' convention, bodies.py:667: verts / (res - 1) * 2 - 1),
    scaled to metric units. Returns (verts (3 n, 3), faces (n, 3) int32):
    triangle i is verts 3i, 3i+1, 3i+2."""
    tri = marching_tets(grid, iso=iso, max_tris=max_tris)
    res = torch.as_tensor(grid.shape, dtype=tri.dtype, device=tri.device)
    verts = (tri / (res - 1.0) * 2.0 - 1.0) * scale
    n = tri.shape[0]
    return verts.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(n, 3)
