"""Template meshes (numpy, built once on the host).

An icosphere and a cube-sphere, both with vertices on the unit sphere.
``ops/surface.py`` Newton-projects them onto a shape's SDF zero set.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def icosphere(subdivisions: int = 3):
    """Unit icosphere. Returns numpy (V,3) float64, (F,3) int32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )

    for _ in range(subdivisions):
        edge_mid = {}
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        new_faces = []
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.stack(verts_list)
        faces = np.array(new_faces, dtype=np.int64)

    return verts, faces.astype(np.int32)


@functools.lru_cache(maxsize=None)
def cube_template(n: int = 8):
    """Unit-cube surface grid mapped to the sphere (cube-sphere): (V,3),(F,3).

    Better vertex coverage of large flat faces than the icosphere when
    projected onto box SDFs."""
    lin = np.linspace(-1.0, 1.0, n + 1)
    u, v = np.meshgrid(lin, lin, indexing="ij")
    u = u.reshape(-1)
    v = v.reshape(-1)
    ones = np.ones_like(u)
    face_pts = [
        np.stack([ones, u, v], 1), np.stack([-ones, v, u], 1),
        np.stack([u, ones, -v], 1), np.stack([v, -ones, -u], 1),
        np.stack([u, v, ones], 1), np.stack([v, u, -ones], 1),
    ]
    grid_f = []
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[1:, :-1].reshape(-1)
    c = idx[:-1, 1:].reshape(-1)
    d = idx[1:, 1:].reshape(-1)
    tris = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    verts = []
    off = 0
    for pts in face_pts:
        verts.append(pts)
        grid_f.append(tris + off)
        off += pts.shape[0]
    verts = np.concatenate(verts)
    faces = np.concatenate(grid_f)
    # weld duplicate vertices along cube edges
    verts_r = np.round(verts, 9)
    uniq, inv = np.unique(verts_r, axis=0, return_inverse=True)
    faces = inv.reshape(-1)[faces]
    verts = uniq
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return verts, faces.astype(np.int32)
