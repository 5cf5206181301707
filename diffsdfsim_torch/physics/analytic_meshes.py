"""Analytic surface meshes (the reference's ``custom_mesh`` body options).

PyTorch counterpart of ``diffsdfsim_tpu/physics/analytic_meshes.py``: the
box grid (reference bodies.py:799-854), the cylinder (:914-949), the
icosphere (:973-1009) and the bowl's lat-long shell (:1028-1060). The
topology is built on the host once (numpy int32 faces, in the JAX package's
order); the vertices are differentiable functions of the shape's parameters
and lie on their device and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.meshes import icosphere


def _const(a, like):
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def box_mesh(dims, n: int = 4):
    """Axis-aligned box with an n x n grid per face; verts (6 (n+1)^2, 3)
    differentiable in ``dims`` (3,)."""
    lin = np.linspace(-0.5, 0.5, n + 1)
    u, v = np.meshgrid(lin, lin, indexing="ij")
    u = u.reshape(-1)
    v = v.reshape(-1)
    half = np.full_like(u, 0.5)
    faces_param = [
        np.stack([half, u, v], 1), np.stack([-half, v, u], 1),
        np.stack([u, half, -v], 1), np.stack([v, -half, -u], 1),
        np.stack([u, v, half], 1), np.stack([v, u, -half], 1),
    ]
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[1:, :-1].reshape(-1)
    c = idx[:-1, 1:].reshape(-1)
    d = idx[1:, 1:].reshape(-1)
    tris = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    faces = np.concatenate([tris + i * (n + 1) ** 2 for i in range(6)]).astype(np.int32)
    return _const(np.concatenate(faces_param), dims) * dims, faces


def sphere_mesh(rad, subdivisions: int = 4):
    """Icosphere scaled by ``rad``."""
    tv, tf = icosphere(subdivisions)
    return _const(tv, rad) * rad, tf.astype(np.int32)


def cylinder_mesh(rad, height, numsegs: int = 32, nh: int = 4):
    """Capped cylinder along z: a side grid of numsegs x (nh + 1) rings, a
    top and a bottom center vertex."""
    thetas = np.linspace(0, 2 * np.pi, numsegs, endpoint=False)
    hs = np.linspace(-0.5, 0.5, nh + 1)
    tg, hg = np.meshgrid(thetas, hs, indexing="ij")  # (S, H+1)
    cx, sx, hz = (_const(x.reshape(-1), rad) for x in (np.cos(tg), np.sin(tg), hg))
    side = torch.stack([rad * cx, rad * sx, height * hz], dim=-1)
    zero = torch.zeros((), dtype=rad.dtype, device=rad.device)
    top = torch.stack([zero * rad, zero, height * 0.5])
    bot = torch.stack([zero * rad, zero, -height * 0.5])
    verts = torch.cat([side, top[None], bot[None]])

    idx = np.arange(numsegs * (nh + 1)).reshape(numsegs, nh + 1)
    idx_w = np.concatenate([idx, idx[:1]], axis=0)  # wrap
    a = idx_w[:-1, :-1].reshape(-1)
    b = idx_w[1:, :-1].reshape(-1)
    c = idx_w[:-1, 1:].reshape(-1)
    d = idx_w[1:, 1:].reshape(-1)
    faces = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    ti = numsegs * (nh + 1)
    bi = ti + 1
    top_f = np.stack([np.full(numsegs, ti), idx_w[:-1, -1], idx_w[1:, -1]], 1)
    bot_f = np.stack([np.full(numsegs, bi), idx_w[1:, 0], idx_w[:-1, 0]], 1)
    return verts, np.concatenate([faces, top_f, bot_f]).astype(np.int32)


def bowl_mesh(r, d, numsegs: int = 32, nlat: int = 8):
    """Hemispherical shell opening +z (shell mid-radius r, half-thickness
    d, center shifted +r/2 along z as ``bowl_sdf``): outer surface, inner
    surface and rim annulus, watertight. Verts differentiable in (r, d)."""
    thetas = np.linspace(0.0, -np.pi / 2, nlat + 1)  # rim -> bottom pole
    phis = np.linspace(0, 2 * np.pi, numsegs, endpoint=False)
    tg, pg = np.meshgrid(thetas[:-1], phis, indexing="ij")  # exclude pole ring
    ct, st, cp, sp = (_const(x.reshape(-1), r) for x in (np.cos(tg), np.sin(tg), np.cos(pg), np.sin(pg)))

    def shell(rad):
        return torch.stack([rad * ct * cp, rad * ct * sp, rad * st], dim=-1)

    outer = shell(r + d)
    inner = shell(r - d)
    pole_o = torch.stack([r * 0, r * 0, -(r + d)])
    pole_i = torch.stack([r * 0, r * 0, -(r - d)])
    verts = torch.cat([outer, inner, pole_o[None], pole_i[None]])
    verts = verts + torch.stack([r * 0, r * 0, r / 2.0])  # shift like bowl_sdf

    nring = nlat  # rings per shell (excluding the pole)
    grid = np.arange(nring * numsegs).reshape(nring, numsegs)
    grid_w = np.concatenate([grid, grid[:, :1]], axis=1)
    a = grid_w[:-1, :-1].reshape(-1)
    b = grid_w[1:, :-1].reshape(-1)
    c = grid_w[:-1, 1:].reshape(-1)
    dd = grid_w[1:, 1:].reshape(-1)
    quad_o = np.concatenate([np.stack([a, b, dd], 1), np.stack([a, dd, c], 1)])
    off_i = nring * numsegs
    quad_i = np.concatenate([np.stack([a, dd, b], 1), np.stack([a, c, dd], 1)]) + off_i
    po = 2 * nring * numsegs
    pi = po + 1
    last_o = grid_w[-1]
    last_i = grid_w[-1] + off_i
    cap_o = np.stack([np.full(numsegs, po), last_o[1:], last_o[:-1]], 1)
    cap_i = np.stack([np.full(numsegs, pi), last_i[:-1], last_i[1:]], 1)
    rim_o = grid_w[0]
    rim_i = grid_w[0] + off_i
    rim = np.concatenate([
        np.stack([rim_o[:-1], rim_o[1:], rim_i[1:]], 1),
        np.stack([rim_o[:-1], rim_i[1:], rim_i[:-1]], 1),
    ])
    return verts, np.concatenate([quad_o, quad_i, cap_o, cap_i, rim]).astype(np.int32)
