"""Inertia tensors from closed triangle meshes (Mirtich volume integrals).

PyTorch counterpart of ``diffsdfsim_tpu/ops/inertia.py`` (reference
``sdf_physics/physics3d/bodies.py:260-395``): projection integrals -> face
integrals -> volume integrals -> mass-normalized angular inertia tensor,
vectorized over faces. Degenerate (zero-area) faces contribute nothing.
"""

from __future__ import annotations

import torch

from ..utils.spherical import normalize


def _gather_axis(vals, axis_idx):
    """vals (F,3verts,3coords), axis_idx (F,) -> (F,3verts) coordinate axis_idx."""
    idx = axis_idx[:, None, None].expand(vals.shape[0], vals.shape[1], 1)
    return torch.gather(vals, 2, idx)[..., 0]


def _projection_integrals(a0, a1, b0, b1):
    """Per-face projection integrals over the 3 directed edges
    (reference comp_projection_integrals, bodies.py:260-303)."""
    da = a1 - a0
    db = b1 - b0
    a0_2, a0_3 = a0 * a0, a0**3
    a0_4 = a0_3 * a0
    b0_2, b0_3 = b0 * b0, b0**3
    b0_4 = b0_3 * b0
    a1_2, a1_3 = a1 * a1, a1**3
    b1_2, b1_3 = b1 * b1, b1**3

    C1 = a1 + a0
    Ca = a1 * C1 + a0_2
    Caa = a1 * Ca + a0_3
    Caaa = a1 * Caa + a0_4
    Cb = b1 * (b1 + b0) + b0_2
    Cbb = b1 * Cb + b0_3
    Cbbb = b1 * Cbb + b0_4
    Cab = 3 * a1_2 + 2 * a1 * a0 + a0_2
    Kab = a1_2 + 2 * a1 * a0 + 3 * a0_2
    Caab = a0 * Cab + 4 * a1_3
    Kaab = a1 * Kab + 4 * a0_3
    Cabb = 4 * b1_3 + 3 * b1_2 * b0 + 2 * b1 * b0_2 + b0_3
    Kabb = b1_3 + 2 * b1_2 * b0 + 3 * b1 * b0_2 + 4 * b0_3

    P1 = torch.sum(db * C1, dim=1) / 2.0
    Pa = torch.sum(db * Ca, dim=1) / 6.0
    Paa = torch.sum(db * Caa, dim=1) / 12.0
    Paaa = torch.sum(db * Caaa, dim=1) / 20.0
    Pb = torch.sum(da * Cb, dim=1) / -6.0
    Pbb = torch.sum(da * Cbb, dim=1) / -12.0
    Pbbb = torch.sum(da * Cbbb, dim=1) / -20.0
    Pab = torch.sum(db * (b1 * Cab + b0 * Kab), dim=1) / 24.0
    Paab = torch.sum(db * (b1 * Caab + b0 * Kaab), dim=1) / 60.0
    Pabb = torch.sum(da * (a1 * Cabb + a0 * Kabb), dim=1) / -60.0
    return P1, Pa, Paa, Paaa, Pb, Pbb, Pbbb, Pab, Paab, Pabb


def volume_integrals(verts, faces):
    """T0 (volume), T1 (int x), T2 (int x^2), TP (int xy) per axis
    (reference comp_face_integrals + comp_volume_integrals, bodies.py:306-377)."""
    faces = torch.as_tensor(faces, device=verts.device, dtype=torch.long)
    tri = verts[faces]  # (F,3,3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 1]
    n_raw = torch.linalg.cross(e1, e2, dim=-1)
    area_sq = torch.sum(n_raw * n_raw, dim=1)
    valid_mask = area_sq > 1e-20
    valid = valid_mask.to(verts.dtype)
    dummy = torch.zeros_like(n_raw)
    dummy[:, 0] = 1.0
    normals = normalize(torch.where(valid_mask[:, None], n_raw, dummy))
    w = -torch.sum(normals * tri[:, 0], dim=1)

    C = torch.argmax(torch.abs(normals), dim=1)
    A = (C + 1) % 3
    B = (A + 1) % 3

    tri_roll = verts[faces[:, [1, 2, 0]]]
    a0 = _gather_axis(tri, A)
    a1 = _gather_axis(tri_roll, A)
    b0 = _gather_axis(tri, B)
    b1 = _gather_axis(tri_roll, B)

    P1, Pa, Paa, Paaa, Pb, Pbb, Pbbb, Pab, Paab, Pabb = _projection_integrals(a0, a1, b0, b1)

    F_idx = torch.arange(faces.shape[0], device=verts.device)
    nA = normals[F_idx, A]
    nB = normals[F_idx, B]
    nC = normals[F_idx, C]
    k1 = 1.0 / torch.where(torch.abs(nC) > 1e-12, nC, torch.ones_like(nC))
    k2, k3 = k1 * k1, k1 * k1 * k1
    k4 = k3 * k1

    Fa = k1 * Pa
    Fb = k1 * Pb
    Fc = -k2 * (nA * Pa + nB * Pb + w * P1)

    Faa = k1 * Paa
    Fbb = k1 * Pbb
    Fcc = k3 * (
        nA * nA * Paa + 2 * nA * nB * Pab + nB * nB * Pbb
        + w * (2 * (nA * Pa + nB * Pb) + w * P1)
    )

    Faaa = k1 * Paaa
    Fbbb = k1 * Pbbb
    Fccc = -k4 * (
        nA**3 * Paaa + 3 * nA * nA * nB * Paab
        + 3 * nA * nB * nB * Pabb + nB**3 * Pbbb
        + 3 * w * (nA * nA * Paa + 2 * nA * nB * Pab + nB * nB * Pbb)
        + w * w * (3 * (nA * Pa + nB * Pb) + w * P1)
    )

    Faab = k1 * Paab
    Fbbc = -k2 * (nA * Pabb + nB * Pbbb + w * Pbb)
    Fcca = k3 * (
        nA * nA * Paaa + 2 * nA * nB * Paab + nB * nB * Pabb
        + w * (2 * (nA * Paa + nB * Pab) + w * Pa)
    )

    nx = normals[:, 0]
    T0 = torch.sum(
        valid * torch.where(A == 0, nx * Fa, torch.where(B == 0, nx * Fb, nx * Fc))
    )

    eye = torch.eye(3, dtype=verts.dtype, device=verts.device)
    ohA, ohB, ohC = eye[A], eye[B], eye[C]
    T1 = torch.sum(
        valid[:, None] * (ohA * (nA * Faa)[:, None] + ohB * (nB * Fbb)[:, None] + ohC * (nC * Fcc)[:, None]),
        dim=0,
    ) / 2.0
    T2 = torch.sum(
        valid[:, None] * (ohA * (nA * Faaa)[:, None] + ohB * (nB * Fbbb)[:, None] + ohC * (nC * Fccc)[:, None]),
        dim=0,
    ) / 3.0
    TP = torch.sum(
        valid[:, None] * (ohA * (nA * Faab)[:, None] + ohB * (nB * Fbbc)[:, None] + ohC * (nC * Fcca)[:, None]),
        dim=0,
    ) / 2.0
    return T0, T1, T2, TP


def ang_inertia_from_mesh(verts, faces, mass):
    """Mass-normalized angular inertia tensor about the local origin
    (reference get_ang_inertia, bodies.py:380-395)."""
    T0, T1, T2, TP = volume_integrals(verts, faces)
    density = mass / T0
    diag = density * (T2[[1, 2, 0]] + T2[[2, 0, 1]])
    off = [(0, 1, 0), (1, 2, 1), (2, 0, 2)]
    J = torch.diag(diag)
    for i, j, t in off:
        J[i, j] = -density * TP[t]
        J[j, i] = -density * TP[t]
    return J
