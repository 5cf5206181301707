"""Contact filtering: normal clustering + deterministic support selection.

PyTorch counterpart of ``diffsdfsim_tpu/ops/filtering.py`` (replacing the
reference ``_filter_contacts``, ``sdf_physics/physics3d/contacts.py:97-158``):
greedy clustering by normal angle, then per cluster the support points along
8 tangential directions, duplicate removal and stable compaction to k_out
slots. The direction fan is rotated about 7 degrees off the frame axes,
exactly as in the JAX package: an axis-aligned fan ties its argmax along
axis-aligned face edges and picks different manifolds on equivalent paths.
"""

from __future__ import annotations

import torch

from ..utils.spherical import normalize, orthogonal

_SQ2 = 0.7071067811865476


def filter_contacts(normals, p1, valid, k_out: int, n_clusters: int = 4,
                    angle_thresh: float = 1e-2, dedup_eps: float = 1e-3):
    """Select up to k_out representative contact indices of one pair.

    normals/p1 (F,3), valid (F,). Returns (sel_idx (k_out,) int64,
    sel_valid (k_out,) bool)."""
    nf = normals.shape[0]
    device = normals.device
    f_idx = torch.arange(nf, device=device)
    valid = valid & (torch.linalg.norm(normals, dim=-1) > 1e-12)
    n_unit = normalize(normals)

    unassigned = valid
    slot_idx = []
    slot_valid = []
    for _ in range(n_clusters):
        # the first unassigned valid contact seeds the cluster
        first = torch.argmin(torch.where(unassigned, f_idx, torch.full_like(f_idx, nf)))
        has = torch.any(unassigned)
        n_ref = n_unit[first]
        cosang = torch.clamp(n_unit @ n_ref, -1.0, 1.0)
        member = unassigned & (torch.arccos(cosang) < angle_thresh) & has

        t1r = normalize(orthogonal(n_ref))
        t2r = normalize(torch.linalg.cross(n_ref, t1r, dim=-1))
        # fan rotated by 0.125 rad off the frame axes (see module docstring)
        _c0, _s0 = 0.992197667229329, 0.124674733385228  # cos/sin(0.125)
        t1 = _c0 * t1r + _s0 * t2r
        t2 = -_s0 * t1r + _c0 * t2r
        dirs = torch.stack(
            [
                t1, t2, -t1, -t2,
                _SQ2 * (t1 + t2), _SQ2 * (t1 - t2),
                -_SQ2 * (t1 + t2), -_SQ2 * (t1 - t2),
            ]
        )  # (8,3)
        scores = p1 @ dirs.T  # (F,8)
        scores = torch.where(member[:, None], scores, float("-inf"))
        picks = torch.argmax(scores, dim=0)  # (8,)
        slot_idx.append(picks)
        slot_valid.append(member[picks])
        unassigned = unassigned & ~member

    slot_idx = torch.cat(slot_idx)  # (S,)
    slot_valid = torch.cat(slot_valid)

    # duplicate removal, keep the first occurrence: same face index or
    # contact point within dedup_eps
    s = slot_idx.shape[0]
    p1s = p1[slot_idx]
    d2 = torch.sum((p1s[None, :, :] - p1s[:, None, :]) ** 2, dim=-1)
    eq = (slot_idx[None, :] == slot_idx[:, None]) | (d2 < dedup_eps * dedup_eps)
    earlier = torch.tril(torch.ones((s, s), dtype=torch.bool, device=device), diagonal=-1)
    dup = torch.any(eq & earlier.T & slot_valid[:, None], dim=0)
    unique = slot_valid & ~dup

    # stable compaction: valid-unique slots first, original order kept
    ar = torch.arange(s, device=device)
    keys = torch.where(unique, ar, s + ar)
    order = torch.argsort(keys)
    top = order[:k_out]
    return slot_idx[top], unique[top]
