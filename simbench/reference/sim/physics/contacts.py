"""Contact generation: per-pair Frank-Wolfe search + differentiable recompute.

PyTorch counterpart of ``diffsdfsim_tpu/physics/contacts.py`` (reference
``FWContactHandler``, ``sdf_physics/physics3d/contacts.py:161-273``):

- per directed body pair (body 1's surface mesh vs body 2's SDF) a
  gradient-free search, the plain Frank-Wolfe search
  ``search_pair_raw_plain``;
- filtering of the accepted rung's candidates to K representatives;
- the contact recompute at the selected candidates, differentiable in the
  poses and the bodies (the search itself is gradient-free, as in the
  reference, contacts.py:255-264), with the 6-point Laplacian stability
  test choosing which body's normal to report;
- SDF-SDF pairs run both directions, the second gated on the first finding
  no penetration; both gated by the ``_overlap`` AABB test;
- compaction of all pairs into one fixed-K contact buffer, valid slots first.

Searches carry a leading rung axis R: the probe ladder searches all its
trial poses in one call (one kernel launch per directed pair). A seed
sweep's bodies carry a lane axis (``physics/bodies.py``); its probe stage
searches L D poses, lane-major, D per lane, in the same one call: the
search's early stops stay one host read for the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
from torch.utils._pytree import tree_map

from ..config import SimConfig
from ..ops.filtering import filter_contacts
from ..ops.frank_wolfe import finalize_fw, frank_wolfe
from ..ops.polish import polish_pair
from ..utils.quaternion import quat_apply, quat_invert, quat_multiply
from .bodies import BodyDef, lane_map


@dataclasses.dataclass
class Contacts:
    """Global padded contact buffer (K slots)."""

    normal: torch.Tensor  # (K,3)
    p1: torch.Tensor  # (K,3)
    p2: torch.Tensor  # (K,3)
    pen: torch.Tensor  # (K,)
    valid: torch.Tensor  # (K,) bool
    i1: torch.Tensor  # (K,) int64 body index of body 1
    i2: torch.Tensor  # (K,) int64
    pair_id: torch.Tensor  # (K,) int64 unordered-pair id
    max_pen_all: torch.Tensor  # () max penetration across all candidates
    pair_active: torch.Tensor  # (n_pairs,) any valid contact per unordered pair


class DirectedPair(NamedTuple):
    """Static contact-pair descriptor (built once at world construction)."""

    b1: int  # body whose surface mesh provides candidates
    b2: int  # body whose SDF is queried
    pair_id: int  # unordered pair index
    gated: bool  # True for the second direction of an SDF-SDF pair
    overlap_test: bool  # True for SDF-SDF pairs


def _overlap(bd1: BodyDef, q1, pos1, bd2: BodyDef, q2, pos2):
    """Broadphase gate (reference _overlap, contacts.py:27-36, widened to a
    true AABB test as in the JAX package). q*/pos* (R,4)/(R,3); returns (R,)."""
    q1, pos1, q2, pos2 = q1[:, None], pos1[:, None], q2[:, None], pos2[:, None]
    v1_b2 = quat_apply(quat_invert(q2), quat_apply(q1, bd1.verts) + pos1 - pos2)
    v2_b1 = quat_apply(quat_invert(q1), quat_apply(q2, bd2.verts) + pos2 - pos1)
    s1, s2 = bd1.scale()[..., None], bd2.scale()[..., None]
    ov1 = torch.all((torch.amax(v1_b2, dim=1) >= -s2) & (torch.amin(v1_b2, dim=1) <= s2), dim=-1)
    ov2 = torch.all((torch.amax(v2_b1, dim=1) >= -s1) & (torch.amin(v2_b1, dim=1) <= s1), dim=-1)
    return ov1 & ov2


def _compute_contacts(bd1: BodyDef, q1, pos1, bd2: BodyDef, q2, pos2, abc, face_idx, valid,
                      eps: float, detach_contact_b2: bool = False, with_stability: bool = True,
                      anchor_b1=None):
    """Differentiable contact recompute (reference _compute_contacts,
    contacts.py:161-214) for a masked set of candidates. Poses broadcast
    against the per-candidate arrays (..., N, 3). With ``anchor_b1``
    (body-1-frame points from the polish, gradient-free), the detached
    anchor replaces the barycentric face point; gradients then flow through
    the surface projection below as they would for the face point."""
    if anchor_b1 is not None:
        cp_b1 = anchor_b1.detach()
    else:
        tri = bd1.face_tris(face_idx)  # (..., N,3,3)
        cp_b1 = torch.sum(tri * abc[..., None], dim=-2)

    if bd1.is_sdf:
        d1, n1 = bd1.query_sdfs(cp_b1)
        cp_b1 = cp_b1 - d1[..., None] * n1
        d1, n1 = bd1.query_sdfs(cp_b1)

    contact_pts = quat_apply(q1, cp_b1) + pos1
    cp_b2 = quat_apply(quat_invert(q2), contact_pts - pos2)
    if detach_contact_b2:
        cp_b2 = cp_b2.detach()
    d2, n2 = bd2.query_sdfs(cp_b2)

    if bd1.is_sdf and with_stability:
        # 6-point Laplacian stability test (contacts.py:184-202)
        eye = torch.eye(3, dtype=cp_b1.dtype, device=cp_b1.device) * eps
        offs = torch.cat([eye, -eye], dim=0)  # (6,3)
        offs = offs.reshape((6,) + (1,) * (cp_b1.dim() - 1) + (3,))
        s1 = bd1.query_sdfs(cp_b1[None] + offs, return_grads=False)
        s2 = bd2.query_sdfs(cp_b2[None] + offs, return_grads=False)
        lap1 = torch.sum(s1, dim=0) - 6 * d1
        lap2 = torch.sum(s2, dim=0) - 6 * d2
        stable = (torch.abs(lap2) < torch.abs(lap1))[..., None]
        normals = quat_apply(q2, n2) * stable - quat_apply(q1, n1) * (~stable)
    else:
        normals = quat_apply(q2, n2)

    p1 = quat_apply(q1, cp_b1)
    p2 = quat_apply(q2, cp_b2 - d2[..., None] * n2)
    vm = valid[..., None]
    zero = torch.zeros_like(p1)
    return (
        torch.where(vm, normals, zero),
        torch.where(vm, p1, zero),
        torch.where(vm, p2, zero),
        torch.where(valid, -d2, torch.full_like(d2, -1.0)),
    )


class PairCache(NamedTuple):
    """Filtered search results of one directed pair at one pose."""

    abc_sel: torch.Tensor  # (K,3)
    sel_idx: torch.Tensor  # (K,) int64 face indices
    sel_valid: torch.Tensor  # (K,) bool
    max_pen: torch.Tensor  # () over all candidates (step acceptance)
    x1_sel: torch.Tensor  # (K,3) polished body-1-frame anchors (zeros if none)


class RawPairSearch(NamedTuple):
    """Per-face search results of one directed pair before filtering, for R
    poses (the kernel's outputs, in the JAX package's (F, 3) layout)."""

    abc: torch.Tensor  # (R,F,3)
    n_ng: torch.Tensor  # (R,F,3) world normals
    p1_ng: torch.Tensor  # (R,F,3) world-oriented p1 offsets
    pen: torch.Tensor  # (R,F)
    cand: torch.Tensor  # (R,F) bool candidate mask
    cmask: torch.Tensor  # (R,F) bool contact mask
    max_pen: torch.Tensor  # (R,)
    x1: torch.Tensor  # (R,F,3) polished anchors (zeros when the pair does not polish)

    def at(self, r: int | torch.Tensor) -> "RawPairSearch":
        """The search at one rung, keeping a leading axis of 1 (at the
        poses ``r``, one per lane, for a (B,) tensor)."""
        r = torch.as_tensor(r, device=self.pen.device).reshape(-1)
        return RawPairSearch(*(t.index_select(0, r) for t in self))


def pair_polishes(bd1: BodyDef, cfg: SimConfig) -> bool:
    """Does this directed pair run the contact polish (ops/polish.py)?"""
    return cfg.contact_polish_iters > 0 and bd1.is_sdf


def pair_uses_anchors(bd1: BodyDef, bd2: BodyDef, cfg: SimConfig) -> bool:
    """Does the contact recompute read the cached body-1-frame anchors
    (``x1_sel``) in place of barycentric face points? For a polishing
    pair."""
    return pair_polishes(bd1, cfg)


def _fw_setup(bd1: BodyDef, q1, pos1, bd2: BodyDef, q2, pos2):
    """Triangles of body 1's surface in body 2's local frame, (R,F,3,3)."""
    verts_b2 = quat_apply(
        quat_invert(q2[:, None]), quat_apply(q1[:, None], bd1.verts) + pos1[:, None] - pos2[:, None]
    )
    return verts_b2[:, bd1.faces_t]


def search_pair_raw_plain(bd1: BodyDef, q1, pos1, bd2: BodyDef, q2, pos2, cfg: SimConfig) -> RawPairSearch:
    """Plain PyTorch version of the FW kernel K3 (the JAX package's
    ``_search_pair_raw_xla``): FW over all faces, surface push, polish and
    contact test, and the no-grad contact quantities, for R poses. A lane
    body of L lanes serves R / L consecutive poses per lane."""
    bd1, bd2 = per_pose(bd1, q1.shape[0]), per_pose(bd2, q1.shape[0])
    pqr = _fw_setup(bd1, q1, pos1, bd2, q2, pos2)
    R, F = pqr.shape[:2]
    dtype, device = pqr.dtype, pqr.device

    def query2(p):
        return bd2.query_sdfs(p)

    fw = frank_wolfe(pqr, query2, cfg.eps, cfg.tol, cfg.fw_iters)
    has = torch.any(fw.cand, dim=-1)
    x1 = torch.zeros((R, F, 3), dtype=dtype, device=device)
    if not bool(torch.any(has)):
        return RawPairSearch(
            abc=torch.zeros_like(x1), n_ng=torch.zeros_like(x1), p1_ng=torch.zeros_like(x1),
            pen=torch.full((R, F), -1.0, dtype=dtype, device=device), cand=fw.cand,
            cmask=torch.zeros((R, F), dtype=torch.bool, device=device),
            max_pen=torch.full((R,), float("-inf"), dtype=dtype, device=device), x1=x1,
        )

    q1b, p1b, q2b, p2b = q1[:, None], pos1[:, None], q2[:, None], pos2[:, None]
    push_fn = None
    if bd1.is_sdf:
        q21 = quat_multiply(quat_invert(q2b), q1b)
        tri1 = bd1.verts[..., bd1.faces_t, :]

        def push_fn(abc):
            x_b1 = torch.sum(tri1 * abc[..., None], dim=-2)
            s1, g1 = bd1.query_sdfs(x_b1)
            return -s1[..., None] * quat_apply(q21, g1)

    fwf = finalize_fw(fw, query2, cfg.eps, push_fn)
    cmask = fwf.contact_mask
    polishes = pair_polishes(bd1, cfg)
    if polishes:
        # step scale = face circumradius (the FW point's error bound)
        rads = torch.amax(torch.linalg.norm(torch.mean(pqr, dim=2)[:, :, None, :] - pqr, dim=-1), dim=2)
        x1, s2p = polish_pair(fwf.x, fw.cand, rads, bd1, q1, pos1, bd2, q2, pos2, cfg.contact_polish_iters)
        cmask = fw.cand & (s2p <= cfg.eps)
    face_idx = torch.arange(F, device=device).expand(R, F)
    n_ng, p1_ng, _, pen = _compute_contacts(
        bd1, q1b, p1b, bd2, q2b, p2b, fwf.abc, face_idx, cmask, cfg.eps, cfg.detach_contact_b2,
        with_stability=False, anchor_b1=x1 if polishes else None,
    )
    max_pen = torch.amax(torch.where(cmask, pen, torch.full_like(pen, float("-inf"))), dim=-1)
    raw = RawPairSearch(abc=fwf.abc, n_ng=n_ng, p1_ng=p1_ng, pen=pen, cand=fw.cand,
                        cmask=cmask, max_pen=max_pen, x1=x1)
    # rungs without any candidate take the no-candidate values
    empty = RawPairSearch(
        abc=torch.zeros_like(x1), n_ng=torch.zeros_like(x1), p1_ng=torch.zeros_like(x1),
        pen=torch.full_like(pen, -1.0), cand=fw.cand, cmask=torch.zeros_like(cmask),
        max_pen=torch.full_like(max_pen, float("-inf")), x1=torch.zeros_like(x1),
    )
    return RawPairSearch(*(
        torch.where(has.reshape((R,) + (1,) * (a.dim() - 1)), a, b) for a, b in zip(raw, empty)
    ))


def per_pose(bd: BodyDef, R: int) -> BodyDef:
    """A lane body with a lane for each of R poses (lane-major; its shape's
    tensors, a grid's included, are not copied: ``BodyDef.shape_div``); a
    body every lane shares as it is."""
    if not bd.lanes or bd.lanes == R:
        return bd
    if R % bd.lanes:
        raise ValueError(f"a body of {bd.lanes} lanes at {R} poses")
    return bd.repeat_lanes(R // bd.lanes)


def search_pair_raw(bd1: BodyDef, q1, pos1, bd2: BodyDef, q2, pos2, cfg: SimConfig) -> RawPairSearch:
    """One directed pair's gradient-free search for R poses, on the tensors'
    device."""
    return search_pair_raw_plain(bd1, q1, pos1, bd2, q2, pos2, cfg)


def cache_from_raw(raw: RawPairSearch, cfg: SimConfig) -> PairCache:
    """Filter one rung's raw search (R = 1) down to K = max_contacts_per_pair
    representatives. Computed without a host sync; a search without any
    contact gets the all-invalid cache."""
    k = cfg.max_contacts_per_pair
    cmask = raw.cmask[0]
    sel_idx, sel_valid = filter_contacts(
        raw.n_ng[0], raw.p1_ng[0], cmask, k_out=k, n_clusters=cfg.max_filter_clusters
    )
    has = torch.any(cmask)
    zero3 = torch.zeros((k, 3), dtype=raw.abc.dtype, device=raw.abc.device)
    return PairCache(
        abc_sel=torch.where(has, raw.abc[0][sel_idx], zero3),
        sel_idx=torch.where(has, sel_idx, torch.zeros_like(sel_idx)),
        sel_valid=sel_valid & has,
        max_pen=raw.max_pen[0],
        x1_sel=torch.where(has, raw.x1[0][sel_idx], zero3),
    )


class ContactCache(NamedTuple):
    """Filtered search results for all directed pairs at one pose."""

    caches: tuple  # tuple[PairCache]
    gates: tuple  # tuple[() bool]
    max_pen_all: torch.Tensor  # ()


class RawContactSearch(NamedTuple):
    """Pre-filter search results for all directed pairs, for R poses."""

    raws: tuple  # tuple[RawPairSearch]
    gates: tuple  # tuple[(R,) bool]
    max_pen_all: torch.Tensor  # (R,)

    def at(self, r) -> "RawContactSearch":
        r1 = torch.as_tensor(r, device=self.max_pen_all.device).reshape(-1)
        return RawContactSearch(
            raws=tuple(x.at(r1) for x in self.raws),
            gates=tuple(g.index_select(0, r1) for g in self.gates),
            max_pen_all=self.max_pen_all.index_select(0, r1),
        )


def search_contacts_raw(bodies: Sequence[BodyDef], quat, pos, directed_pairs: Sequence[DirectedPair],
                        cfg: SimConfig) -> RawContactSearch:
    """Gradient-free search of all pairs at R poses (quat (R,B,4), pos
    (R,B,3)), with the SDF-SDF overlap gate and the direction-2 gate
    (contacts.py:233-240). No filtering."""
    R = quat.shape[0]
    raws, gates = [], []
    pair_pens = {}
    neg_inf = torch.full((R,), float("-inf"), dtype=pos.dtype, device=pos.device)
    for dp in directed_pairs:
        bd1, bd2 = bodies[dp.b1], bodies[dp.b2]
        q1, p1, q2, p2 = quat[:, dp.b1], pos[:, dp.b1], quat[:, dp.b2], pos[:, dp.b2]
        raw = search_pair_raw(bd1, q1, p1, bd2, q2, p2, cfg)
        gate = torch.ones((R,), dtype=torch.bool, device=pos.device)
        if dp.overlap_test:
            gate = _overlap(per_pose(bd1, R), q1, p1, per_pose(bd2, R), q2, p2)
        if dp.gated:
            gate = gate & (pair_pens[dp.pair_id] <= cfg.tol)
        max_pen = torch.where(gate, raw.max_pen, neg_inf)
        pair_pens[dp.pair_id] = torch.maximum(pair_pens.get(dp.pair_id, neg_inf), max_pen)
        raws.append(raw)
        gates.append(gate)
    if pair_pens:
        max_pen_all = torch.amax(torch.stack([pair_pens[p] for p in sorted(pair_pens)]), dim=0)
    else:
        max_pen_all = neg_inf
    return RawContactSearch(raws=tuple(raws), gates=tuple(gates), max_pen_all=max_pen_all)


def finish_contacts(raw: RawContactSearch, cfg: SimConfig) -> ContactCache:
    """Filter each pair of a one-rung raw search into its PairCache."""
    return ContactCache(
        caches=tuple(cache_from_raw(r, cfg) for r in raw.raws),
        gates=tuple(g[0] for g in raw.gates),
        max_pen_all=raw.max_pen_all[0],
    )


def search_contacts(bodies, quat, pos, directed_pairs, cfg: SimConfig) -> ContactCache:
    """Search + filter at one pose (quat (B,4), pos (B,3))."""
    return finish_contacts(search_contacts_raw(bodies, quat[None], pos[None], directed_pairs, cfg), cfg)


def find_contacts_pair(bd1: BodyDef, q1, pos1, bd2: BodyDef, q2, pos2, cfg: SimConfig, cache: PairCache):
    """One directed pair at one pose: the differentiable contact recompute
    at the cached candidates. Returns per-slot (normal, p1, p2, pen, valid,
    max_pen)."""
    normals, p1c, p2c, pens = _compute_contacts(
        bd1, q1, pos1, bd2, q2, pos2, cache.abc_sel, cache.sel_idx, cache.sel_valid,
        cfg.eps, cfg.detach_contact_b2, with_stability=True,
        anchor_b1=cache.x1_sel if pair_uses_anchors(bd1, bd2, cfg) else None,
    )
    return normals, p1c, p2c, pens, cache.sel_valid, cache.max_pen


def find_contacts(bodies: Sequence[BodyDef], quat, pos, directed_pairs: Sequence[DirectedPair],
                  n_unordered: int, cfg: SimConfig, cache: ContactCache | None = None) -> Contacts:
    """All pairs -> global compacted contact buffer (max_contacts_total
    slots), differentiable in the poses and bodies. With ``cache`` (from
    search_contacts at the same pose) only the recompute runs; without it
    the search runs first, gradient-free."""
    dtype, device = quat.dtype, quat.device
    if cache is None:
        with torch.no_grad():
            cache = search_contacts(bodies, quat, pos, directed_pairs, cfg)
    kt = cfg.max_contacts_total
    if not directed_pairs:
        zero3 = torch.zeros((kt, 3), dtype=dtype, device=device)
        zi = torch.zeros((kt,), dtype=torch.long, device=device)
        return Contacts(
            normal=zero3, p1=zero3, p2=zero3, pen=torch.full((kt,), -1.0, dtype=dtype, device=device),
            valid=torch.zeros((kt,), dtype=torch.bool, device=device), i1=zi, i2=zi, pair_id=zi,
            max_pen_all=torch.tensor(float("-inf"), dtype=dtype, device=device),
            pair_active=torch.zeros((max(n_unordered, 1),), dtype=torch.bool, device=device),
        )
    parts = {key: [] for key in ("normal", "p1", "p2", "pen", "valid", "i1", "i2", "pair_id")}
    for dp, pc, gate in zip(directed_pairs, cache.caches, cache.gates):
        n, p1c, p2c, pens, valid, _ = find_contacts_pair(
            bodies[dp.b1], quat[dp.b1], pos[dp.b1], bodies[dp.b2], quat[dp.b2], pos[dp.b2], cfg, cache=pc
        )
        k = valid.shape[0]
        for key, val in (("normal", n), ("p1", p1c), ("p2", p2c), ("pen", pens), ("valid", valid & gate)):
            parts[key].append(val)
        for key, val in (("i1", dp.b1), ("i2", dp.b2), ("pair_id", dp.pair_id)):
            parts[key].append(torch.full((k,), val, dtype=torch.long, device=device))
    cat = {key: torch.cat(v) for key, v in parts.items()}
    s = cat["valid"].shape[0]

    # stable compaction: valid slots first
    ar = torch.arange(s, device=device)
    order = torch.argsort(torch.where(cat["valid"], ar, s + ar))[:kt]
    valid = cat["valid"][order]
    pair_id = cat["pair_id"][order]
    pair_active = torch.zeros((max(n_unordered, 1),), dtype=torch.long, device=device)
    pair_active = pair_active.scatter_reduce(0, pair_id, valid.long(), reduce="amax") > 0
    return Contacts(
        normal=cat["normal"][order], p1=cat["p1"][order], p2=cat["p2"][order], pen=cat["pen"][order],
        valid=valid, i1=cat["i1"][order], i2=cat["i2"][order], pair_id=pair_id,
        max_pen_all=cache.max_pen_all, pair_active=pair_active,
    )


# ---------------------------------------------------------------- lanes


def contacts_fields(c: Contacts) -> tuple:
    return tuple(getattr(c, f.name) for f in dataclasses.fields(Contacts))


def finish_contacts_lanes(raw: RawContactSearch, cfg: SimConfig) -> ContactCache:
    """``finish_contacts`` of B worlds, each at its own selected rung (raw
    with a leading lane axis): the filter mapped over the lanes."""
    return torch.func.vmap(lambda r: finish_contacts(tree_map(lambda x: x[None], r), cfg))(raw)


def find_contacts_lanes(bodies: Sequence[BodyDef], quat, pos, directed_pairs: Sequence[DirectedPair],
                        n_unordered: int, cfg: SimConfig, cache: ContactCache) -> Contacts:
    """``find_contacts`` of B worlds at their cached candidates (quat (B,
    nb, 4), pos (B, nb, 3), the cache with a lane axis): the recompute and
    compaction mapped over the lanes, differentiable in the poses and the
    bodies."""
    fields = lane_map(
        lambda bds, q, p, cc: contacts_fields(find_contacts(bds, q, p, directed_pairs, n_unordered, cfg, cache=cc)),
        bodies, quat, pos, cache)
    return Contacts(*fields)
