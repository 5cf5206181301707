"""Batched-native rollout: a seed sweep's worlds on one leading lane axis.

B worlds that share their static structure (pair tables, joints, config)
and differ in their bodies (each lane has its own vertices, mass, inertia
and SDF parameters), stepped together.

- ``make_world_batched`` builds each lane with the single-world constructor
  and stacks the leaves: bodies that differ between lanes become lane
  bodies (``physics/bodies.py``), the state carries the lane axis first;
- every control-flow decision is one host read for the whole batch,
  whatever B is (``WorldSpec.host_bool``, counted by kind in
  ``WorldSpec.host_reads``): whether any lane still has frame time to cover
  (``"substep"``), whether any lane starts with a contact (``"contact"``),
  whether any lane failed the shallow probe stage (``"deep"``), whether any
  lane selected a contact (``"recompute"``), whether any lane gained one
  (``"toc"``) and whether any lane re-runs its frame (``"redo"``). Where
  the JAX package's vmapped ``lax.cond`` selects per lane, the lanes are
  selected here (``_select_lanes``);
- a probe stage of the whole batch is one batched solve over its B D
  problems and one search per directed pair over its B D poses,
  lane-major (``engine.probe_dynamics_lanes``,
  ``contacts.search_contacts_raw``); the replay's backward is one batched
  KKT solve over the B lanes (``engine.replay_dynamics_lanes``); the eager
  ops of a substep do not grow with B.

The solver decides over its whole batch whether a problem's last step was
checked for improvement, as the JAX solver's loop does, so a lane's
solution can depend, at that margin, on the batch it runs in.

``spec.stages`` counts the substeps and the probe stages (``"shallow"``,
``"deep"``) the batch ran, and the stages that solved the LCP (``"lcp"``:
some lane started with a contact) and the taped replays that re-emit an LCP
solution (``"replay_lcp"``). ``remat_*``, ``*_unroll`` and ``replay_mode``
are no-ops (``config.SimConfig``). Per-lane force
parameters travel as ``forces_b`` (``make_world_batched(...,
return_forces=True)``); without it ``spec.forces`` applies to every lane.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from .bodies import stack_lanes
from .contacts import Contacts, finish_contacts_lanes, find_contacts_lanes, search_contacts_raw
from .engine import (
    _lane_select,
    apply_forces_lanes,
    body_lanes,
    probe_dynamics_lanes,
    replay_dynamics_lanes,
)
from .world import (
    StepRecord,
    Trajectory,
    WorldSpec,
    WorldState,
    _accept_thresh,
    _detached,
    _integrate,
    _requires_grad,
    _stack_frames,
)
from ..ops.toc import TocArgs, toc_dt
from ..utils.quaternion import quat_to_matrix, so3_exp_map


def _select_lanes(pred, a, b):
    """Per-lane select over states, records, contact buffers and tuples of
    them, every tensor with a leading lane axis; pred (B,)."""
    if isinstance(a, torch.Tensor):
        return _lane_select(pred, a, b)
    if isinstance(a, Contacts):
        return Contacts(**{f.name: _select_lanes(pred, getattr(a, f.name), getattr(b, f.name))
                           for f in dataclasses.fields(Contacts)})
    out = [_select_lanes(pred, x, y) for x, y in zip(a, b)]
    return type(a)(*out) if hasattr(a, "_fields") else type(a)(out)


def _stack(xs):
    """Stack per-lane states or contact buffers (same structure) on a new
    leading lane axis."""
    x0 = xs[0]
    if isinstance(x0, torch.Tensor):
        return torch.stack(xs)
    if isinstance(x0, Contacts):
        return Contacts(**{f.name: _stack([getattr(x, f.name) for x in xs]) for f in dataclasses.fields(Contacts)})
    return type(x0)(*(_stack(list(f)) for f in zip(*xs)))


def _stack_forces(per_lane):
    """One force object per lane -> a force whose tensor attributes carry
    the lane axis (an attribute equal in every lane and requiring no grad
    stays as it is; any other attribute must be the same in every lane)."""
    f0 = per_lane[0]
    out = copy.copy(f0)
    for name, v0 in vars(f0).items():
        vals = [vars(f)[name] for f in per_lane]
        if isinstance(v0, torch.Tensor):
            if any(v.requires_grad for v in vals) or not all(torch.equal(v, v0) for v in vals[1:]):
                setattr(out, name, torch.stack(vals))
        elif not all(v is v0 or v == v0 for v in vals[1:]):
            raise ValueError(f"{type(f0).__name__}.{name} differs between lanes and is not a tensor")
    return out


def make_world_batched(build_fn, *batched_args, return_forces: bool = False):
    """Build a seed sweep's worlds: ``build_fn(*args) -> (spec, state)`` is
    the single-world constructor (typically closing over the config and
    calling ``make_world``), called for each lane i with ``args[j][i]`` (so
    a lane's parameter reaches its own tape). Returns ``(spec, bodies_b,
    state_b)``: ``spec`` is lane 0's (the static structure, which every lane
    must share); ``bodies_b`` the bodies with a lane axis where they differ;
    ``state_b`` the state with the lane axis first. With
    ``return_forces=True``: ``(spec, bodies_b, forces_b, state_b)``."""
    n = len(batched_args[0])
    worlds = [build_fn(*(a[i] for a in batched_args)) for i in range(n)]
    spec = worlds[0][0]
    for s, _ in worlds[1:]:
        if s.directed_pairs != spec.directed_pairs or s.joints != spec.joints or s.cfg != spec.cfg:
            raise ValueError("the lanes' worlds differ in their pairs, joints or config")
    bodies_b = tuple(stack_lanes([s.bodies[j] for s, _ in worlds]) for j in range(len(spec.bodies)))
    state_b = _stack([st for _, st in worlds])
    if return_forces:
        forces_b = tuple(
            tuple(_stack_forces([s.forces[i][j] for s, _ in worlds]) for j in range(len(spec.forces[i])))
            for i in range(len(spec.forces)))
        return spec, bodies_b, forces_b, state_b
    return spec, bodies_b, state_b


def _forces_arg(spec: WorldSpec, forces_b):
    """The forces of every lane: per-lane when given, spec.forces otherwise."""
    return spec.forces if forces_b is None else forces_b


def _taping(spec: WorldSpec, bodies_b, forces, state: WorldState) -> bool:
    """Whether the batch records its tape (``world._taping`` over the lane
    bodies and the forces in use)."""
    return torch.is_grad_enabled() and (
        any(_requires_grad(bd.tensors().values()) for bd in bodies_b)
        or any(_requires_grad(vars(o).values()) for o in (*spec.joints, *(f for fs in forces for f in fs)))
        or _requires_grad((state.quat, state.pos, state.v, state.last_dt)))


def _probe_rungs(spec: WorldSpec, bodies_b, forces, state: WorldState, dt_frame, thresh, lo: int, hi: int,
                 any_contact: bool):
    """Rungs lo..hi of every lane (``world._probe_rungs``): one dynamics
    solve over the B D problems, one search of the B D poses, and per lane
    the smallest passing rung. Returns (found (B,), k (B,), raw with a
    leading lane axis at each lane's rung, sol_k (B, ...))."""
    cfg = spec.cfg
    B, nb = state.pos.shape[:2]
    D = hi - lo + 1
    ar = torch.arange(lo, hi + 1, dtype=dt_frame.dtype, device=dt_frame.device)
    dts = dt_frame[:, None] * torch.pow(0.5, ar)  # (B, D)
    new_vs, sol = probe_dynamics_lanes(bodies_b, spec.joints, forces, state, dts, cfg, any_contact)
    spec.stages["lcp"] += any_contact
    q2, p2 = _integrate(state.quat[:, None], state.pos[:, None], new_vs.reshape(B, D, nb, 6), dts[:, :, None, None])
    raw = search_contacts_raw(bodies_b, q2.reshape(B * D, nb, 4), p2.reshape(B * D, nb, 3), spec.directed_pairs, cfg)
    ok = raw.max_pen_all.reshape(B, D) <= thresh[:, None]
    found = torch.any(ok, dim=-1)
    idx = torch.where(found, torch.argmax(ok.to(torch.uint8), dim=-1), torch.full_like(found, D - 1, dtype=torch.long))
    lanes = torch.arange(B, device=idx.device)
    sol_k = tuple(x[lanes, idx] for x in sol)
    return found, lo + idx, raw.at(lanes * D + idx), sol_k


@torch.no_grad()
def _probe_batched(spec: WorldSpec, bodies_b, state_b: WorldState, dt_frame_b, forces_b=None):
    """Gradient-free staged probe of the whole batch: rungs 0..ladder_stage1
    for every lane in one stage, the deep rungs for every lane only when
    some lane failed the shallow stage, each lane selecting its own.
    Returns (k, found, ContactCache with a lane axis, sol_k, any_contact)."""
    cfg = spec.cfg
    forces = _forces_arg(spec, forces_b)
    mb = cfg.max_bisect
    s1 = min(cfg.ladder_stage1, mb) if cfg.ladder_stage1 >= 0 else mb
    thresh = _accept_thresh(spec, state_b)
    any_contact = spec.host_bool(torch.any(state_b.contacts.valid), "contact")
    spec.stages["shallow"] += 1
    stage = _probe_rungs(spec, bodies_b, forces, state_b, dt_frame_b, thresh, 0, s1, any_contact)
    if s1 < mb and not spec.host_bool(torch.all(stage[0]), "deep"):
        spec.stages["deep"] += 1
        deep = _probe_rungs(spec, bodies_b, forces, state_b, dt_frame_b, thresh, s1 + 1, mb, any_contact)
        stage = _select_lanes(stage[0], stage, deep)
    found, k, raw, sol_k = stage
    return k, found, finish_contacts_lanes(raw, cfg), sol_k, any_contact


def _empty_contacts(spec: WorldSpec, B: int, dtype, max_pen_all) -> Contacts:
    """The all-invalid contact buffer of every lane (``world._empty_contacts_value``)."""
    i1, i2, pid = (c.expand(B, -1) for c in spec._empty_cols)
    n = i1.shape[1]
    zero3 = torch.zeros((B, n, 3), dtype=dtype, device=i1.device)
    return Contacts(
        normal=zero3, p1=zero3, p2=zero3, pen=torch.full((B, n), -1.0, dtype=dtype, device=i1.device),
        valid=torch.zeros((B, n), dtype=torch.bool, device=i1.device), i1=i1, i2=i2, pair_id=pid,
        max_pen_all=max_pen_all,
        pair_active=torch.zeros((B, spec.n_unordered), dtype=torch.bool, device=i1.device),
    )


def _gather_bodies(x, idx):
    """x (B, nb, ...) at body indices idx (B, K) -> (B, K, ...)."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:]))


def _toc_recompute(spec: WorldSpec, bodies_b, forces, state: WorldState, new_v, q2, p2, contacts: Contacts, dt_,
                   toc_mask):
    """``world._toc_recompute`` of every lane in one ``toc_dt`` call."""
    B, nb = state.pos.shape[:2]
    af = apply_forces_lanes(bodies_b, forces, state.t).reshape(B, nb, 6)
    accel = af / body_lanes(bodies_b, "mass", B)[..., None]
    i1, i2 = contacts.i1, contacts.i2
    vs1, vs2 = _gather_bodies(new_v, i1), _gather_bodies(new_v, i2)
    d = dt_[:, None, None]
    rots1 = so3_exp_map(-d * vs1[..., :3]) @ quat_to_matrix(_gather_bodies(q2, i1))
    rots2 = so3_exp_map(-d * vs2[..., :3]) @ quat_to_matrix(_gather_bodies(q2, i2))
    rt1, rt2 = rots1.transpose(-1, -2), rots2.transpose(-1, -2)
    args = TocArgs(
        cs1=(rt1 @ contacts.p1[..., None])[..., 0], cs2=(rt2 @ contacts.p2[..., None])[..., 0],
        vs1=vs1, vs2=vs2, poss1=_gather_bodies(p2, i1) - d * vs1[..., 3:], poss2=_gather_bodies(p2, i2) - d * vs2[..., 3:],
        rots1=rots1, rots2=rots2, ns2=(rt2 @ contacts.normal[..., None])[..., 0],
        as1=_gather_bodies(accel, i1), as2=_gather_bodies(accel, i2),
    )
    dt_toc = toc_dt(dt_, args, toc_mask)
    q2t, p2t = _integrate(state.quat, state.pos, new_v, dt_toc[:, None, None])
    return q2t, p2t, dt_toc


def finish_step_batched(spec: WorldSpec, bodies_b, state_b: WorldState, dt_frame_b, k_b, ok_b, cache_b,
                        forces_b=None, any_contact: bool | None = None):
    """Differentiable substep tail of the whole batch (``world.finish_step``
    per lane): the replay at each lane's rung, the contact recompute when any
    lane selected a contact (the others take the empty buffer), the TOC
    re-emission when taping and any lane gained a contact (lanes without one
    keep their values). ``any_contact``: the host's knowledge of whether any
    lane starts with a valid contact (read when not given)."""
    cfg = spec.cfg
    dtype = state_b.pos.dtype
    B, nb = state_b.pos.shape[:2]
    forces = _forces_arg(spec, forces_b)
    if any_contact is None:
        any_contact = spec.host_bool(torch.any(state_b.contacts.valid), "contact")
    cc, sol = cache_b
    dt_k = dt_frame_b * torch.pow(0.5, k_b.to(dtype))
    use_pair = state_b.had_toc if cfg.time_of_contact_diff else torch.zeros_like(state_b.had_toc)
    ld = state_b.last_dt
    dt_ = torch.where(use_pair, -ld + (ld.detach() + dt_k), dt_k)

    tape = _taping(spec, bodies_b, forces, state_b)
    spec.stages["replay_lcp"] += tape and any_contact
    if tape:
        new_v = replay_dynamics_lanes(bodies_b, spec.joints, forces, state_b, dt_, cfg, sol, any_contact)
    else:
        new_v = -sol[0][:, : 6 * nb]
    new_v = new_v.reshape(B, nb, 6)
    q2, p2 = _integrate(state_b.quat, state_b.pos, new_v, dt_[:, None, None])

    lane_valid = torch.zeros((B,), dtype=torch.bool, device=q2.device)
    for pc, gate in zip(cc.caches, cc.gates):
        lane_valid = lane_valid | (gate & torch.any(pc.sel_valid, dim=-1))
    empty = _empty_contacts(spec, B, dtype, cc.max_pen_all)
    any_valid = spec.host_bool(torch.any(lane_valid), "recompute")
    if any_valid:
        cts = find_contacts_lanes(bodies_b, q2, p2, spec.directed_pairs, spec.n_unordered, cfg, cc)
        contacts = _select_lanes(lane_valid, cts, empty)
    else:
        contacts = empty

    if cfg.time_of_contact_diff:
        toc_mask = contacts.valid & ~torch.gather(state_b.contacts.pair_active, 1, contacts.pair_id)
        had_toc = torch.any(toc_mask, dim=-1)
        if tape and any_valid and spec.host_bool(torch.any(had_toc), "toc"):
            q2t, p2t, dt_toc = _toc_recompute(spec, bodies_b, forces, state_b, new_v, q2, p2, contacts, dt_,
                                              toc_mask)
            q2, p2 = _lane_select(had_toc, q2t, q2), _lane_select(had_toc, p2t, p2)
            last_dt = torch.where(had_toc, dt_toc, state_b.last_dt)
        else:
            last_dt = torch.where(had_toc, dt_, state_b.last_dt)
    else:
        last_dt = state_b.last_dt
        had_toc = torch.zeros_like(state_b.had_toc)

    new_state = WorldState(quat=q2, pos=p2, v=new_v, t=state_b.t + dt_k.detach(), contacts=contacts,
                           last_dt=last_dt, had_toc=had_toc)
    rec = StepRecord(t=state_b.t, quat=q2, pos=p2, v=new_v, valid=torch.ones_like(ok_b), bisect_failed=~ok_b,
                     n_halvings=k_b)
    return new_state, rec


def step_dt_batched(spec: WorldSpec, bodies_b, state_b: WorldState, dt_frame_b, forces_b=None):
    """One substep of the whole batch (``world.step_dt`` per lane)."""
    k, ok, cc, sol, any_contact = _probe_batched(spec, bodies_b, state_b, dt_frame_b, forces_b=forces_b)
    return finish_step_batched(spec, bodies_b, state_b, dt_frame_b, k, ok, (cc, sol), forces_b=forces_b,
                               any_contact=any_contact)


def _skip_record(st: WorldState) -> StepRecord:
    false = torch.zeros_like(st.had_toc)
    return StepRecord(t=st.t, quat=st.quat, pos=st.pos, v=st.v, valid=false, bisect_failed=false,
                      n_halvings=torch.zeros_like(st.t, dtype=torch.long))


def step_frame_batched(spec: WorldSpec, bodies_b, state_b: WorldState, forces_b=None):
    """One fixed-dt frame of the whole batch: substep while any lane has
    frame time to cover (at most ``max_substeps``), the lanes already done
    selected back. Returns (state, had_contacts (B,), recs (one StepRecord
    (B, ...) per substep slot), truncated (B,))."""
    cfg = spec.cfg
    end_t = state_b.t + cfg.dt
    floor = cfg.dt * 1e-6
    had = torch.zeros_like(state_b.had_toc)
    recs = []
    st = state_b
    for _ in range(cfg.max_substeps):
        remaining = end_t - st.t
        active = remaining > floor
        if not spec.host_bool(torch.any(active), "substep"):
            break
        spec.stages["substep"] += 1
        new_st, rec = step_dt_batched(spec, bodies_b, st, torch.clamp(remaining, min=floor), forces_b=forces_b)
        rec = _select_lanes(active, rec, _skip_record(st))
        recs.append(rec._replace(valid=rec.valid & active))
        st = _select_lanes(active, new_st, st)
        had = had | (active & torch.any(st.contacts.valid, dim=-1))
    recs += [_skip_record(st)] * (cfg.max_substeps - len(recs))
    truncated = (end_t - st.t) > floor
    return st, had, recs, truncated


def trajectory_lanes_first(traj: Trajectory) -> Trajectory:
    """A ``rollout_batched`` Trajectory ((T, S, B, ...) leaves, truncated
    (T, B)) with the lanes first: (B, T, S, ...), truncated (B, T)."""
    return Trajectory(*(x.movedim(1 if name == "truncated" else 2, 0) for name, x in traj._asdict().items()))


def rollout_batched(spec: WorldSpec, bodies_b, state_b: WorldState, n_frames: int, detach_2nd_bounce: bool = False,
                    forces_b=None):
    """Run ``n_frames`` frames of the whole batch. Trajectory leaves are (T,
    S, B, ...), truncated (T, B). It tapes as ``world.rollout`` does.

    ``detach_2nd_bounce`` truncates each lane's gradient as ``world.rollout``
    does: a lane whose frame is its second contacting frame since its last
    truncation re-runs the frame from its detached start state; the re-run
    goes for the whole batch, when any lane needs it, and the other lanes
    keep their first run."""
    B = state_b.pos.shape[0]
    st = state_b
    n_contact = torch.zeros((B,), dtype=torch.long, device=st.pos.device)
    frames, truncs = [], []
    for _ in range(n_frames):
        pre = st
        st, had, recs, truncated = step_frame_batched(spec, bodies_b, st, forces_b=forces_b)
        if detach_2nd_bounce:
            n2 = n_contact + had.long()
            trigger = had & (n2 > 1)
            if spec.host_bool(torch.any(trigger), "redo"):
                base = _select_lanes(trigger, _detached(pre), pre)
                st3, _, recs3, trunc3 = step_frame_batched(spec, bodies_b, base, forces_b=forces_b)
                st = _select_lanes(trigger, st3, st)
                recs = [_select_lanes(trigger, r3, r) for r3, r in zip(recs3, recs)]
                truncated = torch.where(trigger, trunc3, truncated)
            n_contact = torch.where(trigger, torch.ones_like(n2), n2)
        frames.append(StepRecord(*(torch.stack(f) for f in zip(*recs))))
        truncs.append(truncated)
    return st, _stack_frames(frames, truncs)

