"""World: state, substep machinery, frames, the rollout and its gradient.

PyTorch counterpart of the single-rollout path of
``diffsdfsim_tpu/physics/world.py`` (reference
``lcp_physics/physics/world.py:39-379``):

- ``WorldState`` holds pose, velocity, the padded contact buffer and the
  TOC pairing carry (``last_dt``, ``had_toc``);
- a substep (``step_dt``) probes a staged dt-bisection ladder without
  gradients, on the detached state: rungs 0..ladder_stage1 first (one
  batched PDIPM solve, one FW search per directed pair), the deep rungs
  only when none of those pass, then accepts the smallest passing rung
  (reference world.py:344-356). A speculative step is never differentiated
  (its backward at deeply penetrating trial states would produce inf/NaN);
- ``finish_step`` replays the accepted rung differentiably: the solve
  re-emits the probe's cached solution (its backward is the KKT solve), one
  integrate, the contact recompute at the cached candidates, then the TOC
  re-emission when a contact is new. The replay and the TOC block run
  only when there is a tape to record: grad mode is on and a parameter
  of the world or the state requires grad. Otherwise the replay only
  re-emits the cached values;
- a fixed-dt frame runs substeps until it covers dt (at most
  ``max_substeps``); a rollout runs frames.

Control flow on data (the JAX package's ``lax.cond`` predicates) reads the
device here; ``WorldSpec.host_syncs`` counts those reads.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Sequence

import torch

from ..config import SimConfig, resolve_device
from ..ops.toc import TocArgs, toc_dt
from ..utils.quaternion import integrate_quat, quat_to_matrix, so3_exp_map
from .bodies import BodyDef
from .contacts import (
    Contacts,
    DirectedPair,
    find_contacts,
    finish_contacts,
    search_contacts_raw,
)
from .engine import _Emit, apply_forces, post_stabilization, probe_dynamics_batch, solve_dynamics


class WorldState(NamedTuple):
    quat: torch.Tensor  # (B,4) wxyz
    pos: torch.Tensor  # (B,3)
    v: torch.Tensor  # (B,6) [omega, vel]
    t: torch.Tensor  # ()
    contacts: Contacts
    last_dt: torch.Tensor  # ()
    had_toc: torch.Tensor  # () bool


class WorldSpec:
    """Static world description: bodies, joints, forces, config and the
    directed contact pairs."""

    def __init__(self, bodies: Sequence[BodyDef], joints: Sequence = (), forces: Sequence[Sequence] = (),
                 no_contact: Sequence[tuple] = (), cfg: SimConfig = SimConfig()):
        self.bodies = tuple(bodies)
        self.joints = tuple(joints)
        if not forces:
            forces = tuple(() for _ in bodies)
        self.forces = tuple(tuple(f) for f in forces)
        self.cfg = cfg
        # reads of device values that steer control flow (see module
        # docstring), and those of a seed sweep by decision kind
        self.host_syncs = 0
        self.host_reads = collections.Counter()
        # a seed sweep's substeps and probe stages (physics/batched.py)
        self.stages = collections.Counter()
        # whether a parameter is on the tape: a body's tensors, or a tensor
        # attribute of a joint or force
        self.params_require_grad = any(_requires_grad(bd.tensors().values()) for bd in self.bodies) or any(
            _requires_grad(vars(o).values()) for o in (*self.joints, *(f for fs in self.forces for f in fs))
        )

        nc = {tuple(sorted(p)) for p in no_contact}
        pairs, directed = [], []
        for i in range(len(bodies)):
            for j in range(i + 1, len(bodies)):
                if (i, j) in nc:
                    continue
                si, sj = bodies[i].is_sdf, bodies[j].is_sdf
                if not (si or sj):
                    continue  # the reference asserts at least one SDF body
                pid = len(pairs)
                pairs.append((i, j))
                if si and sj:
                    directed.append(DirectedPair(i, j, pid, gated=False, overlap_test=True))
                    directed.append(DirectedPair(j, i, pid, gated=True, overlap_test=True))
                elif sj:
                    directed.append(DirectedPair(i, j, pid, gated=False, overlap_test=False))
                else:
                    directed.append(DirectedPair(j, i, pid, gated=False, overlap_test=False))
        self.pairs = tuple(pairs)
        self.directed_pairs = tuple(directed)
        self.n_unordered = max(len(pairs), 1)

        # body-index columns of an all-invalid contact buffer (the stable
        # valid-first compaction of all-invalid slots is the identity order)
        device = bodies[0].verts.device
        K, kt = cfg.max_contacts_per_pair, cfg.max_contacts_total
        cols = [[dp.b1, dp.b2, dp.pair_id] for dp in self.directed_pairs for _ in range(K)][:kt]
        cols = cols or [[0, 0, 0]] * kt
        self._empty_cols = torch.tensor(cols, dtype=torch.long, device=device).T

    def host_bool(self, x: torch.Tensor, kind: str | None = None) -> bool:
        """Read a device flag on the host, counting the sync (and its
        decision ``kind``, where named)."""
        self.host_syncs += 1
        if kind is not None:
            self.host_reads[kind] += 1
        return bool(x)


def _requires_grad(tensors) -> bool:
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _taping(spec: WorldSpec, state: WorldState) -> bool:
    """Whether a substep records its tape: grad mode is on and a parameter
    (``WorldSpec.params_require_grad``) or the state requires grad (no
    device read)."""
    return torch.is_grad_enabled() and (
        spec.params_require_grad or _requires_grad((state.quat, state.pos, state.v, state.last_dt))
    )


def make_world(bodies: Sequence[BodyDef], poses, vels, joints: Sequence = (), forces: Sequence[Sequence] = (),
               no_contact: Sequence[tuple] = (), cfg: SimConfig = SimConfig(), device=None):
    """Build (spec, initial state). ``poses`` (B,7) [quat wxyz | pos] or
    (B,3) positions; ``vels`` (B,6) or (B,3) linear. ``device=None`` means
    CUDA; the bodies must live on the same device."""
    device = resolve_device(device)
    dtype = bodies[0].verts.dtype
    for bd in bodies:
        if bd.verts.device.type != device.type or bd.verts.dtype != dtype:
            raise ValueError(
                f"body on {bd.verts.device} ({bd.verts.dtype}); the world is on {device} ({dtype})"
            )
    spec = WorldSpec(bodies, joints, forces, no_contact, cfg)
    poses = torch.as_tensor(poses, dtype=dtype, device=device)
    if poses.shape[-1] == 3:
        quat = torch.zeros((poses.shape[0], 4), dtype=dtype, device=device)
        quat[:, 0] = 1.0
        pos = poses
    else:
        quat, pos = poses[:, :4], poses[:, 4:]
    vels = torch.as_tensor(vels, dtype=dtype, device=device)
    if vels.shape[-1] == 3:
        vels = torch.cat([torch.zeros_like(vels), vels], dim=-1)

    contacts = find_contacts(spec.bodies, quat, pos, spec.directed_pairs, spec.n_unordered, cfg)
    if cfg.strict_no_penetration and bool(contacts.max_pen_all > cfg.tol):
        # construction-time interpenetration check (reference world.py:98-100)
        raise ValueError(
            "strict_no_penetration: bodies interpenetrate at world construction "
            f"(max penetration {float(contacts.max_pen_all):.3e} > tol {cfg.tol:.1e})"
        )
    state = WorldState(
        quat=quat.contiguous(), pos=pos.contiguous(), v=vels,
        t=torch.zeros((), dtype=dtype, device=device), contacts=contacts,
        last_dt=torch.tensor(cfg.dt, dtype=dtype, device=device),
        had_toc=torch.zeros((), dtype=torch.bool, device=device),
    )
    return spec, state


def _integrate(quat, pos, v, dt):
    """Semi-implicit Euler pose update (reference Body3D.move,
    bodies.py:488-496). Leading axes broadcast (the ladder's rungs)."""
    return integrate_quat(quat, v[..., :3], dt), pos + v[..., 3:] * dt


def _accept_thresh(spec: WorldSpec, state: WorldState):
    """Step-acceptance penetration threshold: accept a step that does not
    worsen penetration beyond max(tol, start_pen), plus a one-tol slack that
    keeps the decision off its own noise floor (JAX world.py:199-228)."""
    start_pen = state.contacts.max_pen_all
    tol = torch.full_like(start_pen, spec.cfg.tol)
    base = torch.maximum(tol, torch.where(torch.isfinite(start_pen), start_pen, tol))
    return base + tol


def _probe_rungs(spec: WorldSpec, state: WorldState, dt_frame, thresh, lo: int, hi: int, any_contact: bool):
    """Probe ladder rungs lo..hi: solve dynamics for all D = hi-lo+1 trial
    dts in one batched PDIPM call, integrate, search contacts at all D trial
    poses, and select the smallest rung whose penetration passes.

    Returns (found, k, raw_k, sol_k): ``found`` (device bool) whether any
    rung passed; ``k`` the selected rung (hi when none passed); ``raw_k`` /
    ``sol_k`` the search and solution at rung k (leading axis 1)."""
    cfg = spec.cfg
    D = hi - lo + 1
    ar = torch.arange(lo, hi + 1, dtype=dt_frame.dtype, device=dt_frame.device)
    dts = dt_frame * torch.pow(0.5, ar)
    new_vs, sol = probe_dynamics_batch(
        spec.bodies, spec.joints, spec.forces, state, state.contacts, dts, cfg, any_contact=any_contact
    )
    q2, p2 = _integrate(state.quat[None], state.pos[None], new_vs.reshape(D, -1, 6), dts[:, None, None])
    raw = search_contacts_raw(spec.bodies, q2, p2, spec.directed_pairs, cfg)
    ok = raw.max_pen_all <= thresh  # (D,)
    found = torch.any(ok)
    idx = torch.where(found, torch.argmax(ok.to(torch.uint8)), torch.full_like(found, D - 1, dtype=torch.long))
    sol_k = tuple(x.index_select(0, idx.reshape(1)) for x in sol)
    return found, lo + idx, raw.at(idx), sol_k


@torch.no_grad()
def _probe_ladder(spec: WorldSpec, state: WorldState, dt_frame, thresh):
    """Staged bisection probe (JAX ``_probe_ladder_full``): rungs
    0..ladder_stage1 first, the deep rungs only when the shallow stage
    fails. Selected-rung semantics: the smallest passing rung, or the floor
    (max_bisect) when none pass. Gradient-free. Returns (k, found,
    ContactCache, sol_k, any_contact), the last the host's knowledge of
    whether the step starts with a valid contact."""
    cfg = spec.cfg
    mb = cfg.max_bisect
    s1 = min(cfg.ladder_stage1, mb) if cfg.ladder_stage1 >= 0 else mb
    any_contact = spec.host_bool(torch.any(state.contacts.valid))
    found, k, raw, sol_k = _probe_rungs(spec, state, dt_frame, thresh, 0, s1, any_contact)
    if s1 < mb and not spec.host_bool(found):
        found, k, raw, sol_k = _probe_rungs(spec, state, dt_frame, thresh, s1 + 1, mb, any_contact)
    return k, found, finish_contacts(raw, cfg), sol_k, any_contact


def _empty_contacts_value(spec: WorldSpec, dtype, max_pen_all) -> Contacts:
    """The all-invalid Contacts buffer (JAX world.py:278-306)."""
    i1, i2, pid = spec._empty_cols
    n = i1.shape[0]
    zero3 = torch.zeros((n, 3), dtype=dtype, device=i1.device)
    return Contacts(
        normal=zero3, p1=zero3, p2=zero3, pen=torch.full((n,), -1.0, dtype=dtype, device=i1.device),
        valid=torch.zeros((n,), dtype=torch.bool, device=i1.device), i1=i1, i2=i2, pair_id=pid,
        max_pen_all=max_pen_all,
        pair_active=torch.zeros((spec.n_unordered,), dtype=torch.bool, device=i1.device),
    )


def _contacts_value(spec: WorldSpec, q2, p2, cc) -> tuple[Contacts, bool]:
    """Contacts at the accepted pose: the (differentiable) recompute at the
    cached candidates when any directed pair selected a contact (JAX
    world.py:320-340). Also returns whether it did."""
    any_valid = torch.zeros((), dtype=torch.bool, device=q2.device)
    for pc, gate in zip(cc.caches, cc.gates):
        any_valid = any_valid | (gate & torch.any(pc.sel_valid))
    if spec.host_bool(any_valid):
        cts = find_contacts(spec.bodies, q2, p2, spec.directed_pairs, spec.n_unordered, spec.cfg, cache=cc)
        return cts, True
    return _empty_contacts_value(spec, q2.dtype, cc.max_pen_all), False


def _replay(spec: WorldSpec, state: WorldState, dt_, cache, any_contact: bool, tape: bool):
    """Differentiable step at dt_ reusing the probe's cache (JAX _replay,
    world.py:251-275): the solve re-emits the cached solution, one
    integrate, the contact recompute at the cached candidates. Values are
    the probe's: the step velocity is -x of the cached solution on both
    solve branches; without ``tape`` it is taken as it is."""
    cc, sol = cache
    nb = state.pos.shape[0]
    v_val = -sol[0][0, : 6 * nb].reshape(nb, 6)
    if tape:
        new_v = solve_dynamics(
            spec.bodies, spec.joints, spec.forces, state, state.contacts, dt_, spec.cfg,
            lcp_sol=sol, any_contact=any_contact,
        ).reshape(nb, 6)
        if not any_contact:
            # the exact solve recomputed here may round differently from the
            # probe's batched one
            new_v = _Emit.apply(new_v, v_val)
    else:
        new_v = v_val
    q2, p2 = _integrate(state.quat, state.pos, new_v, dt_)
    contacts, any_valid = _contacts_value(spec, q2, p2, cc)
    return new_v, q2, p2, contacts, any_valid


def _toc_recompute(spec: WorldSpec, state: WorldState, new_v, q2, p2, contacts: Contacts, dt_, toc_mask):
    """TOC re-emission (reference world.py:272-341; JAX world.py:808-838):
    reconstruct the step-start contact geometry, re-emit dt through
    ``toc_dt`` and replay the move with the gradient-carrying dt. Numerically
    an identity; only the tape changes."""
    af = apply_forces(spec.bodies, spec.forces, state.t).reshape(-1, 6)
    masses = torch.stack([b.mass for b in spec.bodies])
    accel = af / masses[:, None]
    i1, i2 = contacts.i1, contacts.i2
    vs1, vs2 = new_v[i1], new_v[i2]
    rots1 = so3_exp_map(-dt_ * vs1[:, :3]) @ quat_to_matrix(q2[i1])
    rots2 = so3_exp_map(-dt_ * vs2[:, :3]) @ quat_to_matrix(q2[i2])
    rt1, rt2 = rots1.transpose(-1, -2), rots2.transpose(-1, -2)
    args = TocArgs(
        cs1=(rt1 @ contacts.p1[..., None])[..., 0], cs2=(rt2 @ contacts.p2[..., None])[..., 0],
        vs1=vs1, vs2=vs2, poss1=p2[i1] - dt_ * vs1[:, 3:], poss2=p2[i2] - dt_ * vs2[:, 3:],
        rots1=rots1, rots2=rots2, ns2=(rt2 @ contacts.normal[..., None])[..., 0],
        as1=accel[i1], as2=accel[i2],
    )
    dt_toc = toc_dt(dt_, args, toc_mask)
    q2t, p2t = _integrate(state.quat, state.pos, new_v, dt_toc)
    return q2t, p2t, dt_toc


class StepRecord(NamedTuple):
    t: torch.Tensor
    quat: torch.Tensor
    pos: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    bisect_failed: torch.Tensor  # accepted a penetrating state at the bisection floor
    n_halvings: torch.Tensor  # dt halvings of the accepted rung


def finish_step(spec: WorldSpec, state: WorldState, dt_frame, k, ok_final, cache, any_contact: bool):
    """Differentiable tail of a substep once the probe selected rung ``k``
    (JAX ``finish_step``, world.py:841-960): replay, TOC re-emission,
    post-stabilization."""
    cfg = spec.cfg
    dtype = state.pos.dtype
    dt_k = dt_frame * torch.pow(0.5, k.to(dtype))
    # TOC pairing with the previous step (world.py:253-257): numerically an
    # identity whose gradient cancels the previous step's re-emitted dt; keep
    # the arithmetic exactly as written, its last bits decide the acceptance
    # of later steps
    use_pair = state.had_toc if cfg.time_of_contact_diff else torch.zeros_like(state.had_toc)
    ld = state.last_dt
    dt_ = torch.where(use_pair, -ld + (ld.detach() + dt_k), dt_k)

    tape = _taping(spec, state)
    new_v, q2, p2, contacts, any_valid = _replay(spec, state, dt_, cache, any_contact, tape)

    if cfg.time_of_contact_diff:
        # contacts new in this step: the pair had no valid contact at step
        # start (world.py:272-274). The re-emission only changes the tape,
        # so it runs when taping and only when the host sees a new contact
        toc_mask = contacts.valid & ~state.contacts.pair_active[contacts.pair_id]
        had_toc = torch.any(toc_mask)
        if tape and any_valid and spec.host_bool(had_toc):
            q2, p2, last_dt = _toc_recompute(spec, state, new_v, q2, p2, contacts, dt_, toc_mask)
        else:
            last_dt = torch.where(had_toc, dt_, state.last_dt)
    else:
        last_dt = state.last_dt
        had_toc = torch.zeros_like(state.had_toc)

    if cfg.post_stab:
        st = WorldState(q2, p2, new_v, state.t, contacts, last_dt, had_toc)
        dp = post_stabilization(spec.bodies, spec.joints, st, contacts, cfg).reshape(-1, 6) / 2.0
        q2, p2 = _integrate(q2, p2, dp, dt_k)
        contacts = find_contacts(spec.bodies, q2, p2, spec.directed_pairs, spec.n_unordered, cfg)

    new_state = WorldState(
        quat=q2, pos=p2, v=new_v, t=state.t + dt_k.detach(), contacts=contacts, last_dt=last_dt,
        had_toc=had_toc,
    )
    rec = StepRecord(
        t=state.t, quat=q2, pos=p2, v=new_v, valid=torch.ones_like(ok_final),
        bisect_failed=~ok_final, n_halvings=k,
    )
    return new_state, rec


def step_dt(spec: WorldSpec, state: WorldState, dt_frame):
    """One substep (reference step_dt, world.py:241-379): gradient-free
    probe ladder, then the differentiable replay of the accepted rung."""
    thresh = _accept_thresh(spec, state)
    k, ok_final, cc, sol_k, any_contact = _probe_ladder(spec, state, dt_frame, thresh)
    return finish_step(spec, state, dt_frame, k, ok_final, (cc, sol_k), any_contact)


def step_frame(spec: WorldSpec, state: WorldState):
    """One fixed-dt frame: substep until t reaches end_t (reference
    World.step(fixed_dt=True), world.py:119-139), at most cfg.max_substeps.

    Returns (state, had_contacts, recs (list of StepRecord, one per substep
    slot), truncated)."""
    cfg = spec.cfg
    end_t = state.t + cfg.dt
    floor = cfg.dt * 1e-6
    had_contacts = torch.zeros((), dtype=torch.bool, device=state.pos.device)
    recs = []
    for _ in range(cfg.max_substeps):
        remaining = end_t - state.t
        if not spec.host_bool(remaining > floor):
            break
        state, rec = step_dt(spec, state, torch.clamp(remaining, min=floor))
        recs.append(rec)
        had_contacts = had_contacts | torch.any(state.contacts.valid)
    # the remaining slots repeat the frame's end state, marked invalid
    false = torch.zeros((), dtype=torch.bool, device=state.pos.device)
    skip = StepRecord(
        t=state.t, quat=state.quat, pos=state.pos, v=state.v, valid=false, bisect_failed=false,
        n_halvings=torch.zeros((), dtype=torch.long, device=state.pos.device),
    )
    recs += [skip] * (cfg.max_substeps - len(recs))
    truncated = (end_t - state.t) > floor
    return state, had_contacts, recs, truncated


class Trajectory(NamedTuple):
    """(T, S, ...) stacked per-substep records with validity mask."""

    t: torch.Tensor
    quat: torch.Tensor
    pos: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    bisect_failed: torch.Tensor  # (T, S) accepted a penetrating state at the floor
    truncated: torch.Tensor  # (T,) frame exhausted max_substeps before covering dt
    n_halvings: torch.Tensor  # (T, S) dt halvings per substep


def _detached(state: WorldState) -> WorldState:
    """The state cut off the autograd tape (pose, velocity, contacts, TOC carry)."""
    c = state.contacts
    return WorldState(
        quat=state.quat.detach(), pos=state.pos.detach(), v=state.v.detach(), t=state.t,
        contacts=Contacts(**{f: getattr(c, f).detach() for f in c.__dataclass_fields__}),
        last_dt=state.last_dt.detach(), had_toc=state.had_toc,
    )


def _stack_frames(frames, truncs) -> Trajectory:
    stacked = StepRecord(*(torch.stack(f) for f in zip(*frames)))
    return Trajectory(
        t=stacked.t, quat=stacked.quat, pos=stacked.pos, v=stacked.v, valid=stacked.valid,
        bisect_failed=stacked.bisect_failed, truncated=torch.stack(truncs), n_halvings=stacked.n_halvings,
    )


def rollout(spec: WorldSpec, state: WorldState, n_frames: int,
            detach_2nd_bounce: bool = False) -> tuple[WorldState, Trajectory]:
    """Run ``n_frames`` fixed-dt frames (reference run_world_fixed_dt,
    optim_sphere.py:163-177). It records its tape when grad mode is on and
    a body parameter, a tensor attribute of a joint or force, or ``state``
    requires grad; otherwise it runs the forward only, as under
    ``torch.no_grad()`` (a tensor that only a force's ``force_func`` closes
    over is not seen: give it to the force as an attribute).

    ``detach_2nd_bounce`` truncates the gradient as the reference does: at
    the second contacting frame since the last truncation, the frame is run
    again from its detached start state (numerically the same frame; only
    the tape is cut) and the count restarts at 1 (JAX world.py:1058-1098)."""
    frames, truncs = [], []
    n_contact = 0
    for _ in range(n_frames):
        pre = state
        state, had_contacts, recs, truncated = step_frame(spec, state)
        if detach_2nd_bounce:
            n_contact += spec.host_bool(had_contacts)
            if n_contact > 1:
                state, _, recs, truncated = step_frame(spec, _detached(pre))
                n_contact = 1
        frames.append(StepRecord(*(torch.stack(f) for f in zip(*recs))))
        truncs.append(truncated)
    return state, _stack_frames(frames, truncs)


def run_world(spec: WorldSpec, state: WorldState, run_time: float = 10.0, fixed_dt: bool = True,
              recorder=None, print_time: bool = False):
    """Host-loop runner (reference run_world, sdf_physics/physics3d/world.py:
    113-205; JAX world.py:1114-1160): step fixed-dt frames until ``state.t``
    reaches ``run_time``, handing each frame's end state to ``recorder``
    (``rendering.Recorder3D``) where one is given. Raises in strict mode when
    the dt-bisection hit its floor with penetration; warns on a frame that
    ran out of substeps. Returns (final state, Trajectory of the frames run,
    or None)."""
    import time

    frames, truncs = [], []
    t_start = time.time()
    while float(state.t) < run_time:
        state, _, recs, truncated = step_frame(spec, state)
        rec = StepRecord(*(torch.stack(f) for f in zip(*recs)))
        if spec.cfg.strict_no_penetration and bool(torch.any(rec.bisect_failed)):
            raise AssertionError(
                "strict_no_penetration: dt-bisection hit the floor "
                f"(dt/2^{spec.cfg.max_bisect}) with penetration at "
                f"t={float(state.t):.4f} (reference world.py:344-356 raises here)"
            )
        if bool(truncated):
            print(f"warning: frame at t={float(state.t):.4f} exhausted "
                  f"max_substeps={spec.cfg.max_substeps} before covering dt")
        frames.append(rec)
        truncs.append(truncated)
        if recorder is not None:
            recorder.record(float(state.t), spec.bodies, state.quat, state.pos)
        if print_time:
            print(f"\r {float(state.t):.3f} / {time.time() - t_start:.2f}s", end="")
    if print_time:
        print()
    return state, (_stack_frames(frames, truncs) if frames else None)
