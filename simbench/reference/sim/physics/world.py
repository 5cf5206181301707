"""World: state, static description, construction and frame records.

The single world of the port's plain path (reference
``lcp_physics/physics/world.py:39-379``), which a seed sweep
(``physics/batched.py``) builds per lane and steps on a lane axis:

- ``WorldState`` holds pose, velocity, the padded contact buffer and the
  TOC pairing carry (``last_dt``, ``had_toc``);
- ``WorldSpec`` the bodies, joints, forces, config and the directed
  contact pairs, and counts the host's reads of the device
  (``host_bool``);
- ``StepRecord`` and ``Trajectory`` the records of substeps and frames.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Sequence

import torch

from ..config import SimConfig, resolve_device
from ..utils.quaternion import integrate_quat
from .bodies import BodyDef
from .contacts import Contacts, DirectedPair, find_contacts


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


class StepRecord(NamedTuple):
    t: torch.Tensor
    quat: torch.Tensor
    pos: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    bisect_failed: torch.Tensor  # accepted a penetrating state at the bisection floor
    n_halvings: torch.Tensor  # dt halvings of the accepted rung


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
