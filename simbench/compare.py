"""The comparison that decides ``correct``.

A rollout's answer is each lane's trajectory; a fit iteration's is each
lane's loss, its gradient and its parameter after the update (and the
targets' trajectories it was fitted to). The numbers compared, per sampled
lane, the largest over the sample:

- ``decisions``: frames whose discrete decisions differ (the number of
  accepted substeps, the halvings of each, whether the bisection accepted a
  penetrating state, whether the frame ran out of substeps);
- ``nonfinite``: frames whose end state is not finite on either side;
- ``pos``, ``vel``: the largest gap of a body's position (m) and velocity
  (angular rad/s and linear m/s) at a frame's end, over the other frames;
- ``loss``, ``grad``: the gap of each lane's loss and of its gradient
  relative to the reference's value, the worst lane;
- ``param``: the gap of each lane's parameter after the update (m), the
  worst lane.

Each number has its limit in the cell's workload file.
"""

from __future__ import annotations

import collections
import math

import torch

DECISIONS = ("n_halvings", "bisect_failed")
FIELDS = ("t", "quat", "pos", "v", "valid", "bisect_failed", "truncated", "n_halvings")
Traj = collections.namedtuple("Traj", FIELDS)


def plain(traj) -> Traj:
    """A trajectory's fields (lanes first) as plain tensors, detached."""
    return Traj(*(getattr(traj, f).detach() for f in FIELDS))


def frame_ends(traj, lane: int):
    """(pos (T, nb, 3), quat (T, nb, 4), v (T, nb, 6)) at each frame's last
    accepted substep of a lanes-first trajectory's lane."""
    valid = traj.valid[lane]
    S = valid.shape[-1]
    last = (S - 1) - torch.argmax(torch.flip(valid.to(torch.int64), dims=[-1]), dim=-1)
    take = lambda x: x[lane][torch.arange(x.shape[1]), last]  # noqa: E731
    return take(traj.pos), take(traj.quat), take(traj.v)


def decision_frames(a, b, la: int, lb: int) -> int:
    """Frames of lane la of ``a`` and lane lb of ``b`` whose decisions differ."""
    va, vb = a.valid[la], b.valid[lb]
    diff = (va != vb).any(-1) | (a.truncated[la] != b.truncated[lb])
    for k in DECISIONS:
        diff = diff | ((getattr(a, k)[la] != getattr(b, k)[lb]) & (va | vb)).any(-1)
    return int(diff.sum())


def trajectory_gaps(prog, ref) -> dict:
    """The numbers of a rollout: each lane of the program's sampled
    trajectory against the same lane of the reference's. The gaps are taken
    over the frames where both are finite; ``nonfinite`` counts the others."""
    out = dict(decisions=0, nonfinite=0, pos=0.0, vel=0.0)
    for j in range(prog.pos.shape[0]):
        out["decisions"] = max(out["decisions"], decision_frames(prog, ref, j, j))
        pp, _, vp = frame_ends(prog, j)
        pr, _, vr = frame_ends(ref, j)
        ok = torch.stack([torch.isfinite(x).flatten(1).all(1) for x in (pp, vp, pr, vr)]).all(0)
        out["nonfinite"] = max(out["nonfinite"], int((~ok).sum()))
        out["pos"] = max(out["pos"], _max_abs((pp - pr)[ok]))
        out["vel"] = max(out["vel"], _max_abs((vp - vr)[ok]))
    return out


def _max_abs(x) -> float:
    if x.numel() == 0:
        return 0.0
    v = float(torch.max(torch.abs(x.to(torch.float64))))
    return v if math.isfinite(v) else math.inf


def relative(a, b):
    """|a - b| / |b| of each lane (|b| floored at 1e-300; NaN as inf)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return torch.nan_to_num((a - b).abs() / torch.clamp(b.abs(), min=1e-300), nan=math.inf)


def fit_lane_gaps(prog: dict, ref: dict) -> dict:
    """Each lane's relative gap of its loss and of its gradient, and the gap
    of its stepped parameter (m)."""
    return dict(loss=relative(prog["loss"], ref["loss"]), grad=relative(prog["grad"], ref["grad"]),
                param=torch.nan_to_num((prog["param"].to(torch.float64) - ref["param"]).abs(), nan=math.inf))


def fit_gaps(prog: dict, ref: dict, ties: dict | None = None) -> dict:
    """The numbers of a fit iteration, each by the worst lane of the sample:
    the loss; the gradient and the stepped parameter; the targets'
    decisions. ``ties`` maps the positions in the sample of lanes that the
    reference shows to sit at a contact tie (its own loss or gradient moves
    by more than the limit at a 1e-13 change of the start, on the card and
    on the CPU alike) to the reference's losses at those nearby starts: such
    a lane's loss gap is the smallest to any of the reference's readings,
    and its gradient and parameter are left out. The targets' poses are not
    compared: a touchdown tie moves a target lane by ~3e-5 m at a 1e-13
    change of its radius, and the loss, which each side takes against its
    own targets, holds them."""
    ties = ties or {}
    gaps = fit_lane_gaps(prog, ref)
    loss = gaps["loss"].clone()
    for i, near in ties.items():
        loss[i] = torch.min(torch.cat([loss[i:i + 1], relative(prog["loss"][i].expand(near.shape), near)]))
    held = [i for i in range(loss.shape[0]) if i not in ties]
    worst = lambda x: float(x[held].max()) if held else 0.0  # noqa: E731
    out = dict(loss=float(loss.max()), grad=worst(gaps["grad"]), param=worst(gaps["param"]))
    tgt = trajectory_gaps(prog["target"], ref["target"])
    out.update(target_decisions=tgt["decisions"], target_nonfinite=tgt["nonfinite"])
    return out


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or NaN, fails."""
    rows = [(k, numbers[k], limits.get(k)) for k in numbers]
    ok = all(lim is not None and v <= lim for k, v, lim in rows)
    return ok, rows
