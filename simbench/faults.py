"""Faults planted under the timed path, to show that the output check
catches them (``simbench/tests`` on the CPU, ``calibrate.py`` on the card).

- ``frozen``: a step that returns its state unchanged: a rollout's frame
  step hands back the state it was given; a fit's optimizer step leaves
  the parameters where they were;
- ``half_batch``: half of the batch left out: the second half of the
  lanes' trajectories replaced by the mean over the first half;
- ``altered``: an answer altered where it is produced: every lane's
  positions moved by ``ALTER_M`` from the middle frame on (in a fit, those
  of the taped rollout, whose losses are the answers);
- ``half_backward`` (a fit): half of the batch left out of the backward
  alone: the losses of the second half of the lanes are detached, so their
  gradient is 0 and their parameters stay, while every loss is as it was.

(One chip holds every cell, so there is no exchange between chips to
leave out.)
"""

from __future__ import annotations

import contextlib

import torch

from . import tracing

FAULTS = {"rollout": ("frozen", "half_batch", "altered"), "fit": ("frozen", "half_batch", "altered", "half_backward")}
ALTER_M = 1e-4


def _half_batch(traj):
    B = traj.pos.shape[0]
    h = B // 2
    out = {}
    for name, x in traj._asdict().items():
        rest = x[:h].mean(0, keepdim=True) if x.is_floating_point() else x[:1]
        out[name] = torch.cat([x[:h], rest.expand((B - h,) + x.shape[1:])])
    return type(traj)(**out)


def _half_backward(losses):
    h = losses.shape[0] // 2
    return torch.cat([losses[:h], losses[h:].detach()])


def _altered(traj):
    pos = traj.pos.clone()
    pos[:, pos.shape[1] // 2:] += ALTER_M
    return traj._replace(pos=pos)


@contextlib.contextmanager
def planted(fault: str, unit_kind: str, adapter):
    """Plant ``fault`` for a cell whose unit is ``unit_kind``; ``adapter``
    is the port's side of its experiment (``simbench.experiments.*``)."""
    from diffsdfsim_torch.experiments import fitting
    from diffsdfsim_torch.physics import batched

    if fault == "frozen" and unit_kind == "fit":
        patches = [(fitting.SGD, "update", lambda self, grad, state: (torch.zeros_like(grad), state))]
    elif fault == "frozen":
        orig = batched.step_frame_batched

        def frozen(spec, bodies_b, state_b, forces_b=None):
            _, had, recs, truncated = orig(spec, bodies_b, state_b, forces_b=forces_b)
            return state_b, had, recs, truncated

        patches = [(batched, "step_frame_batched", frozen)]
    elif fault == "half_batch":
        orig = adapter.trajectory_lanes_first
        patches = [(adapter, "trajectory_lanes_first", lambda traj: _half_batch(orig(traj)))]
    elif fault == "altered":
        orig = adapter.trajectory_lanes_first
        taped_only = unit_kind == "fit"

        def altered(traj):
            out = orig(traj)
            return _altered(out) if torch.is_grad_enabled() or not taped_only else out

        patches = [(adapter, "trajectory_lanes_first", altered)]
    elif fault == "half_backward" and unit_kind == "fit":
        orig = fitting.lane_losses
        patches = [(fitting, "lane_losses", lambda *a, **k: _half_backward(orig(*a, **k)))]
    else:
        raise ValueError(f"fault {fault!r}: one of {FAULTS[unit_kind]}")
    with tracing.patched(patches):
        yield
