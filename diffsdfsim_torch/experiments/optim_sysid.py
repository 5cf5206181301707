"""System identification: recover mass, push force, or friction coefficient.

PyTorch counterpart of ``diffsdfsim_tpu/experiments/optim_sysid.py``
(re-creation of the reference's ``experiments/system_identification/
optim_sysid.py``): a 1 m cube rests on a fixed floor and is pushed by a
constant horizontal force; the loss is the nearest-time trajectory MSE of
the cube against the trajectory at the target parameter. ``param`` picks
the optimized quantity (mass, force or friction, reference :86-101); the
others stay at their per-parameter values (``PARAM_SETUP``).
``strict_no_penetration=False`` and no TOC differential, as in the
reference. The optimizer is Adam by optax's rule (``fitting.Adam``), then a
clip to the range.

``n_par > 1`` runs a seed sweep. ``sweep="batched"`` (the default) steps
the n_par worlds as the lanes of one batched-native rollout
(``physics/batched.py``) and one Adam step updates every lane's parameter
(Adam is elementwise, so this is n_par independent fits). Where the
parameter sits in the world sets the lanes: ``mass`` makes the cube a lane
body; ``friction`` makes the floor and the cube lane bodies, each with a
per-lane ``fric_coeff`` on the tape; ``force`` keeps both bodies shared and
the push magnitude per lane (``Push.mag`` in ``forces_b``).
``sweep="vmap"`` runs each seed through the single path in turn, the
meaning of the JAX package's ``jax.vmap(run_one)``.

Draws come from a ``torch.Generator`` seeded with ``seed``
(``fitting.uniform_draws``); ``fit`` and ``fit_batched`` take them
explicitly, so a caller can hand them the JAX package's draws.

Run: python -m diffsdfsim_torch.experiments.optim_sysid with param=friction n_par=16
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..physics import (
    BoxShape,
    ExternalForce3D,
    Gravity3D,
    TotalConstraint3D,
    make_body,
    make_world,
    make_world_batched,
    rollout,
    rollout_batched,
    trajectory_lanes_first,
)
from ..physics.forces import RIGHT, _col
from .common import Run, parse_cli
from .fitting import Adam, descend, lane_losses, uniform_draws
from .losses import trajectory_loss

DEFAULTS = dict(
    seed=0,
    param="mass",  # mass | force | friction
    run_time=1.0,
    max_iter=100,
    lr=1e-1,
    min_val=0.0,  # 0 -> per-param default range (see PARAM_SETUP)
    max_val=0.0,
    mesh_subdiv=2,
    n_par=1,
    # n_par > 1: "batched" = the batched-native rollout, the push magnitude
    # per lane in forces_b; "vmap" = each seed through the single path
    sweep="batched",
    base_dir="outputs",
)

# The pushed body must actually slide: push force > stiction mu*m*g for the
# whole parameter range, or trajectories are identical and the loss has no
# signal. Per-parameter (range, fixed mass, fixed force, fixed friction):
PARAM_SETUP = {
    "friction": dict(range=(0.15, 0.55), force=6.0, mass=1.0, fric=None),
    "mass": dict(range=(0.2, 1.4), force=8.0, mass=None, fric=0.5),
    "force": dict(range=(4.0, 8.0), force=None, mass=1.0, fric=0.3),
}


def build_cfg(c, dtype=None) -> SimConfig:
    f32 = (dtype or default_dtype()) == torch.float32
    return SimConfig(
        fric_dirs=8,
        max_contacts_per_pair=4,
        max_contacts_total=4,
        mesh_subdiv=c["mesh_subdiv"],
        max_substeps=4,
        max_bisect=6,
        tol=1e-5 if f32 else 1e-8,
        strict_no_penetration=False,
        time_of_contact_diff=False,
        stop_contact_grad=False,
    )


def param_range(c):
    """(lo, hi) of the optimized parameter: min_val / max_val, or the
    parameter's default range when both are 0."""
    lo, hi = c["min_val"], c["max_val"]
    if lo == 0.0 and hi == 0.0:
        lo, hi = PARAM_SETUP[c["param"]]["range"]
    return lo, hi


class Push(ExternalForce3D):
    """A constant push of magnitude ``mag`` along +x; ``mag`` is an
    attribute, so it may require grad or carry a lane axis (``forces_b``)."""

    def __init__(self, mag):
        self.mag = mag

    def force(self, t, body):
        return RIGHT(self.mag) * _col(self.mag)


def build_world(theta, c, cfg, device=None):
    """The pushed cube on the floor with ``theta`` as the optimized quantity
    (a tensor; the others at PARAM_SETUP's values). Returns (spec, state),
    the single-world constructor of both sweep backends."""
    device = resolve_device(device)
    dtype = theta.dtype
    setup = PARAM_SETUP[c["param"]]
    mass = theta if c["param"] == "mass" else setup["mass"]
    force_mag = theta if c["param"] == "force" else torch.tensor(setup["force"], dtype=dtype, device=device)
    fric = theta if c["param"] == "friction" else setup["fric"]
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), fric_coeff=fric, subdiv=3, device=device,
                      dtype=dtype)
    cube = make_body(BoxShape(torch.tensor([1.0, 1.0, 1.0])), mass=mass, fric_coeff=fric, subdiv=2, device=device,
                     dtype=dtype)
    return make_world(
        [floor, cube], [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 0.5, 0.0]], np.zeros((2, 6)),
        joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0), Push(force_mag))), cfg=cfg,
        device=device,
    )


def n_frames(c, cfg) -> int:
    return int(round(c["run_time"] / cfg.dt))


def simulate(theta, c, cfg, device=None):
    """One world's rollout: (final state, Trajectory)."""
    spec, state = build_world(theta, c, cfg, device)
    return rollout(spec, state, n_frames(c, cfg))


def simulate_batched(theta_b, c, cfg, device=None):
    """The batched-native rollout over a (B,) parameter vector: the bodies
    and the push carry the lane axis where the parameter puts it. Returns
    (final, lanes-first Trajectory)."""
    spec, bodies_b, forces_b, state_b = make_world_batched(
        lambda th: build_world(th, c, cfg, device), theta_b, return_forces=True)
    final, traj = rollout_batched(spec, bodies_b, state_b, n_frames(c, cfg), forces_b=forces_b)
    return final, trajectory_lanes_first(traj)


def _result(target, start, out):
    final, loss_hist, theta_hist, grad_hist = out
    return dict(start_theta=start, final_theta=final, target_theta=target, loss_hist=loss_hist,
                theta_hist=theta_hist, grad_hist=grad_hist)


def fit(target, start, c, cfg, device=None, max_iter=None):
    """One fit on the single path: Adam on ``trajectory_loss(body=1)`` from
    ``start`` toward the trajectory at ``target`` (scalar tensors), each
    step clipped to the range. Returns ``run_one``'s histories plus each
    step's gradient."""
    max_iter = c["max_iter"] if max_iter is None else max_iter
    with torch.no_grad():
        _, tgt = simulate(target, c, cfg, device)

    def value_and_grad(th):
        th = th.clone().requires_grad_(True)
        loss = trajectory_loss(simulate(th, c, cfg, device)[1], tgt, body=1)
        return loss.detach(), torch.autograd.grad(loss, th)[0]

    return _result(target, start, descend(value_and_grad, start, Adam(c["lr"]), max_iter, clip=param_range(c)))


def fit_batched(targets, starts, c, cfg, device=None, max_iter=None):
    """``fit`` of B lanes ((B,) draws) through the batched-native rollout:
    one taped rollout of the batch and one backward of the lanes' summed
    loss per step. Histories are (max_iter, B)."""
    max_iter = c["max_iter"] if max_iter is None else max_iter
    with torch.no_grad():
        _, tgt = simulate_batched(targets, c, cfg, device)

    def value_and_grad(th):
        th = th.clone().requires_grad_(True)
        losses = lane_losses(simulate_batched(th, c, cfg, device)[1], tgt, body=1)
        return losses.detach(), torch.autograd.grad(losses.sum(), th)[0]

    return _result(targets, starts, descend(value_and_grad, starts, Adam(c["lr"]), max_iter, clip=param_range(c)))


def draws(c, device=None, dtype=None):
    """(targets, starts), (max(n_par, 1),) each, on ``device``."""
    lo, hi = param_range(c)
    return tuple(x.to(resolve_device(device)) for x in uniform_draws(c["seed"], max(c["n_par"], 1), lo, hi,
                                                                     dtype or default_dtype()))


def run_one(c, cfg, device=None):
    """The single fit of ``seed``'s draws."""
    targets, starts = draws(c, device)
    return fit(targets[0], starts[0], c, cfg, device)


def run_sweep_batched(c, cfg, device=None):
    """The n_par seeds as one batched-native sweep."""
    return fit_batched(*draws(c, device), c, cfg, device)


def run_sweep_vmap(c, cfg, device=None):
    """Each of the n_par seeds through the single path; histories lanes
    first (B, max_iter), as the JAX package's ``jax.vmap(run_one)``."""
    targets, starts = draws(c, device)
    outs = [fit(t, s, c, cfg, device) for t, s in zip(targets, starts)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def main(argv=None, device=None):
    c = parse_cli(DEFAULTS, argv)
    if c["param"] not in PARAM_SETUP:
        raise SystemExit(f"param={c['param']!r}: one of {sorted(PARAM_SETUP)}")
    if c["sweep"] not in ("batched", "vmap"):
        raise SystemExit(f"sweep={c['sweep']!r}: batched or vmap")
    device = resolve_device(device)
    cfg = build_cfg(c)
    run = Run(f"sysid_{c['param']}", c, base_dir=c["base_dir"])
    if c["n_par"] > 1 and c["sweep"] == "batched":
        out = run_sweep_batched(c, cfg, device)
    elif c["n_par"] > 1:
        out = run_sweep_vmap(c, cfg, device)
    else:
        out = run_one(c, cfg, device)
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    steps_first = out["loss_hist"] if c["sweep"] == "batched" or c["n_par"] <= 1 else out["loss_hist"].T
    for i, v in enumerate(steps_first.reshape(c["max_iter"], -1).mean(axis=-1)):
        run.log_scalar("loss", float(v), i)
    run.save_output(out)
    run.finish()
    print("theta error:", abs(out["final_theta"] - out["target_theta"]))
    return out


if __name__ == "__main__":
    main()
