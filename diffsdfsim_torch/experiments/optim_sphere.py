"""Trajectory fitting: recover a sphere's radius from an observed bounce.

PyTorch counterpart of ``diffsdfsim_tpu/experiments/optim_sphere.py``
(re-creation of the reference's ``experiments/trajectory_fitting/
optim_sphere.py``): a sphere is thrown at 5 m/s from (0, 5, 0) in a room
(a floor and a wall, each fixed by a ``TotalConstraint3D``), a target
trajectory is simulated at a random radius, and gradient descent on the
nearest-time trajectory MSE recovers the radius. The reference's ablations
are options (``use_toc_diff``, ``detach_2nd_bounce``, gravity, friction,
wall, floor, GD or Adam).

The loop keeps the reference's convergence freeze (``fitting.descend``):
a lane whose loss moved less than ``conv_thresh`` since its last step
keeps its radius and its optimizer state (SGD and Adam by optax's rule,
each lane with its own Adam count), and the loop ends when every lane is
done. Without the TOC differential the loss is a staircase whose noisy
gradients walk away from the optimum, so the ablations need the freeze.

``n_par > 1`` runs a seed sweep (the reference's 50 processes of
``generate_sphere.sh``): ``sweep_backend="bnative"`` (the default) steps
the seeds' worlds as the lanes of one batched-native rollout
(``physics/batched.py``), one taped rollout of the batch and one backward
of the lanes' summed loss per iteration; ``"vmap"`` runs each seed through
the single path in turn. ``sweep_mode`` (``"hostloop"`` or ``"scan"``) is
accepted and is a no-op: the port's loop is always on the host, as the JAX
package's ``hostloop``. ``backend``, ``replay`` and the ladder gates are
``SimConfig``'s own (``backend`` takes only ``"auto"``).

Draws come from a ``torch.Generator`` seeded with ``seed``
(``fitting.uniform_draws``); ``fit`` and ``fit_batched`` take them
explicitly, so a caller can hand them the JAX package's draws.

Run: python -m diffsdfsim_torch.experiments.optim_sphere with n_par=50
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..physics import (
    BoxShape,
    Gravity3D,
    SphereShape,
    TotalConstraint3D,
    make_body,
    make_world,
    make_world_batched,
    rollout,
    rollout_batched,
    trajectory_lanes_first,
)
from .common import Run, parse_cli
from .fitting import descend, lane_losses, make_optimizer, uniform_draws
from .losses import trajectory_loss

DEFAULTS = dict(
    seed=0,
    run_time=1.5,
    max_iter=100,
    lr=1e-1,
    conv_thresh=1e-5,
    optimizer="GD",
    min_dim=0.4,
    max_dim=2.0,
    use_toc_diff=True,
    detach_2nd_bounce=True,
    use_wall=True,
    use_floor=True,
    use_gravity=True,
    use_friction=True,
    n_par=1,
    sweep_mode="hostloop",  # hostloop | scan: a no-op here, the loop is on the host
    sweep_backend="bnative",  # bnative (one batched-native rollout) | vmap (each seed alone)
    mesh_subdiv=2,
    fric_dirs=8,
    # contact polish trips, staged-ladder stage-1 depth (-1 = unstaged),
    # replay mode (a no-op here)
    polish_iters=10,
    stage1=2,
    replay="auto",
    backend="auto",
    base_dir="outputs",
)


def build_cfg(c, dtype=None) -> SimConfig:
    f32 = (dtype or default_dtype()) == torch.float32
    return SimConfig(
        fric_dirs=c["fric_dirs"],
        max_contacts_per_pair=4,
        max_contacts_total=8,
        mesh_subdiv=c["mesh_subdiv"],
        # reference bounds: the substep loop is unbounded (world.py:129-133)
        # and the strict halving loop never gives up (world.py:345-349);
        # 6 substeps / 12 halvings cover the deepest observed impact frames
        max_substeps=6,
        max_bisect=12,
        tol=1e-5 if f32 else 1e-8,
        time_of_contact_diff=c["use_toc_diff"],
        ladder_fast_path=c.get("n_par", 1) <= 1,
        ladder_batch_gate=c.get("n_par", 1) > 1,
        contact_polish_iters=c.get("polish_iters", 10),
        ladder_stage1=c.get("stage1", 2),
        replay_mode=c.get("replay", "auto"),
        solver_backend=c.get("backend", "auto"),
    )


def _fric(c) -> float:
    return 0.25 if c["use_friction"] else 0.0


def room_bodies(c, device=None, dtype=None):
    """The fixed bodies of the room (reference optim_sphere.py:78-101): the
    20x1x20 floor and the 1x10x10 wall, as the config keeps them, each
    restitution 0.5. They do not depend on the radius, so a sweep builds
    them once for all its lanes."""
    device, dtype = resolve_device(device), dtype or default_dtype()
    out = []
    for use, dims in (("use_floor", [20.0, 1.0, 20.0]), ("use_wall", [1.0, 10.0, 10.0])):
        if c[use]:
            out.append(make_body(BoxShape(torch.tensor(dims)), restitution=0.5, fric_coeff=_fric(c), subdiv=3,
                                 device=device, dtype=dtype))
    return tuple(out)


def sphere_index(c) -> int:
    return int(c["use_floor"]) + int(c["use_wall"])


def build_world(rad, c, cfg, device=None, room=None):
    """The room and a sphere of radius ``rad`` (a tensor) at (0, 5, 0) with
    vx = 5 (reference optim_sphere.py:78-111). ``room``: the fixed bodies of
    ``room_bodies`` (built here when not given). Returns (spec, state,
    sphere index, sphere body)."""
    device = resolve_device(device)
    dtype = rad.dtype
    room = room_bodies(c, device, dtype) if room is None else room
    poses = ([[1.0, 0, 0, 0, 0.0, -0.5, 0.0]] if c["use_floor"] else []) + (
        [[1.0, 0, 0, 0, 5.0, 5.0, 0.0]] if c["use_wall"] else [])
    joints = [TotalConstraint3D(body1=i) for i in range(len(room))]
    forces = [()] * len(room)
    no_contact = [(0, 1)] if c["use_floor"] and c["use_wall"] else []
    sphere = make_body(SphereShape(rad), restitution=0.5, fric_coeff=_fric(c), subdiv=c["mesh_subdiv"], device=device,
                       dtype=dtype)
    idx = len(room)
    vels = np.zeros((idx + 1, 6))
    vels[idx, 3] = 5.0
    spec, state = make_world(
        [*room, sphere], poses + [[1.0, 0, 0, 0, 0.0, 5.0, 0.0]], vels, joints=joints,
        forces=forces + [(Gravity3D(10.0),) if c["use_gravity"] else ()], no_contact=no_contact, cfg=cfg,
        device=device,
    )
    return spec, state, idx, sphere


def n_frames(c, cfg) -> int:
    return int(round(c["run_time"] / cfg.dt))


def simulate(rad, c, cfg, device=None, room=None):
    """Build the world and roll out; returns (final state, trajectory,
    sphere index, sphere body)."""
    spec, state, idx, sphere = build_world(rad, c, cfg, device, room)
    final, traj = rollout(spec, state, n_frames(c, cfg), detach_2nd_bounce=c["detach_2nd_bounce"])
    return final, traj, idx, sphere


def make_loss(c, cfg, device=None):
    """(target_traj(target_rad), loss_fn(rad, target_traj)) on the single
    path. The target world runs without ``detach_2nd_bounce`` (the
    reference's run_world_fixed_dt default, optim_sphere.py:163/249; it
    changes the tape only)."""
    idx = sphere_index(c)
    room = room_bodies(c, device)

    def target_traj(target_rad):
        with torch.no_grad():
            return simulate(target_rad, dict(c, detach_2nd_bounce=False), cfg, device, room)[1]

    def loss_fn(rad, tgt):
        return trajectory_loss(simulate(rad, c, cfg, device, room)[1], tgt, body=idx)

    return target_traj, loss_fn


def make_loss_batched(c, cfg, device=None):
    """The batched-native counterpart of ``make_loss``: (target_trajs(rads)
    -> lanes-first Trajectory, losses(rads, target) -> (B,) per-lane
    losses), each one rollout of the whole batch."""
    idx = sphere_index(c)
    room = room_bodies(c, device)

    def run(rads, detach):
        spec, bodies_b, state_b = make_world_batched(lambda r: build_world(r, c, cfg, device, room)[:2], rads)
        return trajectory_lanes_first(rollout_batched(spec, bodies_b, state_b, n_frames(c, cfg),
                                                      detach_2nd_bounce=detach)[1])

    def target_trajs(target_rads):
        with torch.no_grad():
            return run(target_rads, False)

    def losses(rads, tgt):
        return lane_losses(run(rads, c["detach_2nd_bounce"]), tgt, body=idx)

    return target_trajs, losses


def _value_and_grad(loss_fn, tgt):
    def vg(rad):
        r = rad.clone().requires_grad_(True)
        loss = loss_fn(r, tgt)
        return loss.detach(), torch.autograd.grad(loss.sum(), r)[0]

    return vg


def _descend(vg, target, start, c, max_iter):
    final, loss_hist, rad_hist, grad_hist = descend(
        vg, start, make_optimizer(c["optimizer"], c["lr"]), c["max_iter"] if max_iter is None else max_iter,
        clip=(c["min_dim"], c["max_dim"]), conv_thresh=c["conv_thresh"])
    return dict(start_rad=start, final_rad=final, target_rad=target, loss_hist=loss_hist, rad_hist=rad_hist,
                grad_hist=grad_hist)


def fit(target_rad, start_rad, c, cfg, device=None, max_iter=None):
    """One seed on the single path (``run_one``): GD or Adam from
    ``start_rad`` toward the trajectory at ``target_rad`` (scalar tensors)
    with the convergence freeze. Returns ``run_one``'s histories plus each
    step's gradient."""
    target_traj, loss_fn = make_loss(c, cfg, device)
    return _descend(_value_and_grad(loss_fn, target_traj(target_rad)), target_rad, start_rad, c, max_iter)


def fit_batched(target_rads, start_rads, c, cfg, device=None, max_iter=None):
    """``run_sweep_hostloop``'s batched-native sweep of B lanes ((B,)
    draws): per iteration one taped rollout of the batch and one backward of
    the lanes' summed loss, then the per-lane update and freeze. Histories
    are (max_iter, B)."""
    target_trajs, losses = make_loss_batched(c, cfg, device)
    return _descend(_value_and_grad(losses, target_trajs(target_rads)), target_rads, start_rads, c, max_iter)


def draws(c, device=None, dtype=None):
    """(target radii, start radii), (max(n_par, 1),) each, on ``device``."""
    targets, starts = uniform_draws(c["seed"], max(c["n_par"], 1), c["min_dim"], c["max_dim"],
                                    dtype or default_dtype())
    device = resolve_device(device)
    return targets.to(device), starts.to(device)


def run_one(c, cfg, device=None):
    """The single fit of ``seed``'s draws."""
    targets, starts = draws(c, device)
    return fit(targets[0], starts[0], c, cfg, device)


def run_sweep_hostloop(c, cfg, device=None):
    """The n_par seeds: one batched-native sweep (``sweep_backend=bnative``)
    or each seed through the single path (``vmap``), histories (max_iter,
    B) either way."""
    targets, starts = draws(c, device)
    if c.get("sweep_backend", "bnative") == "bnative":
        return fit_batched(targets, starts, c, cfg, device)
    outs = [fit(t, s, c, cfg, device) for t, s in zip(targets, starts)]
    return {k: torch.stack([o[k] for o in outs], dim=-1) for k in outs[0]}


def main(argv=None, device=None):
    c = parse_cli(DEFAULTS, argv)
    if c["sweep_mode"] not in ("hostloop", "scan"):
        raise SystemExit(f"sweep_mode={c['sweep_mode']!r}: hostloop or scan")
    if c["sweep_backend"] not in ("bnative", "vmap"):
        raise SystemExit(f"sweep_backend={c['sweep_backend']!r}: bnative or vmap")
    device = resolve_device(device)
    cfg = build_cfg(c)
    run = Run("trajectory_fitting_sphere", c, base_dir=c["base_dir"])
    out = run_sweep_hostloop(c, cfg, device) if c["n_par"] > 1 else run_one(c, cfg, device)
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    err = abs(out["final_rad"] - out["target_rad"])
    for i, v in enumerate(out["loss_hist"].reshape(c["max_iter"], -1).mean(axis=-1)):
        run.log_scalar("loss", float(v), i)
    run.save_output(out)
    run.finish()
    print("radius error:", err)
    return out


if __name__ == "__main__":
    main()
