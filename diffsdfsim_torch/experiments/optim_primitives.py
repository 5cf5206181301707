"""Shape from inertia: recover a primitive's dimensions from its spin response.

PyTorch counterpart of ``diffsdfsim_tpu/experiments/optim_primitives.py``
(re-creation of the reference's ``experiments/inertia_fitting/
optim_primitives.py``): a body pinned in translation (X, Y and Z
constraints, reference :111-113) takes a unit torque for the first
``impulse_time`` seconds (:101-106); the loss is the final generalized
velocity error |v - v_target|^2 (:198). The optimized parameters are a box's
dims (3), a sphere's radius (1) or a cylinder's (radius, height); Adam by
optax's rule (``fitting.Adam``), each step clipped to [min_dim, max_dim].
The inertia is differentiable through the Mirtich integrals of the body's
mesh (``custom_inertia=False``, the default) or the analytic formulas;
``custom_mesh`` takes the analytic mesh (the JAX package's experiment does
not pass its ``custom_mesh`` to ``make_body``; this one does). The world
has no contact pair: every step is the joint solve
(``engine._eq_constrained_solve``) and launches no kernel.

``n_par > 1`` runs a seed sweep, the JAX package's ``jax.vmap(run_one)``,
as one batched-native rollout per Adam step (``physics/batched.py``): the
body is a lane body built by ``bodies.make_body_lanes``, the joints' rows
come from ``engine.joint_jacobian_lanes``, and each lane's torque axis
travels in ``forces_b``; Adam runs over the (B, n) parameters and the loss
is summed over the lanes (Adam is elementwise, so this equals B fits).

Draws (target, start, torque axis) come from a ``torch.Generator`` seeded
with ``seed``, lane after lane (lane 0 draws what the single run draws);
``fit`` and ``fit_batched`` take them explicitly, so a caller can hand them
the JAX package's draws.

Run: python -m diffsdfsim_torch.experiments.optim_primitives with shape=box n_par=50
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..physics import (
    BoxShape,
    CylinderShape,
    ExternalForce3D,
    SphereShape,
    XConstraint3D,
    YConstraint3D,
    ZConstraint3D,
    make_body,
    make_world,
    make_world_batched,
    rollout,
    rollout_batched,
)
from ..physics.bodies import make_body_lanes
from ..physics.forces import _col
from .common import Run, parse_cli
from .fitting import Adam, descend

DEFAULTS = dict(
    seed=0,
    shape="box",  # box | sphere | cylinder
    run_time=0.9,
    impulse_time=0.3,
    max_iter=100,
    lr=1e-2,
    min_dim=0.3,
    max_dim=1.2,
    custom_inertia=False,
    custom_mesh=False,
    mesh_subdiv=2,
    n_par=1,
    base_dir="outputs",
)


def build_cfg(c, dtype=None) -> SimConfig:
    f32 = (dtype or default_dtype()) == torch.float32
    return SimConfig(
        fric_dirs=4,
        max_contacts_per_pair=2,
        max_contacts_total=2,
        mesh_subdiv=c["mesh_subdiv"],
        max_substeps=2,
        max_bisect=4,
        tol=1e-5 if f32 else 1e-8,
        time_of_contact_diff=False,
    )


def _make_shape(name, params):
    if name == "box":
        return BoxShape(params)
    if name == "sphere":
        return SphereShape(params[0])
    if name == "cylinder":
        return CylinderShape(params[0], params[1])
    raise ValueError(name)


def n_params(name):
    return {"box": 3, "sphere": 1, "cylinder": 2}[name]


class TorqueImpulse(ExternalForce3D):
    """The torque ``axis`` while t < ``impulse_time``, zero after; the axis
    may require grad or carry a lane axis (``forces_b``)."""

    def __init__(self, axis, impulse_time: float):
        self.axis = axis
        self.impulse_time = impulse_time

    def force(self, t, body):
        torque = self.axis * _col((t < self.impulse_time).to(self.axis.dtype))
        return torch.cat([torque, torch.zeros_like(torque)], dim=-1)


def spin_world(body, axis, c, cfg, device=None):
    """One body at the origin, pinned in translation, spun by the torque
    ``axis`` for ``impulse_time``. Returns (spec, state)."""
    dtype = body.verts.dtype
    return make_world(
        [body], [[1.0, 0, 0, 0, 0.0, 0.0, 0.0]], np.zeros((1, 6)),
        joints=(XConstraint3D(body1=0), YConstraint3D(body1=0), ZConstraint3D(body1=0)),
        forces=((TorqueImpulse(torch.as_tensor(axis, dtype=dtype, device=body.verts.device), c["impulse_time"]),),),
        cfg=cfg, device=device,
    )


def n_frames(c, cfg) -> int:
    return int(round(c["run_time"] / cfg.dt))


def spin(body, axis, c, cfg, device=None):
    """The final state of ``body``'s spin."""
    spec, state = spin_world(body, axis, c, cfg, device)
    return rollout(spec, state, n_frames(c, cfg))[0]


def spin_batched(body_b, axes, c, cfg, device=None):
    """The final states (lane axis first) of a lane body's spins about
    ``axes`` (B, 3), as one batched-native rollout."""
    B = axes.shape[0]
    spec, bodies_b, forces_b, state_b = make_world_batched(
        lambda i, a: spin_world(body_b.lane(i), a, c, cfg, device), list(range(B)), axes, return_forces=True)
    return rollout_batched(spec, bodies_b, state_b, n_frames(c, cfg), forces_b=forces_b)[0]


def build_body(params, c, device=None):
    dtype = params.dtype
    return make_body(_make_shape(c["shape"], params), custom_inertia=c["custom_inertia"],
                     custom_mesh=c["custom_mesh"], subdiv=c["mesh_subdiv"], device=device, dtype=dtype)


def build_body_lanes(params_b, c, device=None):
    return make_body_lanes(lambda p: _make_shape(c["shape"], p), params_b, custom_inertia=c["custom_inertia"],
                           custom_mesh=c["custom_mesh"], subdiv=c["mesh_subdiv"], device=device,
                           dtype=params_b.dtype)


def simulate(params, torque_axis, c, cfg, device=None):
    """The final state of the spin of the shape with ``params``."""
    return spin(build_body(params, c, device), torque_axis, c, cfg, device)


def simulate_batched(params_b, axes, c, cfg, device=None):
    """The final states of B shapes (B, n) spun about their axes (B, 3)."""
    return spin_batched(build_body_lanes(params_b, c, device), axes, c, cfg, device)


def _result(target, start, axis, out):
    final, loss_hist, param_hist, grad_hist = out
    return dict(start_params=start, final_params=final, target_params=target, torque_axis=axis,
                loss_hist=loss_hist, param_hist=param_hist, grad_hist=grad_hist)


def fit(target, start, axis, c, cfg, device=None, max_iter=None):
    """Adam on |v - v_target|^2 from ``start`` toward the spin of
    ``target``, clipped to [min_dim, max_dim]. Returns ``run_one``'s
    histories plus each step's gradient."""
    max_iter = c["max_iter"] if max_iter is None else max_iter
    with torch.no_grad():
        target_v = simulate(target, axis, c, cfg, device).v

    def value_and_grad(p):
        p = p.clone().requires_grad_(True)
        loss = torch.sum((simulate(p, axis, c, cfg, device).v[0] - target_v[0]) ** 2)
        return loss.detach(), torch.autograd.grad(loss, p)[0]

    return _result(target, start, axis, descend(value_and_grad, start, Adam(c["lr"]), max_iter,
                                                clip=(c["min_dim"], c["max_dim"])))


def fit_batched(targets, starts, axes, c, cfg, device=None, max_iter=None):
    """``fit`` of B lanes (targets and starts (B, n), axes (B, 3)) through
    the batched-native rollout. Histories are lanes second."""
    max_iter = c["max_iter"] if max_iter is None else max_iter
    with torch.no_grad():
        target_v = simulate_batched(targets, axes, c, cfg, device).v

    def value_and_grad(p):
        p = p.clone().requires_grad_(True)
        losses = torch.sum((simulate_batched(p, axes, c, cfg, device).v[:, 0] - target_v[:, 0]) ** 2, dim=-1)
        return losses.detach(), torch.autograd.grad(losses.sum(), p)[0]

    return _result(targets, starts, axes, descend(value_and_grad, starts, Adam(c["lr"]), max_iter,
                                                  clip=(c["min_dim"], c["max_dim"])))


def draw_problem(c, generator: torch.Generator, dtype=None):
    """(target, start, unit torque axis) as ``run_one`` draws them: the
    parameters uniform in [min_dim, max_dim), the axis normal then
    normalized."""
    dtype = dtype or default_dtype()
    npar, lo, hi = n_params(c["shape"]), c["min_dim"], c["max_dim"]
    u = torch.rand((2, npar), generator=generator, dtype=torch.float64)
    axis = torch.randn((3,), generator=generator, dtype=torch.float64)
    x = (lo + (hi - lo) * u).to(dtype)
    return x[0], x[1], (axis / torch.linalg.norm(axis)).to(dtype)


def draws(c, device=None, dtype=None):
    """(targets, starts, axes) of the max(n_par, 1) lanes on ``device``, lane
    after lane from one generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(c["seed"])
    lanes = [draw_problem(c, gen, dtype) for _ in range(max(c["n_par"], 1))]
    return tuple(torch.stack(x).to(resolve_device(device)) for x in zip(*lanes))


def run_one(c, cfg, device=None):
    """The single fit of ``seed``'s draws."""
    targets, starts, axes = draws(c, device)
    return fit(targets[0], starts[0], axes[0], c, cfg, device)


def run_sweep(c, cfg, device=None):
    """The n_par seeds as one batched-native sweep; histories lanes first
    ((B, max_iter, ...)), as the JAX package's ``jax.vmap(run_one)``."""
    out = fit_batched(*draws(c, device), c, cfg, device)
    return {k: v.movedim(0, 1) if k.endswith("_hist") else v for k, v in out.items()}


def main(argv=None, device=None):
    c = parse_cli(DEFAULTS, argv)
    device = resolve_device(device)
    cfg = build_cfg(c)
    run = Run("inertia_fitting_primitives", c, base_dir=c["base_dir"])
    out = run_sweep(c, cfg, device) if c["n_par"] > 1 else run_one(c, cfg, device)
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    steps_first = out["loss_hist"].T if c["n_par"] > 1 else out["loss_hist"]
    for i, v in enumerate(steps_first.reshape(c["max_iter"], -1).mean(axis=-1)):
        run.log_scalar("loss", float(v), i)
    run.save_output(out)
    run.finish()
    print("param error:", abs(out["final_params"] - out["target_params"]))
    return out


if __name__ == "__main__":
    main()
