"""Shape-space trajectory fitting: recover an IGR latent code from a bounce.

PyTorch counterpart of ``diffsdfsim_tpu/experiments/optim_shapespace.py``
(re-creation of the reference's ``experiments/trajectory_fitting/
optim_shapespace.py``): a body whose shape is decoded from a latent space
(the IGR MLP, ``models/igr.py``; its values are kernel K4 on the card) is
dropped with a random initial rotation onto a fixed floor; Adam (optax's
rule, ``fitting.Adam``) on the nearest-time trajectory MSE plus
``latent_reg * |z|^2`` recovers the latent. The target latent is one of
the codes and the start N(mean, 0.1 std) (reference :241-248).

``--model_path .../ModelParameters/x.pth --latent_path .../LatentCodes/x.pth``
loads real IGR weights (``models/igr.load_torch_checkpoint``); otherwise a
geometrically initialized net (an approximate sphere of radius 0.55) keeps
the pipeline runnable. ``trained_space`` takes the in-repo trained space
(``models/igr_train.load_or_train``: 2500 steps, cached at
``space_cache`` in the JAX package's format).

``n_par > 1`` runs a seed sweep, the JAX package's ``jax.vmap(run_one)``
(B independent fits), as one batched-native rollout per Adam step
(``physics/batched.py``): the body is a latent lane body whose code differs
per lane and whose decoder every lane shares, Adam runs over the (B, L)
latents and the loss is summed over the lanes (Adam is elementwise, so
this equals the B separate fits). Each SDF query of the batch's latent
body is one decoder call for all lanes: one K4 launch on the card.

The port's own draws (the default net, the codes, the target, the start and
the initial rotation) come from ``torch.Generator``s seeded from the config;
they differ from the JAX package's ``jax.random`` draws. ``fit`` and
``fit_batched`` take the target latents, the start latents and the initial
rotations explicitly, so a caller can hand them the JAX package's draws.

Run: python -m diffsdfsim_torch.experiments.optim_shapespace with n_par=8
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..models.igr import init_implicit_net, load_torch_checkpoint
from ..physics import (
    BoxShape,
    Gravity3D,
    LatentShape,
    TotalConstraint3D,
    make_body,
    make_world,
    make_world_batched,
    rollout,
    rollout_batched,
    trajectory_lanes_first,
)
from ..utils.quaternion import random_quaternions
from .common import Run, parse_cli
from .fitting import Adam, descend, lane_losses
from .losses import trajectory_loss

DEFAULTS = dict(
    seed=0,
    run_time=1.2,
    max_iter=60,
    lr=1e-2,
    latent_reg=1e-3,
    latent_size=2,
    scale=1.0,
    mesh_subdiv=2,
    model_path="",
    latent_path="",
    trained_space=False,
    space_cache="outputs/igr_space4.pkl",
    n_par=1,
    base_dir="outputs",
)


def build_cfg(c, dtype=None) -> SimConfig:
    f32 = (dtype or default_dtype()) == torch.float32
    return SimConfig(
        fric_dirs=8,
        max_contacts_per_pair=4,
        max_contacts_total=8,
        mesh_subdiv=c["mesh_subdiv"],
        max_substeps=4,
        max_bisect=6,
        tol=1e-5 if f32 else 1e-8,
        time_of_contact_diff=True,
    )


def load_decoder(c, device=None, dtype=None):
    """(ImplicitNet, codes (n, latent_size)) on ``device``: the checkpoint at
    ``model_path`` / ``latent_path``, the trained space (``trained_space``),
    or a geometric-init net and 16 codes drawn N(0, 0.3^2)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    if c["model_path"]:
        return load_torch_checkpoint(c["model_path"], c["latent_path"], dtype=dtype, device=device)
    if c.get("trained_space"):
        # the in-repo trained space (sphere, box, cylinder, torus codes) at
        # the reference's bob_spot_setup.conf size ((128,)*8, skip at 4)
        from ..models.igr_train import load_or_train

        return load_or_train(str(c.get("space_cache", "outputs/igr_space4.pkl")), dims=(128,) * 8, n_steps=2500,
                             device=device, dtype=dtype)
    net = init_implicit_net(3 + c["latent_size"], radius_init=0.55, generator=torch.Generator().manual_seed(1234),
                            dtype=dtype)
    codes = torch.randn((16, c["latent_size"]), generator=torch.Generator().manual_seed(4321), dtype=dtype) * 0.3
    return net.to(device), codes.to(device)


def build_world(latent, quat0, decoder, c, cfg, device=None):
    """The scene of ``optim_shapespace.simulate``: a fixed 20x1x20 floor and
    the latent body dropped from y = 2 with vx = 1 and rotation ``quat0``.
    Returns (spec, state)."""
    device = resolve_device(device)
    dtype = latent.dtype
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device=device, dtype=dtype)
    shape = LatentShape(latent=latent, scale_=torch.tensor(c["scale"]), decoder=decoder)
    body = make_body(shape, subdiv=c["mesh_subdiv"], project_iters=16, device=device, dtype=dtype)
    quat0 = torch.as_tensor(quat0, dtype=dtype, device=device)
    poses = torch.stack([
        torch.tensor([1.0, 0, 0, 0, 0.0, -0.5, 0.0], dtype=dtype, device=device),
        torch.cat([quat0, torch.tensor([0.0, 2.0, 0.0], dtype=dtype, device=device)]),
    ])
    vels = torch.zeros((2, 6), dtype=dtype, device=device)
    vels[1, 3] = 1.0
    return make_world(
        [floor, body], poses, vels, joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)),
        cfg=cfg, device=device,
    )


def n_frames(c, cfg) -> int:
    return int(round(c["run_time"] / cfg.dt))


def simulate(latent, quat0, decoder, c, cfg, device=None):
    """One drop: (final state, Trajectory)."""
    spec, state = build_world(latent, quat0, decoder, c, cfg, device)
    return rollout(spec, state, n_frames(c, cfg))


def simulate_batched(latents, quats, decoder, c, cfg, device=None):
    """The drops of B latents (B, L) at their rotations (B, 4) as one
    batched-native rollout: (final, lanes-first Trajectory)."""
    spec, bodies_b, state_b = make_world_batched(
        lambda z, q: build_world(z, q, decoder, c, cfg, device), latents, quats)
    final, traj = rollout_batched(spec, bodies_b, state_b, n_frames(c, cfg))
    return final, trajectory_lanes_first(traj)


def draw_problem(codes, generator: torch.Generator):
    """(target latent, start latent, initial rotation) as ``run_one`` draws
    them, from a ``torch.Generator`` on the CPU."""
    idx = int(torch.randint(0, codes.shape[0], (), generator=generator))
    target = codes[idx]
    mean = torch.mean(codes, dim=0)
    std = torch.std(codes, dim=0, unbiased=False)
    noise = torch.randn(mean.shape, generator=generator, dtype=codes.dtype).to(codes.device)
    quat0 = random_quaternions(1, generator, dtype=codes.dtype)[0].to(codes.device)
    return target, mean + 0.1 * std * noise, quat0


def _fit(value_and_grad, target, start, c, max_iter):
    final, loss_hist, latent_hist, grad_hist = descend(value_and_grad, start, Adam(c["lr"]), max_iter)
    before = torch.cat([start.detach()[None], latent_hist[:-1]])  # each step's latent
    return dict(
        start_latent=start, final_latent=final, target_latent=target, loss_hist=loss_hist,
        latent_err_hist=torch.linalg.norm(before - target, dim=-1), grad_hist=grad_hist,
    )


def fit(decoder, target_latent, start_latent, quat0, c, cfg, device=None, max_iter=None):
    """Adam on ``trajectory_loss(body=1) + latent_reg * |z|^2`` from
    ``start_latent`` toward the trajectory of ``target_latent``. Returns the
    histories of ``run_one``, plus each step's gradient."""
    max_iter = c["max_iter"] if max_iter is None else max_iter
    with torch.no_grad():
        _, tgt = simulate(target_latent, quat0, decoder, c, cfg, device)

    def value_and_grad(z):
        z = z.clone().requires_grad_(True)
        loss = trajectory_loss(simulate(z, quat0, decoder, c, cfg, device)[1], tgt, body=1) + c["latent_reg"] * torch.sum(z**2)
        return loss.detach(), torch.autograd.grad(loss, z)[0]

    return _fit(value_and_grad, target_latent, start_latent, c, max_iter)


def fit_batched(decoder, targets, starts, quats, c, cfg, device=None, max_iter=None):
    """``fit`` of B lanes (targets and starts (B, L), rotations (B, 4))
    through the batched-native rollout: per step one taped rollout of the
    batch and one backward of the lanes' summed loss. Histories are lanes
    second: losses (max_iter, B), latents and gradients (max_iter, B, L)."""
    max_iter = c["max_iter"] if max_iter is None else max_iter
    with torch.no_grad():
        _, tgt = simulate_batched(targets, quats, decoder, c, cfg, device)

    def value_and_grad(z):
        z = z.clone().requires_grad_(True)
        losses = lane_losses(simulate_batched(z, quats, decoder, c, cfg, device)[1], tgt, body=1) + c[
            "latent_reg"] * torch.sum(z**2, dim=-1)
        return losses.detach(), torch.autograd.grad(losses.sum(), z)[0]

    return _fit(value_and_grad, targets, starts, c, max_iter)


def draws(codes, c):
    """(targets, starts, rotations) of the max(n_par, 1) lanes, drawn in lane
    order from one generator seeded with ``seed`` (lane 0 draws what the
    single run of that seed draws)."""
    gen = torch.Generator().manual_seed(c["seed"])
    return tuple(torch.stack(x) for x in zip(*(draw_problem(codes, gen) for _ in range(max(c["n_par"], 1)))))


def run_one(seed: int, decoder, codes, c, cfg, device=None):
    """One fit with the problem drawn from ``seed`` (see ``draw_problem``)."""
    target, start, quat0 = draw_problem(codes, torch.Generator().manual_seed(seed))
    return fit(decoder, target, start, quat0, c, cfg, device)


def run_sweep(decoder, codes, c, cfg, device=None):
    """The n_par seeds as one batched-native sweep; histories lanes first
    ((B, max_iter, ...)), as the JAX package's ``jax.vmap(run_one)``."""
    out = fit_batched(decoder, *draws(codes, c), c, cfg, device)
    return {k: v.movedim(0, 1) if k.endswith("_hist") else v for k, v in out.items()}


def main(argv=None, device=None):
    c = parse_cli(DEFAULTS, argv)
    device = resolve_device(device)
    cfg = build_cfg(c)
    decoder, codes = load_decoder(c, device)
    run = Run("trajectory_fitting_shapespace", c, base_dir=c["base_dir"])
    out = run_sweep(decoder, codes, c, cfg, device) if c["n_par"] > 1 else run_one(c["seed"], decoder, codes, c,
                                                                                      cfg, device)
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    steps_first = out["loss_hist"].T if c["n_par"] > 1 else out["loss_hist"]
    for i, v in enumerate(steps_first.reshape(c["max_iter"], -1).mean(axis=-1)):
        run.log_scalar("loss", float(v), i)
    run.save_output(out)
    run.finish()
    norm = lambda x: np.linalg.norm(x, axis=-1)  # noqa: E731
    print("latent err start->final:", norm(out["start_latent"] - out["target_latent"]),
          norm(out["final_latent"] - out["target_latent"]))
    return out


if __name__ == "__main__":
    main()
