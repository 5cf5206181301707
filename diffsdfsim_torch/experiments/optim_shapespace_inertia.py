"""Shape from inertia in a learned shape space: recover an IGR latent code
from the spin response to a torque impulse.

PyTorch counterpart of ``diffsdfsim_tpu/experiments/
optim_shapespace_inertia.py`` (re-creation of the reference's
``experiments/inertia_fitting/optim_shapespace.py``): the latent body
(template projection, ``project_iters=16``) is pinned in translation and
spun by a unit torque for the first 0.3 s (``optim_primitives.spin``); the
loss is the final velocity error plus ``latent_reg * |z|^2`` (:198), and the
chamfer distance between the current and the target body's mesh is logged
every iteration (:195). The target is one of the codes and the start
N(mean, 0.1 std) over them (:155-162). The gradient reaches the latent
through the Mirtich inertia of the projection mesh, whose vertices are
decoder queries: on the card each query is one K4 launch, and the gradient
its backward with respect to the latent columns of the decoder's input. The
world has no contact pair, so no K1, K2 or K3 runs.

``n_par > 1`` runs a seed sweep as one batched-native rollout per Adam
step: the lane body is built by ``bodies.make_body_lanes`` (each projection
query one decoder call, one K4 launch, for the whole batch), the torque
axes travel in ``forces_b``.

Draws (target index, start, torque axis) come from a ``torch.Generator``
seeded with ``seed``, lane after lane; ``fit`` and ``fit_batched`` take
them explicitly, so a caller can hand them the JAX package's draws.

Run: python -m diffsdfsim_torch.experiments.optim_shapespace_inertia with n_par=8
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..physics import LatentShape, make_body
from ..physics.bodies import make_body_lanes
from ..utils.meshes import chamfer_distance
from .common import Run, parse_cli
from .fitting import Adam, descend
from .optim_primitives import spin, spin_batched
from .optim_shapespace import load_decoder

DEFAULTS = dict(
    seed=0,
    run_time=2.0,
    impulse_time=0.3,
    max_iter=200,
    lr=1e-3,
    latent_reg=1e-4,
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
    # one pinned body, no contacts: minimal contact buffers
    return SimConfig(
        fric_dirs=4,
        max_contacts_per_pair=1,
        max_contacts_total=1,
        mesh_subdiv=c["mesh_subdiv"],
        max_substeps=2,
        max_bisect=2,
        tol=1e-5 if f32 else 1e-8,
        time_of_contact_diff=False,
    )


def _shape(latent, decoder, c):
    return LatentShape(latent=latent, scale_=torch.tensor(c["scale"]), decoder=decoder)


def build_body(latent, decoder, c, device=None):
    return make_body(_shape(latent, decoder, c), subdiv=c["mesh_subdiv"], project_iters=16, device=device,
                     dtype=latent.dtype)


def build_body_lanes(latents, decoder, c, device=None):
    return make_body_lanes(lambda z: _shape(z, decoder, c), latents, subdiv=c["mesh_subdiv"], project_iters=16,
                           device=device, dtype=latents.dtype)


def simulate(latent, torque_dir, decoder, c, cfg, device=None):
    """The pinned spin: (final state, body)."""
    body = build_body(latent, decoder, c, device)
    return spin(body, torque_dir, c, cfg, device), body


def simulate_batched(latents, torque_dirs, decoder, c, cfg, device=None):
    """The spins of B latents (B, L) about their axes (B, 3): (final states,
    lane body)."""
    body_b = build_body_lanes(latents, decoder, c, device)
    return spin_batched(body_b, torque_dirs, c, cfg, device), body_b


def _fit(value_and_grad, target, start, torque_dir, c, max_iter, dists):
    final, loss_hist, latent_hist, grad_hist = descend(value_and_grad, start, Adam(c["lr"]), max_iter)
    before = torch.cat([start.detach()[None], latent_hist[:-1]])  # each step's latent
    return dict(
        start_latent=start, final_latent=final, target_latent=target, torque_dir=torque_dir, loss_hist=loss_hist,
        dist_hist=torch.stack(dists), latent_err_hist=torch.linalg.norm(before - target, dim=-1),
        grad_hist=grad_hist,
    )


def fit(decoder, target_latent, start_latent, torque_dir, c, cfg, device=None, max_iter=None):
    """Adam on |v - v_target|^2 + latent_reg |z|^2 from ``start_latent``
    toward the spin of ``target_latent``. Returns ``run_one``'s histories
    (each step's chamfer distance to the target mesh in ``dist_hist``) and
    the final mesh's chamfer distance, plus each step's gradient."""
    max_iter = c["max_iter"] if max_iter is None else max_iter
    with torch.no_grad():
        target_final, target_body = simulate(target_latent, torque_dir, decoder, c, cfg, device)
    target_v, target_verts = target_final.v, target_body.verts
    dists = []

    def value_and_grad(z):
        z = z.clone().requires_grad_(True)
        final, body = simulate(z, torque_dir, decoder, c, cfg, device)
        loss = torch.sum((final.v[0] - target_v[0]) ** 2) + c["latent_reg"] * torch.sum(z**2)
        dists.append(chamfer_distance(body.verts.detach(), target_verts))
        return loss.detach(), torch.autograd.grad(loss, z)[0]

    out = _fit(value_and_grad, target_latent, start_latent, torque_dir, c, max_iter, dists)
    with torch.no_grad():
        out["final_chamfer"] = chamfer_distance(build_body(out["final_latent"], decoder, c, device).verts,
                                                target_verts)
    return out


def fit_batched(decoder, targets, starts, torque_dirs, c, cfg, device=None, max_iter=None):
    """``fit`` of B lanes (targets and starts (B, L), axes (B, 3)) through the
    batched-native rollout; histories lanes second."""
    max_iter = c["max_iter"] if max_iter is None else max_iter
    with torch.no_grad():
        target_final, target_body = simulate_batched(targets, torque_dirs, decoder, c, cfg, device)
    target_v, target_verts = target_final.v, target_body.verts
    dists = []

    def lane_chamfer(verts):
        return torch.stack([chamfer_distance(a, b) for a, b in zip(verts, target_verts)])

    def value_and_grad(z):
        z = z.clone().requires_grad_(True)
        final, body_b = simulate_batched(z, torque_dirs, decoder, c, cfg, device)
        losses = torch.sum((final.v[:, 0] - target_v[:, 0]) ** 2, dim=-1) + c["latent_reg"] * torch.sum(z**2, dim=-1)
        dists.append(lane_chamfer(body_b.verts.detach()))
        return losses.detach(), torch.autograd.grad(losses.sum(), z)[0]

    out = _fit(value_and_grad, targets, starts, torque_dirs, c, max_iter, dists)
    with torch.no_grad():
        out["final_chamfer"] = lane_chamfer(build_body_lanes(out["final_latent"], decoder, c, device).verts)
    return out


def draw_problem(codes, generator: torch.Generator):
    """(target latent, start latent, unit torque axis) as ``run_one`` draws
    them, from a ``torch.Generator`` on the CPU."""
    idx = int(torch.randint(0, codes.shape[0], (), generator=generator))
    mean = torch.mean(codes, dim=0)
    std = torch.std(codes, dim=0, unbiased=False)
    noise = torch.randn(mean.shape, generator=generator, dtype=torch.float64).to(codes.dtype).to(codes.device)
    axis = torch.randn((3,), generator=generator, dtype=torch.float64)
    axis = (axis / torch.linalg.norm(axis)).to(codes.dtype).to(codes.device)
    return codes[idx], mean + 0.1 * std * noise, axis


def draws(codes, c):
    """(targets, starts, axes) of the max(n_par, 1) lanes, lane after lane
    from one generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(c["seed"])
    return tuple(torch.stack(x) for x in zip(*(draw_problem(codes, gen) for _ in range(max(c["n_par"], 1)))))


def run_one(decoder, codes, c, cfg, device=None):
    targets, starts, axes = draws(codes, c)
    return fit(decoder, targets[0], starts[0], axes[0], c, cfg, device)


def run_sweep(decoder, codes, c, cfg, device=None):
    """The n_par seeds as one batched-native sweep; histories lanes first."""
    out = fit_batched(decoder, *draws(codes, c), c, cfg, device)
    return {k: v.movedim(0, 1) if k.endswith("_hist") else v for k, v in out.items()}


def main(argv=None, device=None):
    c = parse_cli(DEFAULTS, argv)
    device = resolve_device(device)
    cfg = build_cfg(c)
    run = Run("inertia_fitting_shapespace", c, base_dir=c["base_dir"])
    decoder, codes = load_decoder(c, device)
    out = run_sweep(decoder, codes, c, cfg, device) if c["n_par"] > 1 else run_one(decoder, codes, c, cfg, device)
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    for name in ("loss_hist", "dist_hist"):
        series = out[name].T if c["n_par"] > 1 else out[name]
        for i, v in enumerate(series.reshape(c["max_iter"], -1).mean(axis=-1)):
            run.log_scalar(name.replace("_hist", ""), float(v), i)
    run.save_output(out)
    run.finish()
    err = lambda a: np.linalg.norm(out[a] - out["target_latent"], axis=-1)  # noqa: E731
    print("latent err start->final:", err("start_latent"), err("final_latent"),
          "final chamfer:", float(np.mean(out["final_chamfer"])))
    return out


if __name__ == "__main__":
    main()
