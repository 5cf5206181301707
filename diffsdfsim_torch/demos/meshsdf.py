"""Shape optimization demo: optimize a latent-space shape so the falling
body lands at a target position.

PyTorch counterpart of ``demos/demo_meshsdf.py`` (the reference's
``demos/demo_meshsdf.py``): a fixed floor box and a fixed upright cylinder
pole (both ``TotalConstraint3D``) and a falling body whose shape is an IGR
decoder's latent code. The loss is the body's final position against a
target plus an L2 regularizer on the code; the code steps by SGD (lr 5e-3)
after optax's ``clip_by_global_norm(10)``. The decoder is the
``model_path`` / ``latent_path`` checkpoint (``models/igr.
load_torch_checkpoint``, the first latent code as the start), else a
geometric-init net (radius 0.5) drawn from a ``torch.Generator`` seeded
with ``seed``, and a zero code.

Run (on the card; ``device=cpu`` runs the plain path on the CPU):

    python -m diffsdfsim_torch.demos.meshsdf [iters=N] [run_time=T] [device=cpu]

``build_world`` and ``loss_fn`` take the decoder and the code, so a caller
can hand them any decoder's weights (the JAX demo's, as numpy) and compare.
"""

from __future__ import annotations

import pickle

import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..experiments.common import parse_cli
from ..models.igr import init_implicit_net, load_torch_checkpoint
from ..physics import BoxShape, CylinderShape, Gravity3D, TotalConstraint3D, make_body, make_world, rollout
from ..physics.shapes import LatentShape

DEFAULTS = dict(
    iters=50,
    lr=5e-3,
    latent_reg=1e-2,
    latent_size=2,
    run_time=1.0,
    grad_clip=10.0,
    model_path="",
    latent_path="",
    seed=7,
    device="",
    out="demo_meshsdf_out.pkl",
)
TARGET_POS = (0.8, 0.5, 0.0)
# floor, pole (its axis, local z, turned upright about x), falling body
POSES = ((1.0, 0, 0, 0, 0.0, -0.5, 0.0),
         (0.7071067811865476, 0.7071067811865476, 0, 0, 0.3, 0.6, 0.0),
         (1.0, 0, 0, 0, 0.0, 2.2, 0.0))


def build_cfg(dtype=None) -> SimConfig:
    """The demo's simulation config (float32 takes bench.py's f32 tol)."""
    f32 = (dtype or default_dtype()) == torch.float32
    return SimConfig(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=3,
                     max_bisect=6, tol=1e-5 if f32 else 1e-8)


def load_decoder(c: dict, device):
    """(decoder, start code): the checkpoint's, or a seeded geometric-init
    net and a zero code."""
    if c["model_path"]:
        net, codes = load_torch_checkpoint(c["model_path"], c["latent_path"], device=device)
        return net, codes[0]
    net = init_implicit_net(3 + c["latent_size"], radius_init=0.5, generator=torch.Generator().manual_seed(c["seed"]))
    return net.to(device), torch.zeros(c["latent_size"], dtype=default_dtype(), device=device)


def fixed_bodies(device, dtype=None):
    """The floor and the pole (no parameter of the fit)."""
    dtype = dtype or default_dtype()
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device=device, dtype=dtype)
    pole = make_body(CylinderShape(torch.tensor(0.15), torch.tensor(1.2)), subdiv=2, device=device, dtype=dtype)
    return floor, pole


def build_world(z, decoder, cfg: SimConfig, fixed):
    """(spec, state) of the demo's world with the body's latent code ``z``
    (differentiable into it)."""
    floor, pole = fixed
    device, dtype = z.device, z.dtype
    shape = LatentShape(latent=z, scale_=torch.tensor(0.6, dtype=dtype, device=device), decoder=decoder)
    body = make_body(shape, subdiv=2, project_iters=16, device=device, dtype=dtype)
    return make_world([floor, pole, body], torch.tensor(POSES, dtype=dtype, device=device),
                      torch.zeros((3, 6), dtype=dtype, device=device),
                      joints=(TotalConstraint3D(body1=0), TotalConstraint3D(body1=1)),
                      forces=((), (), (Gravity3D(10.0),)), no_contact=[(0, 1)], cfg=cfg, device=device)


def loss_fn(z, decoder, c: dict, cfg: SimConfig, fixed):
    """The final position's squared distance to the target plus
    ``latent_reg`` |z|^2, after ``run_time`` of simulation."""
    spec, state = build_world(z, decoder, cfg, fixed)
    final, _ = rollout(spec, state, n_frames=int(round(c["run_time"] / cfg.dt)))
    target = torch.tensor(TARGET_POS, dtype=z.dtype, device=z.device)
    return torch.sum((final.pos[2] - target) ** 2) + c["latent_reg"] * torch.sum(z**2)


def clip_by_global_norm(g, max_norm: float):
    """``optax.clip_by_global_norm`` of one leaf: g where its norm is below
    ``max_norm``, else (g / norm) * max_norm, in optax's order of
    operations."""
    g_norm = torch.sqrt(torch.sum(g * g))
    return torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm)


def optimize(decoder, z0, c: dict, cfg: SimConfig, fixed, log=print):
    """``iters`` steps of the fit: value and gradient, the clip, SGD.
    Returns {"loss": [...], "latent": [z after each step], "grad": [...]}."""
    z = z0.detach().clone()
    hist = {"loss": [], "latent": [], "grad": []}
    for i in range(c["iters"]):
        z.requires_grad_(True)
        val = loss_fn(z, decoder, c, cfg, fixed)
        (g,) = torch.autograd.grad(val, z)
        z = (z.detach() + (-c["lr"]) * clip_by_global_norm(g, c["grad_clip"])).detach()
        hist["loss"].append(float(val.detach()))
        hist["latent"].append(z.cpu().numpy())
        hist["grad"].append(g.cpu().numpy())
        log(f"iter {i}: loss {float(val.detach()):.5f}")
    return hist


def main(argv=None):
    c = parse_cli(DEFAULTS, argv)
    device = resolve_device(c["device"] or None)
    decoder, z0 = load_decoder(c, device)
    cfg = build_cfg()
    hist = optimize(decoder, z0, c, cfg, fixed_bodies(device))
    with open(c["out"], "wb") as f:
        pickle.dump(hist, f)
    print("saved", c["out"])
    return hist


if __name__ == "__main__":
    main()
