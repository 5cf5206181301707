"""Training of a small IGR shape space on analytic shapes.

PyTorch counterpart of ``diffsdfsim_tpu/models/igr_train.py``. The
reference experiments load an externally trained IGR checkpoint
(``shapespaces/IGR/models/bob_and_spot``); this module trains the same
``ImplicitNet`` (``models/igr.py``) as an auto-decoder on analytic SDFs, so
that the shape-space experiments have codes that decode to distinct shapes:

- the SDF regression on surface-biased and uniform points in [-1, 1]^3;
- the eikonal term mean((|grad sdf| - 1)^2) on the uniform points, a double
  backward through ``implicit_net_apply``;
- the L2 term on the latent codes;
- Adam by optax's rule (``experiments/fitting.Adam``) on every weight, bias
  and code.

Training goes through ``implicit_net_apply``, the plain decoder, whose
weights take autograd's gradient; kernel K4 refuses weights that require
grad. The trained net is an ``ImplicitNet`` whose forward is K4 on the card.

Every draw (the initial net, the codes, each step's points) comes from one
``torch.Generator`` on the CPU and is then moved to the device, so that
the card and the CPU train on the same points. The draws differ from the
JAX package's ``jax.random`` ones; ``shapespace_loss`` and ``adam_step``
take the parameters and points explicitly, so a caller can hand them the
JAX package's. ``load_or_train`` reads and writes the JAX package's cache
file (``interop.read_space`` / ``write_space``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Sequence

import torch

from ..config import default_dtype, resolve_device
from ..ops import sdf as sdf_ops
from .igr import ImplicitNet, ImplicitNetParams, implicit_net_apply, init_implicit_net


def _torus_sdf(p, R, r):
    qx = torch.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 2] ** 2, min=1e-24)) - R
    return torch.sqrt(torch.clamp(qx**2 + p[..., 1] ** 2, min=1e-24)) - r


def default_shape_fns() -> Sequence[Callable]:
    """Four analytic SDFs in the normalized [-1, 1]^3 frame: a sphere, a
    box, a squat cylinder and a torus (genus 1, which no interpolation of
    the star-shaped ones reaches)."""
    def dt(p, v):
        return torch.as_tensor(v, dtype=p.dtype, device=p.device)

    return (
        lambda p: sdf_ops.sphere_sdf(p, dt(p, 0.55)),
        lambda p: sdf_ops.box_sdf(p, dt(p, [0.45, 0.45, 0.45])),
        lambda p: sdf_ops.cylinder_sdf(p, dt(p, 0.4), dt(p, 1.0)),
        lambda p: _torus_sdf(p, dt(p, 0.45), dt(p, 0.22)),
    )


def _net_sdf(params: ImplicitNetParams, z, pts):
    return implicit_net_apply(params, torch.cat([z.expand(pts.shape[0], z.shape[-1]), pts], dim=-1))


def shapespace_loss(params: ImplicitNetParams, codes, surfb, uniform, shape_fns, eikonal_w: float = 0.05,
                    latent_reg: float = 1e-4):
    """The training loss at (params, codes) on one step's points: per shape
    i the SDF regression on surfb[i] and the uniform points, plus
    eikonal_w times the eikonal term on the uniform points; plus
    latent_reg |codes|^2. Differentiable in the params and the codes."""
    total = 0.0
    for i, fn in enumerate(shape_fns):
        pts = torch.cat([surfb[i], uniform])
        total = total + torch.mean((_net_sdf(params, codes[i], pts) - fn(pts)) ** 2)
        pu = uniform.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_net_sdf(params, codes[i], pu).sum(), pu, create_graph=True)
        total = total + eikonal_w * torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    return total + latent_reg * torch.sum(codes**2)


def draw_points(shape_fns, n_pts: int, generator: torch.Generator, dtype=None, device=None):
    """One step's points, drawn on the CPU and moved to ``device``: (surfb
    (K, n_pts, 3), uniform (n_pts, 3)). A shape's surface-biased points are
    uniform points moved one Newton step toward its zero set plus N(0,
    0.05^2) jitter, clipped to [-1, 1]; every shape starts from the same
    uniform points and jitter (as the JAX package draws them)."""
    dtype = dtype or default_dtype()
    u = torch.rand((2, n_pts, 3), generator=generator, dtype=torch.float64).to(dtype) * 2.0 - 1.0
    noise = torch.randn((n_pts, 3), generator=generator, dtype=torch.float64).to(dtype)
    uniform, p = u[0], u[1]
    surfb = []
    for fn in shape_fns:
        pg = p.clone().requires_grad_(True)
        d = fn(pg)
        (g,) = torch.autograd.grad(d.sum(), pg)
        g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-6)
        surfb.append(torch.clamp(p - d.detach()[:, None] * g + 0.05 * noise, -1.0, 1.0))
    return torch.stack(surfb).to(device), uniform.to(device)


def adam_step(tensors, states, opt, loss_fn):
    """One optimizer step on a list of tensors: (loss, new tensors, new
    states); ``loss_fn(tensors)`` is differentiable in them."""
    xs = [t.detach().requires_grad_(True) for t in tensors]
    loss = loss_fn(xs)
    grads = torch.autograd.grad(loss, xs)
    out, new_states = [], []
    for x, g, s in zip(xs, grads, states):
        upd, s = opt.update(g, s)
        out.append((x + upd).detach())
        new_states.append(s)
    return loss.detach(), out, new_states


def train_tiny_shapespace(
    generator: torch.Generator | None = None,
    shape_fns: Sequence[Callable] | None = None,
    latent_size: int = 2,
    dims: Sequence[int] = (64, 64, 64, 64),
    n_steps: int = 1500,
    n_pts: int = 512,
    lr: float = 2e-3,
    eikonal_w: float = 0.05,
    latent_reg: float = 1e-4,
    device=None,
    dtype=None,
):
    """Train the shape space; returns (ImplicitNet, codes (K, latent_size),
    the last step's loss). ``generator`` (default: seeded with 7) draws the
    initial net (IGR's geometric init toward a sphere of radius 0.5, a skip
    at the middle layer from 4 layers on), the codes N(0, 0.3^2) and every
    step's points, in that order."""
    from ..experiments.fitting import Adam

    device = resolve_device(device)
    dtype = dtype or default_dtype()
    generator = torch.Generator().manual_seed(7) if generator is None else generator
    shape_fns = default_shape_fns() if shape_fns is None else shape_fns
    skip = (len(dims) // 2,) if len(dims) >= 4 else ()
    net = init_implicit_net(3 + latent_size, tuple(dims), skip, radius_init=0.5, generator=generator, dtype=dtype)
    codes = 0.3 * torch.randn((len(shape_fns), latent_size), generator=generator, dtype=torch.float64).to(dtype)
    p = net.params()
    nl = len(p.weights)
    tensors = [t.detach().to(device) for t in (*p.weights, *p.biases, codes)]
    opt = Adam(lr)
    states = [opt.init(t) for t in tensors]

    def loss_fn(xs, surfb, uniform):
        params = ImplicitNetParams(tuple(xs[:nl]), tuple(xs[nl : 2 * nl]), p.skip_in, p.d_in, p.beta)
        return shapespace_loss(params, xs[-1], surfb, uniform, shape_fns, eikonal_w, latent_reg)

    loss = None
    for _ in range(n_steps):
        surfb, uniform = draw_points(shape_fns, n_pts, generator, dtype, device)
        loss, tensors, states = adam_step(tensors, states, opt, lambda xs: loss_fn(xs, surfb, uniform))
    trained = ImplicitNet.from_arrays([t.cpu() for t in tensors[:nl]], [t.cpu() for t in tensors[nl : 2 * nl]],
                                      skip_in=p.skip_in, beta=p.beta, dtype=dtype, device=device)
    return trained, tensors[-1], loss


def load_or_train(cache_path: str, generator: torch.Generator | None = None, device=None, dtype=None, **kw):
    """(ImplicitNet, codes) from the cache file, which the JAX package's
    ``load_or_train`` reads and writes too; or trained
    (``train_tiny_shapespace(generator, **kw)``) and cached there."""
    from ..interop import read_space, write_space

    path = Path(cache_path)
    if path.exists():
        return read_space(path, device=device, dtype=dtype)
    net, codes, _ = train_tiny_shapespace(generator, device=device, dtype=dtype, **kw)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_space(path, net, codes)
    return net, codes
