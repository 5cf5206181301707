"""IGR shape-space decoder (implicit geometric regularization MLP).

PyTorch counterpart of ``diffsdfsim_tpu/models/igr.py``, itself a
re-implementation of the IGR ``ImplicitNet`` the reference loads
(``sdf_physics/physics3d/utils.py:286-350``): a ``lin{i}`` stack of Linear
layers, Softplus(beta=100) between them, and at each ``skip_in`` layer the
network input re-concatenated and the result divided by sqrt(2). The decoder
maps (latent, pts in [-1,1]^3) -> sdf, as ``decode_igr`` does.

- ``ImplicitNet`` is an ``nn.Module`` whose layers carry IGR's state-dict
  names (``lin0.weight`` ...), so a published ``model_state_dict`` loads
  after its weight-norm fold. Its weights are frozen: only the latent code
  is a simulation parameter (the JAX package keeps the decoder out of the
  differentiated pytree).
- ``implicit_net_apply`` is the plain version of the fused decoder kernel K4
  (``ops/igr_cuda.py``); ``implicit_net_grad`` is the decoder's gradient with
  respect to the three point inputs, carried forward through the layers as
  three tangent columns in plain tensor ops, so ordinary autograd
  differentiates it again (the contact normals' dependence on the latent).
"""

from __future__ import annotations

import math
import os
import re
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import default_dtype, resolve_device


class ImplicitNetParams(NamedTuple):
    weights: tuple  # per layer (out, in)
    biases: tuple  # per layer (out,)
    skip_in: tuple  # layer indices with input re-concatenation
    d_in: int
    beta: float = 100.0


def softplus_beta(x, beta=100.0):
    """torch.nn.Softplus(beta): (1/beta) log(1 + exp(beta x)), linear where
    beta x > 20 (torch's threshold)."""
    bx = beta * x
    return torch.where(bx > 20.0, x, torch.log1p(torch.exp(torch.clamp(bx, max=20.0))) / beta)


def _softplus_slope(x, beta=100.0):
    """d softplus_beta / dx."""
    bx = beta * x
    e = torch.exp(torch.clamp(bx, max=20.0))
    return torch.where(bx > 20.0, torch.ones_like(x), e / (1.0 + e))


def implicit_net_apply(params: ImplicitNetParams, x):
    """(N, d_in) -> (N,) sdf values, as IGR's ImplicitNet.forward (plain
    version of kernel K4)."""
    inp = x
    n_layers = len(params.weights)
    for i in range(n_layers):
        if i in params.skip_in:
            x = torch.cat([x, inp], dim=-1) / math.sqrt(2.0)
        x = x @ params.weights[i].T + params.biases[i]
        if i < n_layers - 1:
            x = softplus_beta(x, params.beta)
    return x[..., 0]


def implicit_net_grad(params: ImplicitNetParams, x):
    """(N, d_in) -> (N, 3): the gradient of the decoder with respect to its
    last three inputs (the point), by forward-mode tangents in plain tensor
    ops: J <- J W' for a layer, J <- J * softplus'(a) for an activation, and
    J <- [J, J0] / sqrt(2) at a skip layer."""
    n, d_in = x.shape
    J0 = torch.zeros((1, 3, d_in), dtype=x.dtype, device=x.device)
    J0[0, :, d_in - 3 :] = torch.eye(3, dtype=x.dtype, device=x.device)
    inp, J = x, J0
    n_layers = len(params.weights)
    for i in range(n_layers):
        w = params.weights[i]
        if i in params.skip_in:
            x = torch.cat([x, inp], dim=-1) / math.sqrt(2.0)
            J = torch.cat([J.expand(n, -1, -1), J0.expand(n, -1, -1)], dim=-1) / math.sqrt(2.0)
        a = x @ w.T + params.biases[i]
        J = J @ w.T  # (N or 1, 3, out)
        if i < n_layers - 1:
            x = softplus_beta(a, params.beta)
            J = J * _softplus_slope(a, params.beta)[:, None, :]
    return J[..., 0].expand(n, 3)


def _normal(generator, shape, dtype):
    """Standard normal draws from a torch.Generator or a numpy Generator (the
    numpy draws can be handed to the JAX package unchanged)."""
    if isinstance(generator, np.random.Generator):
        return torch.as_tensor(generator.standard_normal(shape), dtype=dtype)
    return torch.randn(shape, generator=generator, dtype=torch.float64).to(dtype)


class ImplicitNet(torch.nn.Module):
    """IGR's ImplicitNet: ``dims`` hidden widths, input re-concatenated at the
    layers in ``skip_in``, Softplus(beta) activations, one output. The
    parameters are frozen; ``init_implicit_net`` and ``from_arrays`` set
    them."""

    def __init__(self, d_in: int, dims: Sequence[int] = (128,) * 8, skip_in: Sequence[int] = (4,),
                 beta: float = 100.0, dtype=None):
        super().__init__()
        self.d_in = d_in
        self.skip_in = tuple(skip_in)
        self.beta = float(beta)
        dims = [d_in] + list(dims) + [1]
        self.num_layers = len(dims) - 1
        for layer in range(self.num_layers):
            out_dim = dims[layer + 1] - d_in if layer + 1 in self.skip_in else dims[layer + 1]
            setattr(self, f"lin{layer}", torch.nn.Linear(dims[layer], out_dim, dtype=dtype or default_dtype()))
        self.requires_grad_(False)

    def params(self) -> ImplicitNetParams:
        lins = [getattr(self, f"lin{i}") for i in range(self.num_layers)]
        return ImplicitNetParams(
            tuple(lin.weight for lin in lins), tuple(lin.bias for lin in lins), self.skip_in, self.d_in, self.beta
        )

    def forward(self, x):
        """(N, d_in) -> (N,): kernel K4 on CUDA tensors, the plain version on CPU."""
        from ..ops.igr_cuda import igr_mlp

        return igr_mlp(self.params(), x)

    @classmethod
    def from_arrays(cls, weights, biases, skip_in=(4,), beta: float = 100.0, dtype=None, device=None):
        """A net holding the given per-layer (out, in) weights and biases, on
        ``device`` (None: CUDA, raising without it; "cpu" for the plain path)."""
        device = resolve_device(device)
        d_in = int(np.shape(weights[0])[1])
        dims = [int(np.shape(w)[0]) + (d_in if i + 1 in skip_in else 0) for i, w in enumerate(weights[:-1])]
        net = cls(d_in, dims, skip_in, beta=beta, dtype=dtype)
        with torch.no_grad():
            for i, (w, b) in enumerate(zip(weights, biases)):
                lin = getattr(net, f"lin{i}")
                lin.weight.copy_(torch.as_tensor(np.asarray(w)))
                lin.bias.copy_(torch.as_tensor(np.asarray(b)))
        return net.to(device)


def init_implicit_net(d_in: int, dims: Sequence[int] = (128,) * 8, skip_in: Sequence[int] = (4,),
                      radius_init: float = 1.0, generator=None, dtype=None) -> ImplicitNet:
    """IGR's geometric initialization, toward a sphere of radius
    ``radius_init``: hidden weights N(0, 2/out) and zero biases, the last
    layer sqrt(pi/in) with bias -radius_init (as
    ``diffsdfsim_tpu/models/igr.init_implicit_net``). ``generator`` is a
    ``torch.Generator`` (default: seeded with 0) or a
    ``numpy.random.Generator``, whose draws the JAX package can take."""
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    net = ImplicitNet(d_in, dims, skip_in, dtype=dtype)
    with torch.no_grad():
        for layer in range(net.num_layers):
            lin = getattr(net, f"lin{layer}")
            out_dim, in_dim = lin.weight.shape
            if layer == net.num_layers - 1:
                lin.weight.fill_(math.sqrt(math.pi) / math.sqrt(in_dim))
                lin.bias.fill_(-radius_init)
            else:
                lin.weight.copy_(_normal(generator, (out_dim, in_dim), lin.weight.dtype) * (math.sqrt(2.0) / math.sqrt(out_dim)))
                lin.bias.zero_()
    return net


def _net_input(pts, latent):
    p = pts.reshape(-1, 3)
    return torch.cat([latent.expand(p.shape[0], latent.shape[-1]), p], dim=-1)


def decode(net: ImplicitNet, pts, latent):
    """decoder(pts (..., 3), latent (L,)) -> (...) (reference decode_igr)."""
    return net(_net_input(pts, latent)).reshape(pts.shape[:-1])


def decode_grad(net: ImplicitNet, pts, latent):
    """d decoder / d pts, (..., 3), differentiable in the latent."""
    return implicit_net_grad(net.params(), _net_input(pts, latent)).reshape(pts.shape)


def make_decoder(net: ImplicitNet):
    """decoder(pts (..., 3), latent (L,)) -> (...), as the JAX package's."""
    return lambda pts, latent: decode(net, pts, latent)


def _parse_hocon_lite(text: str) -> dict:
    """Minimal HOCON subset parser for IGR ``exp.conf`` files: nested
    ``name{...}`` blocks, ``key = value`` or ``"key" : value`` pairs,
    numbers / booleans / strings / [lists] / inline {dicts}, optional
    commas (replaces the reference's pyhocon dependency)."""
    s = re.sub(r"//[^\n]*|#[^\n]*", "", text)
    tokens = re.findall(r'"[^"]*"|[{}\[\],=:]|[^\s{}\[\],=:]+', s)

    def atom(tok):
        if tok.startswith('"'):
            return tok[1:-1]
        low = tok.lower()
        if low in ("true", "false"):
            return low == "true"
        for cast in (int, float):
            try:
                return cast(tok)
            except ValueError:
                pass
        return tok

    def parse_value(i):
        tok = tokens[i]
        if tok == "{":
            return parse_dict(i + 1)
        if tok == "[":
            out = []
            i += 1
            while tokens[i] != "]":
                if tokens[i] == ",":
                    i += 1
                    continue
                v, i = parse_value(i)
                out.append(v)
            return out, i + 1
        return atom(tok), i + 1

    def parse_dict(i):
        out = {}
        while tokens[i] != "}":
            if tokens[i] == ",":
                i += 1
                continue
            key = tokens[i][1:-1] if tokens[i].startswith('"') else tokens[i]
            i += 1
            if tokens[i] in ("=", ":"):
                i += 1
            v, i = parse_value(i)
            out[key] = v
        return out, i + 1

    tokens.append("}")
    return parse_dict(0)[0]


def load_torch_checkpoint(model_path: str, latent_path: str, skip_in=(4,), dtype=None, device=None):
    """Load published IGR checkpoints (``ModelParameters/*.pth`` with a
    ``model_state_dict`` of ``lin{i}.weight/bias``, or its weight-norm form
    ``weight_g``/``weight_v``; ``LatentCodes/*.pth`` with ``latent_codes``).

    Both go to ``device`` (None: CUDA, raising without it; "cpu" for the
    plain path). Returns (ImplicitNet, latent_codes (n_shapes, L))."""
    dtype = dtype or default_dtype()
    device = resolve_device(device)
    sd = torch.load(model_path, map_location="cpu")["model_state_dict"]
    clean = {k.replace("module.", ""): v for k, v in sd.items()}
    ws, bs = [], []
    idx = 0
    while f"lin{idx}.weight" in clean or f"lin{idx}.weight_g" in clean:
        if f"lin{idx}.weight_g" in clean:
            # weight-norm parametrization: w = g * v / |v|
            g, v = clean[f"lin{idx}.weight_g"], clean[f"lin{idx}.weight_v"]
            w = g * v / torch.linalg.norm(v, dim=1, keepdim=True)
        else:
            w = clean[f"lin{idx}.weight"]
        ws.append(w.detach().to(torch.float64).numpy())
        bs.append(clean[f"lin{idx}.bias"].detach().to(torch.float64).numpy())
        idx += 1
    net = ImplicitNet.from_arrays(ws, bs, skip_in=tuple(skip_in), dtype=dtype, device=device)

    lat = torch.load(latent_path, map_location="cpu")["latent_codes"]
    if hasattr(lat, "weight"):  # nn.Embedding
        lat = lat.weight
    elif isinstance(lat, dict) and "weight" in lat:
        lat = lat["weight"]
    return net, lat.detach().to(dtype=dtype, device=device)


def load_igr_experiment(experiment_dir: str, timestamp: str = "latest", checkpoint: str = "latest",
                        dtype=None, device=None):
    """Resolve an IGR experiment directory like the reference
    (``utils.py:286-327``): the latest timestamp directory, its exp.conf
    (skip_in) and the ModelParameters / LatentCodes checkpoints.

    On ``device`` as ``load_torch_checkpoint``. Returns (ImplicitNet,
    latent_codes, conf_dict)."""
    device = resolve_device(device)
    if timestamp == "latest":
        timestamps = sorted(os.listdir(experiment_dir))
        if not timestamps:
            raise FileNotFoundError(f"no timestamp dirs in {experiment_dir}")
        timestamp = timestamps[-1]
    with open(os.path.join(experiment_dir, timestamp, "exp.conf")) as f:
        conf = _parse_hocon_lite(f.read())
    skip_in = tuple(conf["network"]["inputs"].get("skip_in", [4]))
    ckpt_dir = os.path.join(experiment_dir, timestamp, "checkpoints")
    net, codes = load_torch_checkpoint(
        os.path.join(ckpt_dir, "ModelParameters", f"{checkpoint}.pth"),
        os.path.join(ckpt_dir, "LatentCodes", f"{checkpoint}.pth"),
        skip_in=skip_in, dtype=dtype, device=device,
    )
    return net, codes, conf
