"""IGR shape-space decoder (implicit geometric regularization MLP).

The IGR ``ImplicitNet`` the reference loads
(``sdf_physics/physics3d/utils.py:286-350``): a ``lin{i}`` stack of Linear
layers, Softplus(beta=100) between them, and at each ``skip_in`` layer the
network input re-concatenated and the result divided by sqrt(2). The decoder
maps (latent, pts in [-1,1]^3) -> sdf, as ``decode_igr`` does.

- ``ImplicitNet`` is an ``nn.Module`` whose layers carry IGR's state-dict
  names (``lin0.weight`` ...). Its weights are frozen: only the latent code
  is a simulation parameter.
- ``implicit_net_apply`` evaluates it in plain tensor ops;
  ``implicit_net_grad`` is the decoder's gradient with respect to the three
  point inputs, carried forward through the layers as three tangent columns
  in plain tensor ops, so ordinary autograd differentiates it again (the
  contact normals' dependence on the latent).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..config import default_dtype


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
        """(N, d_in) -> (N,)."""
        return implicit_net_apply(self.params(), x)


def _net_input(pts, latent):
    p = pts.reshape(-1, 3)
    return torch.cat([latent.expand(p.shape[0], latent.shape[-1]), p], dim=-1)


def decode(net: ImplicitNet, pts, latent):
    """decoder(pts (..., 3), latent (L,)) -> (...) (reference decode_igr)."""
    return net(_net_input(pts, latent)).reshape(pts.shape[:-1])


def decode_grad(net: ImplicitNet, pts, latent):
    """d decoder / d pts, (..., 3), differentiable in the latent."""
    return implicit_net_grad(net.params(), _net_input(pts, latent)).reshape(pts.shape)
