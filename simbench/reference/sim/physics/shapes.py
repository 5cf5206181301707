"""SDF shapes: scale conventions, SDFs and gradients of the kinds the
benchmark's worlds build (reference SDF body subclasses,
``sdf_physics/physics3d/bodies.py:763-1060``): the sphere, the box and the
shape-space shape, an IGR decoder fed (latent, pts).

Each shape is a dataclass of tensors. ``query_sdfs`` reproduces
``SDF3D.query_sdfs`` (bodies.py:721-760): metric local points in, metric sdf
and normalized local gradients out, with the bounding-scale overlap mask
(outside: sdf = scale, grad = 0).
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ..models import igr
from ..ops import sdf as sdf_ops
from ..utils.spherical import normalize


def _same_device(a: torch.device, b) -> bool:
    """Whether device ``b`` (as given: "cuda" names the current card) is ``a``."""
    b = torch.device(b)
    if b.type == "cuda" and b.index is None:
        b = torch.device("cuda", torch.cuda.current_device())
    return a == b


def _field_to(value, device, dtype):
    """A shape field on this device and dtype: a module (the decoder) is
    copied there unless it is there already (so the lanes of a sweep share
    one decoder), anything else becomes a tensor."""
    if isinstance(value, torch.nn.Module):
        p = next(value.parameters(), None)
        if p is None or (_same_device(p.device, device) and p.dtype == dtype):
            return value
        return copy.deepcopy(value).to(device=device, dtype=dtype)
    return torch.as_tensor(value, dtype=dtype, device=device)


class ShapeBase:
    def to(self, device, dtype):
        """Copy with every parameter on this device and dtype."""
        return dataclasses.replace(
            self, **{f.name: _field_to(getattr(self, f.name), device, dtype) for f in dataclasses.fields(self)}
        )


@dataclasses.dataclass
class SphereShape(ShapeBase):
    rad: torch.Tensor

    def scale(self):
        return self.rad * 1.5

    def sdf(self, pts):
        return sdf_ops.sphere_sdf(pts, self.rad / self.scale())

    def sdf_grad(self, pts):
        return sdf_ops.sphere_sdf_grad(pts, self.rad / self.scale())


@dataclasses.dataclass
class BoxShape(ShapeBase):
    dims: torch.Tensor  # (3,)

    def scale(self):
        return torch.amax(self.dims) * 1.5 / 2.0

    def sdf(self, pts):
        return sdf_ops.box_sdf(pts, self.dims / self.scale())

    def sdf_grad(self, pts):
        return sdf_ops.box_sdf_grad(pts, self.dims / self.scale())


@dataclasses.dataclass
class LatentShape(ShapeBase):
    """Learned shape-space SDF (reference IGR decoder bodies, utils.py:286-350):
    ``decoder`` is a frozen ``models.igr.ImplicitNet`` fed (latent, pts);
    ``latent`` is the differentiable code."""

    latent: torch.Tensor  # (L,)
    scale_: torch.Tensor  # ()
    decoder: igr.ImplicitNet

    def scale(self):
        return self.scale_

    def sdf(self, pts):
        return igr.decode(self.decoder, pts, self.latent)

    def sdf_grad(self, pts):
        return igr.decode_grad(self.decoder, pts, self.latent)


def query_sdfs(shape: ShapeBase, pts_loc, return_grads: bool = True):
    """Metric local-frame SDF query (reference SDF3D.query_sdfs)."""
    scale = shape.scale()
    overlap = torch.all(torch.abs(pts_loc) <= scale, dim=-1)
    pts_in = pts_loc / scale
    sdfs_n = shape.sdf(pts_in)
    sdfs = torch.where(overlap, sdfs_n, torch.ones_like(sdfs_n)) * scale
    if not return_grads:
        return sdfs
    grads = normalize(shape.sdf_grad(pts_in))
    grads = torch.where(overlap[..., None], grads, torch.zeros_like(grads))
    return sdfs, grads
