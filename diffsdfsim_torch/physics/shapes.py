"""Analytic SDF shapes: scale conventions, SDFs, gradients, inertias.

PyTorch counterpart of the analytic kinds in
``diffsdfsim_tpu/physics/shapes.py`` (reference SDF body subclasses,
``sdf_physics/physics3d/bodies.py:763-1060``): sphere, box, rounded box,
cylinder and brick, the kinds the Frank-Wolfe kernel K3 knows; the voxel-grid
shape, whose every query is one launch of kernel K5 (``ops/grid_cuda.py``)
on CUDA tensors;
and the shape-space shape, an IGR decoder whose values are kernel K4
(``ops/igr_cuda.py``) on CUDA tensors; and the bowl, which K3 does not know.

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
from ..ops import inertia as inertia_ops
from ..ops import sdf as sdf_ops
from ..ops import grid_cuda
from ..utils.spherical import normalize

# shape-kind tags shared with the Frank-Wolfe kernel (ops/fw_cuda.py); a
# shape the kernel does not know has kind None
KIND_NONE = -1  # body 1 is a plain mesh (no SDF queries on it)
KIND_SPHERE = 0
KIND_BOX = 1
KIND_ROUNDED_BOX = 2
KIND_CYLINDER = 3
KIND_BRICK = 4


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
    kind = None  # the Frank-Wolfe kernel's tag, None where it has none

    def to(self, device, dtype):
        """Copy with every parameter on this device and dtype."""
        return dataclasses.replace(
            self, **{f.name: _field_to(getattr(self, f.name), device, dtype) for f in dataclasses.fields(self)}
        )

    def scale(self):
        raise NotImplementedError

    def sdf(self, pts):
        raise NotImplementedError

    def sdf_grad(self, pts):
        raise NotImplementedError

    def ang_inertia(self, mass):
        return None

    def kernel_params(self):
        """Scale-normalized parameters, in the order the FW kernel reads."""
        raise NotImplementedError


@dataclasses.dataclass
class SphereShape(ShapeBase):
    rad: torch.Tensor
    kind = KIND_SPHERE

    def scale(self):
        return self.rad * 1.5

    def sdf(self, pts):
        return sdf_ops.sphere_sdf(pts, self.rad / self.scale())

    def sdf_grad(self, pts):
        return sdf_ops.sphere_sdf_grad(pts, self.rad / self.scale())

    def ang_inertia(self, mass):
        return inertia_ops.sphere_inertia(self.rad, mass)

    def kernel_params(self):
        return [self.rad / self.scale()]


@dataclasses.dataclass
class BoxShape(ShapeBase):
    dims: torch.Tensor  # (3,)
    kind = KIND_BOX

    def scale(self):
        return torch.amax(self.dims) * 1.5 / 2.0

    def sdf(self, pts):
        return sdf_ops.box_sdf(pts, self.dims / self.scale())

    def sdf_grad(self, pts):
        return sdf_ops.box_sdf_grad(pts, self.dims / self.scale())

    def ang_inertia(self, mass):
        return inertia_ops.box_inertia(self.dims, mass)

    def kernel_params(self):
        d = self.dims / self.scale()
        return [d[0], d[1], d[2]]


@dataclasses.dataclass
class RoundedBoxShape(ShapeBase):
    dims: torch.Tensor  # (3,) outer dims
    r: torch.Tensor
    kind = KIND_ROUNDED_BOX

    def scale(self):
        return torch.amax(self.dims) * 1.5 / 2.0

    def sdf(self, pts):
        s = self.scale()
        return sdf_ops.rounded_box_sdf(pts, self.r / s, (self.dims - 2 * self.r) / s)

    def sdf_grad(self, pts):
        s = self.scale()
        return sdf_ops.box_sdf_grad(pts, (self.dims - 2 * self.r) / s)

    def kernel_params(self):
        s = self.scale()
        inner = (self.dims - 2 * self.r) / s
        return [self.r / s, inner[0], inner[1], inner[2]]


@dataclasses.dataclass
class BrickShape(ShapeBase):
    dims: torch.Tensor  # (3,)
    r: torch.Tensor
    kind = KIND_BRICK

    def scale(self):
        return torch.amax(self.dims) * 1.5 / 2.0

    def sdf(self, pts):
        s = self.scale()
        return sdf_ops.brick_sdf(pts, self.dims / s, self.r / s)

    def sdf_grad(self, pts):
        return sdf_ops.box_sdf_grad(pts, self.dims / self.scale())

    def kernel_params(self):
        s = self.scale()
        d = self.dims / s
        return [d[0], d[1], d[2], self.r / s]


@dataclasses.dataclass
class CylinderShape(ShapeBase):
    rad: torch.Tensor
    height: torch.Tensor
    kind = KIND_CYLINDER

    def scale(self):
        return torch.maximum(self.rad, self.height / 2.0) * 1.5

    def sdf(self, pts):
        s = self.scale()
        return sdf_ops.cylinder_sdf(pts, self.rad / s, self.height / s)

    def sdf_grad(self, pts):
        s = self.scale()
        return sdf_ops.cylinder_sdf_grad(pts, self.rad / s, self.height / s)

    def ang_inertia(self, mass):
        return inertia_ops.cylinder_inertia(self.rad, self.height, mass)

    def kernel_params(self):
        s = self.scale()
        return [self.rad / s, self.height / s]


@dataclasses.dataclass
class BowlShape(ShapeBase):
    """Hemispherical shell of mid-radius ``r`` and half-thickness ``d``,
    opening along +z. K3 has no bowl kind: its pairs take the plain
    Frank-Wolfe search, as in the JAX package. Its mesh is the analytic
    ``bowl_mesh`` (``make_body``), which the projection cannot give."""

    r: torch.Tensor
    d: torch.Tensor

    def scale(self):
        return (self.r + self.d) * 1.3333

    def sdf(self, pts):
        s = self.scale()
        return sdf_ops.bowl_sdf(pts, self.r / s, self.d / s)

    def sdf_grad(self, pts):
        s = self.scale()
        return sdf_ops.bowl_sdf_grad(pts, self.r / s, self.d / s)


@dataclasses.dataclass
class GridShape(ShapeBase):
    """Voxel-grid SDF body (reference SDFGrid3D, bodies.py:763-775): ``grid``
    holds normalized-frame distances on a regular lattice over [-1, 1]^3,
    ``scale_`` is the metric half-extent. The grid takes no gradient. Its
    queries (``sdf``, ``sdf_grad`` and ``query_sdfs``) go through
    ``grid_cuda.grid_query``: one K5 launch each on CUDA, the plain
    ``ops/sdf.grid_query`` on the CPU. A seed sweep's lane body maps them
    over its lanes (``torch.func.vmap``): one K5 lane-entry launch for all
    lanes on CUDA."""

    grid: torch.Tensor  # (X, Y, Z)
    scale_: torch.Tensor  # ()

    def scale(self):
        return self.scale_

    def sdf(self, pts):
        return grid_cuda.grid_query(pts, self.grid, return_grads=False)

    def sdf_grad(self, pts):
        return grid_cuda.grid_query(pts, self.grid)[1]


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
    if isinstance(shape, GridShape):
        return grid_cuda.grid_query(pts_loc, shape.grid, shape.scale_, return_grads)
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
