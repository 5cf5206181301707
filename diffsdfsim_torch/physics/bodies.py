"""Body definitions: shape + surface mesh + mass properties.

PyTorch counterpart of ``diffsdfsim_tpu/physics/bodies.py``. ``make_body``
builds the surface mesh by template projection (``ops/surface.py``), as an
analytic mesh (``custom_mesh``, and always for a bowl;
``physics/analytic_meshes.py``), by marching tetrahedra (``mesher=
"marching"``; ``ops/marching.py``), or takes explicit verts/faces for a
plain mesh body, and computes Mirtich inertia (or the analytic inertia with
``custom_inertia``). A marching body holds only the triangles extracted: the
JAX package's padding triangles (parked at the origin and masked by
``face_valid``) are not made, so none can reach a contact candidate.

A body of a seed sweep (``physics/batched.py``) has a leading lane axis on
every tensor (``lanes`` > 0): ``verts`` (L, V, 3), ``mass`` (L,),
``ang_inertia`` (L, 3, 3), ``restitution``, ``fric_coeff`` and the shape's
tensor parameters (L, ...), with one topology (``faces``) for all lanes and
a shape's non-tensor field (a latent shape's decoder) shared by every lane.
Its SDF queries and scale map the single-body code over the lanes
(``torch.func.vmap``); the points of a query carry the lane axis first. A
latent lane body's query is one decoder call for all lanes: on the card
one K4 launch, through the launch's vmap rule (``ops/igr_cuda.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Defaults3D, default_dtype, resolve_device
from ..ops.inertia import ang_inertia_from_mesh
from ..ops.surface import surface_mesh
from ..utils import meshes
from .shapes import (KIND_NONE, BowlShape, BoxShape, CylinderShape, GridShape, LatentShape, ShapeBase, SphereShape,
                     query_sdfs)


@dataclasses.dataclass
class BodyDef:
    shape: ShapeBase
    verts: torch.Tensor  # (V,3) metric local frame
    faces: np.ndarray  # (F,3) static topology
    mass: torch.Tensor  # ()
    ang_inertia: torch.Tensor  # (3,3) body frame
    restitution: torch.Tensor  # ()
    fric_coeff: torch.Tensor  # ()
    is_sdf: bool = True
    faces_t: torch.Tensor = None  # (F,3) int64 copy of faces on the body's device
    lanes: int = 0  # leading lane axis of every tensor above (0: one body)

    def __post_init__(self):
        if self.faces_t is None:
            self.faces_t = torch.as_tensor(
                np.asarray(self.faces, dtype=np.int64), device=self.verts.device
            )

    @property
    def kind(self) -> int:
        """Frank-Wolfe kernel kind tag of body 1 in a directed pair."""
        return self.shape.kind if self.is_sdf else KIND_NONE

    def scale(self):
        if self.lanes:
            return torch.func.vmap(lambda p: self._lane_shape(p).scale())(self.shape_params())
        return self.shape.scale()

    def query_sdfs(self, pts_loc, return_grads=True):
        """Metric local-frame SDF query; a lane body's points carry its lane
        axis first."""
        if self.lanes:
            return torch.func.vmap(lambda p, x: query_sdfs(self._lane_shape(p), x, return_grads=return_grads))(
                self.shape_params(), pts_loc)
        return query_sdfs(self.shape, pts_loc, return_grads=return_grads)

    def shape_params(self) -> dict:
        """The shape's tensor parameters by field name (a non-tensor field,
        a latent shape's decoder, stays with the shape)."""
        fields = ((f.name, getattr(self.shape, f.name)) for f in dataclasses.fields(self.shape))
        return {k: v for k, v in fields if isinstance(v, torch.Tensor)}

    def _lane_shape(self, params):
        return dataclasses.replace(self.shape, **params)

    def tensors(self) -> dict:
        """The body's parameters by name: every tensor that may carry a lane
        axis, the shape's tensor fields under ``shape.<field>``."""
        out = {name: getattr(self, name) for name in LANE_FIELDS}
        out.update({f"shape.{k}": v for k, v in self.shape_params().items()})
        return out

    def with_tensors(self, tensors: dict, lanes: int) -> "BodyDef":
        """This body with its tensors replaced (``tensors()``'s keys)."""
        shape = dataclasses.replace(self.shape, **{k[6:]: v for k, v in tensors.items() if k.startswith("shape.")})
        return dataclasses.replace(self, shape=shape, lanes=lanes,
                                   **{k: v for k, v in tensors.items() if not k.startswith("shape.")})

    def face_tris(self, face_idx):
        """Body-frame corners (..., 3, 3) of the faces ``face_idx``; for a
        lane body ``face_idx`` carries the lane axis first."""
        if self.lanes:
            lane = torch.arange(self.lanes, device=face_idx.device).reshape((-1,) + (1,) * face_idx.dim())
            return self.verts[lane, self.faces_t[face_idx]]
        return self.verts[self.faces_t[face_idx]]

    def lane(self, i: int) -> "BodyDef":
        """Lane i of a lane body, as one body (differentiable into it)."""
        return self.with_tensors({k: v[i] for k, v in self.tensors().items()}, 0)

    def repeat_lanes(self, d: int) -> "BodyDef":
        """The lane body with each lane repeated d times (lane-major), one
        lane per pose of a probe stage of d rungs."""
        return self.with_tensors({k: v.repeat_interleave(d, dim=0) for k, v in self.tensors().items()},
                                 self.lanes * d)


LANE_FIELDS = ("verts", "mass", "ang_inertia", "restitution", "fric_coeff")


def stack_lanes(bodies: Sequence[BodyDef]) -> BodyDef:
    """One body per lane -> a lane body. The lanes must share their shape
    class, SDF flag, topology and the shape's non-tensor fields (a latent
    shape's decoder, by identity). A body whose tensors are equal in every
    lane, none requiring grad, stays one body that every lane shares. A
    body that differs between lanes may be analytic or latent (its latent
    code and scale per lane); a grid body may not."""
    b0 = bodies[0]
    statics = [{f.name: getattr(bd.shape, f.name) for f in dataclasses.fields(bd.shape)
                if not isinstance(getattr(bd.shape, f.name), torch.Tensor)} for bd in bodies]
    for bd, st in zip(bodies[1:], statics[1:]):
        if type(bd.shape) is not type(b0.shape) or bd.is_sdf != b0.is_sdf or not np.array_equal(bd.faces, b0.faces):
            raise ValueError("lanes must share each body's shape class, SDF flag and faces")
        if any(st[k] is not v for k, v in statics[0].items()):
            raise ValueError(f"lanes must share a {type(b0.shape).__name__}'s {sorted(statics[0])} as one object")
    ts = [bd.tensors() for bd in bodies]

    def shared(a, b):
        return not (a.requires_grad or b.requires_grad) and torch.equal(a, b)

    if all(shared(tt[k], ts[0][k]) for tt in ts[1:] for k in tt):
        return b0
    if b0.shape.kind is None and not isinstance(b0.shape, LatentShape):
        raise NotImplementedError(
            f"a {type(b0.shape).__name__} body that differs between lanes: lanes take the analytic and latent shapes")
    return b0.with_tensors({k: torch.stack([tt[k] for tt in ts]) for k in ts[0]}, len(bodies))


def make_body(
    shape: ShapeBase,
    mass=1.0,
    restitution=Defaults3D.RESTITUTION,
    fric_coeff=Defaults3D.FRIC_COEFF,
    custom_inertia: bool = Defaults3D.CUSTOM_INERTIA,
    custom_mesh: bool = Defaults3D.CUSTOM_MESH,
    template: str = "auto",
    subdiv: int = 3,
    project_iters: int = 12,
    verts=None,
    faces: Optional[np.ndarray] = None,
    mesher: str = "template",
    grid_res: int = 16,
    max_tris: Optional[int] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> BodyDef:
    """Build a BodyDef from a shape.

    ``template`` picks the projection template: 'ico' (icosphere) or 'cube'
    (cube-sphere); 'auto' takes 'ico' for spheres and 'cube' otherwise.
    ``custom_mesh`` takes the analytic mesh of a box, sphere or cylinder (a
    bowl always has its own). ``mesher="marching"`` extracts the surface by
    marching tetrahedra from the shape's SDF on a ``grid_res``^3 lattice
    over [-1, 1]^3 (a grid shape's own grid), at most ``max_tris`` triangles
    (default 8 res^2), then moves each vertex by the MeshSDF correction
    v - sdf(v) n (v and n detached), so that the vertices take the shape
    parameters' gradient. Explicit ``verts``/``faces`` make a plain mesh
    body (not an SDF body). ``device=None`` means CUDA (see
    ``config.resolve_device``)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    shape = shape.to(device, dtype)
    mass = torch.as_tensor(mass, dtype=dtype, device=device)

    analytic = None
    if verts is None and (custom_mesh or isinstance(shape, BowlShape)):
        analytic = _analytic_mesh(shape, subdiv)
    if analytic is not None:
        verts, faces = analytic
        is_sdf = True
    elif verts is None and mesher == "marching":
        verts, faces = _marching_mesh(shape, grid_res, max_tris)
        is_sdf = True
    elif verts is None:
        if template == "auto":
            template = "ico" if isinstance(shape, SphereShape) else "cube"
        if template == "ico":
            tv, tf = meshes.icosphere(subdiv)
        else:
            tv, tf = meshes.cube_template(2**subdiv)
        tv = torch.as_tensor(tv, dtype=dtype, device=device)
        v_norm = surface_mesh(
            tv,
            lambda p, s: s.sdf(p),
            lambda p, s: s.sdf_grad(p),
            (shape,),
            iters=project_iters,
        )
        verts = v_norm * shape.scale()
        faces = tf
        is_sdf = True
    else:
        verts = torch.as_tensor(verts, dtype=dtype, device=device)
        faces = np.asarray(faces)
        is_sdf = False

    inertia = shape.ang_inertia(mass) if custom_inertia else None
    if inertia is None:
        inertia = ang_inertia_from_mesh(verts, faces, mass)

    return BodyDef(
        shape=shape,
        verts=verts,
        faces=faces,
        mass=mass,
        ang_inertia=inertia,
        restitution=torch.as_tensor(restitution, dtype=dtype, device=device),
        fric_coeff=torch.as_tensor(fric_coeff, dtype=dtype, device=device),
        is_sdf=is_sdf,
    )


def make_body_lanes(shape_fn, params, **kw) -> BodyDef:
    """The lane body of ``make_body(shape_fn(p), **kw)`` for each p of
    ``params`` (lane axis first), built by ``torch.func.vmap`` of the
    single-body construction: each SDF query of the mesh projection is one
    call for all lanes (one K4 launch for a latent shape on the card)."""
    single = {}

    def one(p):
        bd = make_body(shape_fn(p), **kw)
        single["body"] = bd  # its static fields: faces, SDF flag, decoder
        return bd.tensors()

    tensors = torch.func.vmap(one)(params)
    return single["body"].with_tensors(tensors, params.shape[0])


def _analytic_mesh(shape: ShapeBase, subdiv: int):
    """(verts, faces) of a shape's analytic mesh, or None for a shape that
    has none (the JAX package's choice of resolution per kind)."""
    from . import analytic_meshes as am

    if isinstance(shape, BoxShape):
        return am.box_mesh(shape.dims, n=2**subdiv)
    if isinstance(shape, SphereShape):
        return am.sphere_mesh(shape.rad, subdivisions=subdiv + 1)
    if isinstance(shape, CylinderShape):
        return am.cylinder_mesh(shape.rad, shape.height)
    if isinstance(shape, BowlShape):
        return am.bowl_mesh(shape.r, shape.d)
    return None


def _marching_mesh(shape: ShapeBase, grid_res: int, max_tris: Optional[int]):
    """(verts, faces) by marching tetrahedra and the MeshSDF correction. A
    grid shape's correction is one grid query (one K5 launch on the card)."""
    from ..ops.marching import grid_to_mesh

    with torch.no_grad():
        if isinstance(shape, GridShape):
            grid = shape.grid
        else:
            lin = torch.linspace(-1.0, 1.0, grid_res, dtype=shape.scale().dtype, device=shape.scale().device)
            pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)
            grid = shape.sdf(pts).reshape(grid_res, grid_res, grid_res)
        res = grid.shape[0]
        # a closed surface in an N^3 grid cuts O(N^2) cells; 6 tetrahedra x
        # up to 2 triangles a cut cell, with slack for oblique surfaces
        soup, faces = grid_to_mesh(grid, scale=shape.scale(), max_tris=8 * res * res if max_tris is None else max_tris)
    d, n = query_sdfs(shape, soup)
    return soup - d[:, None] * n.detach(), faces


def lane_map(fn, bodies: Sequence[BodyDef], *args):
    """``fn(bodies, *args)`` for each lane: ``torch.func.vmap`` over the lane
    bodies' tensors and the args (lane axis first), each lane seeing one
    world's bodies; a body every lane shares is passed as it is."""
    lane = [bd.tensors() if bd.lanes else {} for bd in bodies]

    def one(lane_t, *a):
        return fn([bd.with_tensors(t, 0) if bd.lanes else bd for bd, t in zip(bodies, lane_t)], *a)

    return torch.func.vmap(one)(lane, *args)
