"""Carry bodies, world state and contacts across as numpy dicts.

The JAX package and this port agree on what a body, a world state and a
contact buffer hold; this module fixes the dict layout between them, so a
test can feed both implementations identical inputs. It takes and returns
numpy only: the caller converts the JAX side with ``np.asarray``.

Layouts:

- body: ``shape`` (shape class name), the shape's parameters under their
  field names (``rad``, ``dims``, ``r``, ``height``; ``grid``, ``scale_``
  for a grid body; ``verts2d``, ``scale_`` for a 2D hull body; ``grid``,
  ``scale_``, ``coord_scale`` for a 2D grid body; ``latent``, ``scale_``
  for a latent body, whose decoder
  is carried as ``weights`` and ``biases`` (lists of (out, in) and (out,)
  arrays) and ``skip_in``), ``verts`` (V,3),
  ``faces`` (F,3), ``mass``, ``ang_inertia`` (3,3), ``restitution``,
  ``fric_coeff``, ``is_sdf``, and ``lanes`` for a seed sweep's lane body
  (every array but ``faces`` then carries the lane axis first; 0 or absent
  for one body). A JAX marching body's dict may hold ``face_valid`` (F,):
  its triangle soup padded with invalid triangles, which the port's body
  does not hold (``body_from_numpy`` keeps the valid ones, in order);
- contacts: ``normal``, ``p1``, ``p2`` (K,3), ``pen``, ``valid``, ``i1``,
  ``i2``, ``pair_id`` (K,), ``max_pen_all`` (), ``pair_active`` (P,);
- state: ``quat`` (B,4), ``pos`` (B,3), ``v`` (B,6), ``t``, ``last_dt``,
  ``had_toc`` and ``contacts`` (a contacts dict); a seed sweep's state has
  the lane axis first on every array (the dicts carry any shape).

The ``*_from_numpy`` entry points keep the arrays' float dtype: a JAX
body, contact buffer or state in float32 (the JAX package's accelerator
dtype) comes across in float32, one in float64 in float64, unless the
caller names a dtype.

The trained shape space's cache file (``read_space`` / ``write_space``) is
the JAX package's ``models/igr_train.load_or_train`` pickle: a dict of
``weights`` and ``biases`` (lists of numpy arrays), ``skip_in`` (list),
``d_in`` (int) and ``codes`` (numpy), so a cache written by one package
loads in the other.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from .config import default_dtype, resolve_device
from .models.igr import ImplicitNet
from .physics import shapes as shapes_mod
from .physics.bodies import BodyDef
from .physics.contacts import Contacts
from .physics.world import WorldState
from .physics2d import facade as facade2d

_SHAPES = {
    cls.__name__: cls
    for cls in (
        shapes_mod.SphereShape, shapes_mod.BoxShape, shapes_mod.RoundedBoxShape,
        shapes_mod.CylinderShape, shapes_mod.BrickShape, shapes_mod.BowlShape, shapes_mod.GridShape,
        shapes_mod.LatentShape, facade2d.HullShape, facade2d.GridShape2D,
    )
}
_CONTACT_INT = ("i1", "i2", "pair_id")
_CONTACT_BOOL = ("valid", "pair_active")


def _t(x, device, dtype):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _float_dtype(x, dtype):
    """``dtype``, or where it is None the dtype of the numpy array ``x``:
    float32 for float32 arrays (the JAX package's accelerator dtype),
    float64 otherwise."""
    if dtype is not None:
        return dtype
    return torch.float32 if np.asarray(x).dtype == np.float32 else torch.float64


def body_from_numpy(d: dict, device=None, dtype=None) -> BodyDef:
    """A body from its numpy dict, on ``device`` (None: CUDA, raising
    without it; pass "cpu" for the plain path), in ``dtype`` (None: the
    dtype of its verts)."""
    device = resolve_device(device)
    dtype = _float_dtype(d["verts"], dtype)
    cls = _SHAPES[d["shape"]]
    kw = {f.name: _t(d[f.name], device, dtype) for f in dataclasses.fields(cls) if f.name != "decoder"}
    if cls is shapes_mod.LatentShape:
        kw["decoder"] = ImplicitNet.from_arrays(d["weights"], d["biases"], tuple(int(i) for i in d["skip_in"]),
                                                dtype=dtype, device=device)
    verts, faces = np.asarray(d["verts"]), np.asarray(d["faces"], dtype=np.int64)
    if d.get("face_valid") is not None:
        used = faces[np.asarray(d["face_valid"], dtype=bool)].reshape(-1)
        verts, faces = verts[used], np.arange(used.size, dtype=np.int64).reshape(-1, 3)
    return BodyDef(
        shape=cls(**kw),
        verts=_t(verts, device, dtype),
        faces=faces,
        mass=_t(d["mass"], device, dtype),
        ang_inertia=_t(d["ang_inertia"], device, dtype),
        restitution=_t(d["restitution"], device, dtype),
        fric_coeff=_t(d["fric_coeff"], device, dtype),
        is_sdf=bool(d["is_sdf"]),
        lanes=int(d.get("lanes", 0)),
    )


def body_to_numpy(bd: BodyDef) -> dict:
    out = {"shape": type(bd.shape).__name__, "faces": np.asarray(bd.faces), "is_sdf": bd.is_sdf, "lanes": bd.lanes}
    for f in dataclasses.fields(bd.shape):
        value = getattr(bd.shape, f.name)
        if isinstance(value, ImplicitNet):
            p = value.params()
            out.update(weights=[w.detach().cpu().numpy() for w in p.weights],
                       biases=[b.detach().cpu().numpy() for b in p.biases], skip_in=list(p.skip_in))
        else:
            out[f.name] = value.detach().cpu().numpy()
    for name in ("verts", "mass", "ang_inertia", "restitution", "fric_coeff"):
        out[name] = getattr(bd, name).detach().cpu().numpy()
    return out


def contacts_from_numpy(d: dict, device=None, dtype=None) -> Contacts:
    """A contact buffer from its numpy dict, on ``device`` (as
    body_from_numpy), in ``dtype`` (None: the dtype of its ``pen``)."""
    device = resolve_device(device)
    dtype = _float_dtype(d["pen"], dtype)
    kw = {}
    for f in dataclasses.fields(Contacts):
        if f.name in _CONTACT_INT:
            kw[f.name] = _t(d[f.name], device, torch.long)
        elif f.name in _CONTACT_BOOL:
            kw[f.name] = _t(d[f.name], device, torch.bool)
        else:
            kw[f.name] = _t(d[f.name], device, dtype)
    return Contacts(**kw)


def contacts_to_numpy(c: Contacts) -> dict:
    return {f.name: getattr(c, f.name).detach().cpu().numpy() for f in dataclasses.fields(Contacts)}


def state_from_numpy(d: dict, device=None, dtype=None) -> WorldState:
    """A world state from its numpy dict, on ``device`` (as
    body_from_numpy), in ``dtype`` (None: the dtype of its ``pos``)."""
    device = resolve_device(device)
    dtype = _float_dtype(d["pos"], dtype)
    return WorldState(
        quat=_t(d["quat"], device, dtype), pos=_t(d["pos"], device, dtype), v=_t(d["v"], device, dtype),
        t=_t(d["t"], device, dtype), contacts=contacts_from_numpy(d["contacts"], device, dtype),
        last_dt=_t(d["last_dt"], device, dtype), had_toc=_t(d["had_toc"], device, torch.bool),
    )


def state_to_numpy(state: WorldState) -> dict:
    out = {
        name: getattr(state, name).detach().cpu().numpy()
        for name in ("quat", "pos", "v", "t", "last_dt", "had_toc")
    }
    out["contacts"] = contacts_to_numpy(state.contacts)
    return out


def write_space(path, net: ImplicitNet, codes) -> None:
    """Write a shape space (decoder and codes) as the cache pickle."""
    p = net.params()
    with open(path, "wb") as f:
        pickle.dump(dict(weights=[w.detach().cpu().numpy() for w in p.weights],
                         biases=[b.detach().cpu().numpy() for b in p.biases], skip_in=list(p.skip_in),
                         d_in=int(p.d_in), codes=codes.detach().cpu().numpy()), f)


def read_space(path, device=None, dtype=None):
    """(ImplicitNet, codes) from the cache pickle, on ``device`` (as
    body_from_numpy) in ``dtype`` (default: the package's)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    with open(path, "rb") as f:
        data = pickle.load(f)
    net = ImplicitNet.from_arrays([np.asarray(w) for w in data["weights"]], [np.asarray(b) for b in data["biases"]],
                                  skip_in=tuple(int(i) for i in data["skip_in"]), dtype=dtype, device=device)
    return net, _t(data["codes"], device, dtype)
