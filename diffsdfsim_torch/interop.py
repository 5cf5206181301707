"""Carry bodies, world state and contacts across as numpy dicts.

The JAX package and this port agree on what a body, a world state and a
contact buffer hold; this module fixes the dict layout between them, so a
test can feed both implementations identical inputs. It takes and returns
numpy only: the caller converts the JAX side with ``np.asarray``.

Layouts:

- body: ``shape`` (shape class name), the shape's parameters under their
  field names (``rad``, ``dims``, ``r``, ``height``; ``grid``, ``scale_``
  for a grid body; ``latent``, ``scale_`` for a latent body, whose decoder
  is carried as ``weights`` and ``biases`` (lists of (out, in) and (out,)
  arrays) and ``skip_in``), ``verts`` (V,3),
  ``faces`` (F,3), ``mass``, ``ang_inertia`` (3,3), ``restitution``,
  ``fric_coeff``, ``is_sdf``, and ``lanes`` for a seed sweep's lane body
  (every array but ``faces`` then carries the lane axis first; 0 or absent
  for one body);
- contacts: ``normal``, ``p1``, ``p2`` (K,3), ``pen``, ``valid``, ``i1``,
  ``i2``, ``pair_id`` (K,), ``max_pen_all`` (), ``pair_active`` (P,);
- state: ``quat`` (B,4), ``pos`` (B,3), ``v`` (B,6), ``t``, ``last_dt``,
  ``had_toc`` and ``contacts`` (a contacts dict); a seed sweep's state has
  the lane axis first on every array (the dicts carry any shape).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import resolve_device
from .models.igr import ImplicitNet
from .physics import shapes as shapes_mod
from .physics.bodies import BodyDef
from .physics.contacts import Contacts
from .physics.world import WorldState

_SHAPES = {
    cls.__name__: cls
    for cls in (
        shapes_mod.SphereShape, shapes_mod.BoxShape, shapes_mod.RoundedBoxShape,
        shapes_mod.CylinderShape, shapes_mod.BrickShape, shapes_mod.GridShape, shapes_mod.LatentShape,
    )
}
_CONTACT_INT = ("i1", "i2", "pair_id")
_CONTACT_BOOL = ("valid", "pair_active")


def _t(x, device, dtype):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def body_from_numpy(d: dict, device=None, dtype=torch.float64) -> BodyDef:
    """A body from its numpy dict, on ``device`` (None: CUDA, raising
    without it; pass "cpu" for the plain path)."""
    device = resolve_device(device)
    cls = _SHAPES[d["shape"]]
    kw = {f.name: _t(d[f.name], device, dtype) for f in dataclasses.fields(cls) if f.name != "decoder"}
    if cls is shapes_mod.LatentShape:
        kw["decoder"] = ImplicitNet.from_arrays(d["weights"], d["biases"], tuple(int(i) for i in d["skip_in"]),
                                                dtype=dtype, device=device)
    return BodyDef(
        shape=cls(**kw),
        verts=_t(d["verts"], device, dtype),
        faces=np.asarray(d["faces"], dtype=np.int64),
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


def contacts_from_numpy(d: dict, device=None, dtype=torch.float64) -> Contacts:
    """A contact buffer from its numpy dict, on ``device`` (as body_from_numpy)."""
    device = resolve_device(device)
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


def state_from_numpy(d: dict, device=None, dtype=torch.float64) -> WorldState:
    """A world state from its numpy dict, on ``device`` (as body_from_numpy)."""
    device = resolve_device(device)
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
