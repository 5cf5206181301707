"""Simulation state checkpoint and restore.

PyTorch counterpart of ``diffsdfsim_tpu/utils/checkpoint.py`` (the
reference leaves ``World.save_state`` / ``load_state`` unimplemented,
``lcp_physics/physics/world.py:503-510``): any nest of tensors (a
``WorldState`` with its ``Contacts``, an optimizer's state, a trajectory) is
written to one file and restored bit for bit.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import torch

from ..config import resolve_device


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A tensor's place in a saved nest."""

    index: int


def _map(fn, x):
    """x with every tensor t replaced by fn(t), through tuples (named or
    not), lists, dicts and dataclasses, in a fixed order."""
    if isinstance(x, (torch.Tensor, _Leaf)):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map(fn, getattr(x, f.name)) for f in dataclasses.fields(x)
                                         if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return x


def _leaves(x) -> list:
    out = []
    _map(lambda t: out.append(t), x)
    return out


def save_state(path, tree):
    """Write a nest of tensors (``WorldState``, optimizer state, ...): each
    tensor as a CPU numpy array of its dtype, and the nest around them."""
    arrays = []

    def leaf(t):
        arrays.append(t.detach().cpu().numpy())
        return _Leaf(len(arrays) - 1)

    payload = {"leaves": arrays, "skeleton": pickle.dumps(_map(leaf, tree))}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_state(path, like=None, device=None):
    """Restore a nest written by ``save_state`` (only a file this program
    wrote: loading unpickles it). With ``like``, the tensors take the places,
    dtypes and devices of ``like``'s (safe against a saved nest from another
    version of its classes); otherwise the saved nest, on ``device``
    (default: the card)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    arrays = payload["leaves"]
    if like is not None:
        like_leaves = _leaves(like)
        if len(like_leaves) != len(arrays):
            raise ValueError(f"checkpoint structure mismatch: {len(arrays)} tensors, `like` has {len(like_leaves)}")
        it = iter(range(len(arrays)))
        return _map(lambda t: torch.as_tensor(arrays[next(it)], dtype=t.dtype, device=t.device), like)
    device = resolve_device(device)
    return _map(lambda leaf: torch.as_tensor(arrays[leaf.index], device=device), pickle.loads(payload["skeleton"]))
