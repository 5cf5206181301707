"""Equality constraints (joints) for the 3D world: the one the benchmark's
worlds use, a body fixed in place (reference
``sdf_physics/physics3d/constraints.py``). A joint exposes ``rows(state) ->
(J1 (r,6), J2 (r,6) | None)`` with static body indices; the engine
assembles Je (neq, 6B). Velocity layout per body is [omega(3), v(3)].
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TotalConstraint3D:
    """constraints.py:131-145: blocks all motion (J = I6)."""

    body1: int
    body2: int | None = None
    num_constraints: int = 6

    def rows(self, state):
        return torch.eye(6, dtype=state.pos.dtype, device=state.pos.device), None
