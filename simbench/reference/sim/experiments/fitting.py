"""The per-lane trajectory losses of the fitting experiments:
``lane_losses`` is ``trajectory_loss`` of each lane of a lanes-first
``Trajectory`` (``physics/batched.trajectory_lanes_first``).
"""

from __future__ import annotations

import torch

from ..physics.world import Trajectory
from .losses import trajectory_loss


def lane(traj: Trajectory, i: int) -> Trajectory:
    """Lane i of a lanes-first Trajectory."""
    return Trajectory(*(t[i] for t in traj))


def lane_losses(traj: Trajectory, target: Trajectory, body: int):
    """(B,) ``trajectory_loss`` of each lane against its target, both
    lanes-first."""
    n = traj.pos.shape[0]
    return torch.stack([trajectory_loss(lane(traj, i), lane(target, i), body=body) for i in range(n)])
