"""Trajectory losses shared by the experiments.

PyTorch counterpart of ``diffsdfsim_tpu/experiments/losses.py``.
``trajectory_loss`` is the nearest-time position MSE of the reference
(``experiments/trajectory_fitting/optim_sphere.py:114-160``) over the padded
(T, S) substep records: for every valid simulated record, the nearest-in-time
valid target record, the squared position error, normalized by the number of
valid records.
"""

from __future__ import annotations

import torch

from ..physics.world import Trajectory


def trajectory_loss(traj: Trajectory, target: Trajectory, body: int, with_vel: bool = False,
                    vel_weight: float = 0.0):
    st = traj.t.reshape(-1)
    sv = traj.valid.reshape(-1)
    tt = target.t.reshape(-1).to(st)
    tv = target.valid.reshape(-1).to(sv.device)

    diff = torch.abs(st[:, None] - tt[None, :]) + 1e9 * (~tv)[None, :].to(st.dtype)
    j = torch.argmin(diff, dim=1)

    spos = traj.pos.reshape(-1, traj.pos.shape[-2], 3)[:, body, :]
    tpos = target.pos.reshape(-1, target.pos.shape[-2], 3)[:, body, :].to(spos)[j]
    per = torch.sum((spos - tpos) ** 2, dim=-1)
    if with_vel and vel_weight > 0:
        svel = traj.v.reshape(-1, traj.v.shape[-2], 6)[:, body, :]
        tvel = target.v.reshape(-1, target.v.shape[-2], 6)[:, body, :].to(svel)[j]
        per = per + vel_weight * torch.sum((svel - tvel) ** 2, dim=-1)
    per = torch.where(sv, per, torch.zeros_like(per))
    return torch.sum(per) / torch.clamp(torch.sum(sv), min=1)
