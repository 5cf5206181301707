"""optim_sphere's room, built from a configuration file, on the plain path.

A sphere of radius ``rad`` thrown from the configured position and
velocity in a room of a fixed floor and wall (reference optim_sphere.py);
``rollout`` runs the lanes' worlds untaped, ``fit_step`` is one iteration
of gradient descent on the nearest-time trajectory loss against the
targets' trajectories, with the clip to the draw range.
"""

from __future__ import annotations

import torch

from .sim.config import SimConfig
from .sim.experiments.fitting import lane_losses
from .sim.physics import (BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world,
                          make_world_batched, rollout_batched, trajectory_lanes_first)


class Reference:
    def __init__(self, config: dict, device="cpu", dtype=torch.float64):
        self.config, self.device, self.dtype = config, torch.device(device), dtype
        self.cfg = SimConfig(dt=config["dt"], **config["sim"])
        self.frames = int(round(config["run_time"] / config["dt"]))
        c = config
        self.room = [make_body(BoxShape(torch.tensor(c[k]["dims"])), restitution=c["restitution"],
                               fric_coeff=c["friction"], subdiv=c[k]["subdiv"], device=self.device, dtype=dtype)
                     for k in ("floor", "wall")]
        self.body = len(self.room)

    def world(self, rad):
        c = self.config
        sphere = make_body(SphereShape(rad), restitution=c["restitution"], fric_coeff=c["friction"],
                           subdiv=c["sphere"]["mesh_subdiv"], device=self.device, dtype=self.dtype)
        poses = [[1.0, 0, 0, 0, *c[k]["pos"]] for k in ("floor", "wall")] + [[1.0, 0, 0, 0, *c["sphere"]["pos"]]]
        vels = torch.zeros((3, 6), dtype=torch.float64)
        vels[2] = torch.tensor(c["sphere"]["vel"], dtype=torch.float64)
        return make_world([*self.room, sphere], poses, vels.numpy(),
                          joints=[TotalConstraint3D(body1=0), TotalConstraint3D(body1=1)],
                          forces=[(), (), (Gravity3D(c["gravity"]),)], no_contact=[(0, 1)], cfg=self.cfg,
                          device=self.device)

    def _run(self, rads, detach: bool):
        spec, bodies_b, state_b = make_world_batched(self.world, rads)
        return trajectory_lanes_first(rollout_batched(spec, bodies_b, state_b, self.frames,
                                                      detach_2nd_bounce=detach)[1])

    def rollout(self, draws):
        """The lanes-first trajectory of the radii ``draws['rad']``, untaped
        and without the second bounce's detach (optim_sphere's targets)."""
        with torch.no_grad():
            return self._run(draws["rad"].to(self.device, self.dtype), False)

    def fit_step(self, traffic: dict, targets, starts):
        """(losses, d loss / d rad, radii after the step, the targets'
        trajectory) of one gradient-descent iteration (the traffic's
        ``lr``) from ``starts``, the radii clipped to their draw range."""
        tgt = self.rollout(targets)
        rad = starts["rad"].to(self.device, self.dtype).clone().requires_grad_(True)
        losses = lane_losses(self._run(rad, self.config["detach_2nd_bounce"]), tgt, body=self.body)
        (grad,) = torch.autograd.grad(losses.sum(), rad)
        r = self.config["draws"]["rad"]
        new = torch.clamp(rad.detach() - traffic["lr"] * grad, r["low"], r["high"])
        return dict(loss=losses.detach(), grad=grad, param=new, target=tgt)
