"""optim_shapespace's latent drop, built from a configuration file, on the
plain path: a body decoded by the IGR network at a latent code, dropped with
an initial rotation onto a fixed floor (reference optim_shapespace.py)."""

from __future__ import annotations

import torch

from .sim.config import SimConfig
from .sim.models.igr import ImplicitNet
from .sim.physics import (BoxShape, Gravity3D, LatentShape, TotalConstraint3D, make_body, make_world,
                          make_world_batched, rollout_batched, trajectory_lanes_first)


class Reference:
    def __init__(self, config: dict, weights, biases, codes, device="cpu", dtype=torch.float64):
        """``weights``, ``biases``: the decoder's per-layer (out, in) and
        (out,) tensors; ``codes``: the (n, latent) codes the draws index."""
        self.config, self.device, self.dtype = config, torch.device(device), dtype
        self.cfg = SimConfig(dt=config["dt"], **config["sim"])
        self.frames = int(round(config["run_time"] / config["dt"]))
        d = config["decoder"]
        net = ImplicitNet(3 + d["latent_size"], d["dims"], d["skip_in"], beta=d["beta"], dtype=dtype)
        with torch.no_grad():
            for i, (w, b) in enumerate(zip(weights, biases)):
                getattr(net, f"lin{i}").weight.copy_(w)
                getattr(net, f"lin{i}").bias.copy_(b)
        self.decoder, self.codes = net.to(self.device), codes.to(self.device, dtype)
        f = config["floor"]
        self.floor = make_body(BoxShape(torch.tensor(f["dims"])), subdiv=f["subdiv"], device=self.device,
                               dtype=dtype)
        self.body = 1

    def world(self, latent, quat0):
        c, b = self.config, self.config["body"]
        shape = LatentShape(latent=latent, scale_=torch.tensor(b["scale"]), decoder=self.decoder)
        body = make_body(shape, subdiv=b["mesh_subdiv"], project_iters=b["project_iters"], device=self.device,
                         dtype=self.dtype)
        vec = lambda x: torch.tensor(x, dtype=self.dtype, device=self.device)  # noqa: E731
        poses = torch.stack([vec([1.0, 0, 0, 0, *c["floor"]["pos"]]), torch.cat([quat0, vec(b["pos"])])])
        vels = torch.stack([vec([0.0] * 6), vec(b["vel"])])
        return make_world([self.floor, body], poses, vels, joints=(TotalConstraint3D(body1=0),),
                          forces=((), (Gravity3D(c["gravity"]),)), cfg=self.cfg, device=self.device)

    def rollout(self, draws):
        """The lanes-first trajectory of the codes ``draws['code']`` at the
        rotations ``draws['rotation']``."""
        with torch.no_grad():
            latents = self.codes[draws["code"].to(self.device)]
            spec, bodies_b, state_b = make_world_batched(self.world, latents,
                                                         draws["rotation"].to(self.device, self.dtype))
            return trajectory_lanes_first(rollout_batched(spec, bodies_b, state_b, self.frames)[1])
