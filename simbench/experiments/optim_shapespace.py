"""The port's side of the optim_shapespace configurations.

The decoder is the port's ``ImplicitNet`` holding the weights the benchmark
drew; each lane's world is built by the port's ``optim_shapespace.
build_world`` and the lanes are stepped by its ``make_world_batched`` /
``rollout_batched``: ``optim_shapespace.simulate_batched`` written out, so
that the run keeps the spec and its counters.
"""

from __future__ import annotations

import torch
from diffsdfsim_torch.experiments import optim_shapespace as oss
from diffsdfsim_torch.models.igr import ImplicitNet
from diffsdfsim_torch.physics import make_world_batched, rollout_batched, trajectory_lanes_first

from .optim_sphere import check_sim


KERNELS = {"rollout": ("pdipm_fwd", "igr_mlp")}


def port_options(config: dict) -> dict:
    d = config["decoder"]
    return dict(oss.DEFAULTS, n_par=config["lanes"], run_time=config["run_time"], latent_size=d["latent_size"],
                scale=config["body"]["scale"], mesh_subdiv=config["body"]["mesh_subdiv"])


def check_scene(config: dict):
    """Raise where the configuration states a scene the port's
    ``build_world`` does not build (its floor, drop and projection steps
    are fixed in the port's code)."""
    want = dict(floor=[20.0, 1.0, 20.0], floor_pos=[0.0, -0.5, 0.0], pos=[0.0, 2.0, 0.0],
                vel=[0.0, 0.0, 0.0, 1.0, 0.0, 0.0], project_iters=16, floor_subdiv=3,
                gravity=10.0)
    got = dict(floor=config["floor"]["dims"], floor_pos=config["floor"]["pos"], pos=config["body"]["pos"],
               vel=config["body"]["vel"], project_iters=config["body"]["project_iters"],
               floor_subdiv=config["floor"]["subdiv"], gravity=config["gravity"])
    if got != want:
        raise ValueError(f"the configuration's scene {got} is not the one the port's build_world builds {want}")


class Program:
    def __init__(self, config: dict, device, dtype, weights, biases, codes):
        """``weights``, ``biases``, ``codes``: the decoder the benchmark drew
        (``simbench.inputs.decoder_weights``)."""
        check_scene(config)
        self.config, self.device, self.dtype = config, device, dtype
        self.c = port_options(config)
        self.cfg = oss.build_cfg(self.c, dtype)
        check_sim(self.cfg, config, dtype)
        self.frames = oss.n_frames(self.c, self.cfg)
        d = config["decoder"]
        net = ImplicitNet(3 + d["latent_size"], d["dims"], d["skip_in"], beta=d["beta"], dtype=dtype).to(device)
        with torch.no_grad():
            for i, (w, b) in enumerate(zip(weights, biases)):
                getattr(net, f"lin{i}").weight.copy_(w)
                getattr(net, f"lin{i}").bias.copy_(b)
        self.decoder, self.codes = net, codes.to(device=device, dtype=dtype)
        self.body = 1

    def rollout(self, draws, span):
        """(spec, lanes-first trajectory) of the lanes' drops, untaped."""
        with torch.no_grad():
            latents = self.codes[draws["code"].to(self.device)]
            quats = draws["rotation"].to(device=self.device, dtype=self.dtype)
            with span("world"):
                spec, bodies_b, state_b = make_world_batched(
                    lambda z, q: oss.build_world(z, q, self.decoder, self.c, self.cfg, self.device), latents, quats)
            with span("rollout"):
                traj = rollout_batched(spec, bodies_b, state_b, self.frames)[1]
            return spec, trajectory_lanes_first(traj)
