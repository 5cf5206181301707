"""The port's side of the optim_sphere configurations.

The worlds are built by the port's ``optim_sphere.room_bodies`` and
``build_world`` and stepped by its ``make_world_batched`` /
``rollout_batched``: the calls of ``optim_sphere.make_loss_batched``
written out, so that the room takes the run's dtype (the float32 control
runs the same calls). A fit iteration is ``fitting``'s: the lanes' losses
(``lane_losses``), ``torch.autograd.grad`` of their sum, gradient
descent's update (``fitting.make_optimizer("GD", lr)``, its state carried
from one iteration to the next) and the clip of the radii to their draw
range, as ``fitting.descend`` does it.
"""

from __future__ import annotations

import torch
from diffsdfsim_torch.experiments import fitting
from diffsdfsim_torch.experiments import optim_sphere as osp
from diffsdfsim_torch.physics import make_world_batched, rollout_batched, trajectory_lanes_first


# the port's kernels each traffic unit launches (built and loaded in set-up)
KERNELS = {"rollout": ("pdipm_fwd", "fw_search"), "fit": ("pdipm_fwd", "fw_search", "kkt_bwd")}


def port_options(config: dict) -> dict:
    """The experiment's options as the port's ``optim_sphere`` names them."""
    r = config["draws"]["rad"]
    return dict(osp.DEFAULTS, n_par=config["lanes"], run_time=config["run_time"],
                mesh_subdiv=config["sphere"]["mesh_subdiv"], fric_dirs=config["sim"]["fric_dirs"],
                use_toc_diff=config["sim"]["time_of_contact_diff"], detach_2nd_bounce=config["detach_2nd_bounce"],
                min_dim=r["low"], max_dim=r["high"])


def check_sim(cfg, config: dict, dtype):
    """Raise unless the port runs what the configuration file states (in
    the configuration's own dtype; the float32 control keeps the port's
    float32 tolerance)."""
    want = dict(config["sim"], dt=config["dt"])
    if dtype == torch.float32:
        want.pop("tol")
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise ValueError(f"the port's SimConfig {got} is not the configuration's {want}")


def check_scene(config: dict):
    """Raise where the configuration states a room the port's
    ``room_bodies`` / ``build_world`` do not build (their geometry is fixed
    in the port's code)."""
    want = dict(floor=[[20.0, 1.0, 20.0], [0.0, -0.5, 0.0], 3], wall=[[1.0, 10.0, 10.0], [5.0, 5.0, 0.0], 3],
                sphere=[[0.0, 5.0, 0.0], [0.0, 0.0, 0.0, 5.0, 0.0, 0.0]], restitution=0.5, friction=0.25,
                gravity=10.0)
    got = dict(floor=[config["floor"][k] for k in ("dims", "pos", "subdiv")],
               wall=[config["wall"][k] for k in ("dims", "pos", "subdiv")],
               sphere=[config["sphere"][k] for k in ("pos", "vel")],
               **{k: config[k] for k in ("restitution", "friction", "gravity")})
    if got != want:
        raise ValueError(f"the configuration's room {got} is not the one the port builds {want}")


class Program:
    def __init__(self, config: dict, device, dtype):
        check_scene(config)
        self.config, self.device, self.dtype = config, device, dtype
        self.c = port_options(config)
        self.cfg = osp.build_cfg(self.c, dtype)
        check_sim(self.cfg, config, dtype)
        self.frames = osp.n_frames(self.c, self.cfg)
        self.room = osp.room_bodies(self.c, device, dtype)
        self.body = osp.sphere_index(self.c)

    def param(self, draws):
        return draws["rad"].to(device=self.device, dtype=self.dtype)

    def run(self, rads, detach: bool, span):
        """(spec, lanes-first trajectory) of one batched rollout."""
        with span("world"):
            spec, bodies_b, state_b = make_world_batched(
                lambda r: osp.build_world(r, self.c, self.cfg, self.device, self.room)[:2], rads)
        with span("rollout"):
            traj = rollout_batched(spec, bodies_b, state_b, self.frames, detach_2nd_bounce=detach)[1]
        return spec, trajectory_lanes_first(traj)

    def rollout(self, draws, span):
        """The targets' rollout: untaped, without the second bounce's detach."""
        with torch.no_grad():
            return self.run(self.param(draws), False, span)

    def fit_state(self, traffic: dict, targets, starts, span) -> dict:
        """The fit before its first iteration: the targets' trajectory
        (which the traffic needs), the start radii and gradient descent's
        state."""
        _, target = self.rollout(targets, span)
        x = self.param(starts)
        opt = fitting.make_optimizer("GD", traffic["lr"])
        return dict(target=target, x=x, opt=opt, opt_state=opt.init(x))

    def fit_step(self, state: dict, span):
        """One iteration from ``state`` (moved on to the next): returns
        (spec, trajectory, dict(loss, grad, param)), per lane."""
        x = state["x"]
        rad = x.clone().requires_grad_(True)
        spec, traj = self.run(rad, self.c["detach_2nd_bounce"], span)
        with span("loss"):
            losses = fitting.lane_losses(traj, state["target"], body=self.body)
        with span("backward"):
            (grad,) = torch.autograd.grad(losses.sum(), rad)
        with span("update"):
            upd, state["opt_state"] = state["opt"].update(grad, state["opt_state"])
            new = torch.clamp(x + upd, self.c["min_dim"], self.c["max_dim"])
        state["x"] = new.detach()
        return spec, traj, dict(loss=losses.detach(), grad=grad, param=new)
