"""Fitting an object's shape and pose to depth measurements (point clouds).

PyTorch counterpart of ``diffsdfsim_tpu/experiments/optim_pointcloud.py``
(re-creation of the reference's ``experiments/trajectory_fitting/
optim_pointcloud.py``): a body (a sphere or a rounded cube) falls under
gravity onto a fixed floor; depth images of the scene are rendered at every
frame with noise std = factor * d^2 (reference utils.py:97), segmented and
unprojected to point clouds. The fit has two phases (reference :429-656):

1. the first-frame fit: the initial position, rotation and size from frame 0;
2. the trajectory fit: the simulation rolled out from the fitted start, and
   size and pose refined against every frame's point cloud.

The loss is the mean squared SDF of the observed points in the body frame
(``match_pointcloud``, reference :166-201), over the eroded segmentation
mask, after the OpenGL camera-frame flip (reference :184-187). Observations
come from the SDF ray-marcher (``rendering/raymarch.py``) in pyrender's
camera convention. Each phase is Adam by optax's rule (``fitting.Adam``) on
the packed parameters [pos (3), quat (4), size], the quaternion
renormalized after each step, and stops on the reference's two-threshold
convergence break (:515, :644) or on a non-finite loss.

The draws (the target's size and quaternion, the start's noise and the
observations' noise) come from one ``torch.Generator`` seeded with
``seed``, in that order (``draw``); ``main`` takes them explicitly
(``draws``), so a caller can hand it the JAX package's draws.

Run: python -m diffsdfsim_torch.experiments.optim_pointcloud with shape=sphere
"""

from __future__ import annotations

import math

import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..physics import (
    BoxShape,
    Gravity3D,
    RoundedBoxShape,
    SphereShape,
    TotalConstraint3D,
    make_body,
    make_world,
    query_sdfs,
    rollout,
)
from ..rendering.raymarch import PinholeCamera, get_pointcloud, render_depth_seg
from ..utils.quaternion import quat_apply, quat_invert, random_quaternions
from .common import Run, parse_cli
from .fitting import Adam

DEFAULTS = dict(
    seed=0,
    shape="sphere",  # sphere | cube
    run_time=1.0,
    use_gravity=True,
    noise_factor=0.002,
    frame_fit_iters=60,
    traj_fit_iters=40,
    # the reference's two-threshold convergence break (optim_pointcloud.py:
    # 515, 644): |d loss| < conv_thresh and |d size| < conv_thresh_shape,
    # tested before the step; without it a sphere's unobservable rotation
    # wanders along the near-flat friction-coupling direction for the whole
    # budget and drags the position fit with it
    conv_thresh=1e-5,
    conv_thresh_shape=1e-3,
    lr_pose=1e-2,
    lr_size=1e-2,
    width=128,
    height=96,
    min_dim=0.4,
    max_dim=1.2,
    mesh_subdiv=2,
    base_dir="outputs",
)

TARGET_POS = (0.0, 2.0, 0.0)


def build_cfg(c, dtype=None) -> SimConfig:
    f32 = (dtype or default_dtype()) == torch.float32
    return SimConfig(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=c["mesh_subdiv"],
                     max_substeps=3, max_bisect=6, tol=1e-5 if f32 else 1e-8)


def n_frames(c, cfg) -> int:
    return int(round(c["run_time"] / cfg.dt))


def _make_shape(c, size):
    if c["shape"] == "sphere":
        return SphereShape(size)
    return RoundedBoxShape(torch.full((3,), 1.0, dtype=size.dtype, device=size.device) * (2 * size), size * 0.2)


def make_scene(c, cfg, size, init_pos, init_quat, device=None):
    """The fixed floor and the body of ``size`` at (init_quat, init_pos), both
    tensors that may require grad. Returns (spec, state)."""
    device = resolve_device(device)
    dtype = size.dtype
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device=device, dtype=dtype)
    body = make_body(_make_shape(c, size), subdiv=c["mesh_subdiv"], device=device, dtype=dtype)
    poses = torch.stack([torch.tensor([1.0, 0, 0, 0, 0.0, -0.5, 0.0], dtype=dtype, device=device),
                         torch.cat([init_quat, init_pos])])
    return make_world([floor, body], poses, torch.zeros((2, 6), dtype=dtype, device=device),
                      joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(10.0),) if c["use_gravity"] else ()), cfg=cfg, device=device)


def camera_setup(c, device=None, dtype=torch.float64):
    """The camera looking down at the scene from the front (the reference's
    record_results camera: z = 15, tilted; here closer, for resolution)."""
    cam = PinholeCamera.from_yfov(math.pi / 3, c["width"], c["height"])
    theta = math.pi / 8
    ct, st = math.cos(theta), math.sin(theta)
    pose = torch.tensor([[1, 0, 0, 0.0], [0, ct, -st, 2.0], [0, st, ct, 6.0], [0, 0, 0, 1.0]], dtype=dtype,
                        device=resolve_device(device))
    return cam, pose


def observe(c, spec, traj, cam, cam_pose, generator=None, noise=None):
    """Each frame's observation (t, point cloud (H, W, 3), segmentation (H,
    W)), rendered at the frame's first substep record. The depth noise's
    standard normal draws come from ``generator`` or are given as ``noise``
    (frames, H, W)."""
    frames = []
    for i in range(traj.t.shape[0]):
        depth, seg = render_depth_seg(spec.bodies, traj.quat[i, 0], traj.pos[i, 0], cam, cam_pose)
        pc = get_pointcloud(depth, cam, generator, c["noise_factor"], None if noise is None else noise[i])
        frames.append((traj.t[i, 0], pc, seg))
    return frames


def erode_mask(mask):
    """3x3 binary erosion (the reference's segmentation-mask erosion): a
    min-pool whose padding never erodes the border (the JAX package pads
    with +inf)."""
    m = mask.to(torch.float32)[None, None]
    return (-torch.nn.functional.max_pool2d(-m, 3, 1, 1))[0, 0] > 0.5


def match_pointcloud(pc, seg_mask, cam_pose, shape, pos, quat):
    """The mean squared SDF of the observed points in the body frame (the
    reference's match_pointcloud, optim_pointcloud.py:166-201)."""
    pts = pc.reshape(-1, 3)
    mask = erode_mask(seg_mask).reshape(-1) & (pts[:, 2] > 1e-6)
    # the pixel convention to the OpenGL camera frame (flip y and z), then
    # to the world
    pts_gl = pts * torch.tensor([1.0, -1.0, -1.0], dtype=pts.dtype, device=pts.device)
    pts_w = pts_gl @ cam_pose[:3, :3].T + cam_pose[:3, 3]
    sdfs = query_sdfs(shape, quat_apply(quat_invert(quat), pts_w - pos), return_grads=False)
    sq = torch.where(mask, sdfs**2, torch.zeros_like(sdfs))
    return torch.sum(sq) / torch.clamp(torch.sum(mask), min=1)


def unpack(x):
    """(pos, unit quat, size) of the packed parameters [pos, quat, size]."""
    quat = x[3:7]
    return x[:3], quat / torch.linalg.norm(quat), x[7]


def pack(pos, quat, size):
    return torch.cat([pos, quat, size.reshape(1)])


def frame_loss(x, c, obs0, seg0, cam_pose):
    """The first frame's point-cloud loss at the packed parameters x; seg0
    is the body's mask."""
    pos, quat, size = unpack(x)
    return match_pointcloud(obs0, seg0, cam_pose, _make_shape(c, size), pos, quat)


def simulate(x, c, cfg, device=None):
    """The rollout from the packed parameters x."""
    pos, quat, size = unpack(x)
    spec, state = make_scene(c, cfg, size, pos, quat, device)
    return rollout(spec, state, n_frames(c, cfg))[1]


def frame_losses(traj, x, c, obs, masks, cam_pose):
    """Each observation's point-cloud loss against the body of size x[7]
    at the trajectory's frame nearest the observation's time (the argmin
    over the frames' first substep times)."""
    shape = _make_shape(c, x[7])
    sim_t = traj.t[:, 0]
    out = []
    for (t_o, pc, _), seg in zip(obs, masks):
        i = torch.argmin(torch.abs(sim_t - t_o)).reshape(1)
        out.append(match_pointcloud(pc, seg, cam_pose, shape, traj.pos[:, 0, 1].index_select(0, i)[0],
                                    traj.quat[:, 0, 1].index_select(0, i)[0]))
    return out


def traj_loss(x, c, cfg, obs, masks, cam_pose, device=None):
    """The mean over frames of the point-cloud loss of the rollout from the
    packed parameters x (``frame_losses``, summed in frame order)."""
    loss = 0.0
    for v in frame_losses(simulate(x, c, cfg, device), x, c, obs, masks, cam_pose):
        loss = loss + v
    return loss / len(obs)


def descend_pose(loss_fn, x0, c, lr, iters, run=None, name="fit"):
    """Adam on ``loss_fn(x)`` from x0 with the quaternion renormalized after
    each step, breaking on a non-finite loss or the reference's two-threshold
    convergence test. Returns (x, losses, gradients)."""
    x = x0.detach().clone()
    opt = Adam(lr)
    state = opt.init(x)
    last_loss, last_size = 1e10, 1e10
    losses, grads = [], []
    for i in range(iters):
        xg = x.clone().requires_grad_(True)
        val = loss_fn(xg)
        (g,) = torch.autograd.grad(val, xg)
        val = float(val.detach())
        losses.append(val)
        grads.append(g)
        if run is not None:
            run.log_scalar(f"{name}_loss", val, i)
        if not math.isfinite(val):
            # diverged: keep the last finite iterate (the reference's seeds
            # hit this too; its 50-seed protocol averages over failures)
            if run is not None:
                run.log_scalar(f"{name}_nan_at", i)
            break
        if abs(last_loss - val) < c["conv_thresh"] and abs(last_size - float(x[7])) < c["conv_thresh_shape"]:
            break
        last_loss, last_size = val, float(x[7])
        upd, state = opt.update(g, state)
        x = x + upd
        x = torch.cat([x[:3], x[3:7] / torch.linalg.norm(x[3:7]), x[7:]])
    return x, losses, grads


def draw(c, dtype=None, generator=None):
    """The seed's draws in the order the fit takes them: the target's size
    (uniform in [min_dim, max_dim)) and quaternion, the start's position
    noise (3,) and quaternion noise (4,), both standard normal, and the
    generator that goes on to draw the observations' noise."""
    dtype = dtype or default_dtype()
    g = generator or torch.Generator().manual_seed(c["seed"])
    size = c["min_dim"] + (c["max_dim"] - c["min_dim"]) * torch.rand((), generator=g, dtype=dtype)
    quat = random_quaternions(1, g, dtype=dtype)[0]
    return dict(target_size=size, target_quat=quat, pos_noise=torch.randn(3, generator=g, dtype=dtype),
                quat_noise=torch.randn(4, generator=g, dtype=dtype), generator=g)


def _errors(x, target_pos, target_quat, target_size):
    """Position error (L2), rotation error (the relative angle, rad) and size
    error (abs) of the packed parameters x."""
    pos, quat, size = x[:3], x[3:7], x[7]
    dot = torch.clamp(torch.abs(torch.sum(quat * target_quat) / torch.linalg.norm(quat)), 0.0, 1.0)
    return (float(torch.linalg.norm(pos - target_pos)), float(2.0 * torch.arccos(dot)),
            abs(float(size) - float(target_size)))


def main(argv=None, device=None, draws=None):
    """The experiment: the target scene and its observations, then the
    first-frame fit and the trajectory fit. ``draws`` replaces ``draw(c)``
    (a dict of its keys; ``obs_noise`` (frames, H, W) in place of the
    generator's draws). Returns the JAX package's output dict."""
    c = parse_cli(DEFAULTS, argv)
    if c["shape"] not in ("sphere", "cube"):
        raise SystemExit(f"shape={c['shape']!r}: sphere or cube")
    device = resolve_device(device)
    dtype = default_dtype()
    cfg = build_cfg(c)
    run = Run(f"pointcloud_{c['shape']}", c, base_dir=c["base_dir"])
    dr = draw(c) if draws is None else dict(draws)
    on = lambda t: torch.as_tensor(t, dtype=dtype).to(device)  # noqa: E731
    target_size, target_quat = on(dr["target_size"]), on(dr["target_quat"])
    target_pos = on(TARGET_POS)

    # the target scene and its observations
    spec_t, state_t = make_scene(c, cfg, target_size, target_pos, target_quat, device)
    with torch.no_grad():
        _, traj_t = rollout(spec_t, state_t, n_frames(c, cfg))
        cam, cam_pose = camera_setup(c, device)
        obs = observe(c, spec_t, traj_t, cam, cam_pose, dr.get("generator"), dr.get("obs_noise"))
    masks = [seg == 1 for (_, _, seg) in obs]

    # the start (reference :381-397): the optimized rotation is a free
    # quaternion, the target's plus N(0, 0.1) on the 4-vector, renormalized
    # (~0.135 rad off the target), not an offset about the truth; the
    # position likewise perturbed by N(0, 0.1)
    init_quat = target_quat + on(dr["quat_noise"]) * 0.1
    x_init = pack(target_pos + on(dr["pos_noise"]) * 0.1, init_quat / torch.linalg.norm(init_quat),
                  on(0.5 * (c["min_dim"] + c["max_dim"])))

    # phase 1: the first frame
    _, pc0, _ = obs[0]
    x1, _, _ = descend_pose(lambda x: frame_loss(x, c, pc0, masks[0], cam_pose), x_init, c, c["lr_pose"],
                            c["frame_fit_iters"], run, "frame_fit")
    # phase 2: the trajectory
    x2, _, _ = descend_pose(lambda x: traj_loss(x, c, cfg, obs, masks, cam_pose, device), x1, c, c["lr_size"],
                            c["traj_fit_iters"], run, "traj_fit")

    errs = {name: _errors(x, target_pos, target_quat, target_size) for name, x in
            (("init", x_init), ("frame_fit", x1), ("traj_fit", x2))}
    npy = lambda t: t.detach().cpu().numpy()  # noqa: E731
    out = dict(target_size=npy(target_size), target_pos=npy(target_pos), target_quat=npy(target_quat))
    for name, x in (("init", x_init), ("frame_fit", x1), ("traj_fit", x2)):
        pe, re, se = errs[name]
        out[name] = dict(pos=npy(x[:3]), quat=npy(x[3:7]), size=npy(x[7]), pos_err=pe, rot_err=re, size_err=se)
    run.save_output(out)
    run.finish()
    for label, name in (("init  ", "init"), ("frame ", "frame_fit"), ("traj  ", "traj_fit")):
        print(f"{label} pos/rot/size err: {errs[name][0]:.4f} {errs[name][1]:.4f} {errs[name][2]:.4f}")
    return out


if __name__ == "__main__":
    main()
