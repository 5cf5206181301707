"""Real-world RGB-D fitting: an object's size and starting pose from recorded
frames.

PyTorch counterpart of ``diffsdfsim_tpu/experiments/optim_pointcloud_real.py``
(re-creation of the reference's ``experiments/trajectory_fitting/
optim_pointcloud_real.py``): recorded RGB-D frames (point clouds,
segmentation and camera poses, pickled) are fitted with a simulated scene
whose static geometry (floor, walls) is built from planes in the data (the
reference poses SDFBox walls from plane parameters, :98-149), and whose
sphere's size and initial pose are optimized with the squared-SDF point-cloud
loss, the simulation matched to the recording's timestamps frame by frame
(reference :199-225). The optimizer is Adam by optax's rule
(``fitting.Adam``) on the packed parameters [size, pos0 (3), rotv (3)].

Data (a pickle, the JAX package's format): a dict with
    frames: a list of {t, points (N, 3) camera frame, seg (N,) bool, cam_pose (4, 4)}
    planes: optional, a list of (normal (3,), offset) world-frame planes
Without planes the dominant plane is fitted to the first three frames'
non-object points by least squares.

Run: python -m diffsdfsim_torch.experiments.optim_pointcloud_real with data_path=real_world_data.pkl
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..config import SimConfig, default_dtype, resolve_device
from ..physics import BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world, query_sdfs, rollout
from ..utils.quaternion import matrix_to_quat, quat_apply, quat_exp_map, quat_invert
from .common import Run, parse_cli
from .fitting import Adam

DEFAULTS = dict(
    seed=0,
    data_path="real_world_data.pkl",
    max_iter=80,
    lr=1e-2,
    mesh_subdiv=2,
    wall_thickness=1.0,
    base_dir="outputs",
)


def build_cfg(c, dtype=None) -> SimConfig:
    f32 = (dtype or default_dtype()) == torch.float32
    return SimConfig(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=c["mesh_subdiv"],
                     max_substeps=3, max_bisect=6, tol=1e-5 if f32 else 1e-8)


def estimate_plane(points: np.ndarray):
    """The least-squares dominant plane (normal, offset), n.x = d, its normal
    oriented +y-ish (a floor faces up)."""
    c = points.mean(axis=0)
    _, _, vt = np.linalg.svd(points - c, full_matrices=False)
    n = vt[-1]
    if n[1] < 0:
        n = -n
    return n, float(n @ c)


def wall_from_plane(normal, offset, thickness, extent=20.0, device=None, dtype=None):
    """A box whose +normal face lies on the plane n.x = d (reference
    :98-149). Returns (BodyDef, pose (7,))."""
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    # the rotation taking +y to n
    y = np.array([0.0, 1.0, 0.0])
    v = np.cross(y, n)
    s = np.linalg.norm(v)
    cth = float(y @ n)
    if s < 1e-9:
        R = np.eye(3) if cth > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx * ((1 - cth) / s**2)
    q = matrix_to_quat(torch.tensor(R, dtype=dtype, device=device))
    center = n * (offset - thickness / 2.0)
    body = make_body(BoxShape(torch.tensor([extent, thickness, extent])), subdiv=3, device=device, dtype=dtype)
    return body, torch.cat([q, torch.tensor(center, dtype=dtype, device=device)])


def synthetic_recording(path, r_target=0.62, n_frames=5):
    """Write a recording in the format above (a pickle) of a sphere of radius
    ``r_target`` resting on a floor plane, as ``tests/test_pointcloud_real.py``
    builds one (its random draws too): per frame 160 object points (the
    upper hemisphere a camera sees) and 120 floor points, the identity as
    camera pose, no planes. Returns r_target."""
    rng = np.random.default_rng(0)
    frames = []
    center = np.array([0.1, r_target, -0.2])
    for i in range(n_frames):
        dirs = rng.standard_normal((160, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        dirs[:, 1] = np.abs(dirs[:, 1])
        obj_pts_w = center + r_target * dirs
        fx = rng.uniform(-2, 2, size=(120, 1))
        fz = rng.uniform(-2, 2, size=(120, 1))
        floor_pts_w = np.concatenate([fx, np.zeros_like(fx), fz], axis=1)
        pts_w = np.concatenate([obj_pts_w, floor_pts_w])
        seg = np.concatenate([np.ones(160, bool), np.zeros(120, bool)])
        # the camera pose is the identity: the loader applies the GL flip
        frames.append(dict(t=i * (1.0 / 30.0), points=(pts_w * np.array([1.0, -1.0, -1.0])).astype(np.float64),
                           seg=seg, cam_pose=np.eye(4)))
    with open(path, "wb") as f:
        pickle.dump(dict(frames=frames), f)
    return r_target


def load_data(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def scene(data, c, device=None, dtype=None):
    """The recording's static walls (bodies, poses) and its object
    observations [(t, world points (N, 3), mask (N,))]."""
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    frames = data["frames"]
    planes = data.get("planes")
    if not planes:
        bg = np.concatenate([np.asarray(f["points"])[~np.asarray(f["seg"])] for f in frames[:3]])
        planes = [estimate_plane(bg)]
    walls, poses = [], []
    for n, d in planes:
        b, p = wall_from_plane(n, d, c["wall_thickness"], device=device, dtype=dtype)
        walls.append(b)
        poses.append(p)
    obs = []
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=dtype, device=device)
    for f in frames:
        pts = torch.tensor(np.asarray(f["points"]), dtype=dtype, device=device)
        T = torch.tensor(np.asarray(f["cam_pose"]), dtype=dtype, device=device)
        pts_w = (pts * flip) @ T[:3, :3].T + T[:3, 3]
        obs.append((float(f["t"]), pts_w, torch.tensor(np.asarray(f["seg"]), device=device)))
    return walls, poses, obs


def sim_traj(params, walls, poses, obs, c, cfg, device=None):
    """The rollout of the walls and a sphere of size params[0] starting at
    (quat_exp_map(rotv), pos0), over the recording's time span."""
    size, pos0, rotv = params[0], params[1:4], params[4:7]
    dtype = params.dtype
    body = make_body(SphereShape(size), subdiv=c["mesh_subdiv"], device=device, dtype=dtype)
    all_poses = torch.stack(poses + [torch.cat([quat_exp_map(rotv), pos0])])
    spec, state = make_world(walls + [body], all_poses, torch.zeros((len(walls) + 1, 6), dtype=dtype, device=device),
                             joints=tuple(TotalConstraint3D(body1=i) for i in range(len(walls))),
                             forces=tuple(() for _ in walls) + ((Gravity3D(10.0),),), cfg=cfg, device=device)
    n_frames = max(int(round((obs[-1][0] - obs[0][0]) / cfg.dt)) + 1, 1)
    return rollout(spec, state, n_frames)[1]


def loss_fn(params, walls, poses, obs, c, cfg, device=None):
    """The mean over the recording's frames of the mean squared SDF of the
    object's points in the sphere's frame, each frame matched to the
    simulated frame nearest its time."""
    traj = sim_traj(params, walls, poses, obs, c, cfg, device)
    shape = SphereShape(params[0])
    sim_t = traj.t[:, 0] + obs[0][0]
    nb = len(walls)
    total = 0.0
    for t_o, pts_w, seg in obs:
        i = torch.argmin(torch.abs(sim_t - t_o)).reshape(1)
        body_pos = traj.pos[:, 0, nb].index_select(0, i)[0]
        body_quat = traj.quat[:, 0, nb].index_select(0, i)[0]
        sdfs = query_sdfs(shape, quat_apply(quat_invert(body_quat), pts_w - body_pos), return_grads=False)
        sq = torch.where(seg, sdfs**2, torch.zeros_like(sdfs))
        total = total + torch.sum(sq) / torch.clamp(torch.sum(seg), min=1)
    return total / len(obs)


def main(argv=None, device=None):
    c = parse_cli(DEFAULTS, argv)
    device = resolve_device(device)
    dtype = default_dtype()
    cfg = build_cfg(c)
    run = Run("pointcloud_real", c, base_dir=c["base_dir"])
    walls, poses, obs = scene(load_data(c["data_path"]), c, device, dtype)
    # the start: size 0.5, the centroid of the object's first-frame points,
    # no rotation
    init_pos = torch.mean(obs[0][1][obs[0][2]], dim=0)
    x = torch.cat([torch.tensor([0.5], dtype=dtype, device=device), init_pos,
                   torch.zeros(3, dtype=dtype, device=device)])
    opt = Adam(c["lr"])
    state = opt.init(x)
    for i in range(c["max_iter"]):
        xg = x.clone().requires_grad_(True)
        val = loss_fn(xg, walls, poses, obs, c, cfg, device)
        (g,) = torch.autograd.grad(val, xg)
        upd, state = opt.update(g, state)
        x = x + upd
        run.log_scalar("loss", float(val.detach()), i)
    out = dict(size=x[0].cpu().numpy(), pos0=x[1:4].cpu().numpy(), rot0=x[4:7].cpu().numpy())
    run.save_output(out)
    run.finish()
    print("fitted size:", float(x[0]))
    return out


if __name__ == "__main__":
    main()
