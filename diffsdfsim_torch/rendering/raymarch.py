"""SDF ray-marching depth and segmentation renderer.

PyTorch counterpart of ``diffsdfsim_tpu/rendering/raymarch.py``, which
replaces the reference's pyrender/EGL offscreen renderer
(``sdf_physics/physics3d/utils.py:107-154``, Recorder3D): the losses need
depth, segmentation masks and point clouds, and all of them fall out of
sphere-tracing the scene's SDFs directly, differentiably where the caller
asks for it.

Conventions are pyrender's (OpenGL): the camera looks along -z with y up;
pixel rays come from the intrinsics (fx, fy, cx, cy); ``camera_pose`` is
camera-to-world. Depth is the positive -z distance (pyrender's depth
buffer), so the reference's unprojection (``optim_pointcloud.py:184-187``,
the OpenGL flip) carries over unchanged.

The march is plain tensor code (the JAX package's is a ``fori_loop`` of
tensor operations, outside any Pallas kernel). A body's SDF query is its
``query_sdfs``: analytic bodies are tensor code, a ``LatentShape`` runs
kernel K4 (the fused decoder) and a ``GridShape`` kernel K5 (the fused grid
query) on CUDA tensors, one launch per body per march step.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..utils.quaternion import quat_apply, quat_invert

# each body's stand-in distance outside its bounding cube never falls below
# this, so crossing the cube never registers as a hit (hit_eps defaults to
# 1e-3)
OOB_FLOOR = 2.5e-3


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @staticmethod
    def from_yfov(yfov: float, width: int, height: int) -> "PinholeCamera":
        """pyrender.PerspectiveCamera(yfov, aspectRatio) equivalent."""
        fy = height / (2.0 * math.tan(yfov / 2.0))
        return PinholeCamera(float(fy), float(fy), width / 2.0, height / 2.0, width, height)


def _pixel_grid(cam: PinholeCamera, dtype, device):
    """(xx, yy), each (H, W): pixel column and row indices."""
    x = torch.arange(cam.width, dtype=dtype, device=device)
    y = torch.arange(cam.height, dtype=dtype, device=device)
    return torch.meshgrid(x, y, indexing="xy")


def _pixel_rays(cam: PinholeCamera, dtype, device):
    """(H W, 3) camera-frame ray directions through the pixel centres,
    unnormalized (on the z = -1 plane); OpenGL: +x right, +y up."""
    xx, yy = _pixel_grid(cam, dtype, device)
    dx = (xx + 0.5 - cam.cx) / cam.fx
    dy = -(yy + 0.5 - cam.cy) / cam.fy
    return torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1).reshape(-1, 3)


def _body_sdfs(bodies, quat, pos, pts_w):
    """(B, N): each body's world-frame SDF at pts_w (N, 3). Outside a body's
    bounding cube ``query_sdfs`` returns the constant ``scale``, which is no
    safe march step; the distance to the cube (a lower bound, the body lies
    inside it), floored at OOB_FLOOR, stands in for it there."""
    vals = []
    for b, bd in enumerate(bodies):
        loc = quat_apply(quat_invert(quat[b]), pts_w - pos[b])
        scale = bd.scale()
        inside = torch.all(torch.abs(loc) <= scale, dim=-1)
        sdf_in = bd.query_sdfs(loc, return_grads=False)
        box_d = torch.linalg.norm(torch.clamp(torch.abs(loc) - scale, min=0.0), dim=-1)
        vals.append(torch.where(inside, sdf_in, torch.clamp(box_d, min=OOB_FLOOR)))
    return torch.stack(vals, dim=0)


def scene_sdf(bodies, quat, pos, pts_w):
    """The minimum over bodies of each body's world-frame SDF at pts_w (N, 3)
    and the body that attains it, the first on ties: (sdf (N,), body (N,))."""
    stack = _body_sdfs(bodies, quat, pos, pts_w)
    return torch.amin(stack, dim=0), torch.argmin(stack, dim=0)


def _camera(camera_pose, dtype, device):
    pose = torch.as_tensor(camera_pose, dtype=dtype, device=device)
    return pose[:3, :3], pose[:3, 3]


def render_depth_seg(bodies: Sequence, quat, pos, cam: PinholeCamera, camera_pose, n_steps: int = 64,
                     max_depth: float = 40.0, hit_eps: float = 1e-3):
    """Sphere-trace the depth (H, W) and each pixel's body (H, W, int32; -1 is
    background). ``n_steps`` march steps; a ray that hits is frozen there.
    Differentiable in ``quat`` and ``pos`` (and the bodies' parameters) as
    the JAX function is; callers that need no gradient pass detached
    poses."""
    dtype, device = quat.dtype, quat.device
    R, origin = _camera(camera_pose, dtype, device)
    dirs_w = _pixel_rays(cam, dtype, device) @ R.T
    # depth is the distance along -z_cam: t in units of the normalized ray
    dirs_u = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    t = torch.zeros((dirs_u.shape[0],), dtype=dtype, device=device)
    hit = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(n_steps):
        sd = torch.amin(_body_sdfs(bodies, quat, pos, origin + t[:, None] * dirs_u), dim=0)
        t = torch.where(hit, t, t + torch.clamp(sd, min=hit_eps * 0.5))
        hit = hit | (sd < hit_eps)
    hit = hit & (t < max_depth)
    pts = origin + t[:, None] * dirs_u
    _, seg_idx = scene_sdf(bodies, quat, pos, pts)
    # pyrender's depth is -z in the camera frame
    depth = torch.where(hit, -((pts - origin) @ R)[:, 2], torch.zeros_like(t))
    seg = torch.where(hit, seg_idx, torch.full_like(seg_idx, -1))
    return depth.reshape(cam.height, cam.width), seg.reshape(cam.height, cam.width).to(torch.int32)


def get_pointcloud(depth, cam: PinholeCamera, generator: torch.Generator | None = None, noise_factor: float = 0.0,
                   noise=None):
    """Unproject a depth image to a camera-frame point cloud (H, W, 3) with
    the reference's depth-noise model, std = noise_factor * d^2
    (utils.py:81-105; x right, y down, z forward in its pixel convention).
    The standard normal draws come from ``generator`` (drawn on its device),
    or are given as ``noise`` (H, W)."""
    dtype = depth.dtype
    xx, yy = _pixel_grid(cam, dtype, depth.device)
    nx = (xx + 0.5 - cam.cx) / cam.fx
    ny = (yy + 0.5 - cam.cy) / cam.fy
    if noise_factor > 0.0 and (generator is not None or noise is not None):
        if noise is None:
            noise = torch.randn(depth.shape, generator=generator, dtype=dtype, device=generator.device)
        depth = depth + torch.as_tensor(noise, dtype=dtype).to(depth.device) * noise_factor * depth**2
    return torch.stack([nx * depth, ny * depth, depth], dim=-1)


BASE_COLORS = ((0.85, 0.35, 0.25), (0.25, 0.55, 0.85), (0.35, 0.75, 0.35), (0.85, 0.75, 0.25),
               (0.65, 0.35, 0.75), (0.75, 0.75, 0.75))


def render_color(bodies: Sequence, quat, pos, cam: PinholeCamera, camera_pose, colors=None,
                 light_dir=(0.3, -1.0, -0.5), ambient: float = 0.25, bg_color=(1.0, 1.0, 1.0), n_steps: int = 64,
                 max_depth: float = 40.0, hit_eps: float = 1e-3):
    """Lambertian color (H, W, 3) on top of the sphere tracer, in place of the
    reference's pyrender color pass (utils.py:107-154, a DirectionalLight):
    per-body albedo (``colors`` (B, 3) in [0, 1], by default distinct hues),
    one directional light (``light_dir``, world frame, pointing from the
    light) and an ambient floor. Normals are the hit body's SDF gradient.
    Returns (color (H, W, 3), depth (H, W), seg (H, W))."""
    dtype, device = quat.dtype, quat.device
    nb = len(bodies)
    if colors is None:
        colors = [BASE_COLORS[b % len(BASE_COLORS)] for b in range(nb)]
    colors = torch.as_tensor(colors, dtype=dtype, device=device)
    depth, seg = render_depth_seg(bodies, quat, pos, cam, camera_pose, n_steps, max_depth, hit_eps)
    # the world hit points from the depth buffer: the unnormalized ray has
    # z_cam = -1, so pts = o + depth dir
    R, origin = _camera(camera_pose, dtype, device)
    pts = origin + depth.reshape(-1)[:, None] * (_pixel_rays(cam, dtype, device) @ R.T)
    seg_flat = seg.reshape(-1)
    normals = torch.zeros_like(pts)
    for b, bd in enumerate(bodies):
        _, g = bd.query_sdfs(quat_apply(quat_invert(quat[b]), pts - pos[b]))
        normals = torch.where((seg_flat == b)[:, None], quat_apply(quat[b], g), normals)
    light = -torch.as_tensor(light_dir, dtype=dtype, device=device)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp(normals @ light, 0.0, 1.0)
    shade = ambient + (1.0 - ambient) * lam
    lit = (seg_flat >= 0)[:, None]
    albedo = torch.where(lit, colors[torch.clamp(seg_flat, 0, nb - 1).long()],
                         torch.as_tensor(bg_color, dtype=dtype, device=device))
    rgb = torch.where(lit, albedo * shade[:, None], albedo)
    return rgb.reshape(cam.height, cam.width, 3), depth, seg
