"""Observation recorder: the reference's Recorder3D on the ray-marcher.

PyTorch counterpart of ``diffsdfsim_tpu/rendering/recorder.py`` (reference
``sdf_physics/physics3d/utils.py:65-154``): records color, depth, point
cloud, segmentation and camera pose as the world is stepped, optionally
turning the camera about an axis, with depth noise std = factor * d^2. The
frames come from the SDF ray-marcher (color from its Lambertian pass) and
are kept on the host as numpy arrays. The noise's standard normal draws
come from a ``torch.Generator`` (the JAX package splits a PRNG key per
frame; the draws differ).

Pacing is the JAX package's, bug for bug: ``prev_t`` starts at -1e9 and
only ever grows by ``dt``, so every call records a frame whatever the time
between calls (ROADMAP queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.quaternion import so3_exp_map
from .raymarch import PinholeCamera, get_pointcloud, render_color, render_depth_seg


class Recorder3D:
    def __init__(self, dt: float, cam: PinholeCamera, camera_pose, rotate: bool = False,
                 rotate_rate: float = math.pi / 3.0, rotate_axis=(0, 0, 1), record_points: bool = False,
                 record_seg: bool = False, record_color: bool = False, body_colors=None, noise_factor: float = 0.0,
                 rng_seed: int = 0, generator: torch.Generator | None = None):
        self.dt = dt
        self.cam = cam
        self.camera_pose = np.asarray(camera_pose, dtype=np.float64)
        self.rotate = rotate
        self.rotate_rate = rotate_rate
        self.rotate_axis = np.asarray(rotate_axis, dtype=np.float64)
        self.record_points = record_points
        self.record_seg = record_seg
        self.record_color = record_color
        self.body_colors = body_colors
        self.noise_factor = noise_factor
        self.generator = generator if generator is not None else torch.Generator().manual_seed(rng_seed)
        self.prev_t = -1e9
        self.frames: list = []

    def record(self, t, bodies, quat, pos):
        """Returns (t, depth, pc, seg, camera_pose, color) or None if not yet
        due (never, by the pacing above)."""
        if t - self.prev_t < self.dt:
            return None
        self.prev_t += self.dt
        if self.rotate:
            R = so3_exp_map(torch.as_tensor(self.rotate_axis * (self.dt * self.rotate_rate))).numpy()
            T = np.eye(4)
            T[:3, :3] = R
            self.camera_pose = T @ self.camera_pose
        cam_pose = torch.as_tensor(self.camera_pose, dtype=quat.dtype, device=quat.device)
        quat, pos = quat.detach(), pos.detach()
        color = None
        if self.record_color:
            color, depth, seg = render_color(bodies, quat, pos, self.cam, cam_pose, colors=self.body_colors)
            color = color.cpu().numpy()
        else:
            depth, seg = render_depth_seg(bodies, quat, pos, self.cam, cam_pose)
        pc = None
        if self.record_points:
            pc = get_pointcloud(depth, self.cam, self.generator, self.noise_factor).cpu().numpy()
        frame = (float(t), depth.cpu().numpy(), pc, seg.cpu().numpy() if self.record_seg else None,
                 self.camera_pose.copy(), color)
        self.frames.append(frame)
        return frame
