"""Re-render a finished ``optim_sphere`` run's start, final and target worlds
as depth and segmentation frames.

PyTorch counterpart of ``diffsdfsim_tpu/experiments/render_result.py``
(which replaces the reference's ``experiments/render_result.py``: reload a
sacred run's config and invoke its ``record_results`` command,
optim_sphere.py:180-207): reads a run directory written by
``experiments/common.Run``, rolls out the world at the stored start, final
and target radii, and writes every 5th frame's depth and segmentation from
the SDF ray-marcher (160 x 120) into ``<run_dir>/render/{start,final,
target}/``.

It renders the world that was simulated (the floor, the wall where the run
had one, the sphere). The JAX package renders a world of the floor and the
sphere alone at the first two bodies' poses of the simulated trajectory,
which puts the sphere at the wall's pose when the run had a wall; with
``use_wall=False`` the two agree (ROADMAP queue 3).

Run: python -m diffsdfsim_torch.experiments.render_result outputs/trajectory_fitting_sphere/1
"""

from __future__ import annotations

import json
import math
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..rendering.raymarch import PinholeCamera, render_depth_seg
from . import optim_sphere


def render_world(spec, traj, out_dir: Path, every: int = 5):
    """Depth and segmentation of every ``every``-th frame of ``traj`` (at
    its first substep record) as ``depth_NNNN.npy`` / ``seg_NNNN.npy``."""
    dtype, device = traj.pos.dtype, traj.pos.device
    cam = PinholeCamera.from_yfov(math.pi / 3, 160, 120)
    theta = math.pi / 4
    ct, st = math.cos(theta), math.sin(theta)
    pose = torch.tensor([[1, 0, 0, 0.0], [0, ct, -st, 8.0], [0, st, ct, 12.0], [0, 0, 0, 1.0]], dtype=dtype,
                        device=device)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = traj.t.shape[0]
    for i in range(0, n, every):
        depth, seg = render_depth_seg(spec.bodies, traj.quat[i, 0], traj.pos[i, 0], cam, pose)
        np.save(out_dir / f"depth_{i:04d}.npy", depth.cpu().numpy())
        np.save(out_dir / f"seg_{i:04d}.npy", seg.cpu().numpy())
    print("wrote", n // every, "frames to", out_dir)


def main(argv=None, device=None):
    argv = argv or sys.argv[1:]
    if not argv:
        raise SystemExit("usage: render_result <run_dir>")
    device = resolve_device(device)
    run_dir = Path(argv[0])
    cfg_dict = json.loads((run_dir / "config.json").read_text())
    with open(run_dir / "output.pkl", "rb") as f:
        out = pickle.load(f)
    c = dict(optim_sphere.DEFAULTS)
    c.update({k: v for k, v in cfg_dict.items() if k in c})
    sim_cfg = optim_sphere.build_cfg(c)
    for name in ("start", "final", "target"):
        rad = torch.tensor(float(np.asarray(out[f"{name}_rad"]).reshape(-1)[0]), dtype=default_dtype(),
                           device=device)
        spec, state, _, _ = optim_sphere.build_world(rad, c, sim_cfg, device)
        with torch.no_grad():
            _, traj = optim_sphere.rollout(spec, state, optim_sphere.n_frames(c, sim_cfg))
        render_world(spec, traj, run_dir / "render" / name)


if __name__ == "__main__":
    main()
