"""External forces (reference ``sdf_physics/physics3d/forces.py``): gravity,
the one the benchmark's worlds use. ``force(t, body)`` returns a 6-vector
``[torque, force]`` in the world frame; in a seed sweep
(``physics/batched.py``) the body's mass may carry a lane axis (B,), and the
force is then (B, 6).
"""

from __future__ import annotations

import torch


def _col(x):
    """A per-lane parameter (B,) as a column against the 6-vector; a scalar
    as it is."""
    return x[..., None] if isinstance(x, torch.Tensor) and x.dim() > 0 else x


def DOWN(like):
    # built on the device without a host-to-device copy (a copy would
    # synchronize the stream on every step)
    out = torch.zeros(6, dtype=like.dtype, device=like.device)
    out[4] = -1.0
    return out


class Gravity3D:
    """m * g * DOWN (reference forces.py:69-85)."""

    def __init__(self, g=10.0):
        self.g = g

    def force(self, t, body):
        return DOWN(body.mass) * _col(body.mass) * _col(self.g)
