"""External forces (reference ``sdf_physics/physics3d/forces.py``).

PyTorch counterpart of ``diffsdfsim_tpu/physics/forces.py``. A force object
returns a 6-vector ``[torque, force]`` in the world frame from ``force(t,
body)``. Parameters are plain attributes (floats or tensors), so they can
be differentiable or per-lane without changing the call: in a seed sweep
(``physics/batched.py``) a tensor attribute may carry a lane axis (B,), as
may the body's mass and the time t, and the force is then (B, 6).
"""

from __future__ import annotations

import torch


def _axis6(i, sign, like):
    # built on the device without a host-to-device copy (a copy would
    # synchronize the stream on every step)
    out = torch.zeros(6, dtype=like.dtype, device=like.device)
    out[i] = sign
    return out


def _col(x):
    """A per-lane parameter (B,) as a column against the 6-vector; a scalar
    as it is."""
    return x[..., None] if isinstance(x, torch.Tensor) and x.dim() > 0 else x


def DOWN(like):
    return _axis6(4, -1.0, like)


class ExternalForce3D:
    """force(t) = force_func(t) * multiplier (reference forces.py:48-66).

    ``force_func(t)`` gets the simulation time as a tensor and returns a
    6-vector tensor; by default it is DOWN."""

    def __init__(self, force_func=None, multiplier=1.0):
        self.force_func = force_func if force_func is not None else DOWN
        self.multiplier = multiplier

    def force(self, t, body):
        return self.force_func(t) * _col(self.multiplier)


class Gravity3D(ExternalForce3D):
    """m * g * DOWN (reference forces.py:69-85)."""

    def __init__(self, g=10.0):
        self.g = g

    def force(self, t, body):
        return DOWN(body.mass) * _col(body.mass) * _col(self.g)
