"""Simulation defaults, dtype policy and device policy.

PyTorch counterpart of ``diffsdfsim_tpu/config.py``: the reference's
two-tier class-attribute defaults (``Defaults`` / ``Defaults3D``) and a
frozen ``SimConfig`` with the same fields and defaults.

Dtype: float64 is the default (the reference's dtype and the regime of
``tol=1e-8``); float32 works too and keeps the f32-only solver rules
(the eps floor in ``physics/engine.py`` and the d-cap / ridge in
``ops/qp.py``).

Device: entry points take ``device=None``, which means CUDA. Without a card
they raise unless the caller asks for ``device="cpu"`` explicitly; they never
fall back to the CPU on their own.
"""

from __future__ import annotations

import dataclasses

import torch


class Defaults:
    """2D-core defaults (reference ``physics/utils.py:33-64``)."""

    DIM = 2
    EPSILON = 0.1
    TOL = 1e-6
    RESTITUTION = 0.5
    FRIC_COEFF = 0.9
    FRIC_DIRS = 2
    DT = 1.0 / 30.0
    ENGINE = "PdipmEngine"
    CONTACT = "DiffContactHandler"
    POST_STABILIZATION = False


class Defaults3D(Defaults):
    """3D defaults (reference ``physics3d/utils.py:41-62``)."""

    DIM = 3
    EPSILON = 1e-3
    TOL = 1e-8
    FRIC_DIRS = 8
    CONTACT = "FWContactHandler"
    CUSTOM_MESH = False
    CUSTOM_INERTIA = False


def default_dtype() -> torch.dtype:
    """The port's working dtype when the caller names none."""
    return torch.float64


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raise rather than run on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "diffsdfsim_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static per-world simulation configuration.

    Same fields and defaults as ``diffsdfsim_tpu.config.SimConfig``. Fields
    that steer JAX/XLA machinery are accepted and are no-ops here, because
    eager PyTorch has no tracing to tune: ``ladder_fast_path``,
    ``ladder_batch_gate``, ``remat_frames``, ``replay_mode``,
    ``remat_replay``, ``remat_policy``, ``substep_unroll`` and
    ``frame_unroll``.

    Backends: ``solver_backend``, ``solver_bwd`` and ``fw_backend`` accept
    only ``"auto"``: every solve and search here is plain PyTorch, on the
    tensors' device.
    """

    dt: float = Defaults.DT
    eps: float = Defaults3D.EPSILON
    tol: float = Defaults3D.TOL
    fric_dirs: int = Defaults3D.FRIC_DIRS
    strict_no_penetration: bool = True
    time_of_contact_diff: bool = True
    stop_contact_grad: bool = False
    stop_friction_grad: bool = False
    detach_contact_b2: bool = False
    # solver
    solver_max_iter: int = 10  # reference engines.py:25
    solver_eps: float = 1e-12
    solver_backend: str = "auto"
    solver_bwd: str = "auto"
    fw_backend: str = "auto"
    # contact-point polish along body 1's analytic surface (ops/polish.py)
    contact_polish_iters: int = 10
    # stepping
    max_bisect: int = 10  # reference dt floor dt/2**10, world.py:345
    ladder_fast_path: bool = True  # no-op
    ladder_batch_gate: bool = False  # no-op
    # staged bisection: rungs 0..ladder_stage1 first, the deep rungs only
    # when the shallow stage fails; -1 probes the whole ladder at once
    ladder_stage1: int = 2
    max_substeps: int = 8
    remat_frames: bool = False  # no-op
    replay_mode: str = "auto"  # no-op
    remat_replay: bool = True  # no-op
    remat_policy: str = "none"  # no-op
    substep_unroll: int = 1  # no-op
    frame_unroll: int = 1  # no-op
    # contact buffers
    max_contacts_per_pair: int = 8
    max_contacts_total: int = 8
    max_filter_clusters: int = 4
    fw_iters: int = 32  # reference contacts.py:63
    # mesh extraction
    mesh_subdiv: int = 3
    mesh_project_iters: int = 12

    def __post_init__(self):
        for name in ("solver_backend", "solver_bwd", "fw_backend"):
            if getattr(self, name) != "auto":
                raise ValueError(
                    f"{name}={getattr(self, name)!r}: only 'auto' is supported; "
                    "the backend follows the tensors' device"
                )
