#!/usr/bin/env python
"""Write the JAX package's bench-loss gradients as a golden file.

The PyTorch port's gradient path (``diffsdfsim_torch``) is held against these
values by ``tests/test_torch_grad_world.py`` and ``chip_smoke.py`` without
compiling a JAX rollout gradient. The loss is ``bench.py``'s,
``sum(traj.pos[:, :, 1, :]**2 * valid)`` over the bench world (sphere rad
0.5, icosphere subdiv 2, dropped from 1.2 m onto the fixed 20x1x20 floor,
bench.py's config with the float64 tolerance), and each case stores its
value and its derivative with respect to the radius, float64 on the CPU
(XLA solver and contact-search paths):

- ``toc_20``: 20 frames (the first bounce, with the time-of-contact
  differential);
- ``notoc_20``: the same without it (``time_of_contact_diff=False``);
- ``detach_27``: 27 frames with ``detach_2nd_bounce``: the sphere touches
  the floor in frames 10, 21 and 26, so the truncation fires twice;
- ``toc_27`` ... ``toc_80``, ``toc_100``: the same loss over the first 27,
  30, 40, 50, 60 and 80 frames, and the whole 100-frame bench rollout.
  They show where the port and the reference part: at a touchdown whose
  contact point is decided by rounding (ROADMAP.md queue 3).

Run from the repository root (about ten minutes, most of it compiling):

    python tests/golden/gen_torch_grad_golden.py [case ...]

Naming cases recomputes only those and keeps the file's other entries.

It writes ``tests/golden/bench_grad_f64.npz`` next to itself.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

RAD = 0.5
DROP = 1.2
# bench.py:47-63 with the float64 tolerance
BENCH_CFG = dict(
    fric_dirs=8,
    max_contacts_per_pair=4,
    max_contacts_total=4,
    mesh_subdiv=2,
    max_substeps=4,
    max_bisect=8,
    tol=1e-8,
    substep_unroll=4,
)
# name: (frames, config overrides, detach_2nd_bounce)
CASES = {
    "toc_20": (20, {}, False),
    "notoc_20": (20, {"time_of_contact_diff": False}, False),
    "detach_27": (27, {}, True),
    "toc_27": (27, {}, False),
    "toc_30": (30, {}, False),
    "toc_40": (40, {}, False),
    "toc_50": (50, {}, False),
    "toc_60": (60, {}, False),
    "toc_80": (80, {}, False),
    "toc_100": (100, {}, False),
}


def loss_fn(n_frames, cfg_kw, detach):
    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import (
        BoxShape,
        Gravity3D,
        SphereShape,
        TotalConstraint3D,
        make_body,
        make_world,
        rollout,
    )

    cfg = SimConfig(**BENCH_CFG, **cfg_kw)

    def loss(rad):
        floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25)
        sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25)
        poses = jnp.array([[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, DROP, 0.0]])
        spec, state = make_world(
            [floor, sphere], poses, jnp.zeros((2, 6)),
            joints=(TotalConstraint3D(body1=0),),
            forces=((), (Gravity3D(10.0),)), cfg=cfg,
        )
        _, traj = rollout(spec, state, n_frames=n_frames, detach_2nd_bounce=detach)
        return jnp.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None])

    return loss


def run(names=None):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_grad_f64.npz")
    out = {k: v for k, v in np.load(path).items() if k != "rad"} if names and os.path.exists(path) else {}
    for name, (n, cfg_kw, detach) in CASES.items():
        if names and name not in names:
            continue
        t0 = time.time()
        val, grad = jax.jit(jax.value_and_grad(loss_fn(n, cfg_kw, detach)))(jnp.asarray(RAD))
        out[f"{name}_loss"] = np.asarray(val)
        out[f"{name}_grad"] = np.asarray(grad)
        print(f"{name}: loss {float(val)!r} dloss/drad {float(grad)!r} ({time.time() - t0:.0f} s)", flush=True)
    np.savez(path, rad=np.asarray(RAD), **out)
    print(f"wrote {path}")


if __name__ == "__main__":
    run(sys.argv[1:])
