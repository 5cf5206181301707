#!/usr/bin/env python
"""Write the JAX package's solver fallback and post-stabilization results as
a golden file.

``tests/test_torch_fallback.py`` (CPU) and ``chip_smoke.phase_fallback``
(the card) hold the port against it without compiling JAX programs. Float64
on the CPU, XLA paths:

- ``qp/*``: the under-iterated LCP of ``tests/test_qp.py:139-165`` (its
  ``jax.random`` draws, stored as ``qp/Q`` ... ``qp/F``) through
  ``pdipm_solve_checked`` at 1 and 20 iterations (fallback 25 iterations,
  threshold 1e-6): the solution, residuals and whether it fell back;
- ``fb<rad>/*``: the bench world (``bench.py``'s scene and configuration)
  at radius 0.5 and 0.58 with ``solver_max_iter=2, solver_fallback=True``,
  20 frames: the trajectory;
- ``ps<rad>/*``: ``tests/test_batched.py``'s sideways-launched sphere
  (icosphere subdiv 1 on the floor box at subdiv 2, ``fric_dirs=4``) with
  ``post_stab=True`` at radius 0.45, 0.6 and 0.8, 10 frames: the
  trajectory.

Run from the repository root (~3 min, most of it compiling):

    python tests/golden/gen_torch_fallback_golden.py

It writes ``tests/golden/fallback_f64.npz`` next to itself.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fallback_f64.npz")
BENCH_CFG = dict(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=2, max_substeps=4,
                 max_bisect=8, tol=1e-8)
FB_CFG = dict(BENCH_CFG, solver_max_iter=2, solver_fallback=True)
FB_RADS, FB_FRAMES = (0.5, 0.58), 20
PS_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=1, max_substeps=4, max_bisect=4,
              post_stab=True)
PS_RADS, PS_FRAMES = (0.45, 0.6, 0.8), 10
TRAJ_KEYS = ("pos", "quat", "v", "valid", "n_halvings", "bisect_failed", "truncated")


def qp_case():
    """tests/test_qp.py:139-165's problem and both of its checked solves."""
    from diffsdfsim_tpu.ops.qp import pdipm_solve_checked

    key = jax.random.PRNGKey(3)
    nz, nineq, neq = 8, 6, 2
    L = jax.random.normal(key, (1, nz, nz))
    args = dict(
        Q=L @ jnp.swapaxes(L, -1, -2) + nz * jnp.eye(nz),
        p=jax.random.normal(jax.random.fold_in(key, 1), (1, nz)),
        G=jax.random.normal(jax.random.fold_in(key, 2), (1, nineq, nz)),
        h=jax.random.uniform(jax.random.fold_in(key, 3), (1, nineq)) + 0.2,
        A=jax.random.normal(jax.random.fold_in(key, 4), (1, neq, nz)),
        b=jnp.zeros((1, neq)),
        F=jnp.zeros((1, nineq, nineq)),
    )
    out = {f"qp/{k}": np.asarray(v) for k, v in args.items()}
    for it in (1, 20):
        sol, res, bad = pdipm_solve_checked(*args.values(), max_iter=it, eps=1e-12, fallback_iters=25,
                                            fallback_thresh=1e-6)
        for name, x in zip("xyzs", sol):
            out[f"qp/it{it}/{name}"] = np.asarray(x)
        out[f"qp/it{it}/resids"] = np.asarray(res)
        out[f"qp/it{it}/fell_back"] = np.asarray(bad)
    return out


def rollouts(prefix, cfg_kw, rads, n_frames, floor_subdiv, sphere_subdiv, v_side):
    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world
    from diffsdfsim_tpu.physics.world import rollout

    cfg = SimConfig(**cfg_kw)
    floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=floor_subdiv)

    def run(rad):
        sphere = make_body(SphereShape(rad), fric_coeff=0.25, subdiv=sphere_subdiv)
        poses = jnp.array([[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]])
        spec, state = make_world([floor, sphere], poses, jnp.zeros((2, 6)).at[1, 3].set(v_side),
                                 joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)), cfg=cfg)
        return rollout(spec, state, n_frames)[1]

    fn = jax.jit(run)
    out = {}
    for rad in rads:
        traj = fn(jnp.asarray(rad))
        out.update({f"{prefix}{rad}/{k}": np.asarray(getattr(traj, k)) for k in TRAJ_KEYS})
    return out


def main():
    out = qp_case()
    out.update(rollouts("fb", FB_CFG, FB_RADS, FB_FRAMES, 3, 2, 0.0))
    out.update(rollouts("ps", PS_CFG, PS_RADS, PS_FRAMES, 2, 1, 2.0))
    np.savez(OUT, **out)


if __name__ == "__main__":
    main()
