#!/usr/bin/env python
"""Write the JAX package's batched-native rollout as a golden file.

The PyTorch port's seed sweep (``diffsdfsim_torch.physics.batched``) is held
against it by ``tests/test_torch_batched.py`` without compiling a JAX
rollout. The scene is ``tests/test_batched.py``'s: a sphere (icosphere
subdiv 1) launched sideways at 2 m/s from 1.2 m onto a fixed 20x1x20 floor
box (cube template subdiv 2), gravity 10, ``fric_dirs=4``, 4 contacts per
pair, 8 in all, ``max_substeps=4``, ``max_bisect=4``, float64 on the CPU
(XLA solver and contact-search paths), one lane per radius:

- ``plain``: radii 0.45, 0.6, 0.8, 10 frames;
- ``detach``: radii 0.55, 0.7, 14 frames with ``detach_2nd_bounce``.

Each case stores the radii, each lane's loss ``sum(pos[..., 1, :]**2 *
valid)`` and its derivative with respect to the lane's radius, and the
trajectory ((T, S, B, ...) leaves).

Run from the repository root (about two minutes, most of it compiling):

    python tests/golden/gen_torch_batched_golden.py

It writes ``tests/golden/batched_f64.npz`` next to itself.
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

CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=1, max_substeps=4, max_bisect=4)
CASES = {"plain": ([0.45, 0.6, 0.8], 10, False), "detach": ([0.55, 0.7], 14, True)}


def run():
    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import (
        BoxShape,
        Gravity3D,
        SphereShape,
        TotalConstraint3D,
        make_body,
        make_world,
        make_world_batched,
        rollout_batched,
    )

    cfg = SimConfig(**CFG)

    def build(rad):
        floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), mass=1.0, fric_coeff=0.25, subdiv=2)
        sphere = make_body(SphereShape(rad), mass=1.0, fric_coeff=0.25, subdiv=1)
        poses = jnp.array([[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]])
        vels = jnp.zeros((2, 6)).at[1, 3].set(2.0)
        return make_world([floor, sphere], poses, vels, joints=(TotalConstraint3D(body1=0),),
                          forces=((), (Gravity3D(10.0),)), cfg=cfg)

    out = {}
    for name, (rads, n_frames, detach) in CASES.items():

        def losses(r, n_frames=n_frames, detach=detach):
            spec, bodies_b, state_b = make_world_batched(build, r)
            _, traj = rollout_batched(spec, bodies_b, state_b, n_frames, detach_2nd_bounce=detach)
            return jnp.sum(traj.pos[:, :, :, 1, :] ** 2 * traj.valid[:, :, :, None], axis=(0, 1, 3)), traj

        def total(r):
            ls, traj = losses(r)
            return jnp.sum(ls), (ls, traj)

        (_, (ls, traj)), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(rads))
        out[f"{name}_rads"] = np.asarray(rads)
        out[f"{name}_loss"] = np.asarray(ls)
        out[f"{name}_grad"] = np.asarray(grads)
        for key in traj._fields:
            out[f"{name}_{key}"] = np.asarray(getattr(traj, key))
        print(f"{name}: losses {np.asarray(ls).tolist()}, d loss / d rad {np.asarray(grads).tolist()}, "
              f"{int(np.asarray(traj.valid).sum())} lane substeps")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "batched_f64.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


if __name__ == "__main__":
    run()
