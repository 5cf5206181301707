#!/usr/bin/env python
"""Write the JAX package's body builders and their worlds as golden files.

The PyTorch port's bowl, analytic meshes, marching mesher and the worlds
built from them are held against these by ``tests/test_torch_meshes.py``
and ``chip_smoke.phase_meshes`` without running JAX. Float64 on the CPU.

- ``shapes``: ``bowl_sdf`` / ``bowl_sdf_grad`` at seeded points and at the
  formula's ties (on the z axis, on the shell's mid-radius); ``box_mesh``,
  ``sphere_mesh``, ``cylinder_mesh``, ``bowl_mesh``; ``make_body(...,
  custom_mesh=True)`` of a box, sphere, cylinder and bowl with its inertia
  and d trace(inertia) / d params; ``marching_tets`` on
  ``test_marching.py``'s sphere (radius 0.5 on a 16^3 grid; the valid
  triangles, all of them and truncated at 500).
- ``torus``: ``test_marching_body.py``'s 14^3 torus grid body
  (``mesher="marching"``: its valid triangles and inertia) dropped on the
  floor for 16 frames, the trajectory, and the loss |final pos|^2 with its
  derivative in the grid's scale.
- ``bowl``: ``test_bowl.py``'s marble dropped into the fixed bowl, 30
  frames.

Run from the repository root (~1-4 min per case, most of it compiling):

    python tests/golden/gen_torch_meshes_golden.py [shapes torus bowl]

It writes ``meshes_<case>_f64.npz`` next to itself.
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

HERE = os.path.dirname(os.path.abspath(__file__))
TRAJ_KEYS = ("t", "quat", "pos", "v", "valid", "bisect_failed", "truncated", "n_halvings")
TORUS_RES, R_MAJ, R_MIN = 14, 0.55, 0.25
TORUS_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=2, max_substeps=2,
                 max_bisect=4, tol=1e-6, time_of_contact_diff=False)
BOWL_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                max_bisect=6, time_of_contact_diff=False)
BOX, SPHERE, CYL, BOWL = [0.5, 0.7, 0.9], 0.6, (0.4, 0.9), (1.0, 0.1)


def bowl_points():
    """Seeded points around the normalized bowl (r 0.6, d 0.075), plus the
    gradient formula's ties: on the z axis and on the mid-radius."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.0, 1.0, size=(256, 3))
    axis = np.stack([np.zeros(8), np.zeros(8), np.linspace(-0.9, 0.9, 8)], 1)
    th = np.linspace(0.1, 1.4, 8)
    mid = np.stack([0.6 * np.cos(th), np.zeros(8), 0.3 - 0.6 * np.sin(th)], 1)  # |p - (0, 0, r/2)| = r, z < r/2
    return np.concatenate([pts, axis, mid])


def marching_sphere_grid(res=16, rad=0.5):
    lin = np.linspace(-1.0, 1.0, res)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    return np.sqrt(np.maximum(np.sum(pts * pts, axis=-1), 1e-24)) - rad


def torus_grid(res=TORUS_RES):
    lin = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt((np.sqrt(x**2 + z**2) - R_MAJ) ** 2 + y**2) - R_MIN


def traj_arrays(prefix, traj):
    return {f"{prefix}_{k}": np.asarray(getattr(traj, k)) for k in TRAJ_KEYS}


def shapes():
    from diffsdfsim_tpu.ops import sdf
    from diffsdfsim_tpu.ops.marching import marching_tets
    from diffsdfsim_tpu.physics import BowlShape, BoxShape, CylinderShape, SphereShape, make_body
    from diffsdfsim_tpu.physics import analytic_meshes as am

    out = {}
    p = jnp.asarray(bowl_points())
    out["bowl_pts"] = p
    out["bowl_sdf"] = sdf.bowl_sdf(p, 0.6, 0.075)
    out["bowl_grad"] = sdf.bowl_sdf_grad(p, 0.6, 0.075)
    for name, (v, f) in dict(box=am.box_mesh(jnp.asarray(BOX)), sphere=am.sphere_mesh(jnp.asarray(SPHERE), 3),
                             cylinder=am.cylinder_mesh(*CYL), bowl=am.bowl_mesh(*BOWL)).items():
        out[f"mesh_{name}_verts"], out[f"mesh_{name}_faces"] = v, f
    makers = dict(box=lambda q: BoxShape(q), sphere=lambda q: SphereShape(q[0]),
                  cylinder=lambda q: CylinderShape(q[0], q[1]), bowl=lambda q: BowlShape(q[0], q[1]))
    params = dict(box=BOX, sphere=[SPHERE], cylinder=list(CYL), bowl=list(BOWL))
    for name, mk in makers.items():
        q = jnp.asarray(params[name], dtype=jnp.float64)
        bd = make_body(mk(q), custom_mesh=True, subdiv=2, mass=1.3)
        out[f"body_{name}_verts"], out[f"body_{name}_inertia"] = bd.verts, bd.ang_inertia
        out[f"body_{name}_dtrace"] = jax.grad(
            lambda x: jnp.trace(make_body(mk(x), custom_mesh=True, subdiv=2, mass=1.3).ang_inertia))(q)
    grid = jnp.asarray(marching_sphere_grid())
    for m in (None, 500):
        tri, valid = marching_tets(grid, max_tris=m)
        out[f"march_{m or 'all'}"] = np.asarray(tri)[np.asarray(valid)]
    return out


def torus():
    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import BoxShape, Gravity3D, TotalConstraint3D, make_body, make_world, rollout
    from diffsdfsim_tpu.physics.shapes import GridShape

    cfg = SimConfig(**TORUS_CFG)
    grid = jnp.asarray(torus_grid())
    out = {}
    body = make_body(GridShape(grid=grid, scale_=jnp.asarray(1.0)), mesher="marching")
    valid = np.asarray(body.face_valid)
    out["torus_tris"] = np.asarray(body.verts).reshape(-1, 3, 3)[valid]
    out["torus_inertia"] = body.ang_inertia

    def world(scale):
        floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), subdiv=3)
        tor = make_body(GridShape(grid=grid, scale_=scale), mesher="marching")
        poses = jnp.array([[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]])
        return make_world([floor, tor], poses, jnp.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                          forces=((), (Gravity3D(10.0),)), cfg=cfg)

    def loss_fn(scale):
        spec, state = world(scale)
        final, traj = rollout(spec, state, n_frames=16)
        return jnp.sum(final.pos[1] ** 2), traj

    (loss, traj), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jnp.asarray(1.0))
    out.update(traj_arrays("torus", traj))
    out["torus_loss"], out["torus_dscale"] = loss, g
    return out


def bowl():
    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import (BowlShape, Gravity3D, SphereShape, TotalConstraint3D, make_body,
                                        make_world, rollout)

    cfg = SimConfig(**BOWL_CFG)
    bowl_bd = make_body(BowlShape(jnp.asarray(1.0), jnp.asarray(0.1)), custom_mesh=True)
    marble = make_body(SphereShape(jnp.asarray(0.2)), subdiv=1, fric_coeff=0.3)
    s = np.sqrt(0.5)
    poses = jnp.array([[s, -s, 0, 0, 0.0, 0.0, 0.0], [1.0, 0, 0, 0, 0.15, 1.2, 0.0]])
    spec, state = make_world([bowl_bd, marble], poses, jnp.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                             forces=((), (Gravity3D(10.0),)), cfg=cfg)
    final, traj = jax.jit(lambda st: rollout(spec, st, n_frames=30))(state)
    return traj_arrays("bowl", traj)


def run(names):
    for name in names or ("shapes", "torus", "bowl"):
        t0 = time.time()
        out = dict(shapes=shapes, torus=torus, bowl=bowl)[name]()
        path = os.path.join(HERE, f"meshes_{name}_f64.npz")
        np.savez_compressed(path, **{k: np.asarray(v) for k, v in out.items()})
        print(f"{name}: {time.time() - t0:.0f} s -> {path}", flush=True)


if __name__ == "__main__":
    run(sys.argv[1:])
