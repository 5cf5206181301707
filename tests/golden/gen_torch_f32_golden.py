#!/usr/bin/env python
"""Write the JAX package's float32 runs as golden files.

float32 is the dtype the JAX package runs on its accelerator
(``diffsdfsim_tpu/config.py`` ``default_dtype``: float32 unless x64 is on).
The PyTorch port's float32 configuration is held against these files by
``tests/test_torch_f32.py`` (the plain path on the CPU) and
``chip_smoke.phase_float32`` (the kernels on the card). The tests turn x64
on for their whole process, so this script runs the JAX package in a
process of its own with ``jax_enable_x64`` off before any array is made.

Two references, one file per case and mode (``<case>_<mode>_f32.npz``):

- ``xla`` (``solver_backend="xla"``, ``fw_backend="xla"``): what the JAX
  package computes off its accelerator, op for op. The port's plain float32
  path is held to it.
- ``pallas`` (``solver_backend="pallas"``, ``fw_backend="pallas"``: the
  PDIPM, KKT and Frank-Wolfe kernels in interpret mode on the CPU): what the
  JAX package computes on its accelerator. The port's kernels (K1, K3, K2)
  are held to it. The bench cases and the card's grid and latent cases have
  it; grid and latent pairs take the XLA search on either backend (the
  Frank-Wolfe kernel takes analytic pairs only), and the decoder and grid
  kernels are off the JAX package's own paths.

Cases, all at float32 with ``bench.py``'s float32 tolerance (``tol=1e-5``;
``optim_shapespace.build_cfg`` picks the same):

- ``bench``: bench.py's 100-frame rollout (sphere rad 0.5, subdiv 2,
  dropped from 1.2 m on the fixed 20x1x20 floor): the trajectory;
- ``grad_12``, ``grad_20``, ``grad_27``, ``grad_100``: bench.py's loss
  ``sum(pos[:, :, 1, :]**2 * valid)`` over that many frames and its
  derivative with respect to the radius;
- ``batched_4``, ``batched_16``: ``rollout_batched`` of the bench world at
  B radii ``linspace(0.42, 0.58, B)`` (bench.py's seed sweep), 30 frames:
  each lane's loss, its d loss / d rad and the trajectory;
- ``grid17``, ``grid64``: ``tests/test_world_extra.py:53-67``'s voxelized
  ball (``tests/torch_jax_bridge.sphere_grid``) on a 17^3 / 64^3 grid, 16
  frames: the body's verts and inertia and the trajectory;
- ``latent32``, ``latent128``: ``optim_shapespace``'s drop of a latent body
  at a narrow decoder (``(32,)*4``, skip at 2, init radius 0.4, 20 frames)
  and at the reference's full width (``(128,)*8``, skip at 4, 0.55, 36
  frames), the decoder from ``gen_torch_shape_golden``'s seeded weights:
  the target's and the start's trajectories, the start body, and the fit's
  first Adam step (loss, d loss / d latent, the latent after it). The
  draws of ``run_one`` from ``FIT_SEED`` are stored for the port to take.

Run from the repository root, one process per case (cases of one mode may
share a process):

    python tests/golden/gen_torch_f32_golden.py --mode=xla [case ...]
    python tests/golden/gen_torch_f32_golden.py --mode=pallas [case ...]

The ``xla`` cases take 45 s to ~5 minutes each (latent128 the longest,
most of it compiling); the ``pallas`` cases, the kernels in interpret
mode, 41 s (bench) to ~4 minutes (latent128). Run the cases as separate
processes in the background.
"""

import dataclasses
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

RAD = 0.5
DROP = 1.2
# bench.py:47-63 at float32 (its tol=1e-5)
BENCH_CFG = dict(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=2, max_substeps=4,
                 max_bisect=8, tol=1e-5)
BENCH_FRAMES = 100
GRAD_FRAMES = {"grad_12": 12, "grad_20": 20, "grad_27": 27, "grad_100": 100}
BATCHED = {"batched_4": 4, "batched_16": 16}
BATCHED_FRAMES = 30
GRID_RES = {"grid17": 17, "grid64": 64}
GRID_FRAMES = 16
# tests/test_world_extra.py:25-35 with the float32 tolerance
GRID_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                max_bisect=6, tol=1e-5)
LATENT = {  # name: (dims, skip_in, geometric-init radius, frames)
    "latent32": ((32,) * 4, (2,), 0.4, 20),
    "latent128": ((128,) * 8, (4,), 0.55, 36),
}
# gen_torch_shape_golden's seeds
WEIGHT_SEED, CODE_SEED, FIT_SEED = 1234, 4321, 9
TRAJ_KEYS = ("t", "quat", "pos", "v", "valid", "bisect_failed", "truncated", "n_halvings")
PALLAS_CASES = ("bench",) + tuple(GRAD_FRAMES) + tuple(BATCHED) + ("grid64", "latent128")


def lane_rads(B):
    """bench.py's sweep radii for B lanes."""
    return np.linspace(0.42, 0.58, B).astype(np.float32)


def bench_world(rad, cfg):
    from diffsdfsim_tpu.physics import BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world

    floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25)
    sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25)
    poses = jnp.array([[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, DROP, 0.0]])
    return make_world([floor, sphere], poses, jnp.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(10.0),)), cfg=cfg)


def traj_out(traj, prefix=""):
    return {f"{prefix}{k}": np.asarray(getattr(traj, k)) for k in TRAJ_KEYS}


def run_bench(cfg):
    from diffsdfsim_tpu.physics import rollout

    def traj_fn(rad):
        spec, state = bench_world(rad, cfg)
        return rollout(spec, state, n_frames=BENCH_FRAMES)[1]

    traj = jax.jit(traj_fn)(jnp.asarray(RAD, jnp.float32))
    return traj_out(traj)


def run_grad(cfg, n):
    from diffsdfsim_tpu.physics import rollout

    def loss(rad):
        spec, state = bench_world(rad, cfg)
        _, traj = rollout(spec, state, n_frames=n)
        return jnp.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None])

    val, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(RAD, jnp.float32))
    return dict(loss=np.asarray(val), grad=np.asarray(grad), frames=np.asarray(n))


def run_batched(cfg, B):
    from diffsdfsim_tpu.physics import make_world_batched, rollout_batched

    def total(r):
        spec, bodies_b, state_b = make_world_batched(lambda rad: bench_world(rad, cfg), r)
        _, traj = rollout_batched(spec, bodies_b, state_b, BATCHED_FRAMES)
        ls = jnp.sum(traj.pos[:, :, :, 1, :] ** 2 * traj.valid[:, :, :, None], axis=(0, 1, 3))
        return jnp.sum(ls), (ls, traj)

    rads = lane_rads(B)
    (_, (ls, traj)), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(rads))
    return dict(rads=rads, loss=np.asarray(ls), grad=np.asarray(grads), frames=np.asarray(BATCHED_FRAMES),
                **traj_out(traj))


def run_grid(res, backends):
    from torch_jax_bridge import sphere_grid

    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import (
        BoxShape, Gravity3D, GridShape, TotalConstraint3D, make_body, make_world, rollout,
    )

    cfg = SimConfig(**GRID_CFG, **backends)
    grid = jnp.asarray(sphere_grid(res), jnp.float32)

    def traj_fn(grid):
        floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3)
        ball = make_body(GridShape(grid=grid, scale_=jnp.asarray(0.75)), fric_coeff=0.25, template="ico",
                         subdiv=2, project_iters=16)
        poses = jnp.array([[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, 1.0, 0]])
        spec, state = make_world([floor, ball], poses, jnp.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                                 forces=((), (Gravity3D(10.0),)), cfg=cfg)
        _, traj = rollout(spec, state, n_frames=GRID_FRAMES)
        return traj, ball.verts, ball.ang_inertia

    traj, verts, inertia = jax.jit(traj_fn)(grid)
    return dict(res=np.asarray(res), verts=np.asarray(verts), ang_inertia=np.asarray(inertia),
                frames=np.asarray(GRID_FRAMES), **traj_out(traj))


def shapespace_arrays(dims, skip_in, radius, latent_size=2):
    """The decoder's weights and biases and the 16 latent codes, as float32
    numpy: ``gen_torch_shape_golden.shapespace_arrays``'s float64 draws,
    rounded (that module turns x64 on at import, so it is not imported)."""
    import torch

    from diffsdfsim_torch.models.igr import init_implicit_net

    net = init_implicit_net(3 + latent_size, dims, skip_in, radius_init=radius,
                            generator=np.random.default_rng(WEIGHT_SEED), dtype=torch.float64)
    p = net.params()
    codes = np.random.default_rng(CODE_SEED).standard_normal((16, latent_size)) * 0.3
    return ([w.numpy().astype(np.float32) for w in p.weights], [b.numpy().astype(np.float32) for b in p.biases],
            codes.astype(np.float32))


def run_latent(name, backends):
    import optax

    from diffsdfsim_tpu.experiments import optim_shapespace as oss
    from diffsdfsim_tpu.experiments.losses import trajectory_loss
    from diffsdfsim_tpu.models.igr import ImplicitNetParams, make_decoder
    from diffsdfsim_tpu.physics import make_body
    from diffsdfsim_tpu.physics.shapes import LatentShape
    from diffsdfsim_tpu.utils.quaternion import random_quaternions

    dims, skip_in, radius, frames = LATENT[name]
    ws, bs, codes_np = shapespace_arrays(dims, skip_in, radius)
    decoder = make_decoder(ImplicitNetParams(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), skip_in,
                                             ws[0].shape[1]))
    c = dict(oss.DEFAULTS, run_time=frames / 30.0)
    cfg = dataclasses.replace(oss.build_cfg(c), **backends)
    assert cfg.tol == 1e-5, cfg.tol
    codes = jnp.asarray(codes_np)

    # run_one's draws (optim_shapespace.py:127-135)
    kt, ks, kq = jax.random.split(jax.random.PRNGKey(FIT_SEED), 3)
    target = codes[jax.random.randint(kt, (), 0, codes.shape[0])]
    mean, std = jnp.mean(codes, axis=0), jnp.std(codes, axis=0)
    start = mean + 0.1 * std * jax.random.normal(ks, mean.shape, jnp.float32)
    quat0 = random_quaternions(kq, 1, dtype=jnp.float32)[0]

    drop = jax.jit(lambda z: oss.simulate(z, quat0, decoder, c, cfg)[1])
    tgt = jax.tree_util.tree_map(np.asarray, drop(target))
    start_traj = drop(start)
    tgt_j = jax.tree_util.tree_map(jnp.asarray, tgt)

    def loss_fn(z):
        _, traj = oss.simulate(z, quat0, decoder, c, cfg)
        return trajectory_loss(traj, tgt_j, body=1) + c["latent_reg"] * jnp.sum(z**2)

    val, g = jax.jit(jax.value_and_grad(loss_fn))(start)
    opt = optax.adam(c["lr"])
    upd, _ = opt.update(g, opt.init(start))
    body = jax.jit(lambda z: make_body(LatentShape(latent=z, scale_=jnp.asarray(1.0), decoder=decoder),
                                       subdiv=2, project_iters=16))(start)
    out = traj_out(tgt, "traj_")
    out.update(traj_out(start_traj, "start_traj_"))
    out.update(loss_0=np.asarray(val), grad_0=np.asarray(g), latent_1=np.asarray(start + upd),
               start_verts=np.asarray(body.verts), start_ang_inertia=np.asarray(body.ang_inertia),
               target_latent=np.asarray(target), start_latent=np.asarray(start), quat0=np.asarray(quat0),
               codes=codes_np, fit_seed=np.asarray(FIT_SEED), radius=np.asarray(radius, np.float32),
               frames=np.asarray(frames), skip_in=np.asarray(skip_in), dims=np.asarray(dims))
    return out


def run_case(name, mode):
    from diffsdfsim_tpu.config import SimConfig

    backends = dict(solver_backend=mode, fw_backend=mode)
    cfg = SimConfig(**BENCH_CFG, **backends)
    if name == "bench":
        return run_bench(cfg)
    if name in GRAD_FRAMES:
        return run_grad(cfg, GRAD_FRAMES[name])
    if name in BATCHED:
        return run_batched(cfg, BATCHED[name])
    if name in GRID_RES:
        return run_grid(GRID_RES[name], backends)
    return run_latent(name, backends)


def golden_path(name, mode):
    return os.path.join(HERE, f"{name}_{mode}_f32.npz")


def run(args):
    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--"))
    mode = opts.get("mode", "xla")
    assert mode in ("xla", "pallas"), mode
    assert not jax.config.read("jax_enable_x64")
    default = PALLAS_CASES if mode == "pallas" else PALLAS_CASES + tuple(GRID_RES) + tuple(LATENT)
    for name in [a for a in args if not a.startswith("--")] or default:
        t0 = time.time()
        out = run_case(name, mode)
        bad = [k for k, v in out.items() if np.asarray(v).dtype == np.float64]
        assert not bad, f"{name}: float64 arrays in a float32 run: {bad}"
        np.savez_compressed(golden_path(name, mode), **out)
        summary = {k: out[k].tolist() for k in ("loss", "grad", "loss_0", "grad_0") if k in out}
        if "valid" in out or "traj_valid" in out:
            summary["substeps"] = int(out.get("valid", out.get("traj_valid")).sum())
        print(f"{name} ({mode}): {summary} ({time.time() - t0:.0f} s) -> {golden_path(name, mode)}", flush=True)


if __name__ == "__main__":
    run(sys.argv[1:])
