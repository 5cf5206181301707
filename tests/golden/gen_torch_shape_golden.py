#!/usr/bin/env python
"""Write the JAX package's shape-space and voxel-grid scenes as golden files.

The PyTorch port's latent and grid bodies (``diffsdfsim_torch``) are held
against these by ``tests/test_torch_shapespace.py``, ``tests/test_torch_grid.py``
and ``chip_smoke.py`` without running a JAX rollout. Float64 on the CPU (XLA
solver and contact-search paths).

- ``latent128``: ``optim_shapespace``'s scene and configuration
  (``diffsdfsim_tpu/experiments/optim_shapespace.py:59-124``) at the full
  width of the reference's IGR net (latent size 2, ``(128,)*8``, skip at 4,
  geometric init toward radius 0.55): the 36-frame drops at the target
  latent (``traj_*``) and at the start latent (``start_traj_*``), then two
  Adam steps (lr 1e-2) of the fit from the start latent,
  with each step's loss (``trajectory_loss(body=1) + 1e-3 |z|^2``), its
  d loss / d latent and the latent after it; and the body at the start
  latent (verts, inertia) with one search of its mesh against the floor
  (``_search_pair_raw_xla``, ``search_*``). ``latent32``: the same at
  ``(32,)*4`` with a skip at 2 and init radius 0.4 over 20 frames.
- ``grid64``: ``tests/test_world_extra.py:53-67``'s drop of a voxelized
  sphere (0.5 / 0.75 in the normalized frame, ``scale_`` 0.75, icosphere
  subdiv 2, 16 projection steps, friction 0.25) on a 64^3 float64 grid for
  16 frames; ``grid33`` the same on a 33^3 grid. The grid is computed with
  numpy (``tests/torch_jax_bridge.sphere_grid``), so the port can rebuild
  the same array.

The decoder's weights come from ``numpy.random.default_rng(WEIGHT_SEED)``
through the geometric-init formula (``diffsdfsim_torch.models.igr``), the
codes from ``default_rng(CODE_SEED)``; the target latent, the start latent
and the initial rotation are ``run_one``'s ``jax.random`` draws from
``FIT_SEED``, stored in the file for the port to take.

Run from the repository root (tens of minutes for the full width, most of it
compiling; run it in the background):

    python tests/golden/gen_torch_shape_golden.py [case ...] [--fit-seed=N] [--out-dir=DIR]

It writes ``<case>_f64.npz`` next to itself (or into ``--out-dir``);
``--fit-seed`` draws the fit's problem from another key.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WEIGHT_SEED = 1234
CODE_SEED = 4321
# run_one's key: seed 0 draws code 8 as the target, which this untrained
# decoder turns into a surface the template projection does not close
# (residual 0.11, an indefinite mesh inertia; the JAX fit's loss is NaN);
# seed 3 (code 5) gives the full-width fit a NaN gradient in its second
# step; seed 9 draws code 3, a closed surface, and a finite fit
FIT_SEED = 9
LATENT_CASES = {  # name: (dims, skip_in, geometric-init radius, frames)
    "latent128": ((128,) * 8, (4,), 0.55, 36),
    # the narrow net's surface reaches the unit box at radius 0.55, where a
    # contact point just outside it gets no normal from the decoder
    "latent32": ((32,) * 4, (2,), 0.4, 20),
}
GRID_CASES = {"grid64": 64, "grid33": 33}
GRID_FRAMES = 16
TRAJ_KEYS = ("t", "quat", "pos", "v", "valid", "bisect_failed", "truncated", "n_halvings")


def shapespace_arrays(dims, skip_in, radius, latent_size=2):
    """The decoder's weights and biases and the 16 latent codes, as numpy."""
    import torch

    from diffsdfsim_torch.models.igr import init_implicit_net

    net = init_implicit_net(3 + latent_size, dims, skip_in, radius_init=radius,
                            generator=np.random.default_rng(WEIGHT_SEED), dtype=torch.float64)
    p = net.params()
    ws = [w.numpy() for w in p.weights]
    bs = [b.numpy() for b in p.biases]
    codes = np.random.default_rng(CODE_SEED).standard_normal((16, latent_size)) * 0.3
    return ws, bs, codes


def run_latent(name, fit_seed=FIT_SEED):
    import optax

    from diffsdfsim_tpu.experiments import optim_shapespace as oss
    from diffsdfsim_tpu.experiments.losses import trajectory_loss
    from diffsdfsim_tpu.models.igr import ImplicitNetParams, make_decoder
    from diffsdfsim_tpu.utils.quaternion import random_quaternions

    dims, skip_in, radius, frames = LATENT_CASES[name]
    ws, bs, codes_np = shapespace_arrays(dims, skip_in, radius)
    params = ImplicitNetParams(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), skip_in, ws[0].shape[1])
    decoder = make_decoder(params)
    c = dict(oss.DEFAULTS, run_time=frames / 30.0)
    cfg = oss.build_cfg(c)
    codes = jnp.asarray(codes_np)

    # run_one's draws (optim_shapespace.py:127-135)
    kt, ks, kq = jax.random.split(jax.random.PRNGKey(fit_seed), 3)
    target = codes[jax.random.randint(kt, (), 0, codes.shape[0])]
    mean, std = jnp.mean(codes, axis=0), jnp.std(codes, axis=0)
    start = mean + 0.1 * std * jax.random.normal(ks, mean.shape, jnp.float64)
    quat0 = random_quaternions(kq, 1, dtype=jnp.float64)[0]

    t0 = time.time()
    drop = jax.jit(lambda z: oss.simulate(z, quat0, decoder, c, cfg)[1])
    tgt = jax.tree_util.tree_map(np.asarray, drop(target))
    print(f"{name}: target rollout {time.time() - t0:.0f} s, "
          f"{int(tgt.valid.sum())} substeps", flush=True)
    start_traj = drop(start)

    tgt_j = jax.tree_util.tree_map(jnp.asarray, tgt)

    def loss_fn(z):
        _, traj = oss.simulate(z, quat0, decoder, c, cfg)
        return trajectory_loss(traj, tgt_j, body=1) + c["latent_reg"] * jnp.sum(z**2)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(c["lr"])
    z, s = start, opt.init(start)
    out = {}
    for i in range(2):
        t0 = time.time()
        val, g = vg(z)
        upd, s = opt.update(g, s)
        z = z + upd
        out[f"loss_{i}"], out[f"grad_{i}"], out[f"latent_{i + 1}"] = map(np.asarray, (val, g, z))
        print(f"{name}: step {i} loss {float(val)!r} grad {np.asarray(g).tolist()} "
              f"({time.time() - t0:.0f} s)", flush=True)
    out.update({f"traj_{k}": np.asarray(getattr(tgt, k)) for k in TRAJ_KEYS})
    out.update({f"start_traj_{k}": np.asarray(getattr(start_traj, k)) for k in TRAJ_KEYS})
    out.update(latent_body_and_search(decoder, start, quat0, cfg))
    out.update(
        target_latent=np.asarray(target), start_latent=np.asarray(start), quat0=np.asarray(quat0),
        codes=codes_np, weight_seed=np.asarray(WEIGHT_SEED), code_seed=np.asarray(CODE_SEED),
        fit_seed=np.asarray(fit_seed), radius=np.asarray(radius),
        frames=np.asarray(frames), skip_in=np.asarray(skip_in), dims=np.asarray(dims),
    )
    return out


def latent_body_and_search(decoder, latent, quat0, cfg):
    """The latent body at ``latent`` (verts, inertia) and one search of its
    mesh against the floor (``_search_pair_raw_xla``), rotated by ``quat0``
    with its lowest vertex 1e-3 into the floor."""
    from diffsdfsim_tpu.physics import BoxShape, make_body
    from diffsdfsim_tpu.physics.contacts import _search_pair_raw_xla
    from diffsdfsim_tpu.physics.shapes import LatentShape
    from diffsdfsim_tpu.utils.quaternion import quat_apply

    floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), subdiv=3)
    body = jax.jit(lambda z: make_body(LatentShape(latent=z, scale_=jnp.asarray(1.0), decoder=decoder),
                                       subdiv=2, project_iters=16))(latent)
    p1 = jnp.array([0.0, -float(quat_apply(quat0, body.verts)[:, 1].min()) - 1e-3, 0.0])
    q2, p2 = jnp.array([1.0, 0, 0, 0]), jnp.array([0.0, -0.5, 0.0])
    raw = jax.jit(lambda q, p: _search_pair_raw_xla(body, q, p, floor, q2, p2, cfg))(quat0, p1)
    out = {f"search_{k}": np.asarray(getattr(raw, k)) for k in raw._fields}
    out.update(start_verts=np.asarray(body.verts), start_ang_inertia=np.asarray(body.ang_inertia),
               search_pos=np.asarray(p1))
    return out


def run_grid(name):
    from torch_jax_bridge import sphere_grid

    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import (
        BoxShape, Gravity3D, GridShape, TotalConstraint3D, make_body, make_world, rollout,
    )

    res = GRID_CASES[name]
    # tests/test_world_extra.py:25-35,53-67
    cfg = SimConfig(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8,
                    mesh_subdiv=2, max_substeps=4, max_bisect=6)
    grid = jnp.asarray(sphere_grid(res))

    def traj_fn(grid):
        floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3)
        ball = make_body(GridShape(grid=grid, scale_=jnp.asarray(0.75)), fric_coeff=0.25, template="ico",
                         subdiv=2, project_iters=16)
        poses = jnp.array([[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, 1.0, 0]])
        spec, state = make_world([floor, ball], poses, jnp.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                                 forces=((), (Gravity3D(10.0),)), cfg=cfg)
        _, traj = rollout(spec, state, n_frames=GRID_FRAMES)
        return traj, ball.verts, ball.ang_inertia

    t0 = time.time()
    traj, verts, inertia = jax.jit(traj_fn)(grid)
    print(f"{name}: rollout {time.time() - t0:.0f} s, {int(np.asarray(traj.valid).sum())} substeps", flush=True)
    out = {f"traj_{k}": np.asarray(getattr(traj, k)) for k in TRAJ_KEYS}
    out.update(res=np.asarray(res), verts=np.asarray(verts), ang_inertia=np.asarray(inertia),
               frames=np.asarray(GRID_FRAMES))
    return out


def run(args):
    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--"))
    names = [a for a in args if not a.startswith("--")]
    for name in names or list(LATENT_CASES) + list(GRID_CASES):
        if name in LATENT_CASES:
            out = run_latent(name, int(opts.get("fit-seed", FIT_SEED)))
        else:
            out = run_grid(name)
        path = os.path.join(opts.get("out-dir", HERE), f"{name}_f64.npz")
        np.savez_compressed(path, **out)
        print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    run(sys.argv[1:])
