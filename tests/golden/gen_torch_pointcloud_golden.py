#!/usr/bin/env python
"""Write the JAX package's point-cloud experiments as golden files.

The PyTorch port's ``optim_pointcloud`` and ``optim_pointcloud_real``
(``diffsdfsim_torch/experiments``) are held against these by
``tests/test_torch_pointcloud.py`` and ``chip_smoke.py`` without running a
JAX rollout. Float64 on the CPU (XLA solver and contact-search paths).

- ``sphere`` and ``cube``: ``optim_pointcloud.main``'s steps at its full
  width (128 x 96, ``mesh_subdiv`` 2, ``run_time`` 1.0: 30 frames) with the
  draws of ``PRNGKey(SEED)``: the draws (target size and quaternion, the
  start's noise), the target trajectory, the observations (the body's
  segmentation mask of every frame, the observed points where it is set;
  JAX's ``jax.random`` depth noise cannot be drawn by the port, so the port's
  losses are evaluated on these observations), the full depth and
  segmentation of frames 0 and 29, then ``FRAME_ITERS`` first-frame Adam
  steps and ``TRAJ_ITERS`` trajectory Adam steps from their result: each
  step's packed parameters [pos, quat, size], loss and gradient.
- ``real``: ``optim_pointcloud_real.main`` for ``REAL_ITERS`` Adam steps on
  the synthetic recording of ``tests/test_pointcloud_real.py``
  (``mesh_subdiv`` 1): each step's loss and the parameters after it.

Run from the repository root (minutes per case, most of it compiling; run
the cases in parallel in the background):

    python tests/golden/gen_torch_pointcloud_golden.py [sphere | cube | real ...]

It writes ``pointcloud_<case>_f64.npz`` next to itself.
"""

import os
import sys
import tempfile
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
import optax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FRAME_ITERS, TRAJ_ITERS, REAL_ITERS = 3, 2, 3
TRAJ_KEYS = ("t", "quat", "pos", "valid", "n_halvings")


def pointcloud_case(shape):
    from diffsdfsim_tpu.experiments import optim_pointcloud as op
    from diffsdfsim_tpu.physics import rollout
    from diffsdfsim_tpu.utils.quaternion import random_quaternions

    c = dict(op.DEFAULTS, shape=shape, seed=SEED)
    cfg = op.build_cfg(c)
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(SEED), 5)
    target_size = jax.random.uniform(k1, (), minval=c["min_dim"], maxval=c["max_dim"], dtype=jnp.float64)
    target_pos = jnp.asarray([0.0, 2.0, 0.0])
    target_quat = random_quaternions(k2, 1, dtype=jnp.float64)[0]
    spec_t, state_t = op.make_scene(c, cfg, target_size, target_pos, target_quat)
    n_frames = int(round(c["run_time"] / cfg.dt))
    _, traj_t = rollout(spec_t, state_t, n_frames=n_frames)
    cam, cam_pose = op.camera_setup(c)
    obs = op.observe(c, cfg, spec_t, traj_t, cam, cam_pose, k3)
    segs = np.stack([np.asarray(seg) for (_, _, seg) in obs])
    masks = [(seg == 1) for (_, _, seg) in obs]
    pcs = np.stack([np.asarray(pc) for (_, pc, _) in obs])
    pos_noise = jax.random.normal(k4, (3,), jnp.float64)
    quat_noise = jax.random.normal(k5, (4,), jnp.float64)
    init_pos = target_pos + pos_noise * 0.1
    init_quat = target_quat + quat_noise * 0.1
    init_quat = init_quat / jnp.linalg.norm(init_quat)
    init_size = jnp.asarray(0.5 * (c["min_dim"] + c["max_dim"]), jnp.float64)
    out = dict(seed=SEED, target_size=target_size, target_quat=target_quat, pos_noise=pos_noise,
               quat_noise=quat_noise, seg=segs.astype(np.int8), obs_pts=pcs[segs == 1],
               obs_t=np.asarray([float(t) for (t, _, _) in obs]))
    for key in TRAJ_KEYS:
        out[f"tgt_{key}"] = np.asarray(getattr(traj_t, key))
    for i in (0, n_frames - 1):
        depth, seg = op.render_depth_seg(spec_t.bodies, traj_t.quat[i, 0], traj_t.pos[i, 0], cam, cam_pose)
        out[f"depth_{i}"], out[f"seg_{i}"] = np.asarray(depth), np.asarray(seg)

    def frame_loss(params):
        pos, quat, size = params
        quat = quat / jnp.linalg.norm(quat)
        return op.match_pointcloud(obs[0][1], masks[0], cam_pose, op._make_shape(c, size), pos, quat)

    def traj_loss(params):
        pos, quat, size = params
        quat = quat / jnp.linalg.norm(quat)
        spec, state = op.make_scene(c, cfg, size, pos, quat)
        _, traj = rollout(spec, state, n_frames=n_frames)
        loss = 0.0
        sim_t = traj.t[:, 0]
        shp = op._make_shape(c, size)
        for (t_o, pc, _), seg in zip(obs, masks):
            i = jnp.argmin(jnp.abs(sim_t - t_o))
            loss = loss + op.match_pointcloud(pc, seg, cam_pose, shp, traj.pos[i, 0, 1], traj.quat[i, 0, 1])
        return loss / len(obs)

    def steps(name, loss_fn, params, lr, iters):
        opt = optax.adam(lr)
        state = opt.init(params)
        vg = jax.jit(jax.value_and_grad(loss_fn))
        xs, losses, grads = [], [], []
        for _ in range(iters):
            t0 = time.time()
            val, g = vg(params)
            xs.append(np.concatenate([np.asarray(p).reshape(-1) for p in params]))
            losses.append(float(val))
            grads.append(np.concatenate([np.asarray(p).reshape(-1) for p in g]))
            upd, state = opt.update(g, state)
            params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
            params = (params[0], params[1] / jnp.linalg.norm(params[1]), params[2])
            print(f"{name} step {len(xs)}: loss {losses[-1]!r} ({time.time() - t0:.1f} s)", flush=True)
        out[f"{name}_x"], out[f"{name}_loss"], out[f"{name}_grad"] = np.stack(xs), np.asarray(losses), np.stack(grads)
        return params

    params = steps("frame", frame_loss, (init_pos, init_quat, init_size), c["lr_pose"], FRAME_ITERS)
    steps("traj", traj_loss, params, c["lr_size"], TRAJ_ITERS)
    return out


def real_case():
    from test_pointcloud_real import _make_fixture

    from diffsdfsim_tpu.experiments import optim_pointcloud_real as opr

    with tempfile.TemporaryDirectory() as tmp:
        r_target = _make_fixture(os.path.join(tmp, "rec.pkl"))
        log = []
        orig = opr.Run.log_scalar
        opr.Run.log_scalar = lambda self, name, value, step=None: (log.append(float(value)),
                                                                    orig(self, name, value, step))
        try:
            res = opr.main(["with", f"data_path={os.path.join(tmp, 'rec.pkl')}", f"max_iter={REAL_ITERS}",
                            "mesh_subdiv=1", f"base_dir={os.path.join(tmp, 'out')}"])
        finally:
            opr.Run.log_scalar = orig
    return dict(r_target=r_target, loss=np.asarray(log), size=np.asarray(res["size"]),
                pos0=np.asarray(res["pos0"]), rot0=np.asarray(res["rot0"]))


CASES = {"sphere": lambda: pointcloud_case("sphere"), "cube": lambda: pointcloud_case("cube"), "real": real_case}


def main(argv):
    for case in argv or list(CASES):
        t0 = time.time()
        out = CASES[case]()
        path = os.path.join(HERE, f"pointcloud_{case}_f64.npz")
        np.savez_compressed(path, **{k: np.asarray(v) for k, v in out.items()})
        print(f"{case}: wrote {path} in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
