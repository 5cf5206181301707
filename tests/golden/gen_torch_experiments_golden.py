#!/usr/bin/env python
"""Write the JAX package's fitting experiments as golden files.

The PyTorch port's ``optim_sysid``, ``optim_sphere`` and
``optim_shapespace`` sweeps (``diffsdfsim_torch/experiments``) are held
against these by ``tests/test_torch_experiments.py`` and ``chip_smoke.py``
without running a JAX rollout. Float64 on the CPU (XLA solver and
contact-search paths). Each case stores JAX's draws, which the port's
explicit-draw functions (``fit``, ``fit_batched``) take.

Sweeps (``tests/test_torch_experiments.py``), 2 lanes each, the draws of
``jax.random.split(PRNGKey(0), 2)`` as the experiment's sweep draws them:

- ``sysid_<param>`` (mass, force, friction): ``optim_sysid``'s batched-native
  sweep (``simulate_batched``, the push magnitude in ``forces_b``) at
  ``run_time`` 0.3 and ``mesh_subdiv`` 1, two Adam steps (lr 0.1, clipped to
  the range): each step's per-lane loss, d loss / d theta and theta after it;
- ``sphere``: ``optim_sphere``'s batched-native sweep (``make_loss_batched``)
  at ``run_time`` 1.0 (the sphere reaches the wall and then the floor) and
  ``mesh_subdiv`` 1, one GD step: loss, d loss / d rad, radius after it;
- ``shapespace``: ``optim_shapespace``'s ``run_one`` on the ``latent32`` net
  of ``gen_torch_shape_golden.py`` (20 frames), lane by lane (the meaning of
  ``jax.vmap(run_one)``), one Adam step: lane 0 has ``latent32``'s draws
  (key 9), lane 1 those of key 13 (both decode to closed surfaces).

Full size (``chip_smoke.py``, one lane each, the single path): ``sysid_
<param>`` (``run_time`` 1.0, ``mesh_subdiv`` 2) and ``sphere``
(``run_time`` 1.5, ``mesh_subdiv`` 2, every other option the default): the
target trajectory, the trajectory at the start value and the first step's
loss and gradient, with the draws of ``PRNGKey(0)``.

Run from the repository root (minutes per case, most of it compiling; run
the cases in parallel in the background):

    python tests/golden/gen_torch_experiments_golden.py [sweep_<case> | full_<case> ...]

It writes ``sweep_<case>_f64.npz`` or ``full_<case>_f64.npz`` next to
itself.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TRAJ_KEYS = ("t", "quat", "pos", "v", "valid", "bisect_failed", "truncated", "n_halvings")
SYSID_SWEEP = dict(run_time=0.3, mesh_subdiv=1, n_par=2)
SPHERE_SWEEP = dict(run_time=1.0, mesh_subdiv=1, n_par=2)
SHAPESPACE_KEYS = (9, 13)


def traj_arrays(prefix, traj):
    return {f"{prefix}_{k}": np.asarray(getattr(traj, k)) for k in TRAJ_KEYS}


def sysid_sweep(param):
    import optax

    from diffsdfsim_tpu.experiments import optim_sysid as m
    from diffsdfsim_tpu.experiments.losses import trajectory_loss

    c = dict(m.DEFAULTS, param=param, **SYSID_SWEEP)
    cfg = m.build_cfg(c)
    lo, hi = m.PARAM_SETUP[param]["range"]

    def draw(k):  # run_sweep_batched's draws
        kt, ks = jax.random.split(k)
        return (jax.random.uniform(kt, (), minval=lo, maxval=hi, dtype=jnp.float64),
                jax.random.uniform(ks, (), minval=lo, maxval=hi, dtype=jnp.float64))

    target, start = jax.vmap(draw)(jax.random.split(jax.random.PRNGKey(0), c["n_par"]))
    tgt = jax.jit(lambda th: m.simulate_batched(th, c, cfg)[1])(target)

    def loss_fn(th):
        _, traj_b = m.simulate_batched(th, c, cfg)
        per_lane = jax.vmap(lambda t, tt: trajectory_loss(t, tt, body=1))(traj_b, tgt)
        return jnp.sum(per_lane), per_lane

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    opt = optax.adam(c["lr"])
    th, s = start, opt.init(start)
    out = dict(target=np.asarray(target), start=np.asarray(start))
    losses, grads, thetas = [], [], []
    for _ in range(2):
        (_, per_lane), g = vg(th)
        upd, s = opt.update(g, s)
        th = jnp.clip(th + upd, lo, hi)
        losses.append(per_lane)
        grads.append(g)
        thetas.append(th)
    out.update(loss=np.asarray(losses), grad=np.asarray(grads), theta=np.asarray(thetas))
    return out


def sphere_sweep():
    from diffsdfsim_tpu.experiments import optim_sphere as m

    c = dict(m.DEFAULTS, **SPHERE_SWEEP)
    cfg = m.build_cfg(c)
    keys = jax.random.split(jax.random.PRNGKey(0), c["n_par"])
    target, start = jax.vmap(lambda k: m.sample_params(k, c))(keys)
    target_trajs, losses = m.make_loss_batched(c, cfg)
    tgt = jax.jit(target_trajs)(target)

    def f(r):
        ls = losses(r, tgt)
        return jnp.sum(ls), ls

    (_, val), g = jax.jit(jax.value_and_grad(f, has_aux=True))(start)
    rad = jnp.clip(start - c["lr"] * g, c["min_dim"], c["max_dim"])  # optax.sgd
    return dict(target=np.asarray(target), start=np.asarray(start), loss=np.asarray(val)[None],
                grad=np.asarray(g)[None], rad=np.asarray(rad)[None], tgt_valid=np.asarray(tgt.valid),
                tgt_n_halvings=np.asarray(tgt.n_halvings))


def shapespace_sweep():
    import optax
    from gen_torch_shape_golden import LATENT_CASES, shapespace_arrays

    from diffsdfsim_tpu.experiments import optim_shapespace as oss
    from diffsdfsim_tpu.experiments.losses import trajectory_loss
    from diffsdfsim_tpu.models.igr import ImplicitNetParams, make_decoder
    from diffsdfsim_tpu.utils.quaternion import random_quaternions

    dims, skip_in, radius, frames = LATENT_CASES["latent32"]
    ws, bs, codes_np = shapespace_arrays(dims, skip_in, radius)
    decoder = make_decoder(ImplicitNetParams(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), skip_in,
                                             ws[0].shape[1]))
    c = dict(oss.DEFAULTS, run_time=frames / 30.0)
    cfg = oss.build_cfg(c)
    codes = jnp.asarray(codes_np)

    def draws(key):  # run_one's draws (optim_shapespace.py:127-135)
        kt, ks, kq = jax.random.split(key, 3)
        target = codes[jax.random.randint(kt, (), 0, codes.shape[0])]
        mean, std = jnp.mean(codes, axis=0), jnp.std(codes, axis=0)
        return target, mean + 0.1 * std * jax.random.normal(ks, mean.shape, jnp.float64), \
            random_quaternions(kq, 1, dtype=jnp.float64)[0]

    drop = jax.jit(lambda z, q: oss.simulate(z, q, decoder, c, cfg)[1])

    def loss_fn(z, q, tgt):
        _, traj = oss.simulate(z, q, decoder, c, cfg)
        return trajectory_loss(traj, tgt, body=1) + c["latent_reg"] * jnp.sum(z**2)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(c["lr"])
    out = {k: [] for k in ("target", "start", "quat0", "loss", "grad", "latent")}
    for key in SHAPESPACE_KEYS:
        target, start, quat0 = draws(jax.random.PRNGKey(key))
        val, g = vg(start, quat0, drop(target, quat0))
        upd, _ = opt.update(g, opt.init(start))
        for k, v in zip(out, (target, start, quat0, val, g, start + upd)):
            out[k].append(np.asarray(v))
    out = {k: np.stack(v) for k, v in out.items()}
    out.update(loss=out["loss"][None], grad=out["grad"][None], latent=out["latent"][None],
               keys=np.asarray(SHAPESPACE_KEYS), frames=np.asarray(frames))
    return out


def sysid_full(param):
    from diffsdfsim_tpu.experiments import optim_sysid as m
    from diffsdfsim_tpu.experiments.losses import trajectory_loss

    c = dict(m.DEFAULTS, param=param)
    cfg = m.build_cfg(c)
    lo, hi = m.PARAM_SETUP[param]["range"]
    kt, ks = jax.random.split(jax.random.PRNGKey(0))  # run_one's draws
    target = jax.random.uniform(kt, (), minval=lo, maxval=hi, dtype=jnp.float64)
    start = jax.random.uniform(ks, (), minval=lo, maxval=hi, dtype=jnp.float64)
    sim = jax.jit(lambda th: m.simulate(th, c, cfg)[1])
    tgt = sim(target)

    def loss_fn(th):
        traj = m.simulate(th, c, cfg)[1]
        return trajectory_loss(traj, tgt, body=1), traj

    (val, traj), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(start)
    return dict(target=np.asarray(target), start=np.asarray(start), loss=np.asarray(val), grad=np.asarray(g),
                **traj_arrays("tgt", tgt), **traj_arrays("start", traj))


def sphere_full():
    from diffsdfsim_tpu.experiments import optim_sphere as m

    c = dict(m.DEFAULTS)
    cfg = m.build_cfg(c)
    target, start = m.sample_params(jax.random.PRNGKey(0), c)
    target_traj, loss_fn = m.make_loss(c, cfg)
    tgt = jax.jit(target_traj)(target)
    val, g = jax.jit(jax.value_and_grad(loss_fn))(start, tgt)
    start_traj = jax.jit(lambda r: m.simulate(r, c, cfg)[1])(start)
    return dict(target=np.asarray(target), start=np.asarray(start), loss=np.asarray(val), grad=np.asarray(g),
                **traj_arrays("tgt", tgt), **traj_arrays("start", start_traj))


SWEEPS = {f"sysid_{p}": (lambda p=p: sysid_sweep(p)) for p in ("mass", "force", "friction")}
SWEEPS.update(sphere=sphere_sweep, shapespace=shapespace_sweep)
FULL = {f"sysid_{p}": (lambda p=p: sysid_full(p)) for p in ("mass", "force", "friction")}
FULL.update(sphere=sphere_full)


def run(names):
    for name in names or [f"sweep_{k}" for k in SWEEPS] + [f"full_{k}" for k in FULL]:
        t0 = time.time()
        kind, case = name.split("_", 1)
        out = (SWEEPS if kind == "sweep" else FULL)[case]()
        print(f"{name}: {time.time() - t0:.0f} s; loss {np.asarray(out['loss']).tolist()}, grad "
              f"{np.asarray(out['grad']).tolist()}", flush=True)
        path = os.path.join(HERE, f"{name}_f64.npz")
        np.savez_compressed(path, **out)
        print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    run(sys.argv[1:])
