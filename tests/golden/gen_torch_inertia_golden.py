#!/usr/bin/env python
"""Write the JAX package's inertia-fitting experiments as golden files.

The PyTorch port's ``optim_primitives`` and ``optim_shapespace_inertia``
(``diffsdfsim_torch/experiments``) are held against these by
``tests/test_torch_inertia.py`` and ``chip_smoke.phase_inertia`` without
running JAX. Float64 on the CPU. Each case stores JAX's draws (as
``run_one`` draws them from ``jax.random.split(PRNGKey(0), 1)[0]``), which
the port's explicit-draw ``fit`` takes, the loss and its gradient at the
start point, and ``run_one``'s histories over two Adam steps.

- ``prim_<shape>[_ci|_cm]`` (box, sphere, cylinder): ``optim_primitives`` at
  its defaults (27 frames, ``mesh_subdiv`` 2), plain, with
  ``custom_inertia`` (``_ci``) or with ``custom_mesh`` (``_cm``). The JAX
  experiment does not pass ``custom_mesh`` to ``make_body``; here
  ``make_body`` is given it for the ``_cm`` cases, the meaning the port's
  experiment gives the option.
- ``ssi_tiny`` / ``ssi_full``: ``optim_shapespace_inertia`` with a
  geometric-init decoder drawn from ``numpy.random.default_rng`` (stored,
  ``w<i>`` / ``b<i>``) and 16 codes N(0, 0.3^2): tiny, ``test_shapespace_
  inertia.py``'s config (``run_time`` 0.4, ``mesh_subdiv`` 1) with a
  (32,)*4 net; full, the defaults (``run_time`` 2.0, 60 frames,
  ``mesh_subdiv`` 2) with the reference's (128,)*8 net, skip at 4.

Run from the repository root (1-5 min per case, most of it compiling; run
the cases in parallel in the background):

    python tests/golden/gen_torch_inertia_golden.py [case ...]

It writes ``inertia_<case>_f64.npz`` next to itself.
"""

import functools
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
PRIM = {f"prim_{s}{v}": (s, v) for s in ("box", "sphere", "cylinder") for v in ("", "_ci", "_cm")}
SSI = {"ssi_tiny": (dict(run_time=0.4, mesh_subdiv=1), (32,) * 4, (2,)),
       "ssi_full": (dict(), (128,) * 8, (4,))}
N_ITER = 2


def key0():
    return jax.random.split(jax.random.PRNGKey(0), 1)[0]


def primitives(shape, variant):
    from diffsdfsim_tpu.experiments import optim_primitives as op
    from diffsdfsim_tpu.physics import make_body

    c = dict(op.DEFAULTS, shape=shape, custom_inertia=variant == "_ci", max_iter=N_ITER)
    op.make_body = functools.partial(make_body, custom_mesh=variant == "_cm")
    cfg = op.build_cfg(c)
    key = key0()
    _, _, ka = jax.random.split(key, 3)
    axis = jax.random.normal(ka, (3,), dtype=jnp.float64)
    axis = axis / jnp.linalg.norm(axis)
    out = jax.jit(lambda k: op.run_one(k, c, cfg))(key)
    target_v = op.simulate(out["target_params"], axis, c, cfg).v

    def loss_fn(p):
        return jnp.sum((op.simulate(p, axis, c, cfg).v[0] - target_v[0]) ** 2)

    loss0, grad0 = jax.jit(jax.value_and_grad(loss_fn))(out["start_params"])
    return dict(target=out["target_params"], start=out["start_params"], axis=axis, target_v=target_v,
                loss0=loss0, grad0=grad0, loss_hist=out["loss_hist"], param_hist=out["param_hist"])


def decoder_arrays(dims, skip, latent_size=2, seed=5):
    """A geometric-init net drawn from numpy (as the port's init_implicit_net
    draws it from a numpy Generator) and 16 codes N(0, 0.3^2)."""
    import torch

    from diffsdfsim_torch.models.igr import init_implicit_net

    rng = np.random.default_rng(seed)
    p = init_implicit_net(3 + latent_size, dims, skip, radius_init=0.55, generator=rng,
                          dtype=torch.float64).params()
    codes = rng.standard_normal((16, latent_size)) * 0.3
    return [w.numpy() for w in p.weights], [b.numpy() for b in p.biases], codes


def shapespace_inertia(over, dims, skip):
    from diffsdfsim_tpu.experiments import optim_shapespace_inertia as ssi
    from diffsdfsim_tpu.models.igr import ImplicitNetParams, make_decoder

    c = dict(ssi.DEFAULTS, max_iter=N_ITER, **over)
    cfg = ssi.build_cfg(c)
    ws, bs, codes = decoder_arrays(dims, skip)
    params = ImplicitNetParams(tuple(jnp.asarray(w) for w in ws), tuple(jnp.asarray(b) for b in bs), skip,
                               3 + codes.shape[1])
    decoder = make_decoder(params)
    codes = jnp.asarray(codes)
    key = key0()
    out = jax.jit(lambda k: ssi.run_one(k, decoder, codes, c, cfg))(key)
    target_final, _ = ssi.simulate(out["target_latent"], out["torque_dir"], decoder, c, cfg)

    def loss_fn(z):
        final, _ = ssi.simulate(z, out["torque_dir"], decoder, c, cfg)
        return jnp.sum((final.v[0] - target_final.v[0]) ** 2) + c["latent_reg"] * jnp.sum(z**2)

    loss0, grad0 = jax.jit(jax.value_and_grad(loss_fn))(out["start_latent"])
    res = dict(target=out["target_latent"], start=out["start_latent"], axis=out["torque_dir"], codes=codes,
               target_v=target_final.v, loss0=loss0, grad0=grad0, loss_hist=out["loss_hist"],
               dist_hist=out["dist_hist"], latent_err_hist=out["latent_err_hist"],
               final_chamfer=out["final_chamfer"], final_latent=out["final_latent"], skip_in=np.asarray(skip))
    res.update({f"w{i}": w for i, w in enumerate(ws)})
    res.update({f"b{i}": b for i, b in enumerate(bs)})
    return res


def run(names):
    for name in names or list(PRIM) + list(SSI):
        t0 = time.time()
        out = primitives(*PRIM[name]) if name in PRIM else shapespace_inertia(*SSI[name])
        path = os.path.join(HERE, f"inertia_{name}_f64.npz")
        np.savez_compressed(path, **{k: np.asarray(v) for k, v in out.items()})
        print(f"{name}: {time.time() - t0:.0f} s -> {path}", flush=True)


if __name__ == "__main__":
    run(sys.argv[1:])
