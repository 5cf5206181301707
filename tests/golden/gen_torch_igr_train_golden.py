#!/usr/bin/env python
"""Write the JAX package's shape-space training step as a golden file.

The PyTorch port's ``models/igr_train.py`` is held against it by
``tests/test_torch_igr_train.py`` and ``chip_smoke.phase_meshes`` without
running JAX. Float64 on the CPU.

``train_tiny_shapespace(PRNGKey(7), dims=(16,)*4, n_pts=64, n_steps=1)``
runs one Adam step; this script also draws, as that function does (the
same key splits), its initial net and codes and the step's points, so that
the port's ``shapespace_loss`` and ``adam_step`` can take them. It stores
the initial weights, biases and codes (``w<i>``, ``b<i>``, ``codes``), the
points (``surfb``, ``uniform``), the step's loss and the trained weights
and codes after it (``w1_<i>``, ``b1_<i>``, ``codes1``). It also writes the
JAX package's cache of that trained space (``load_or_train``'s pickle) as
``igr_space_jax.pkl``, with the decoder's values at seeded points under
each code (``cache_pts``, ``cache_sdf``).

Run from the repository root (~1 min):

    python tests/golden/gen_torch_igr_train_golden.py
"""

import os
import shutil
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
DIMS, LATENT, N_PTS, SEED = (16,) * 4, 2, 64, 7


def main():
    from diffsdfsim_tpu.models.igr import init_implicit_net, make_decoder
    from diffsdfsim_tpu.models.igr_train import default_shape_fns, load_or_train, train_tiny_shapespace

    fns = default_shape_fns()
    key = jax.random.PRNGKey(SEED)
    kp, kc, kt = jax.random.split(key, 3)
    # train_tiny_shapespace's own draws (igr_train.py:72-83, :113-127)
    skip = (len(DIMS) // 2,)
    params0 = init_implicit_net(kp, d_in=3 + LATENT, dims=DIMS, skip_in=skip, radius_init=0.5)
    codes0 = 0.3 * jax.random.normal(kc, (len(fns), LATENT), dtype=jnp.float64)
    ku, ks, kn = jax.random.split(jax.random.split(kt, 1)[0], 3)
    uniform = jax.random.uniform(ku, (N_PTS, 3), minval=-1.0, maxval=1.0, dtype=jnp.float64)
    surfb = []
    for fn in fns:
        p = jax.random.uniform(ks, (N_PTS, 3), minval=-1.0, maxval=1.0, dtype=jnp.float64)
        d = fn(p)
        g = jax.vmap(jax.grad(lambda q: fn(q[None])[0]))(p)
        g = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-6)
        surfb.append(jnp.clip(p - d[:, None] * g + 0.05 * jax.random.normal(kn, (N_PTS, 3), dtype=jnp.float64),
                              -1.0, 1.0))
    params1, codes1, loss = train_tiny_shapespace(key, latent_size=LATENT, dims=DIMS, n_steps=1, n_pts=N_PTS)
    out = dict(codes=codes0, surfb=jnp.stack(surfb), uniform=uniform, loss=loss, codes1=codes1,
               skip_in=np.asarray(skip))
    for tag, prm in (("", params0), ("1_", params1)):
        out.update({f"w{tag}{i}": w for i, w in enumerate(prm.weights)})
        out.update({f"b{tag}{i}": b for i, b in enumerate(prm.biases)})

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "space.pkl")
        cparams, ccodes = load_or_train(path, key=key, latent_size=LATENT, dims=DIMS, n_steps=1, n_pts=N_PTS)
        shutil.copy(path, os.path.join(HERE, "igr_space_jax.pkl"))
    pts = jnp.asarray(np.random.default_rng(1).uniform(-1.0, 1.0, size=(32, 3)))
    dec = make_decoder(cparams)
    out["cache_pts"] = pts
    out["cache_sdf"] = jnp.stack([dec(pts, z) for z in ccodes])
    np.savez_compressed(os.path.join(HERE, "igr_train_f64.npz"), **{k: np.asarray(v) for k, v in out.items()})
    print("wrote igr_train_f64.npz and igr_space_jax.pkl")


if __name__ == "__main__":
    main()
