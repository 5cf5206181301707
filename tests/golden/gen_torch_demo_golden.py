#!/usr/bin/env python
"""Write the JAX package's MeshSDF demo (``demos/demo_meshsdf.py``) as golden
files.

The port's demo (``diffsdfsim_torch/demos/meshsdf.py``) is held against
them by ``tests/test_torch_demo.py`` (``cpu``: a narrow decoder, two hidden
layers of 32, every body's mesh one subdivision coarser than the demo's,
and 0.5 s of simulation: the body lands on the pole at about 0.37 s, so
the loss depends on the latent; before that only the regularizer does) and
by ``chip_smoke.phase_demo``
(``card``: the demo's defaults, the decoder at the reference's full width,
latent 2, (128,)*8 with the skip at 4, and 1.0 s = 30 frames). The JAX
demo's own ``main`` runs, float64 on the CPU, for 2 SGD iterations from its
``init_implicit_net(PRNGKey(7), ...)`` weights (narrowed for ``cpu``),
which the file stores (``w<i>``, ``b<i>``) beside each iteration's loss
and latent after the step.

Run from the repository root (``cpu`` ~1 min, ``card`` several minutes,
most of it compiling):

    python tests/golden/gen_torch_demo_golden.py [cpu] [card]

It writes ``tests/golden/demo_f64.npz`` and ``demo_card_f64.npz`` next to
itself.
"""

import importlib.util
import os
import pickle
import sys
import tempfile
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# size -> (hidden widths, run_time, subdivisions fewer for every body's
# mesh than the demo's, output file)
SIZES = {"cpu": ((32, 32), 0.5, 1, "demo_f64.npz"), "card": ((128,) * 8, 1.0, 0, "demo_card_f64.npz")}
ITERS = 2


def run(size):
    dims, run_time, coarser, name = SIZES[size]
    spec = importlib.util.spec_from_file_location("demo_meshsdf", os.path.join(ROOT, "demos", "demo_meshsdf.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    orig, kept = demo.init_implicit_net, {}

    def init(key, d_in, radius_init):
        kept["params"] = orig(key, d_in=d_in, dims=dims, radius_init=radius_init)
        return kept["params"]

    demo.init_implicit_net = init
    make_body = demo.make_body

    def coarse_body(shape, **kw):
        return make_body(shape, **dict(kw, subdiv=kw["subdiv"] - coarser))

    demo.make_body = coarse_body
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "out.pkl")
        demo.main([f"iters={ITERS}", f"run_time={run_time}", f"out={out_path}"])
        with open(out_path, "rb") as f:
            hist = pickle.load(f)
    p = kept["params"]
    out = {f"w{i}": np.asarray(w) for i, w in enumerate(p.weights)}
    out.update({f"b{i}": np.asarray(b) for i, b in enumerate(p.biases)})
    out.update(skip_in=np.asarray(p.skip_in), run_time=np.asarray(run_time), iters=np.asarray(ITERS),
               coarser=np.asarray(coarser),
               loss=np.asarray(hist["loss"]), latent=np.stack([np.asarray(z) for z in hist["latent"]]))
    np.savez_compressed(os.path.join(HERE, name), **out)
    print(f"{size}: losses {out['loss'].tolist()}, latents {out['latent'].tolist()}", flush=True)


if __name__ == "__main__":
    for size in sys.argv[1:] or list(SIZES):
        t0 = time.time()
        run(size)
        print(f"{size}: {time.time() - t0:.0f} s", flush=True)
