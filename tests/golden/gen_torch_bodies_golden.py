#!/usr/bin/env python
"""Write the JAX package's ``make_body`` outputs as a golden file.

``tests/test_torch_bodies.py`` holds the port's ``make_body`` against these
(the JAX package's eager template projection and Mirtich inertia take
seconds a body on the CPU). Float64. For each case of that test's
``CASES`` (the bench floor and sphere, a cylinder with custom inertia, a
rounded box): the faces, verts, mass, angular inertia, restitution and
friction coefficient, as ``<case>_<field>``; and the numpy dict
(``tests/torch_jax_bridge.jax_body_np``) of a sphere of radius 0.5 at subdiv
2 with the default coefficients, as ``interop_<key>``.

Run from the repository root (~30 s):

    python tests/golden/gen_torch_bodies_golden.py

It writes ``tests/golden/bodies_f64.npz`` next to itself.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

FIELDS = ("faces", "verts", "mass", "ang_inertia", "restitution", "fric_coeff")


def main():
    from diffsdfsim_tpu.physics import shapes as jshapes
    from diffsdfsim_tpu.physics.bodies import make_body
    from test_torch_bodies import CASES
    from torch_jax_bridge import jax_body_np

    out = {}
    for name, kind, params, kw in CASES:
        jb = make_body(getattr(jshapes, kind)(**{k: jnp.asarray(v) for k, v in params.items()}), **kw)
        assert jb.is_sdf
        for field in FIELDS:
            out[f"{name}_{field}"] = np.asarray(getattr(jb, field))
    for key, val in jax_body_np(make_body(jshapes.SphereShape(jnp.asarray(0.5)), subdiv=2)).items():
        out[f"interop_{key}"] = np.asarray(val)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bodies_f64.npz")
    np.savez_compressed(path, **out)
    print("wrote", path)


if __name__ == "__main__":
    main()
