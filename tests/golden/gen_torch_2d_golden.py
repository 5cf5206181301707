#!/usr/bin/env python
"""Write the JAX package's 2D scenes as a golden file.

The port's 2D facade (``diffsdfsim_torch/physics2d``) is held against it by
``tests/test_torch_physics2d.py``, ``test_torch_narrowphase2d.py`` and
``test_torch_marching2d.py`` on the CPU and by ``chip_smoke.phase_2d`` on
the card, without compiling a JAX rollout. The scenes are
``tests/scenes2d.py``'s (the JAX package's own 2D tests), float64 on the
CPU through the XLA paths:

- each case of ``scenes2d.CASES``: its trajectory ((T, S, ...) leaves),
  the surface vertices and inertias of its bodies, and for the Frank-Wolfe
  cases the contacts at each substep's pose (``c_valid``, ``c_p1``,
  ``c_pen``, ``c_max_pen_all``; the tie witness's reference);
- each gradient of ``scenes2d.GRADS``: the final height of body 1 and its
  derivative with respect to the circle's radius or the grid's values;
- for the grid cases, the grid body's vertices as the JAX package projects
  them, compiled (``verts1_xla``), beside the op-by-op projection the
  scenes use (``verts1``; ``eager_grid_projection``), with the template
  vertices at which the compiled projection loses a Newton step to a tie
  (``tie1``) and the body's scale (``scale1``): ``tie_witness`` checks
  that the two differ only there, by at most 2e-4 m.

Run from the repository root (a few minutes per case, most of it compiling;
name cases to run only those, which updates them in the file):

    python tests/golden/gen_torch_2d_golden.py [case ...] [--out FILE]

It writes ``tests/golden/scenes2d_f64.npz`` next to itself (or FILE, whose
cases ``--merge FILE ...`` adds to it, for cases run in parallel).
"""

import contextlib
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

import scenes2d  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes2d_f64.npz")


def run_case(P, case):
    (spec, state), n = scenes2d.build(P, case)
    _, traj = jax.jit(lambda st: P.rollout(spec, st, n))(state)
    out = {f"{case}/{k}": np.asarray(getattr(traj, k)) for k in scenes2d.TRAJ_KEYS}
    for i, bd in enumerate(spec.bodies):
        out[f"{case}/verts{i}"] = np.asarray(bd.verts)
        out[f"{case}/inertia{i}"] = np.asarray(bd.ang_inertia)
    if case in scenes2d.FW_CASES:
        # the contacts at each substep's pose, for the tie witness
        from diffsdfsim_tpu.physics.contacts import find_contacts

        T, S, nb = out[f"{case}/pos"].shape[:3]
        one = jax.jit(jax.vmap(lambda q, p: find_contacts(spec.bodies, q, p, spec.directed_pairs, spec.n_unordered,
                                                          spec.cfg)))
        c = one(jnp.asarray(out[f"{case}/quat"].reshape(T * S, nb, 4)), jnp.asarray(out[f"{case}/pos"].reshape(
            T * S, nb, 3)))
        for k in scenes2d.CONTACT_KEYS:
            x = np.asarray(getattr(c, k))
            out[f"{case}/c_{k}"] = x.reshape((T, S) + x.shape[1:])
    return out


def run_grad(P, name):
    n = scenes2d.GRADS[name][2]
    param = P.arr(scenes2d.grad_param(name))
    scenes2d.grad_world(P, name, param)  # the grid body's projection, eagerly, outside the jit

    def height(p):
        spec, state = scenes2d.grad_world(P, name, p)
        final, _ = P.rollout(spec, state, n)
        return final.pos[1, 1]

    val, grad = jax.jit(jax.value_and_grad(height))(param)
    return {f"{name}/value": np.asarray(val), f"{name}/grad": np.asarray(grad)}


@contextlib.contextmanager
def eager_grid_projection(name, seen=None):
    """For a grid case, the grid body's template projection made op by op
    (eager JAX). Compiled, XLA fuses the 2D grid SDF's gradient so that a
    duplicated computation rounds apart from the max it is tested against:
    the max's tie test fails and the gradient is 0 at such points (ROADMAP
    queue 3, item 25), a Newton step of the projection is lost there, and
    the projected mesh moves (``tie_witness`` bounds how far and where). Op
    by op, the JAX package's arithmetic is the port's.

    The projection is ``ops/surface.surface_mesh``'s with the body's own
    shape: Newton steps on the stop-gradient parameters, then the
    differentiable MeshSDF correction ``v - sdf(v; params) n``. A body built
    from concrete parameters is projected on the spot and its (v, n) kept;
    one built inside a jit (a gradient's) reuses them, so ``run_grad``
    builds its world once outside the jit first, from the same values.
    ``seen`` (a dict) receives the template and parameters of the last
    concrete projection."""
    from diffsdfsim_tpu.physics import bodies as jbodies
    from diffsdfsim_tpu.physics2d.facade import GridShape2D
    from diffsdfsim_tpu.utils.spherical import normalize

    if not name.startswith(("grid", "grad_grid")):
        yield
        return
    orig = jbodies.surface_mesh
    kept = {}

    def patched(tv, sdf_fn, grad_fn, params, iters=12):
        if not isinstance(params[0], GridShape2D):
            return orig(tv, sdf_fn, grad_fn, params, iters=iters)
        if not any(isinstance(x, jax.core.Tracer) for x in jax.tree_util.tree_leaves((tv, params))):
            v = tv
            for _ in range(iters):  # eager: each operation on its own
                v = v - sdf_fn(v, *params)[..., None] * grad_fn(v, *params)
            kept["vn"] = (v, normalize(grad_fn(v, *params)))
            if seen is not None:
                seen.update(tv=tv, params=params)
        v, n = kept["vn"]
        return v - sdf_fn(v, *params)[..., None] * n

    jbodies.surface_mesh = patched
    try:
        yield
    finally:
        jbodies.surface_mesh = orig


def tie_witness(verts, verts_xla, tv, params, scale, iters=12, bound=2e-4):
    """Where the eagerly projected grid body (``verts``) differs from the
    JAX package's compiled projection (``verts_xla``, both scaled by
    ``scale``). A template vertex ties where a coordinate of the compiled
    Newton iterate k + 1 equals iterate k while the op-by-op step from
    iterate k moves it. Off the ties the two may differ by the SDF's floor,
    sqrt(1e-24) = 1e-12 of the normalized frame, which the compiled
    projection rounds apart at the surface; at the ties by at most
    ``bound`` m. Returns the tie mask; raises where either fails."""
    from diffsdfsim_tpu.ops.surface import project_to_surface

    shape = params[0]
    its = [np.asarray(project_to_surface(tv, shape.sdf, shape.sdf_grad, iters=k)) for k in range(iters + 1)]
    tie = np.zeros(len(tv), dtype=bool)
    for k in range(iters):
        v = jnp.asarray(its[k])
        step = np.asarray(shape.sdf(v))[:, None] * np.asarray(shape.sdf_grad(v))
        tie |= np.any((its[k + 1] == its[k]) & (its[k] - step != its[k]), axis=1)
    check_ties(verts, verts_xla, tie, scale, bound)
    moved = np.abs(verts - verts_xla).max(axis=1)
    print(f"tie witness: {int(tie.sum())} of {len(tv)} vertices lose a step, moved by at most "
          f"{moved[tie].max():.3e} m; the rest by at most {moved[~tie].max():.3e} m", flush=True)
    return tie


def check_ties(verts, verts_xla, tie, scale, bound=2e-4):
    """The two projections of a grid body differ by at most the SDF's floor
    off the tie vertices ``tie`` and by at most ``bound`` m at them."""
    moved = np.abs(np.asarray(verts) - np.asarray(verts_xla)).max(axis=1)
    floor = (1e-12 + 1e-15) * float(scale)
    assert np.all(moved[~tie] <= floor), f"projections differ off the ties by {moved[~tie].max():.3e} m"
    assert moved.max() <= bound, f"projections differ at the ties by {moved.max():.3e} m"


def main(argv):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--merge", nargs="*", default=[])
    args = ap.parse_args(argv)
    out = dict(np.load(args.out)) if os.path.exists(args.out) else {}
    for path in args.merge:
        out.update(dict(np.load(path)))
    if args.merge:
        np.savez(args.out, **out)
        return
    P = scenes2d.namespace("jax")
    for name in args.names or list(scenes2d.CASES) + list(scenes2d.GRADS):
        print(name, flush=True)
        seen = {}
        with eager_grid_projection(name, seen):
            out.update(run_case(P, name) if name in scenes2d.CASES else run_grad(P, name))
        if name in scenes2d.CASES and seen:
            (spec, _), _ = scenes2d.build(P, name)  # the grid body as the JAX package projects it
            bd = spec.bodies[1]
            out[f"{name}/verts1_xla"] = np.asarray(bd.verts)
            out[f"{name}/scale1"] = np.asarray(seen["params"][0].scale())
            out[f"{name}/tie1"] = tie_witness(out[f"{name}/verts1"], out[f"{name}/verts1_xla"], seen["tv"],
                                              seen["params"], out[f"{name}/scale1"])
        np.savez(args.out, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
