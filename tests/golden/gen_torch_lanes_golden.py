#!/usr/bin/env python
"""Write the JAX package's seed sweeps of grid, bowl, hull and 2D-grid
bodies as golden files.

The port's lane bodies of every shape class are held against them by
``tests/test_torch_lanes.py`` (the ``cpu`` size) and by
``chip_smoke.phase_lanes_3d`` / ``phase_lanes_2d`` (the ``card`` size),
without compiling a JAX rollout. The sweeps are ``tests/scenes_lanes.py``'s, float64 on the CPU
through the XLA paths:

- ``grid``: ``make_world_batched`` and ``rollout_batched``, with the sum
  of the lanes' final heights and its gradient with respect to the lanes'
  scales (``jax.value_and_grad`` of the batched rollout);
- ``bowl`` and ``hull``: ``make_world_batched`` and ``rollout_batched``,
  forward;
- ``grid2d``: each lane's single ``rollout`` with its final height and d /
  d grid values, the grid body projected op by op
  (``gen_torch_2d_golden.eager_grid_projection``: JAX's compiled 2D grid
  gradient loses a tie test, ROADMAP queue 3, item 25), the contacts at
  each substep's pose compiled (``c_*``, the port's reference, as the 2D
  goldens') and op by op (``e_*``: where JAX's two executions keep other
  points, a tie is witnessed; ``scenes_lanes.hold_lane``).

Each sweep stores ``<sweep>/<key>`` for the trajectory's keys with the lane
axis first ((B, T, S, ...)) and, where there is one, ``<sweep>/value`` and
``<sweep>/grad`` (its inputs are ``scenes_lanes.inputs``).

Run from the repository root (name sweeps to run only those; ``--size
card`` writes the card's, minutes each, most of it compiling):

    python tests/golden/gen_torch_lanes_golden.py [--size cpu|card] [sweep ...]

It writes ``tests/golden/lanes_f64.npz`` (``lanes_card_f64.npz``) next to
itself.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import scenes2d  # noqa: E402
import scenes_lanes as SL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = {"cpu": os.path.join(HERE, "lanes_f64.npz"), "card": os.path.join(HERE, "lanes_card_f64.npz")}


def lanes_first(traj):
    """A batched Trajectory's leaves with the lane axis first."""
    return {k: np.moveaxis(np.asarray(getattr(traj, k)), 1 if k == "truncated" else 2, 0)
            for k in scenes2d.TRAJ_KEYS}


def batched(P, sweep, size):
    """``rollout_batched`` of the sweep (with d sum of final heights / d
    scales for the grid sweep)."""
    build = SL.world_fn(P, sweep, size)
    ins = [jnp.asarray(x) for x in SL.inputs(sweep, size)]
    n = SL.frames(sweep, size)
    body = 2 if sweep == "hull" else 1

    def run(*args):
        spec, bodies_b, state_b = P.p3.make_world_batched(build, *args)
        final, traj = P.p3.rollout_batched(spec, bodies_b, state_b, n)
        return jnp.sum(final.pos[:, body, 1]), traj

    out = {}
    if sweep == "grid":
        (val, traj), grad = jax.jit(jax.value_and_grad(lambda s: run(ins[0], s), has_aux=True))(ins[1])
        out.update(value=np.asarray(val), grad=np.asarray(grad))
    else:
        _, traj = jax.jit(run)(*ins)
    out.update(lanes_first(traj))
    return out


def singles_2d(P, size):
    """The 2D grid sweep lane by lane: each lane's single rollout (the grid
    body projected op by op), its final height and d / d grid values, and
    its contacts at each substep's pose."""
    from diffsdfsim_tpu.physics.contacts import find_contacts
    from gen_torch_2d_golden import eager_grid_projection

    build = SL.world_fn(P, "grid2d", size)
    n = SL.frames("grid2d", size)
    per = []
    for g in SL.inputs("grid2d", size)[0]:
        g = jnp.asarray(g)
        with eager_grid_projection("grid"):
            spec, state = build(g)  # the projection, eagerly, outside the jits

            def height(x):
                sp, st = build(x)
                final, traj = P.rollout(sp, st, n)
                return final.pos[1, 1], traj

            (val, traj), grad = jax.jit(jax.value_and_grad(height, has_aux=True))(g)
        tr = {k: np.asarray(getattr(traj, k)) for k in scenes2d.TRAJ_KEYS}
        T, S, nb = tr["pos"].shape[:3]
        one = jax.jit(jax.vmap(lambda q, p: find_contacts(spec.bodies, q, p, spec.directed_pairs, spec.n_unordered,
                                                          spec.cfg)))
        c = one(jnp.asarray(tr["quat"].reshape(T * S, nb, 4)), jnp.asarray(tr["pos"].reshape(T * S, nb, 3)))
        for k in scenes2d.CONTACT_KEYS:
            x = np.asarray(getattr(c, k))
            tr[f"c_{k}"] = x.reshape((T, S) + x.shape[1:])
            tr[f"e_{k}"] = np.zeros_like(tr[f"c_{k}"])
        # the same contacts op by op (eager JAX) at each valid substep: where
        # the two executions keep other points, rounding decides (the tie
        # witness of scenes_lanes.hold_lane)
        for f in range(T):
            for s_ in range(S):
                if tr["valid"][f, s_]:
                    e = find_contacts(spec.bodies, jnp.asarray(tr["quat"][f, s_]), jnp.asarray(tr["pos"][f, s_]),
                                      spec.directed_pairs, spec.n_unordered, spec.cfg)
                    for k in scenes2d.CONTACT_KEYS:
                        tr[f"e_{k}"][f, s_] = np.asarray(getattr(e, k))
        tr.update(value=np.asarray(val), grad=np.asarray(grad))
        per.append(tr)
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def main(argv):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("sweeps", nargs="*")
    ap.add_argument("--size", default="cpu", choices=("cpu", "card"))
    args = ap.parse_args(argv)
    path = OUT[args.size]
    out = dict(np.load(path)) if os.path.exists(path) else {}
    P = SL.namespace("jax")
    for sweep in args.sweeps or SL.SWEEPS:
        t0 = time.time()
        res = singles_2d(P, args.size) if sweep == "grid2d" else batched(P, sweep, args.size)
        out = {k: v for k, v in out.items() if not k.startswith(sweep + "/")}
        out.update({f"{sweep}/{k}": v for k, v in res.items()})
        np.savez_compressed(path, **out)
        print(f"{sweep} ({args.size}): {time.time() - t0:.0f} s, {int(res['valid'].sum())} lane substeps"
              + (f", value {np.asarray(res['value']).tolist()}" if "value" in res else ""), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
