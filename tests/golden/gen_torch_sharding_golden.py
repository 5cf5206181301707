#!/usr/bin/env python
"""Write the JAX package's seed sweep of ``tests/scenes_sharding.py`` as
golden files, for the port's sharded sweep (``diffsdfsim_torch.parallel``).

- ``cpu``: runs ``tests/test_torch_sharding.py`` once with its JAX calls live
  (``tests/torch_jax_bridge.JaxGolden``): JAX's unsharded
  ``batched_rollout(jax.value_and_grad(loss))`` of the ``cpu`` size (8
  seeds, 14 frames; ``diffsdfsim_tpu/parallel/sharding.py``), each lane's
  loss and its gradient with respect to (rad, drop). It writes
  ``tests/golden/sharding_jax.pkl`` (~1-2 min, most of it compiling).
- ``card``: ``dryrun_multichip``'s ``seed_step`` of the ``card`` size (the
  bench's configuration, 16 seeds, 20 frames) through JAX's batched-native
  rollout, jitted, float64 on the CPU: each lane's loss, d loss / d rad,
  the updated radius and the trajectory's discrete decisions, lanes first.
  It writes ``tests/golden/sharding_card_f64.npz``, which
  ``chip_smoke.phase_sharding`` reads (several minutes, most of it
  compiling).

Run from the repository root:

    python tests/golden/gen_torch_sharding_golden.py [cpu] [card]
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def card():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import functools

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    import scenes_sharding as ss
    from __graft_entry__ import _bounce_loss

    # the card size is the dry run's bench-scale configuration
    from diffsdfsim_tpu.config import SimConfig

    spec, _ = _bounce_loss(bench_scale=True).world_fn(jnp.asarray(0.5), jnp.asarray(1.2))
    assert spec.cfg == SimConfig(**ss.SIZES["card"]["cfg"]), spec.cfg
    rads, drops = ss.seeds("card")
    t0 = time.perf_counter()
    out = jax.jit(functools.partial(ss.jax_seed_step, "card"))(jnp.asarray(rads), jnp.asarray(drops))
    out = {k: np.asarray(v) for k, v in out.items()}
    print(f"card: {time.perf_counter() - t0:.1f} s; losses {out['loss'].tolist()}; d loss / d rad "
          f"{out['d_rad'].tolist()}; {int(out['valid'].sum())} lane substeps")
    path = os.path.join(HERE, "sharding_card_f64.npz")
    np.savez_compressed(path, rads=rads, drops=drops, **out)
    print(f"wrote {path}")


if __name__ == "__main__":
    which = sys.argv[1:] or ["cpu", "card"]
    rc = 0
    if "card" in which:
        card()
    if "cpu" in which:
        from torch_jax_bridge import record_golden

        rc = record_golden("test_torch_sharding.py")
    sys.exit(rc)
