#!/usr/bin/env python
"""Write the JAX side of ``tests/test_torch_sweep_knobs.py`` as a golden
file: the test runs once with its JAX calls live
(``tests/torch_jax_bridge.JaxGolden``), which writes each JAX result, keyed
by test and call, to ``tests/golden/sweep_knobs_jax.pkl``; the tier-1 run
reads them from there.

Run from the repository root (~26 min on one CPU process, most of it
compiling the JAX package's rollout gradients):

    python tests/golden/gen_torch_sweep_knobs_golden.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                                "tests"))

from torch_jax_bridge import record_golden  # noqa: E402

if __name__ == "__main__":
    sys.exit(record_golden("test_torch_sweep_knobs.py"))
