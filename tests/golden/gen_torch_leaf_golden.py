#!/usr/bin/env python
"""Write the JAX side of ``tests/test_torch_leaf.py`` as a golden file.

That test holds the port's leaf modules (quaternions, vector helpers, SDFs)
against the JAX package on seeded inputs; eager JAX compiles each of their
operations once, seconds in all. This script runs the test file once with
its JAX calls live (``tests/torch_jax_bridge.JaxGolden``, every test, slow
ones included), which writes each JAX result, keyed by test and call, to
``tests/golden/leaf_jax.pkl``; the tier-1 run reads them from there.

Run from the repository root (~20 s):

    python tests/golden/gen_torch_leaf_golden.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                                "tests"))

from torch_jax_bridge import record_golden  # noqa: E402

if __name__ == "__main__":
    sys.exit(record_golden("test_torch_leaf.py"))
