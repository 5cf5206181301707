#!/usr/bin/env python
"""Write the JAX side of ``tests/test_torch_qp.py`` as a golden file.

That test holds the port's PDIPM forward against the JAX package on inputs
made from numpy seeds; each JAX program it compiles (the jitted PDIPM solve
per problem shape, the residuals) takes seconds to build. This script runs the test file once with its JAX calls live
(``tests/torch_jax_bridge.JaxGolden``, every test, slow ones included),
which writes each JAX result, keyed by test and call, to
``tests/golden/qp_jax.pkl``; the tier-1 run reads them from there.

Run from the repository root (~1 min):

    python tests/golden/gen_torch_qp_golden.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                                "tests"))

from torch_jax_bridge import record_golden  # noqa: E402

if __name__ == "__main__":
    sys.exit(record_golden("test_torch_qp.py"))
