"""Run one cell of the benchmark of diffsdfsim_torch once.

    python3 simbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the output check compared beside its limit); the same numbers are
the last lines of standard error. Exits with another code than 0, and
prints no result, without a CUDA device, when JAX or the JAX package is
loaded once the window has closed, or on any failure.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".simbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path.insert(0, REPO)

if __name__ == "__main__":
    from simbench import core

    sys.exit(core.main(sys.argv[1:], T_START))
