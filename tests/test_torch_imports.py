"""The port imports neither JAX nor the JAX package: every module of
``diffsdfsim_torch`` is imported in a fresh interpreter, which must then hold
no ``jax`` and no ``diffsdfsim_tpu`` module, and neither ``pygame`` nor
``matplotlib`` (the 2D recorder and ``utils/viz`` import them only to draw;
the card's machine has neither)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, json, pkgutil, sys
import diffsdfsim_torch
names = ["diffsdfsim_torch"] + [m.name for m in pkgutil.walk_packages(diffsdfsim_torch.__path__, "diffsdfsim_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "diffsdfsim_tpu"))
lazy = sorted(m for m in sys.modules if m.split(".")[0] in ("pygame", "matplotlib"))
print(json.dumps({"modules": names, "bad": bad, "lazy": lazy}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["modules"]) > 40 and "diffsdfsim_torch.experiments.optim_shapespace_inertia" in res["modules"]
    new = ("physics2d.facade", "physics2d.narrowphase", "physics2d.recorder", "ops.marching2d", "utils.checkpoint",
           "utils.profiling", "utils.viz", "demos.meshsdf", "parallel.sharding")
    assert all(f"diffsdfsim_torch.{m}" in res["modules"] for m in new)
    assert res["bad"] == [], res["bad"]
    assert res["lazy"] == [], res["lazy"]
