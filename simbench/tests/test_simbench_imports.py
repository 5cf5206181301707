"""Nothing the benchmark's command loads has ``jax`` or ``diffsdfsim_tpu``
as its top-level module name; nothing under ``simbench/reference`` has
those or ``diffsdfsim_torch``. Names are compared whole (the port's name
begins with the JAX package's)."""

import ast
import json
import subprocess
import sys

from simbench import core

FORBIDDEN_RUN = {"jax", "jaxlib", "flax", "diffsdfsim_tpu"}
FORBIDDEN_REF = FORBIDDEN_RUN | {"diffsdfsim_torch"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=core.REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_what_the_command_loads():
    mods = ["simbench.core", "simbench.calibrate", "simbench.faults", "simbench.experiments.optim_sphere",
            "simbench.experiments.optim_shapespace", "simbench.reference.optim_sphere",
            "simbench.reference.optim_shapespace", "diffsdfsim_torch.parallel",
            "diffsdfsim_torch.ops._build"]
    code = "import sys; sys.path.insert(0, '.')\n" + "\n".join(f"import {m}" for m in mods) + (
        "\nfrom simbench import core\n"
        "for w in core.read_json(core.REPO / 'BENCHMARK.json')['workloads']:\n"
        "    c = core.Cell(w['name'])\n"
        "    [c.reader(m['name']) for m in c.per_layer]; c.counts()\n")
    top = _loaded(code)
    assert "diffsdfsim_torch" in top and "simbench" in top
    assert not top & FORBIDDEN_RUN, top & FORBIDDEN_RUN


def test_what_the_reference_loads():
    top = _loaded("import sys; sys.path.insert(0, '.')\n"
                  "import simbench.reference.optim_sphere, simbench.reference.optim_shapespace")
    assert not top & FORBIDDEN_REF, top & FORBIDDEN_REF


def test_reference_sources_import_nothing_of_the_port():
    for path in (core.ROOT / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN_REF, f"{path}: imports {n}"
