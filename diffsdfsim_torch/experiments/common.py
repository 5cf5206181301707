"""Experiment infrastructure: config CLI, run dirs, metrics, artifacts.

The port's own copy of ``diffsdfsim_tpu/experiments/common.py`` (plain
Python, no array library).

Replaces the reference's sacred setup (`@ex.config` / `@ex.automain` /
FileStorageObserver / `ex.log_scalar`, e.g. optim_sphere.py:38-41,253-254)
with a dependency-free equivalent writing the same artifact layout:

    outputs/<experiment>/<run_id>/config.json
    outputs/<experiment>/<run_id>/metrics.json   {name: {steps, values}}
    outputs/<experiment>/<run_id>/output.pkl     (pickled histories)
    outputs/<experiment>/<run_id>/run.json       {status, host, duration}

CLI: `python -m diffsdfsim_torch.experiments.optim_shapespace with key=value ...`
(`with k=v` syntax kept for reference-script compatibility; plain `--key value`
also accepted).
"""

from __future__ import annotations

import json
import pickle
import sys
import time
from pathlib import Path


def parse_cli(defaults: dict, argv=None) -> dict:
    """sacred-style `with key=value` + plain `--key value` parsing."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = dict(defaults)
    if argv and argv[0] == "with":
        argv = argv[1:]
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            key, val = tok[2:], argv[i + 1]
            i += 2
        elif "=" in tok:
            key, val = tok.split("=", 1)
            i += 1
        else:
            raise SystemExit(f"cannot parse arg {tok!r}")
        if key not in cfg:
            raise SystemExit(f"unknown config key {key!r}; known: {sorted(cfg)}")
        ref = cfg[key]
        if isinstance(ref, bool):
            cfg[key] = val.lower() in ("1", "true", "yes")
        elif isinstance(ref, int):
            cfg[key] = int(val)
        elif isinstance(ref, float):
            cfg[key] = float(val)
        else:
            cfg[key] = val
    return cfg


class Run:
    """A run directory with metrics and artifacts (FileStorageObserver-like)."""

    def __init__(self, experiment: str, cfg: dict, base_dir: str | None = None):
        base = Path(base_dir or "outputs") / experiment
        base.mkdir(parents=True, exist_ok=True)
        existing = [int(p.name) for p in base.iterdir() if p.name.isdigit()]
        self.run_id = max(existing, default=0) + 1
        self.dir = base / str(self.run_id)
        self.dir.mkdir()
        self.cfg = cfg
        self.metrics: dict = {}
        self._t0 = time.time()
        (self.dir / "config.json").write_text(json.dumps(cfg, indent=2, default=str))

    def log_scalar(self, name: str, value, step: int | None = None):
        m = self.metrics.setdefault(name, {"steps": [], "values": []})
        m["steps"].append(step if step is not None else len(m["steps"]))
        m["values"].append(float(value))

    def save_output(self, obj, name: str = "output.pkl"):
        with open(self.dir / name, "wb") as f:
            pickle.dump(obj, f)

    def finish(self, status: str = "COMPLETED"):
        (self.dir / "metrics.json").write_text(json.dumps(self.metrics))
        (self.dir / "run.json").write_text(
            json.dumps(
                {"status": status, "duration_s": time.time() - self._t0},
                indent=2,
            )
        )
        return self.dir
