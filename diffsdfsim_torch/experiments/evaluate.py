"""Evaluation / aggregation of experiment runs.

The port's own copy of ``diffsdfsim_tpu/experiments/evaluate.py`` (numpy
only): it reads the run directories the port's experiments write
(``experiments/common.Run``), which have the JAX package's layout.

Replaces the reference eval scripts (`experiments/trajectory_fitting/
eval_sphere.py`, `eval_shapespace.py`, `eval_pointcloud.py`,
`inertia_fitting/eval.py`, `system_identification/eval.py`): walk the run
directories written by experiments/common.Run, assert completion status
(reference eval scripts hard-assert run counts), and aggregate the
min/mean/max error statistics that RESULTS.md tabulates.

Run: python -m diffsdfsim_torch.experiments.evaluate outputs/trajectory_fitting_sphere
"""

from __future__ import annotations

import json
import pickle
import sys
from pathlib import Path

import numpy as np


def read_runs(base: Path, require_completed: bool = True):
    runs = []
    for d in sorted(base.iterdir(), key=lambda p: int(p.name) if p.name.isdigit() else 0):
        if not d.is_dir():
            continue
        run_json = d / "run.json"
        if not run_json.exists():
            continue
        status = json.loads(run_json.read_text()).get("status")
        if require_completed and status != "COMPLETED":
            print(f"skipping {d} with status {status}")
            continue
        out = {}
        if (d / "output.pkl").exists():
            with open(d / "output.pkl", "rb") as f:
                out = pickle.load(f)
        cfg = json.loads((d / "config.json").read_text())
        metrics = (
            json.loads((d / "metrics.json").read_text())
            if (d / "metrics.json").exists()
            else {}
        )
        runs.append(dict(dir=d, cfg=cfg, output=out, metrics=metrics))
    return runs


def param_errors(runs, final_key: str, target_key: str):
    errs = []
    for r in runs:
        out = r["output"]
        if final_key not in out:
            continue
        f = np.atleast_1d(np.asarray(out[final_key], dtype=np.float64))
        t = np.atleast_1d(np.asarray(out[target_key], dtype=np.float64))
        errs.extend(np.abs(f.reshape(-1) - t.reshape(-1)).tolist())
    return np.asarray(errs)


def summarize(errs: np.ndarray, label: str):
    if errs.size == 0:
        print(f"{label}: no runs")
        return {}
    stats = dict(
        n=int(errs.size),
        min=float(errs.min()),
        mean=float(errs.mean()),
        max=float(errs.max()),
        median=float(np.median(errs)),
    )
    print(
        f"{label}: n={stats['n']} min={stats['min']:.3g} "
        f"mean={stats['mean']:.3g} max={stats['max']:.3g}"
    )
    return stats


KEYMAP = {
    "trajectory_fitting_sphere": ("final_rad", "target_rad"),
    "trajectory_fitting_shapespace": ("final_latent", "target_latent"),
    "inertia_fitting_primitives": ("final_params", "target_params"),
    "sysid_mass": ("final_theta", "target_theta"),
    "sysid_force": ("final_theta", "target_theta"),
    "sysid_friction": ("final_theta", "target_theta"),
}


def boxplot(errs_by_label: dict, out_path):
    """Error boxplot across configurations (reference eval scripts produce
    the paper's Tables 1-2 boxplots)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(1.5 + 1.2 * len(errs_by_label), 3.5))
    labels = list(errs_by_label)
    ax.boxplot([errs_by_label[k] for k in labels], tick_labels=labels)
    ax.set_ylabel("parameter error")
    ax.set_yscale("log")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    return out_path


def main(argv=None):
    argv = argv or sys.argv[1:]
    if not argv:
        raise SystemExit("usage: evaluate <outputs/experiment_dir> [expected_n] [--plot]")
    do_plot = "--plot" in argv
    argv = [a for a in argv if a != "--plot"]
    base = Path(argv[0])
    expected = int(argv[1]) if len(argv) > 1 else None
    runs = read_runs(base)
    if expected is not None:
        assert len(runs) >= expected, f"expected {expected} runs, found {len(runs)}"
    fk, tk = KEYMAP.get(base.name, ("final_rad", "target_rad"))
    errs = param_errors(runs, fk, tk)
    stats = summarize(errs, base.name)
    out = base / "summary.json"
    out.write_text(json.dumps(stats, indent=2))
    print("wrote", out)
    if do_plot and errs.size:
        p = boxplot({base.name: errs.tolist()}, base / "errors.png")
        print("wrote", p)
    return stats


if __name__ == "__main__":
    main()
