"""Seed-sweep job generation.

The port's own copy of ``diffsdfsim_tpu/experiments/generate_jobs.py``, with
the module paths under ``diffsdfsim_torch``. The reference farms 50-seed
sweeps as one process per seed via bash generators
(`experiments/*/generate_*.sh`). The port prefers one process per sweep
(`n_par=50` runs the seeds as the lanes of one batched-native rollout on
the card, ``physics/batched.py``); ``--spmd`` emits those lines, the default
the one-process-per-seed job lists.

  python -m diffsdfsim_torch.experiments.generate_jobs sphere 50
  python -m diffsdfsim_torch.experiments.generate_jobs sphere 50 --spmd
"""

from __future__ import annotations

import sys

VARIANTS = {
    "sphere": [
        "use_gravity=True use_toc_diff=True",
        "use_gravity=True use_toc_diff=False",
        "use_gravity=False use_toc_diff=True",
        "use_gravity=False use_toc_diff=False",
    ],
    "shapespace": [""],
    "pointcloud": ["shape=sphere use_gravity=False", "shape=sphere use_gravity=True",
                   "shape=cube use_gravity=False"],
    "primitives": ["shape=box", "shape=sphere", "shape=cylinder"],
    "sysid": ["param=mass", "param=force", "param=friction"],
}

MODULES = {
    "sphere": "optim_sphere",
    "shapespace": "optim_shapespace",
    "pointcloud": "optim_pointcloud",
    "primitives": "optim_primitives",
    "sysid": "optim_sysid",
}


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) < 2:
        raise SystemExit(f"usage: generate_jobs <{'|'.join(VARIANTS)}> <n_seeds> [--spmd]")
    kind, n = argv[0], int(argv[1])
    spmd = "--spmd" in argv
    mod = f"diffsdfsim_torch.experiments.{MODULES[kind]}"
    lines = []
    for variant in VARIANTS[kind]:
        if spmd:
            lines.append(f"python -m {mod} with {variant} seed=0 n_par={n}".replace("  ", " "))
        else:
            for seed in range(n):
                lines.append(f"python -m {mod} with {variant} seed={seed}".replace("  ", " "))
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
