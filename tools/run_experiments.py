#!/usr/bin/env python3
"""Run each fitting experiment's ``main`` a few iterations, single and as
seed sweeps on both sweep backends, then ``evaluate`` over the run
directories they wrote.

    python3 tools/run_experiments.py [--base DIR] [--device cpu] [--only NAME,...]

The runs (each ``main`` as a user calls it, in this one process):
``optim_sphere`` (n_par 1, 4, and 3 with ``sweep_backend=vmap``),
``optim_sysid`` for mass, force and friction (n_par 1, 4, and 3 with
``sweep=vmap``) and ``optim_shapespace`` (n_par 1 and 4), two iterations
each (the shape space one); ``optim_pointcloud`` (sphere and cube) and
``optim_pointcloud_real`` (on ``synthetic_recording``'s recording: the
reference's real-world recording is not in the repository) at their
defaults. ``--only`` keeps the runs of the named modules. Each run's wall
time and the parameter errors it prints are echoed; a run that raises is
reported and the script goes on, then exits 1. The run directories go under
DIR (default ``chiprun_out/experiments``). The device is the card unless
``--device cpu`` is given.
"""

import argparse
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = [("optim_sphere", "trajectory_fitting_sphere", args) for args in (
    ["n_par=1", "max_iter=2"], ["n_par=4", "max_iter=2"], ["n_par=3", "max_iter=2", "sweep_backend=vmap"])]
RUNS += [("optim_sysid", f"sysid_{p}", [f"param={p}"] + args) for p in ("mass", "force", "friction") for args in (
    ["n_par=1", "max_iter=2"], ["n_par=4", "max_iter=2"], ["n_par=3", "max_iter=2", "sweep=vmap"])]
RUNS += [("optim_shapespace", "trajectory_fitting_shapespace", args) for args in (
    ["n_par=1", "max_iter=1"], ["n_par=4", "max_iter=1"])]
RUNS += [("optim_pointcloud", f"pointcloud_{shape}", [f"shape={shape}"]) for shape in ("sphere", "cube")]
RUNS += [("optim_pointcloud_real", "pointcloud_real", ["data_path={recording}"])]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default=os.path.join(ROOT, "chiprun_out", "experiments"))
    ap.add_argument("--device", default=None)
    ap.add_argument("--only", default=None)
    opts = ap.parse_args()
    sys.path.insert(0, ROOT)
    import importlib

    from diffsdfsim_torch.experiments import evaluate
    from diffsdfsim_torch.experiments.optim_pointcloud_real import synthetic_recording

    os.makedirs(opts.base, exist_ok=True)
    recording = os.path.join(opts.base, "synthetic_recording.pkl")
    synthetic_recording(recording)
    only = None if opts.only is None else set(opts.only.split(","))
    failed, dirs = [], {}
    for module, exp, args in RUNS:
        if only is not None and module not in only:
            continue
        mod = importlib.import_module(f"diffsdfsim_torch.experiments.{module}")
        args = [a.format(recording=recording) for a in args]
        argv = ["with", *args, f"base_dir={opts.base}"]
        t0 = time.perf_counter()
        try:
            mod.main(argv, device=opts.device)
            dirs[exp] = os.path.join(opts.base, exp)
            print(f"ok {time.perf_counter() - t0:.1f} s: {module} {' '.join(args)}", flush=True)
        except Exception:
            traceback.print_exc()
            failed.append(f"{module} {' '.join(args)}")
            print(f"FAILED {time.perf_counter() - t0:.1f} s: {module} {' '.join(args)}", flush=True)
    for exp, d in sorted(dirs.items()):
        stats = evaluate.main([d])
        print(f"evaluate {exp}: {stats}", flush=True)
    print(f"runs failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
