"""The readings the output check's limits are set from, on the card.

    python3 simbench/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 3 4 5] [--faults frozen half_batch altered] [--fault-seeds 6 7 8] [--out FILE]

For each seed, one unit of the cell's traffic runs as a run's window runs
it (the program in the configuration's dtype), and the numbers the check
compares are read against the plain reference (``core.check``), whose
jobs run in worker processes while the card goes on. ``--control-seeds``: the same
with the program in the precision below the configuration's (float32 for
float64), the control that has to fail; ``--faults``: the same with each
fault of ``faults.py`` planted. Prints each reading, then per number the
lower reading (the largest over the sound seeds) and the upper (the
smallest over the control's, and over each fault's), and writes them as
JSON to ``--out``.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import concurrent.futures as cf  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402

import torch  # noqa: E402

from simbench import core, faults  # noqa: E402

LOWER = {torch.float64: torch.float32}  # the precision below the configuration's


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cell = core.Cell(args.workload)
    dtype = getattr(torch, cell.config["dtype"])
    adapter = core.experiment("experiments", cell.config, cell.traffic["unit"])
    runs = [(f, s, f) for f in args.faults for s in args.fault_seeds]
    runs += [("control", s, None) for s in args.control_seeds] + [("sound", s, None) for s in args.seeds]
    pool = cf.ProcessPoolExecutor(args.workers, mp_context=multiprocessing.get_context("spawn"))
    checks = cf.ThreadPoolExecutor(max(1, len(runs)))
    pending = []
    try:
        for kind, seed, fault in runs:
            t = time.perf_counter()
            plant = faults.planted(fault, cell.traffic["unit"], adapter) if fault else contextlib.nullcontext()
            with plant:
                result, job, info = core.run_program(cell, seed, 0.0, False, t,
                                                     dtype=LOWER[dtype] if kind == "control" else None)
            job["threads"] = args.threads
            print(f"{kind} seed {seed}: unit {info['window_s']:.2f} s, set-up {info['setup_s']:.2f} s, "
                  f"lanes not finite {result['failed']}, launches {info['launches']}", flush=True)
            fut = checks.submit(core.check, job, pool.map)
            fut.add_done_callback(lambda f, k=kind, s=seed: print(
                f"{k} seed {s} read: {json.dumps(f.result()) if not f.exception() else repr(f.exception())}",
                flush=True))
            pending.append((kind, seed, fut))
        rows = []
        for kind, seed, fut in pending:
            numbers, notes = fut.result()
            rows.append(dict(kind=kind, seed=seed, numbers=numbers, notes=notes))
            print(f"{kind} seed {seed}: {json.dumps(numbers)} {json.dumps(notes)}", flush=True)
    finally:
        checks.shutdown()
        pool.shutdown()
    names = list(rows[0]["numbers"]) if rows else []
    summary = {}
    for n in names:
        sound = [r["numbers"][n] for r in rows if r["kind"] == "sound"]
        entry = dict(lower=max(sound) if sound else None)
        for kind in ["control"] + list(args.faults):
            vals = [r["numbers"][n] for r in rows if r["kind"] == kind]
            entry[kind] = min(vals) if vals else None
        summary[n] = entry
        print(f"{n}: {json.dumps(entry)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload, rows=rows, summary=summary), f, indent=1)


if __name__ == "__main__":
    main()
