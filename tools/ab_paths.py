#!/usr/bin/env python3
"""Time the port's end-to-end paths of several checkouts on one GPU, to
compare commits within one machine session.

    python3 tools/ab_paths.py ROOT [ROOT ...] [--out FILE] [--paths P,...]

Each ROOT is the root of a checkout (an unpacked ``git archive`` of a
commit). For each ROOT, in the order given, a fresh Python process imports
that checkout's ``chip_smoke.py``, builds its kernels and runs its path
phases with their checks: the bench forward rollout (``forward``), its
gradient (``fwd_bwd``), the grid drop (``grid``), and the latent drop and
fit (``latent``); ``--paths`` picks some, all by default. A root given
twice runs twice, so ``parent change change parent`` alternates the two.
The processes' output goes to FILE (default ``chiprun_out/ab_paths.log``);
the last line is one JSON object with each path's wall times in seconds,
per root, in run order.
"""

import json
import os
import re
import subprocess
import sys

CHILD = """
import os, sys
root = sys.argv[1]
os.chdir(root)
sys.path.insert(0, root)
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_device_and_build()
for path in sys.argv[2].split(","):
    dict(forward=cs.phase_main_path, fwd_bwd=cs.phase_gradient, grid=cs.phase_grid_path,
         latent=cs.phase_latent_path)[path]()
"""

# each path's wall time, as chip_smoke.py's path phases print it
WALLS = {
    "forward": r"^main path: \d+ frames in ([0-9.]+) s wall",
    "fwd_bwd": r"^gradient path: \d+ frames fwd\+bwd in ([0-9.]+) s wall",
    "grid": r"^grid path: \d+ frames on a \S+ grid in ([0-9.]+) s wall",
    "latent_fwd": r"^latent path, forward: \d+ frames in ([0-9.]+) s wall",
    "latent_fit": r"^latent path, fit: .* in ([0-9.]+) s wall",
}


def main(argv):
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out", "ab_paths.log")
    opts = {"--out": out, "--paths": "forward,fwd_bwd,grid,latent"}
    for opt in opts:
        if opt in argv:
            i = argv.index(opt)
            opts[opt] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    out, paths = opts["--out"], opts["--paths"]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    runs = []
    with open(out, "w") as log:
        for root in argv:
            root = os.path.abspath(root)
            proc = subprocess.run([sys.executable, "-c", CHILD, root, paths], capture_output=True, text=True)
            log.write(f"===== {root} (rc {proc.returncode})\n{proc.stdout}\n{proc.stderr[-4000:]}\n")
            log.flush()
            walls = {}
            for key, pat in WALLS.items():
                m = re.search(pat, proc.stdout, re.M)
                if m:
                    walls[key] = float(m.group(1))
            runs.append(dict(root=root, rc=proc.returncode, walls=walls))
            print(f"{root}: rc {proc.returncode}, walls (s) {walls}", flush=True)
    print(json.dumps({"runs": runs}))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
