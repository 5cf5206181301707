#!/usr/bin/env python3
"""Time the port's end-to-end paths of several checkouts on one GPU, to
compare commits within one machine session.

    python3 tools/ab_paths.py ROOT [ROOT ...] [--out FILE] [--paths P,...]

Each ROOT is the root of a checkout (an unpacked ``git archive`` of a
commit). For each ROOT, in the order given, a fresh Python process imports
that checkout's ``chip_smoke.py``, builds its kernels and runs its path
phases with their checks: the bench forward rollout (``forward``), its
gradient (``fwd_bwd``), the grid drop (``grid``), and the latent drop and
fit (``latent``); ``--paths`` picks some, all by default. Besides the
paths: ``k3`` and ``k4`` run the checkout's K3 and K4 kernel phases (their
kernel and wrapper times go to the log), ``kernel_times`` times K3's launch
at the bench pairs (R = 3) and K4's at N = 100, 576 and 2304 with CUDA
events around 200 back-to-back launches, the same way in every checkout
(the profiler's trace can drop launches), ``grid_query`` times one
``GridShape`` query (``query_sdfs`` with its gradient, float64, a 64^3
sphere grid, 960 points: the grid drop's most frequent query) by CUDA events
around each synchronized call and by the host clock, median and mean of 200,
and ``digest`` prints the sha256
of the 100-frame bench trajectory and the repr of d loss / d rad at 20, 27
and 100 frames, to tell whether two commits compute bitwise the same. A root given
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


def digest():
    import hashlib
    import numpy as np
    spec, state, rollout = cs.run_rollout("cuda")
    _, traj = rollout(spec, state, cs.N_FRAMES)
    h = hashlib.sha256()
    for v in traj:
        h.update(np.ascontiguousarray(v.detach().cpu().numpy()).tobytes())
    grads = []
    for n in (20, 27, cs.N_FRAMES):
        loss, rad, _ = cs.bench_loss("cuda", n)
        loss.backward()
        grads.append(repr(float(rad.grad)))
    print(f"digest: trajectory sha256 {h.hexdigest()}; d loss / d rad at 20, 27, {cs.N_FRAMES} frames {' '.join(grads)}")


def kernel_times():
    import numpy as np
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp
    cfg = SimConfig(**cs.BENCH_CFG)
    cases = {c[0]: c for c in cs.k3_cases("cuda", torch.float64)}
    for label in ("sphere->floor touch R=3", "floor->sphere touch R=3"):
        _, bd1, bd2, q1, p1, q2, p2 = cases[label]
        prep = fw_search_pair.prepare(bd1, q1, p1, bd2, q2, p2, cfg)
        ms = cs.cuda_ms(lambda: fw_search_pair.launch(prep), n=200, warm=10)
        print(f"kernel times: K3 float64 {label}: {ms:.4f} ms (CUDA events, 200 launches)")
    params = cs.igr_net(torch.float64).params()
    for n in (100, 576, 2304):
        rng = np.random.default_rng(n)
        x = torch.tensor(np.concatenate([rng.normal(size=(n, 2)) * 0.3, rng.uniform(-1.0, 1.0, (n, 3))], axis=1),
                         device="cuda")
        ms = cs.cuda_ms(lambda: igr_mlp.run(params, x), n=200, warm=10)
        print(f"kernel times: K4 float64 N={n}: {ms:.4f} ms (CUDA events, 200 launches)")


def grid_query():
    import time
    import numpy as np
    from diffsdfsim_torch.physics import GridShape
    from diffsdfsim_torch.physics.shapes import query_sdfs
    grid = torch.tensor(cs.sphere_grid(64), device="cuda")
    shape = GridShape(grid=grid, scale_=torch.tensor(0.75, dtype=torch.float64, device="cuda"))
    pts = torch.tensor(np.random.default_rng(960).uniform(-0.8, 0.8, (960, 3)), device="cuda")
    for _ in range(20):
        query_sdfs(shape, pts)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev, host = [], []
    for _ in range(200):
        t0 = time.perf_counter()
        e0.record()
        query_sdfs(shape, pts)
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(e0.elapsed_time(e1))
    print(f"grid query: N=960 on 64^3, CUDA events around a synchronized call median {np.median(ev):.4f} ms, "
          f"mean {np.mean(ev):.4f} ms; host clock median {np.median(host):.4f} ms, mean {np.mean(host):.4f} ms")


for path in sys.argv[2].split(","):
    dict(forward=cs.phase_main_path, fwd_bwd=cs.phase_gradient, grid=cs.phase_grid_path,
         latent=cs.phase_latent_path, k3=cs.phase_k3, k4=cs.phase_k4, kernel_times=kernel_times,
         grid_query=grid_query, digest=digest)[path]()
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
            m = re.search(r"^digest: (.*)$", proc.stdout, re.M)
            runs.append(dict(root=root, rc=proc.returncode, walls=walls, **({"digest": m.group(1)} if m else {})))
            print(f"{root}: rc {proc.returncode}, walls (s) {walls}", flush=True)
    print(json.dumps({"runs": runs}))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
