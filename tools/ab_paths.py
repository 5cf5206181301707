#!/usr/bin/env python3
"""Time the port's end-to-end paths of several checkouts on one GPU, to
compare commits within one machine session.

    python3 tools/ab_paths.py ROOT [ROOT ...] [--out FILE] [--paths P,...]

Each ROOT is the root of a checkout (an unpacked ``git archive`` of a
commit). For each ROOT, in the order given, a fresh Python process imports
that checkout's ``chip_smoke.py``, builds its kernels and runs its path
phases with their checks: the bench forward rollout (``forward``), its
gradient (``fwd_bwd``), the seed sweep at B = 16 and 64 (``batched``:
forward and fwd+bwd, lanes against the single path), the grid drop
(``grid``), and the latent drop and fit (``latent``); ``--paths`` picks
some, all but ``batched`` by default. Besides the
paths: ``k3`` and ``k4`` run the checkout's K3 and K4 kernel phases (their
kernel and wrapper times go to the log), ``kernel_times`` times K3's launch
at the bench pairs (R = 3), K4's at N = 100, 576 and 2304, K1's at one bench
LCP and K2's at one and six bench LCPs and one room LCP with CUDA
events around 200 back-to-back launches, the same way in every checkout
(the profiler's trace can drop launches), ``grid_query`` times one
``GridShape`` query (``query_sdfs`` with its gradient, float64, a 64^3
sphere grid, 960 points: the grid drop's most frequent query) by CUDA events
around each synchronized call and by the host clock, median and mean of 200,
and ``digest`` prints the sha256
of the 100-frame bench trajectory and the repr of d loss / d rad at 20, 27
and 100 frames, to tell whether two commits compute bitwise the same;
``sweep_k1_rule`` runs the targets of chip_smoke.py's sysid sweeps (each
parameter) and shape-space sweep with K1's committed rule and the per-lane
one, and prints where lanes part from the single path each time;
``k1_lane_rule`` runs the seed sweep at B = 64 over the 100 frames fwd+bwd
twice, with K1's committed rule (whether a problem's last step was checked
for improvement is decided over the whole launch) and with that decision
taken per lane's group of rungs (as a single rollout's launch takes it),
and prints how far lanes 0, 21, 42 and 63 are from the single path each
time. A root given
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
    from diffsdfsim_torch.ops.qp import blockdiag_inv3, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric, pdipm_fric
    for case, B in ((4, 1), (4, 6), ("room", 1)):
        Q, p, G, h, A, b, F, invQ = cs.case_lcps(case, B, seed=B, device="cuda", dtype=torch.float64)
        k = G.shape[-2] // 10
        st = ("fric", k, 8)
        if case == 4 and B == 1:
            prep = pdipm_fric.prepare(Q, p, G, h, A, b, F, invQ, 10, 1e-12, 3, st)
            ms = cs.cuda_ms(lambda: pdipm_fric.launch(prep), n=200, warm=10)
            print(f"kernel times: K1 float64 k=4 B=1: {ms:.4f} ms (CUDA events, 200 launches)")
        x, y, z, s_ = pdipm_solve_raw(Q, p, G, h, A, b, F, 10, 1e-12, 3, st)
        d = torch.clamp(torch.clamp(z, min=1e-8) / torch.clamp(s_, min=1e-8), max=1e12)
        rx = torch.tensor(np.random.default_rng(B).normal(size=tuple(x.shape)), dtype=torch.float64, device="cuda")
        prep = kkt_grad_fric.prepare(blockdiag_inv3(Q), G, A, F, d, rx, st)
        ms = cs.cuda_ms(lambda: kkt_grad_fric.launch(prep), n=200, warm=10)
        print(f"kernel times: K2 float64 {case if case == 'room' else f'k={k}'} B={B}: {ms:.4f} ms "
              f"(CUDA events, 200 launches)")


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


class k1_rule:
    # within it (per_lane), K1 decides per lane's group of rungs (as a
    # single rollout's launch does) whether a problem's last step was
    # checked for improvement, instead of over the whole launch

    def __init__(self, per_lane):
        self.per_lane, self.group = per_lane, None

    def __enter__(self):
        from diffsdfsim_torch.ops import qp_cuda
        from diffsdfsim_torch.physics import batched

        self.probe, self.finish = batched.probe_dynamics_lanes, qp_cuda._PdipmKernel.finish
        if not self.per_lane:
            return self
        rule = self

        def probe_grouped(bodies, joints, forces, state, dts, cfg, any_contact, **kw):
            rule.group = dts.shape[1]
            try:
                return rule.probe(bodies, joints, forces, state, dts, cfg, any_contact, **kw)
            finally:
                rule.group = None

        def finish_grouped(kernel, args):
            # qp_cuda._PdipmKernel.finish with n_run per group of rungs
            if rule.group is None:
                return rule.finish(kernel, args)
            _, B, nz, neq, neq_real, nineq, _, _, max_iter, _ = args["dims"]
            sol2, ints = args["outs"]
            done_it, cur_imp = ints[:, 0], ints[:, 1]
            g = rule.group
            n_run = torch.clamp(done_it.view(-1, g).amax(1) + 1, max=max_iter).repeat_interleave(g)
            use_cur = (cur_imp != 0) & ((done_it >= max_iter) | (done_it + 1 < n_run))
            sol = torch.where(use_cur[:, None], sol2[1], sol2[0])
            return (sol[:, :nz], sol[:, nz + 2 * nineq : nz + 2 * nineq + neq_real],
                    sol[:, nz + nineq : nz + 2 * nineq], sol[:, nz : nz + nineq])

        batched.probe_dynamics_lanes, qp_cuda._PdipmKernel.finish = probe_grouped, finish_grouped
        return self

    def __exit__(self, *exc):
        from diffsdfsim_torch.ops import qp_cuda
        from diffsdfsim_torch.physics import batched

        batched.probe_dynamics_lanes, qp_cuda._PdipmKernel.finish = self.probe, self.finish


def sweep_k1_rule():
    import numpy as np
    from diffsdfsim_torch.experiments import optim_shapespace as oss
    from diffsdfsim_torch.experiments import optim_sysid as osy

    for param in ("mass", "force", "friction"):
        golden = dict(np.load(cs.SYSID_GOLDEN.format(param)))
        c = dict(osy.DEFAULTS, param=param, n_par=cs.SYSID_B)
        cfg = osy.build_cfg(c)
        targets, starts = osy.draws(c, "cuda")
        targets[0], starts[0] = float(golden["target"]), float(golden["start"])
        lanes = (0, cs.SYSID_B - 1)
        with torch.no_grad():
            singles = {i: cs.traj_np(osy.simulate(targets[i], c, cfg, "cuda")[1]) for i in lanes}
            for per_lane in (False, True):
                with k1_rule(per_lane):
                    tb = cs.traj_np(osy.simulate_batched(targets, c, cfg, "cuda")[1])
                for i in lanes:
                    print(f"sweep k1 rule: sysid {param} targets, K1 decided {'per lane' if per_lane else 'over the launch'}: "
                          f"lane {i} " + cs.partings({"batch": {k: v[i] for k, v in tb.items()}, "single": singles[i]}))
    golden = dict(np.load(cs.LATENT_GOLDEN))
    net = cs.igr_net(torch.float64, tuple(golden["dims"].tolist()), tuple(golden["skip_in"].tolist()),
                     int(golden["weight_seed"]))
    c = dict(oss.DEFAULTS, run_time=int(golden["frames"]) / 30.0, n_par=cs.SHAPE_B)
    cfg = oss.build_cfg(c)
    targets, starts, quats = oss.draws(torch.tensor(golden["codes"], device="cuda"), c)
    with torch.no_grad():
        single = cs.traj_np(oss.simulate(targets[2], quats[2], net, c, cfg, "cuda")[1])
        for per_lane in (False, True):
            with k1_rule(per_lane):
                tb = cs.traj_np(oss.simulate_batched(targets, quats, net, c, cfg, "cuda")[1])
            print(f"sweep k1 rule: shape-space targets, K1 decided {'per lane' if per_lane else 'over the launch'}: "
                  f"lane 2 " + cs.partings({"batch": {k: v[2] for k, v in tb.items()}, "single": single}))


def k1_lane_rule():
    import numpy as np
    from diffsdfsim_torch.physics import make_world_batched, rollout_batched

    lanes, n = (0, 21, 42, 63), cs.N_FRAMES
    rads = cs.lane_rads(64)
    refs = {i: cs.single_reference(rads[i], n) for i in lanes}
    for rule in ("whole launch", "per lane"):
        with k1_rule(rule == "per lane"):
            r = torch.tensor(rads, dtype=torch.float64, device="cuda", requires_grad=True)
            spec, bodies_b, state_b = make_world_batched(cs.sweep_world, r)
            _, traj = rollout_batched(spec, bodies_b, state_b, n)
            (g,) = torch.autograd.grad(cs.lane_losses(traj, n).sum(), r)
        tr = {k: v.detach().cpu().numpy() for k, v in traj._asdict().items()}
        for i in lanes:
            lt, (ref, gref, _) = cs.lane_traj(tr, i), refs[i]
            same = all(np.array_equal(lt[k], ref[k]) for k in ("valid", "n_halvings", "bisect_failed", "truncated"))
            d = np.abs(lt["pos"] - ref["pos"]).reshape(n, -1).max(1)
            first = int(np.nonzero(d > 0)[0][0]) if (d > 0).any() else n
            print(f"k1 lane rule: K1 decided {rule}: B=64 lane {i} vs the single path: decisions identical {same}, "
                  f"pos max diff {d.max():.3e}, first frame that differs {first}, d loss / d rad over {n} frames "
                  f"{float(g[i])!r} vs {gref[n]!r} (rel {abs(float(g[i]) - gref[n]) / abs(gref[n]):.2e})")


# looked up by name: an older checkout's chip_smoke.py lacks the newer phases
PHASES = dict(forward="phase_main_path", fwd_bwd="phase_gradient", batched="phase_batched", grid="phase_grid_path",
              latent="phase_latent_path", k3="phase_k3", k4="phase_k4")
for path in sys.argv[2].split(","):
    fn = globals().get(path) if path not in PHASES else getattr(cs, PHASES[path])
    fn()
"""

# each path's wall time, as chip_smoke.py's path phases print it
WALLS = {
    "forward": r"^main path: \d+ frames in ([0-9.]+) s wall",
    "fwd_bwd": r"^gradient path: \d+ frames fwd\+bwd in ([0-9.]+) s wall",
    "grid": r"^grid path: \d+ frames on a \S+ grid in ([0-9.]+) s wall",
    "latent_fwd": r"^latent path, forward: \d+ frames in ([0-9.]+) s wall",
    "latent_fit": r"^latent path, fit: .* in ([0-9.]+) s wall",
    **{f"batched{b}_fwd": rf"^batched B={b}: forward \d+ frames in ([0-9.]+) s wall" for b in (16, 64)},
    **{f"batched{b}_fwd_bwd": rf"^batched B={b}: .*; fwd\+bwd in ([0-9.]+) s wall" for b in (16, 64)},
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
