#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``diffsdfsim_torch/ops/csrc``
(one nvcc per source, all started together), holds each kernel against its
plain PyTorch version on the card, then drives the two paths of the port
on CUDA (float64, the bench scene):

- the forward path: the 100-frame bounce rollout through K1 (PDIPM) and K3
  (Frank-Wolfe search), held against the plain CPU rollout and the JAX
  package's committed golden trajectory;
- the gradient path: d loss / d rad of bench.py's 100-frame loss through
  K1, K3 and K2 (the LCP backward's KKT solve), held against the plain CPU
  gradient and the JAX package's committed golden gradients.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Every check that fails raises, so any failure exits
non-zero. Without a CUDA device it exits non-zero before printing any
result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "bench_rollout_f64.npz")
GRAD_GOLDEN = os.path.join(ROOT, "tests", "golden", "bench_grad_f64.npz")

# bench.py's forward configuration (float64 tolerance)
BENCH_CFG = dict(
    fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=2,
    max_substeps=4, max_bisect=8, tol=1e-8,
)
N_FRAMES = 100
# How the rollout is held against a reference. The discrete decisions
# (valid substeps, accepted rungs, bisection failures, truncated frames)
# must be identical. At a touchdown the sphere's polished candidate points
# lie ~1.5e-4 around its lowest point, mirror-symmetric on the icosphere, so
# their floor-SDF values tie and rounding decides which point is kept; its
# offset sets the tangential impulse (~1e-3 m/s). Two JAX executions of the
# same rollout (whole-rollout jit vs per-frame jit) differ so from the second
# touchdown (frame 27) on, and any other arithmetic order may from the first.
# The bounce itself is held tightly: the sphere's height at 1e-6 and its
# vertical velocity at 1e-5 over the whole run; every component at 5e-2
# (a bounded tangential drift). The first frame where any component leaves
# 1e-7 is reported.
ATOL_Y, ATOL_VY, ATOL_ALL, ATOL_REPORT = 1e-6, 1e-5, 5e-2, 1e-7
# How the gradient d loss / d rad is held: within 1e-4 relative through the
# first bounce (20 frames) and through frame 26 (27 frames); over the whole
# 100 frames within 3e-3 relative, because from the touchdown in frame 26
# the reference's own contact point is decided by rounding (above), and the
# CPU and CUDA runs round differently too (on an H100 the CUDA gradient
# reads 7.2e-4 from the JAX golden value and 1.1e-3 from the CPU port's).
RTOL_GRAD_SHORT, RTOL_GRAD_100 = 1e-4, 3e-3

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s float32 and
# 34 TFLOP/s float64 outside the tensor cores (the kernels use none)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


class Failure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def cuda_ms(fn, n=20, warm=3):
    """Average device time of fn() over n calls, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def device_ms(fn, kernel, n=20):
    """(ms, method): device time of one launch of ``kernel`` (a substring of
    its name) per fn() call from torch.profiler's CUDA trace; where the
    trace shows none, CUDA events around n back-to-back calls (an upper
    bound that includes host launch gaps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
    if total_us > 0:
        return total_us / n / 1e3, "profiler"
    return cuda_ms(fn, n=n), "events"


def bench_bodies(device, dtype):
    import torch
    from diffsdfsim_torch.physics import BoxShape, SphereShape, make_body

    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25,
                      device=device, dtype=dtype)
    sphere = make_body(SphereShape(torch.tensor(0.5)), subdiv=2, fric_coeff=0.25,
                       device=device, dtype=dtype)
    return floor, sphere


# ---------------------------------------------------------------- phase 1


def phase_device_and_build():
    import torch
    from diffsdfsim_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}  count: {torch.cuda.device_count()}  nvidia-smi: {smi}")
    t0 = time.perf_counter()
    logs = _build.build_all(["pdipm_fwd", "fw_search", "kkt_bwd"])
    print(f"build: three kernels in {time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for kname, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        regs = [int(ln.split("Used ")[1].split(" registers")[0]) for ln in lines if "Used " in ln]
        spills = [ln for ln in lines if "spill" in ln and not ln.startswith("0 bytes")]
        nonzero = [ln for ln in spills if " 0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"ptxas {kname}: {len(regs)} kernels, registers {min(regs, default=0)}..{max(regs, default=0)}, "
              f"{len(nonzero)} with spills")
        for ln in lines[: 2 * 4]:
            print(f"  {ln}")
    return name, smi


# ---------------------------------------------------------------- phase 2


def physics_lcps(B, seed, device, dtype):
    """B mixed LCPs of the bench scene at contact (floor -> sphere, four
    contact slots, some invalid), assembled by the port's engine."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import Gravity3D, TotalConstraint3D
    from diffsdfsim_torch.physics.contacts import Contacts
    from diffsdfsim_torch.physics.engine import dump_contact_lcp, mass_matrix_inv
    from diffsdfsim_torch.physics.world import WorldState
    from diffsdfsim_torch.utils.spherical import normalize

    cfg = SimConfig(**BENCH_CFG)
    floor, sphere = bench_bodies("cpu", torch.float64)
    f64 = lambda x: torch.tensor(np.asarray(x, dtype=np.float64))
    rng = np.random.default_rng(seed)
    out = [[] for _ in range(8)]
    for _ in range(B):
        k = 4
        valid = rng.random(k) < 0.7
        valid[0] = True
        n = normalize(f64(np.array([0.0, 1.0, 0.0]) + 0.05 * rng.normal(size=(k, 3))))
        off = rng.normal(size=(k, 3)) * 0.05
        contacts = Contacts(
            normal=n, p1=f64(off + [0.0, 0.5, 0.0]), p2=f64(off + [0.0, -0.5, 0.0]), pen=f64(np.zeros(k)),
            valid=torch.tensor(valid), i1=torch.zeros(k, dtype=torch.long), i2=torch.ones(k, dtype=torch.long),
            pair_id=torch.zeros(k, dtype=torch.long), max_pen_all=f64(0.0),
            pair_active=torch.ones(1, dtype=torch.bool),
        )
        v = np.zeros((2, 6))
        v[1, :3] = rng.normal(size=3) * 0.5
        v[1, 3:] = [rng.normal() * 0.3, -3.0 * rng.random() - 0.1, rng.normal() * 0.3]
        q1 = np.array([1.0, *(0.1 * rng.normal(size=3))])
        quat = f64([[1.0, 0, 0, 0], q1 / np.linalg.norm(q1)])
        state = WorldState(quat=quat, pos=f64([[0.0, -0.5, 0.0], [0.0, 0.5, 0.0]]), v=f64(v), t=f64(0.0),
                           contacts=contacts, last_dt=f64(cfg.dt), had_toc=torch.tensor(False))
        dt = cfg.dt * 0.5 ** int(rng.integers(0, 3))
        args, _ = dump_contact_lcp([floor, sphere], (TotalConstraint3D(body1=0),), ((), (Gravity3D(10.0),)),
                                   state, contacts, dt, cfg)
        for i, a in enumerate(args):
            out[i].append(a[0])
        out[7].append(mass_matrix_inv([floor, sphere], quat))
    return [torch.stack(o).to(device=device, dtype=dtype).contiguous() for o in out]


def k1_flops(done_it, max_iter, nz, neq, nineq, k, fd):
    """FLOPs the reduced PDIPM does for these lanes: per Mehrotra iteration
    a Gauss-Jordan inverse of the m2 x m2 system (4 m2^3), its assembly,
    two KKT solves and the residuals; plus the initial solve."""
    m2 = neq + k + k * fd // 2
    gj = 4 * m2**3 + 6 * m2 * m2
    kkt = 2 * (2 * nz * nz + 2 * (neq + nineq) * nz) + 2 * m2 * m2 + 30 * k * fd
    resid = 2 * (2 * nineq * nz + nz * nz + neq * nz) + 2 * nineq * nineq + 10 * nineq
    per_iter = gj + 2 * kkt + resid + 40 * nineq
    iters = np.minimum(done_it.cpu().numpy() + 1, max_iter).astype(np.int64)
    return int(np.sum((iters + 1) * per_iter))


def phase_k1():
    import torch
    from diffsdfsim_torch.ops.qp import lcp_residuals, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import pdipm_fric

    structure = ("fric", 4, 8)
    rows = {}
    # float32: the plain version keeps the JAX XLA path's f32 rules (d
    # clipped to [1e-5, 1e5], a 1e-6 ridge), the kernel the Pallas kernel's
    # (none), so their x agree only to ~1e-3 of |x| ~ 3; both are also held
    # to their KKT residuals below
    for dtype, eps, tol_x in ((torch.float64, 1e-12, 1e-8), (torch.float32, 1e-6, 1e-2)):
        for B in (3, 6, 576):
            Q, p, G, h, A, b, F, invQ = physics_lcps(B, seed=B, device="cuda", dtype=dtype)
            args = (Q, p, G, h, A, b, F)
            sol_k = pdipm_fric(*args, invQ, 10, eps, 3, structure)
            done_it = pdipm_fric.last_done_it.clone()
            sol_p = pdipm_solve_raw(*args, 10, eps, 3, structure)
            torch.cuda.synchronize()
            res_k = lcp_residuals(*args, sol_k)
            res_p = lcp_residuals(*args, sol_p)
            # x is compared on the lanes the plain version solved (KKT
            # residual <= 1e-3); in float32 some lanes it leaves at ~1e-1
            solved = res_p <= 1e-3
            err = float((sol_k[0] - sol_p[0]).abs()[solved].max())
            floor_res = 1e-6 if dtype == torch.float64 else 1e-2
            bad_res = int((res_k > torch.clamp(10 * res_p, min=floor_res)).sum())
            prep = pdipm_fric.prepare(*args, invQ, 10, eps, 3, structure)
            ms, how = device_ms(lambda: pdipm_fric.launch(prep), "pdipm_fwd_kernel")
            wrapper_ms = cuda_ms(lambda: pdipm_fric(*args, invQ, 10, eps, 3, structure))
            plain_ms = cuda_ms(lambda: pdipm_solve_raw(*args, 10, eps, 3, structure), n=5, warm=1)
            nbytes = sum(t.numel() * t.element_size() for t in (*args, invQ)) + sum(
                t.numel() * t.element_size() for t in sol_k
            )
            flops = k1_flops(done_it, 10, 12, 6, 40, 4, 8)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
            tag = f"K1 {str(dtype).split('.')[1]} B={B}"
            print(f"{tag}: max|dx| {err:.3e} (tol {tol_x:g}, {int(solved.sum())}/{B} lanes), resid kernel max {float(res_k.max()):.3e} "
                  f"plain max {float(res_p.max()):.3e}, worse lanes {bad_res}; kernel {ms:.4f} ms ({how}) "
                  f"(wrapper with its tensor glue {wrapper_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, {flops} FLOP)")
            check(err <= tol_x, f"{tag}: kernel x differs from the plain version by {err}")
            check(bad_res == 0, f"{tag}: {bad_res} lanes with a worse KKT residual than the plain version")
            rows[(dtype, B)] = dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                    bytes_ms=bytes_ms, ops_ms=ops_ms)
    return rows


# ---------------------------------------------------------------- phase 3


def k3_cases(device, dtype):
    """(label, bd1, bd2, q1, p1, q2, p2) with R poses each: both bench pairs
    free, touching and penetrating by 1e-3; every other shape kind (and a
    plain mesh body) tilted onto the floor, and the sphere resting on it."""
    import torch
    from diffsdfsim_torch.physics import (BoxShape, BrickShape, CylinderShape, RoundedBoxShape,
                                          make_body)
    from diffsdfsim_torch.utils import meshes
    from diffsdfsim_torch.utils.quaternion import quat_apply
    from diffsdfsim_torch.utils.spherical import normalize

    floor, sphere = bench_bodies(device, dtype)
    tt = lambda x: torch.tensor(x, dtype=dtype, device=device)
    eye = tt([1.0, 0, 0, 0])
    tilt = normalize(tt([0.95, 0.2, 0.1, 0.05]))
    others = {
        "box": make_body(BoxShape(tt([0.6, 0.4, 0.5])), subdiv=2, device=device, dtype=dtype),
        "rounded_box": make_body(RoundedBoxShape(tt([0.6, 0.6, 0.6]), tt(0.05)), subdiv=2, device=device, dtype=dtype),
        "cylinder": make_body(CylinderShape(tt(0.4), tt(0.8)), subdiv=2, device=device, dtype=dtype),
        "brick": make_body(BrickShape(tt([0.6, 0.3, 0.4]), tt(0.05)), subdiv=2, device=device, dtype=dtype),
    }
    tv, tf = meshes.cube_template(4)
    others["mesh"] = make_body(BoxShape(tt([0.5, 0.5, 0.5])), verts=0.25 * np.asarray(tv), faces=tf,
                               device=device, dtype=dtype)
    fp = tt([0.0, -0.5, 0.0])

    def ladder(R, y0, spread):
        rng = np.random.default_rng(R)
        ys = y0 - spread * np.arange(R) / max(R - 1, 1)
        xz = rng.normal(size=(R, 2)) * (0.02 if R > 6 else 0.0)
        return tt(np.stack([xz[:, 0], ys, xz[:, 1]], 1))

    def world_y(bd, q):
        return quat_apply(q, bd.verts)[:, 1]

    cases = []
    for R in (3, 6, 576):
        for tag, y0 in (("free", 0.8), ("touch", 0.5 + 1e-6), ("pen1e-3", 0.5 - 1e-3)):
            ps = ladder(R, y0, 2e-4)
            q = eye.expand(R, 4)
            cases.append((f"floor->sphere {tag} R={R}", floor, sphere, q, fp.expand(R, 3), q, ps))
            cases.append((f"sphere->floor {tag} R={R}", sphere, floor, q, ps, q, fp.expand(R, 3)))
    R = 6
    for name, bd in others.items():
        # shape tilted onto the floor, its lowest vertex 1e-3 below the top
        y0 = float(-world_y(bd, tilt).min()) - 1e-3
        cases.append((f"{name}->floor tilted R={R}", bd, floor, tilt.expand(R, 4), ladder(R, y0, 1e-3),
                      eye.expand(R, 4), fp.expand(R, 3)))
        if bd.is_sdf:
            # the sphere resting on the tilted shape
            top = quat_apply(tilt, bd.verts)[int(world_y(bd, tilt).argmax())]
            ps = ladder(R, float(top[1]) + 0.5 - 1e-3, 1e-3) + tt([float(top[0]), 0.0, float(top[2])])
            cases.append((f"sphere->{name} R={R}", sphere, bd, eye.expand(R, 4), ps,
                          tilt.expand(R, 4), tt([0.0, 0.0, 0.0]).expand(R, 3)))
    return cases


def k3_flops(F, R, iters_run, polish):
    """FLOPs of the search: per face ~5 SDF queries at setup (~40 each),
    ~90 per FW iteration, ~200 per polish round and ~300 at the end."""
    fw = int(iters_run.sum()) * F * 90
    return R * F * (200 + 300 + 200 * polish) + fw


def phase_k3():
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair, pack_inputs
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    rows = {}
    for dtype, tol, eps, atol, mis_frac in (
        (torch.float64, 1e-8, 1e-3, 1e-6, 0.0),
        (torch.float32, 1e-5, 1e-3, 2e-3, 0.005),
    ):
        cfg = SimConfig(**{**BENCH_CFG, "tol": tol, "eps": eps})
        for label, bd1, bd2, q1, p1, q2, p2 in k3_cases("cuda", dtype):
            out_k = fw_search_pair(bd1, q1, p1, bd2, q2, p2, cfg)
            iters_run = fw_search_pair.last_iters.clone()
            out_p = search_pair_raw_plain(bd1, q1, p1, bd2, q2, p2, cfg)
            torch.cuda.synchronize()
            mis = int((out_k.cand != out_p.cand).sum() + (out_k.cmask != out_p.cmask).sum())
            both = out_k.cmask & out_p.cmask
            errs = {}
            for f in ("n_ng", "p1_ng", "x1", "pen"):
                a, b_ = getattr(out_k, f), getattr(out_p, f)
                m = both if f != "x1" else both
                errs[f] = float((a - b_).abs()[m].max()) if bool(m.any()) else 0.0
            agree = out_k.cand == out_p.cand
            errs["abc"] = float((out_k.abc - out_p.abc).abs()[agree].max()) if bool(agree.any()) else 0.0
            mk, mp = out_k.max_pen, out_p.max_pen
            fin = torch.isfinite(mk) & torch.isfinite(mp)
            check(bool(torch.equal(torch.isfinite(mk), torch.isfinite(mp))) or mis > 0,
                  f"K3 {label}: max_pen finiteness differs")
            errs["max_pen"] = float((mk - mp).abs()[fin].max()) if bool(fin.any()) else 0.0
            err = max(errs.values())
            F = bd1.faces_t.shape[0]
            tag = f"K3 {str(dtype).split('.')[1]} {label}"
            allowed = int(mis_frac * out_k.cand.numel())
            line = (f"{tag}: max err {err:.3e} ({', '.join(f'{k} {v:.1e}' for k, v in errs.items())}), "
                    f"mask mismatches {mis} (allowed {allowed}), cmask faces {int(out_k.cmask.sum())}")
            if "R=576" in label or label.startswith(("floor->sphere touch R=3", "sphere->floor touch R=3")):
                R = q1.shape[0]
                prep = fw_search_pair.prepare(bd1, q1, p1, bd2, q2, p2, cfg)
                ms, how = device_ms(lambda: fw_search_pair.launch(prep), "fw_search_kernel")
                wrapper_ms = cuda_ms(lambda: fw_search_pair(bd1, q1, p1, bd2, q2, p2, cfg))
                plain_ms = cuda_ms(lambda: search_pair_raw_plain(bd1, q1, p1, bd2, q2, p2, cfg), n=3, warm=1)
                pqr, consts = pack_inputs(bd1, q1, p1, bd2, q2, p2)
                nbytes = (pqr.numel() + consts.numel()) * pqr.element_size() + R * F * (
                    13 * pqr.element_size() + 2) + R * pqr.element_size()
                flops = k3_flops(F, R, iters_run, cfg.contact_polish_iters if bd1.is_sdf else 0)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
                line += (f"; kernel {ms:.4f} ms ({how}; wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                         f"({'bytes' if bytes_ms > ops_ms else 'operations'})")
                rows[(dtype, label)] = dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                            bytes_ms=bytes_ms, ops_ms=ops_ms)
            print(line)
            check(errs["max_pen"] <= atol, f"{tag}: max_pen differs by {errs['max_pen']} (atol {atol})")
            if label.startswith(("floor->sphere", "sphere->floor")):
                # the bench pairs: every per-face output. Other kinds' box
                # and cylinder gradients have exact-tie "failsafe" branches
                # on their template vertices, where kernel and plain version
                # may settle on different, equally valid points (the JAX
                # package's own Pallas-vs-XLA test makes the same
                # exception); there max_pen, which decides acceptance, is held.
                check(mis <= allowed, f"{tag}: {mis} mask mismatches")
                check(err <= atol, f"{tag}: kernel differs from the plain version by {err} (atol {atol})")
    return rows


# ---------------------------------------------------------------- phase 3b


def k2_flops(nz, neq, nineq, k, fd, B):
    """FLOPs the backward KKT solve needs per problem: the reduced Schur
    matrix [A; G]_r Q^-1 [A; G]_r' over its m2 rows with the cone and
    friction-pair terms, one LU solve of it (2/3 m2^3 + 2 m2^2; the kernel
    inverts instead, 4 m2^3), and the matrix-vector products around it."""
    m2 = neq + k + k * fd // 2
    m = neq + nineq
    schur = 2 * m2 * nz * nz + 2 * m2 * m2 * nz + 30 * k * fd
    solve = 2 * m2**3 // 3 + 2 * m2 * m2
    per = schur + solve + 4 * nz * nz + 4 * m * nz
    return B * per


def phase_k2():
    """K2 against its plain version on the same inputs: the bench LCPs of
    phase 2, their plain solution (x, y, z, s) turned into the backward's
    diagonal d as the replay's backward does, and a seeded rx. float64: 1e-9
    relative to the largest entry, at 1, 6 and 576 problems (one
    contacting substep; a seed sweep's batch). float32: both against the plain version
    run in float64 on the same (float32-rounded) inputs, the kernel within
    1e-4 relative; the plain float32 path keeps the JAX XLA path's d-clip to
    [1e-5, 1e5] and ridge, which move its answer at these d (down to 1e-8),
    so its error is reported, not held."""
    import torch
    from diffsdfsim_torch.ops.qp import blockdiag_inv3, kkt_grad_plain, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    structure = ("fric", 4, 8)
    rows = {}
    for dtype in (torch.float64, torch.float32):
        for B in (1, 6, 576):
            f64 = dtype == torch.float64
            Q, p, G, h, A, b, F, invQ = physics_lcps(B, seed=B, device="cuda", dtype=dtype)
            x, y, z, s = pdipm_solve_raw(Q, p, G, h, A, b, F, 10, 1e-12 if f64 else 1e-6, 3, structure)
            d = torch.clamp(torch.clamp(z, min=1e-8) / torch.clamp(s, min=1e-8), max=1e12 if f64 else 1e5)
            rx = torch.tensor(np.random.default_rng(B).normal(size=tuple(x.shape)), dtype=dtype, device="cuda")
            iq = blockdiag_inv3(Q)
            ins = (iq, G, A, F, d, rx)
            out_k = kkt_grad_fric(*ins, structure)
            out_p = kkt_grad_plain(*ins, structure)
            out_ref = out_p if f64 else kkt_grad_plain(*(t.double() for t in ins), structure)
            torch.cuda.synchronize()
            rel = lambda a, r: float((a.double() - r.double()).abs().max()) / float(r.abs().max())  # noqa: E731
            err = max(rel(a, r) for a, r in zip(out_k, out_ref))
            abs_err = max(float((a.double() - r.double()).abs().max()) for a, r in zip(out_k, out_ref))
            err_plain = max(rel(a, r) for a, r in zip(out_p, out_ref))
            prep = kkt_grad_fric.prepare(*ins, structure)
            ms, how = device_ms(lambda: kkt_grad_fric.launch(prep), "kkt_bwd_kernel")
            wrapper_ms = cuda_ms(lambda: kkt_grad_fric(*ins, structure))
            plain_ms = cuda_ms(lambda: kkt_grad_plain(*ins, structure), n=5, warm=1)
            # the bytes the function needs: F only through its k cone
            # coefficients mu (the kernel reads those and base_red, which
            # is derived from invQ, G and A)
            mu = prep["ins"][4]
            nbytes = sum(t.numel() * t.element_size() for t in (iq, G, A, mu, d, rx) + tuple(out_k))
            flops = k2_flops(12, 6, 40, 4, 8, B)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
            tol = 1e-9 if f64 else 1e-4
            tag = f"K2 {str(dtype).split('.')[1]} B={B}"
            print(f"{tag}: max abs err {abs_err:.3e}, max rel err {err:.3e} vs the plain version{'' if f64 else ' in float64'} (tol {tol:g})"
                  f"{'' if f64 else f'; the plain float32 path is off by {err_plain:.3e}'}; kernel {ms:.4f} ms ({how}) "
                  f"(wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, {flops} FLOP)")
            check(err <= tol, f"{tag}: kernel differs from the plain version by {err} (relative)")
            rows[(dtype, B)] = dict(err=abs_err, rel_err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                    bytes_ms=bytes_ms, ops_ms=ops_ms)
    return rows


# ---------------------------------------------------------------- phase 4


def run_rollout(device, dtype=None):
    """The bench world (float64, or float32 with bench.py's f32 tol 1e-5)."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import Gravity3D, TotalConstraint3D, make_world, rollout

    dtype = dtype or torch.float64
    cfg = dict(BENCH_CFG, tol=1e-5) if dtype == torch.float32 else BENCH_CFG
    floor, sphere = bench_bodies(device, dtype)
    poses = [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]]
    spec, state = make_world([floor, sphere], poses, np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                             forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**cfg), device=device)
    return spec, state, rollout


def compare_traj(traj, ref, label):
    """Hold a trajectory against a reference (numpy dicts) at the stated
    tolerances; returns the errors."""
    n = len(traj["pos"])
    for key in ("valid", "n_halvings", "bisect_failed", "truncated"):
        check(np.array_equal(traj[key], ref[key][:n]), f"{label}: {key} differs")
    errs = {}
    first = n
    for key in ("pos", "quat", "v"):
        d = np.abs(traj[key] - ref[key][:n])
        errs[key] = float(d.max())
        over = np.nonzero(d.reshape(n, -1).max(1) > ATOL_REPORT)[0]
        first = min(first, int(over[0]) if len(over) else n)
        check(errs[key] <= ATOL_ALL, f"{label}: {key} differs by {errs[key]}")
    errs["pos_y"] = float(np.abs(traj["pos"][..., 1, 1] - ref["pos"][:n, :, 1, 1]).max())
    errs["v_y"] = float(np.abs(traj["v"][..., 1, 4] - ref["v"][:n, :, 1, 4]).max())
    check(errs["pos_y"] <= ATOL_Y, f"{label}: the sphere's height differs by {errs['pos_y']}")
    check(errs["v_y"] <= ATOL_VY, f"{label}: the sphere's vertical velocity differs by {errs['v_y']}")
    errs["first_frame_over_1e-7"] = first
    return errs


def phase_main_path():
    import torch
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.ops.qp_cuda import pdipm_fric

    spec, state, rollout = run_rollout("cuda")
    rollout(spec, state, 5)  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    spec, state, rollout = run_rollout("cuda")
    pdipm_fric.launches = 0
    fw_search_pair.launches = 0
    t0 = time.perf_counter()
    _, traj = rollout(spec, state, N_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pdipm_fwd": pdipm_fric.launches, "fw_search": fw_search_pair.launches}
    check(launches["pdipm_fwd"] > 0 and launches["fw_search"] > 0,
          f"the main path did not run through both kernels: {launches}")
    check(traj.pos.grad_fn is None, "the forward path recorded a tape with nothing requiring grad")

    tr = {k: v.cpu().numpy() for k, v in traj._asdict().items()}
    valid = tr["valid"]
    n_sub = int(valid.sum())
    hist = np.bincount(tr["n_halvings"][valid], minlength=BENCH_CFG["max_bisect"] + 1).tolist()
    print(f"main path: {N_FRAMES} frames in {wall:.3f} s wall = {N_FRAMES / wall:.2f} forward steps/s; "
          f"{n_sub} substeps, accepted-rung histogram {hist}, host syncs {spec.host_syncs} "
          f"({spec.host_syncs / n_sub:.2f} per substep); launches {launches}")

    # device busy share of the main path: all kernel time in a profiled
    # 20-frame rollout (the first bounce included) over its wall time
    from torch.profiler import ProfilerActivity, profile

    spec_p, state_p, _ = run_rollout("cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        rollout(spec_p, state_p, 20)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    kern = {}
    for ev in prof.key_averages():
        # device-side kernel events only (operator events repeat their time)
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
        if dev > 0:
            kern[ev.key] = dev / 1e3
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    print(f"main path, 20 profiled frames: wall {pwall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (pwall * 1e3):.1f}%, idle {100 - 100 * busy / (pwall * 1e3):.1f}%); top kernels (ms): "
          + "; ".join(f"{k[:48]} {v:.2f}" for k, v in top) + f"; {len(kern)} distinct kernels")

    spec_c, state_c, _ = run_rollout("cpu")
    t0 = time.perf_counter()
    _, traj_c = rollout(spec_c, state_c, N_FRAMES)
    cpu_wall = time.perf_counter() - t0
    trc = {k: v.numpy() for k, v in traj_c._asdict().items()}
    e_cpu = compare_traj(tr, trc, "cuda vs cpu rollout")
    golden = dict(np.load(GOLDEN))
    e_gold = compare_traj(tr, golden, "cuda rollout vs golden")
    fmt = lambda e: ", ".join(f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}" for k, v in e.items())
    print(f"main path vs plain cpu rollout ({cpu_wall:.2f} s on the host): {fmt(e_cpu)}")
    print(f"main path vs JAX golden: {fmt(e_gold)}")

    # float32 through both kernels: finite, and the bounce within 1e-2 of
    # the float64 golden (its tol is 1e-5, so acceptance decisions differ)
    spec32, state32, _ = run_rollout("cuda", torch.float32)
    t0 = time.perf_counter()
    _, traj32 = rollout(spec32, state32, N_FRAMES)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    pos32 = traj32.pos.double().cpu().numpy()
    dy = float(np.abs(pos32[..., 1, 1] - golden["pos"][..., 1, 1]).max())
    print(f"float32 main path: {N_FRAMES} frames in {wall32:.3f} s, {int(traj32.valid.sum())} substeps, "
          f"sphere height vs float64 golden {dy:.2e}")
    check(bool(np.isfinite(pos32).all()) and dy <= 1e-2, f"float32 rollout: height differs by {dy}")
    return launches, wall, n_sub


# ---------------------------------------------------------------- phase 5


def bench_loss(device, n_frames):
    """bench.py's loss over the bench world built from a radius that
    requires grad: (loss, rad, spec), the rollout taped."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import (BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body,
                                          make_world, rollout)

    rad = torch.tensor(0.5, dtype=torch.float64, device=device, requires_grad=True)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25, device=device)
    sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25, device=device)
    poses = [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]]
    spec, state = make_world([floor, sphere], poses, np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                             forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**BENCH_CFG), device=device)
    _, traj = rollout(spec, state, n_frames)
    return torch.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None]), rad, spec


def phase_gradient():
    """The gradient path: value_and_grad of the 100-frame bench loss on
    CUDA through K1, K3 and K2, held against the plain CPU gradient and the
    JAX golden values."""
    import warnings

    import torch
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric, pdipm_fric

    golden = {k: float(v) for k, v in np.load(GRAD_GOLDEN).items()}
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731

    # warm-up, and the 20- and 27-frame gradients against the golden values
    for n in (20, 27):
        loss, rad, _ = bench_loss("cuda", n)
        loss.backward()
        e = rel(float(rad.grad), golden[f"toc_{n}_grad"])
        print(f"gradient path, {n} frames: d loss / d rad {float(rad.grad)!r} vs JAX golden "
              f"{golden[f'toc_{n}_grad']!r}: rel {e:.2e} (tol {RTOL_GRAD_SHORT:g})")
        check(e <= RTOL_GRAD_SHORT, f"{n}-frame gradient differs from the golden value by {e} (relative)")
    torch.cuda.synchronize()

    pdipm_fric.launches = fw_search_pair.launches = kkt_grad_fric.launches = 0
    t0 = time.perf_counter()
    loss, rad, spec = bench_loss("cuda", N_FRAMES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    syncs_fwd = spec.host_syncs
    # count the backward's reads of the device: a synchronizing op warns
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bwd_syncs = sum("synchroniz" in str(w.message) for w in caught)
    launches = {"pdipm_fwd": pdipm_fric.launches, "fw_search": fw_search_pair.launches,
                "kkt_bwd": kkt_grad_fric.launches}
    grad = float(rad.grad)
    wall = t2 - t0
    print(f"gradient path: {N_FRAMES} frames fwd+bwd in {wall:.3f} s wall = {N_FRAMES / wall:.2f} fwd+bwd steps/s "
          f"(forward {t1 - t0:.3f} s, backward {t2 - t1:.3f} s, backward share {(t2 - t1) / wall:.3f}); "
          f"host syncs forward {syncs_fwd}, backward {bwd_syncs}; launches {launches}")
    check(all(v > 0 for v in launches.values()), f"the gradient path did not run through all three kernels: {launches}")
    check(bool(np.isfinite(grad)), f"the gradient is not finite: {grad}")

    e_gold = rel(grad, golden["toc_100_grad"])
    loss_c, rad_c, _ = bench_loss("cpu", N_FRAMES)
    t0 = time.perf_counter()
    loss_c.backward()
    cpu_bwd = time.perf_counter() - t0
    e_cpu = rel(grad, float(rad_c.grad))
    print(f"gradient path: d loss / d rad {grad!r}; plain CPU {float(rad_c.grad)!r} (rel {e_cpu:.2e}, its backward "
          f"{cpu_bwd:.2f} s on the host); JAX golden {golden['toc_100_grad']!r} (rel {e_gold:.2e}); "
          f"loss {float(loss.detach())!r} vs golden {golden['toc_100_loss']!r} (tol {RTOL_GRAD_100:g})")
    check(e_gold <= RTOL_GRAD_100, f"100-frame gradient differs from the golden value by {e_gold} (relative)")
    check(e_cpu <= RTOL_GRAD_100, f"100-frame gradient differs from the plain CPU gradient by {e_cpu} (relative)")

    # device busy share of a profiled 20-frame fwd+bwd (the first bounce)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        loss, rad, _ = bench_loss("cuda", 20)
        loss.backward()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    kern = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
        if dev > 0:
            kern[ev.key] = dev / 1e3
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    print(f"gradient path, 20 profiled frames fwd+bwd: wall {pwall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (pwall * 1e3):.1f}%, idle {100 - 100 * busy / (pwall * 1e3):.1f}%); top kernels (ms): "
          + "; ".join(f"{k[:48]} {v:.2f}" for k, v in top) + f"; {len(kern)} distinct kernels")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, smi = phase_device_and_build()
    k1 = phase_k1()
    k3 = phase_k3()
    k2 = phase_k2()
    launches, wall, n_sub = phase_main_path()  # in grad mode, as a forward-only caller runs it
    grad_launches = phase_gradient()

    f64 = torch.float64
    k1r = k1[(f64, 3)]
    k3r = k3[(f64, "sphere->floor touch R=3")]  # the pair that finds the contacts
    k2r = k2[(f64, 1)]  # one problem per contacting substep on the main path
    kernels = [
        dict(name="pdipm_fwd", route="cuda", source="diffsdfsim_torch/ops/csrc/pdipm_fwd.cu",
             replaces="diffsdfsim_tpu/ops/qp_pallas.py:247", launches=launches["pdipm_fwd"],
             max_abs_err=max(r["err"] for (dt, _), r in k1.items() if dt == f64), ms=k1r["ms"], plain_ms=k1r["plain_ms"],
             bound_ms=max(k1r["bytes_ms"], k1r["ops_ms"]),
             bound_by="bytes" if k1r["bytes_ms"] > k1r["ops_ms"] else "operations", library_ms=None),
        dict(name="fw_search", route="cuda", source="diffsdfsim_torch/ops/csrc/fw_search.cu",
             replaces="diffsdfsim_tpu/ops/fw_pallas.py:193", launches=launches["fw_search"],
             max_abs_err=max(r["err"] for (dt, _), r in k3.items() if dt == f64), ms=k3r["ms"], plain_ms=k3r["plain_ms"],
             bound_ms=max(k3r["bytes_ms"], k3r["ops_ms"]),
             bound_by="bytes" if k3r["bytes_ms"] > k3r["ops_ms"] else "operations", library_ms=None),
        dict(name="kkt_bwd", route="cuda", source="diffsdfsim_torch/ops/csrc/kkt_bwd.cu",
             replaces="diffsdfsim_tpu/ops/qp_pallas.py:712", launches=grad_launches["kkt_bwd"],
             max_abs_err=max(r["err"] for (dt, _), r in k2.items() if dt == f64), ms=k2r["ms"],
             plain_ms=k2r["plain_ms"], bound_ms=max(k2r["bytes_ms"], k2r["ops_ms"]),
             bound_by="bytes" if k2r["bytes_ms"] > k2r["ops_ms"] else "operations", library_ms=None),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
