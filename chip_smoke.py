#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``diffsdfsim_torch/ops/csrc``
(one nvcc per source, all started together), holds each kernel against its
plain PyTorch version on the card, then drives four paths of the port on
CUDA (float64):

- the forward path: the bench scene's 100-frame bounce rollout through K1
  (PDIPM) and K3 (Frank-Wolfe search), held against the plain CPU rollout
  and the JAX package's committed golden trajectory;
- the gradient path: d loss / d rad of bench.py's 100-frame loss through
  K1, K3 and K2 (the LCP backward's KKT solve), held against the plain CPU
  gradient and the JAX package's committed golden gradients;
- the grid path: a voxelized sphere on a 64^3 grid dropped for 16 frames
  through K5 (one fused launch per grid-SDF query, checked by counting the
  queries; no gradient volume built) and K1, against its JAX golden;
- the latent path: optim_shapespace's 36-frame drop of a shape-space body
  (the reference's IGR decoder at full width) through K4 (the fused
  decoder) and K1, then two Adam steps of the latent fit through K4, K1 and
  K2, against the JAX golden drop, gradients and latents; the drop's K4
  launches are counted by N, and K4 is checked at the most frequent N.

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
LATENT_GOLDEN = os.path.join(ROOT, "tests", "golden", "latent128_f64.npz")
GRID_GOLDEN = os.path.join(ROOT, "tests", "golden", "grid64_f64.npz")

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
# How the gradient d loss / d rad is held against the JAX golden values.
# Through the first bounce (20 frames) and through frame 26 (27 frames) it
# does not depend on the rounding-decided touchdown, so it holds the kernels
# tightly: within 1e-10 and 1e-6 relative (the first bounce reads 0 to
# 4e-16 on an H100; at 27 frames nine equally valid arithmetic orders of
# K1/K2 all read within 1e-7, PR 3's kernels 1e-16). Over the whole 100
# frames within 3e-3 relative, because from the touchdown in frame 26 the
# reference's own contact point is decided by rounding (above), and the CPU
# and CUDA runs round differently too. That check does not tell a right
# kernel from a wrong one: the nine orders put the 100-frame gradient
# between 8.8e-4 and 1.7e-2 from the golden value, six of them over 3e-3
# from it or from the CPU port's, and the committed order was picked among
# the three that pass (8.8e-4 from the golden, 9.7e-4 from the CPU port;
# ROADMAP queue 3).
RTOL_GRAD_SHORT = {20: 1e-10, 27: 1e-6}
RTOL_GRAD_100 = 3e-3
# How the grid and latent paths are held against their JAX goldens:
# identical discrete decisions and every pose and velocity within
# ATOL_SHAPE_PATH (K1's Gauss-Jordan rounds each solve differently from the
# plain Cholesky, ~1e-13 in x, and the drop integrates it: on an H100 the
# grid drop read 1.1e-9, the latent drop 1.8e-14); each fit step's loss and
# d loss / d latent within RTOL_LATENT_GRAD relative (read 3.4e-8: the
# polished contact anchors the gradient flows through round differently);
# the latent after two Adam steps within ATOL_LATENT_Z.
ATOL_SHAPE_PATH, RTOL_LATENT_GRAD, ATOL_LATENT_Z = 1e-7, 1e-6, 1e-9

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s float32 and
# 34 TFLOP/s float64 outside the tensor cores (the kernels use none)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# a chain of matrix products could run on the float64 tensor cores (67
# TFLOP/s); float32 stays at 67 (TF32 would round the inputs)
PEAK_MATMUL_FLOPS = {"float32": 67e12, "float64": 67e12}


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
    its name; None: every kernel fn() launches) per fn() call from
    torch.profiler's CUDA trace; where the trace shows none, CUDA events
    around n back-to-back calls (an upper bound that includes host launch
    gaps). A named kernel's time is its traced total over the launches the
    trace holds: on the H100 the trace has at times kept one launch of n."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel is None:
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                total_us += getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
        elif kernel in ev.key and ev.device_type == torch.autograd.DeviceType.CUDA:
            total_us += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            count += ev.count
    if total_us > 0 and kernel is None:
        return total_us / n / 1e3, "profiler"
    if total_us > 0 and count:
        return total_us / count / 1e3, f"profiler, {count} of {n} launches traced"
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
    logs = _build.build_all(["pdipm_fwd", "fw_search", "kkt_bwd", "igr_mlp", "grid_interp"])
    print(f"build: five kernels in {time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for kname, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        regs = [int(ln.split("Used ")[1].split(" registers")[0]) for ln in lines if "Used " in ln]
        spills = [ln for ln in lines if "spill" in ln and not ln.startswith("0 bytes")]
        nonzero = [ln for ln in spills if " 0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"ptxas {kname}: {len(regs)} kernels, registers {min(regs, default=0)}..{max(regs, default=0)}, "
              f"{len(nonzero)} with spills")
        for ln in lines[: 12 if kname in ("pdipm_fwd", "kkt_bwd") else 8]:
            print(f"  {ln}")
    return name, smi


# ---------------------------------------------------------------- phase 2


def physics_lcps(B, seed, device, dtype, k=4):
    """B mixed LCPs of the bench scene at contact (floor -> sphere, k
    contact slots, some invalid), assembled by the port's engine: k = 4 is
    the bench's contact buffer, k = 8 the shape-space scene's."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import Gravity3D, TotalConstraint3D
    from diffsdfsim_torch.physics.contacts import Contacts
    from diffsdfsim_torch.physics.engine import dump_contact_lcp, mass_matrix_inv
    from diffsdfsim_torch.physics.world import WorldState
    from diffsdfsim_torch.utils.spherical import normalize

    cfg = SimConfig(**dict(BENCH_CFG, max_contacts_total=k))
    floor, sphere = bench_bodies("cpu", torch.float64)
    f64 = lambda x: torch.tensor(np.asarray(x, dtype=np.float64))
    rng = np.random.default_rng(seed)
    out = [[] for _ in range(8)]
    for _ in range(B):
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


def nnz(t):
    """Nonzeros of one problem's matrix, averaged over the batch."""
    return float((t != 0).sum()) / t.shape[0]


def reduced_flops(invQ, G, A, k, fd):
    """FLOPs per problem (averaged over the batch) of the pieces of the
    reduced Schur solve that K1 and K2 share, each product costing 2 per
    pair of nonzeros it multiplies in this run's data (Q^-1 is 3 x 3
    block-diagonal, G's cone rows are zero):

    - base: the reduced base block [A; G]_r Q^-1 [A; G]_r' over its m2 rows,
      one triangle of the symmetric product;
    - factor: K assembled at a new diagonal and one LU of it (2/3 m2^3).
      The assembly: per contact its fd/2 pairs' sigma^-1 and their sum (4
      each), the cone row's d, the Sherman-Morrison coefficient and the
      (v, n) factor (9); per folded row delta, delta sigma^-1, the diagonal
      add, the rank-1 row factor and the (v, n) coupling (11); 2 per entry
      of each contact's fd/2 x fd/2 rank-1 block; m2 diagonal adds;
    - solve: one KKT solve with the factored K for (rx, 0, 0, 0): Q^-1 rx,
      [A; G] times it, the fold of the right-hand side and the recovery of
      (wf+, wf-, wc) (9 per contact, 24 per folded row), the two triangular
      solves (2 m2^2), [A; G]' w and Q^-1 again.

    One LU and one solve are the 2/3 m2^3 + 2 m2^2 of a reduced LU solve;
    the kernels invert K instead (4 m2^3)."""
    import torch

    fd2 = fd // 2
    neq = max(A.shape[-2], 1)
    m2 = neq + k + k * fd2
    AG = torch.cat([A, G], -2)
    rows = list(range(neq + k)) + [neq + k + c * fd + j for c in range(k) for j in range(fd2)]
    pr = (AG[:, rows] != 0).double()
    pq = (invQ != 0).double()
    prq = pr @ pq  # products summed into each entry of [A; G]_r Q^-1
    base = 2 * float(prq.sum()) + 2 * float(torch.triu((prq > 0).double() @ pr.transpose(-1, -2)).sum())
    assemble = k * (9 + 4 * fd2) + 11 * k * fd2 + 2 * k * fd2 * fd2 + m2
    solve = 4 * nnz(invQ) + 4 * nnz(AG) + 9 * k + 24 * k * fd2 + 2 * m2 * m2 + G.shape[-1]
    return dict(base=base / G.shape[0], factor=assemble + 2 * m2**3 / 3, solve=solve)


def k1_flops(done_it, max_iter, Q, G, A, F, invQ, k, fd):
    """FLOPs the reduced PDIPM needs for these lanes (`reduced_flops` for
    the shared pieces, products counted by the data's nonzeros). Once: the
    base block, and the initial factor and KKT solve at d = 1 with its slack
    shift. Per Mehrotra iteration, as many as each lane runs: the
    residuals, one factor, two KKT solves (the right-hand sides rs, rz, ry
    and ds add 6 per inequality row and 1 per equality row each) and the
    step (step lengths, centering, the combined direction and the update:
    35 per inequality row, 5 per variable, 3 per equality row). Last: the
    final residuals."""
    nz, nineq, neq = G.shape[-1], G.shape[-2], A.shape[-2]
    red = reduced_flops(invQ, G, A, k, fd)
    kkt = red["solve"] + 6 * nineq + neq
    resid = 2 * (2 * nnz(G) + nnz(Q) + 2 * nnz(A) + nnz(F)) + 7 * nineq + 4 * nz + 3 * neq
    per_iter = resid + red["factor"] + 2 * kkt + 35 * nineq + 5 * nz + 3 * neq
    iters = np.minimum(done_it.cpu().numpy() + 1, max_iter).astype(np.int64)
    once = red["base"] + red["factor"] + kkt + 4 * nineq + resid
    return int(np.sum(once + iters * per_iter))


def fmt_info(info):
    return (f"{info['threads']} threads, {info['smem_bytes']} B shared, {info['regs']} registers, "
            f"{info['spill_bytes']} B spilled, {info['blocks_per_sm']} blocks/SM, "
            f"{'static m2 ' + str(info['static_m2']) if info['static_m2'] else 'runtime-sized'}")


def phase_k1():
    import torch
    from diffsdfsim_torch.ops.qp import lcp_residuals, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import pdipm_fric

    rows = {}
    # float32: the plain version keeps the JAX XLA path's f32 rules (d
    # clipped to [1e-5, 1e5], a 1e-6 ridge), the kernel the Pallas kernel's
    # (none), so their x agree only to ~1e-3 of |x| ~ 3; both are also held
    # to their KKT residuals below. k = 8 contacts (nineq 80): the
    # shape-space scene's buffer, at its probe batches of 3 and 4 rungs
    cases = [(4, B) for B in (3, 6, 576)] + [(8, B) for B in (3, 4)]
    for dtype, eps, tol_x in ((torch.float64, 1e-12, 1e-8), (torch.float32, 1e-6, 1e-2)):
        for k, B in cases:
            structure = ("fric", k, 8)
            Q, p, G, h, A, b, F, invQ = physics_lcps(B, seed=B, device="cuda", dtype=dtype, k=k)
            args = (Q, p, G, h, A, b, F)
            sol_k = pdipm_fric(*args, invQ, 10, eps, 3, structure)
            done_it = pdipm_fric.last_done_it.clone()
            syncs = pdipm_fric.last_syncs.cpu()
            info = pdipm_fric.info(dtype, 12, 6, k * 10, k, 8)
            sol_p = pdipm_solve_raw(*args, 10, eps, 3, structure)
            torch.cuda.synchronize()
            res_k = lcp_residuals(*args, sol_k)
            res_p = lcp_residuals(*args, sol_p)
            # x is compared on the lanes the plain version solved (KKT
            # residual <= 1e-3); in float32 some lanes it leaves at ~1e-1
            solved = res_p <= 1e-3
            err = float((sol_k[0] - sol_p[0]).abs()[solved].max()) if bool(solved.any()) else 0.0
            floor_res = 1e-6 if dtype == torch.float64 else 1e-2
            bad_res = int((res_k > torch.clamp(10 * res_p, min=floor_res)).sum())
            prep = pdipm_fric.prepare(*args, invQ, 10, eps, 3, structure)
            ms, how = device_ms(lambda: pdipm_fric.launch(prep), "pdipm_fwd_kernel")
            wrapper_ms = cuda_ms(lambda: pdipm_fric(*args, invQ, 10, eps, 3, structure))
            plain_ms = cuda_ms(lambda: pdipm_solve_raw(*args, 10, eps, 3, structure), n=5, warm=1)
            # each input read once, F through its nonzeros (the residual's
            # Fz; the reduced solve reads only its cone coefficients)
            nbytes = sum(t.numel() * t.element_size() for t in (Q, p, G, h, A, b, invQ, *sol_k)) + int(
                nnz(F) * B) * F.element_size()
            flops = k1_flops(done_it, 10, Q, G, A, F, invQ, k, 8)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
            tag = f"K1 {str(dtype).split('.')[1]} k={k} B={B}"
            print(f"{tag}: max|dx| {err:.3e} (tol {tol_x:g}, {int(solved.sum())}/{B} lanes), resid kernel max {float(res_k.max()):.3e} "
                  f"plain max {float(res_p.max()):.3e}, worse lanes {bad_res}; kernel {ms:.4f} ms ({how}) "
                  f"(wrapper with its tensor glue {wrapper_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, {flops} FLOP); "
                  f"barriers per Mehrotra iteration {int(syncs[0, 0])}, per launch {int(syncs[:, 1].max())}; "
                  f"{fmt_info(info)}")
            check(err <= tol_x, f"{tag}: kernel x differs from the plain version by {err}")
            check(bad_res == 0, f"{tag}: {bad_res} lanes with a worse KKT residual than the plain version")
            rows[(dtype, k, B)] = dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
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
    for R in (3, 6, 9, 576):
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


def k3_big_cases(device, dtype, R):
    """[(label, bd1, bd2, q1, p1, q2, p2)]: the sphere at subdiv 5 (20,480
    faces, past K3's one-face-per-thread cap of 8192) touching the floor at
    R rung poses 0..2e-4 apart, as the bench ladder's; and, tilted, 0-1 cm
    above the bench sphere (a curved SDF: several Frank-Wolfe iterations)."""
    import torch
    from diffsdfsim_torch.physics import SphereShape, make_body
    from diffsdfsim_torch.utils.spherical import normalize

    floor, small = bench_bodies(device, dtype)
    sphere = make_body(SphereShape(torch.tensor(0.5)), subdiv=5, fric_coeff=0.25, device=device, dtype=dtype)
    tt = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
    ys = 0.5 + 1e-6 - 2e-4 * np.arange(R) / max(R - 1, 1)
    q = tt([1.0, 0, 0, 0]).expand(R, 4)
    tilt = normalize(tt([0.95, 0.2, 0.1, 0.05])).expand(R, 4)
    gap = 1.0 + 1e-2 * np.arange(R) / max(R - 1, 1)
    return [(f"sphere20480->floor touch R={R}", sphere, floor, q, tt(np.stack([np.zeros(R), ys, np.zeros(R)], 1)),
             q, tt([0.0, -0.5, 0.0]).expand(R, 3)),
            (f"sphere20480->sphere gap R={R}", sphere, small, tilt, tt(np.stack([0.01 * gap, gap, 0.02 * gap], 1)),
             q, tt([0.0, 0.0, 0.0]).expand(R, 3))]


def fmt_k3_info(info):
    return (f"{info['threads']} threads x {info['cluster']} CTAs per pose, {info['smem_bytes']} B shared, "
            f"{info['regs']} registers, {info['spill_bytes']} B spilled, {info['blocks_per_sm']} CTAs/SM")


def k3_flops(F, R, iters_run, polish):
    """FLOPs of the search: per face ~5 SDF queries at setup (~40 each),
    ~90 per FW iteration, ~200 per polish round and ~300 at the end."""
    fw = int(iters_run.sum()) * F * 90
    return R * F * (200 + 300 + 200 * polish) + fw


def phase_k3():
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    rows = {}
    for dtype, tol, eps, atol, mis_frac in (
        (torch.float64, 1e-8, 1e-3, 1e-6, 0.0),
        (torch.float32, 1e-5, 1e-3, 2e-3, 0.005),
    ):
        cfg = SimConfig(**{**BENCH_CFG, "tol": tol, "eps": eps})
        big = [c for R in (3, 9) for c in k3_big_cases("cuda", dtype, R)] if dtype == torch.float64 else []
        for label, bd1, bd2, q1, p1, q2, p2 in k3_cases("cuda", dtype) + big:
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
            if "R=576" in label or any(label.startswith(f"{pair} touch R={R}")
                                       for pair in ("floor->sphere", "sphere->floor", "sphere20480->floor")
                                       for R in (3, 9)):
                R = q1.shape[0]
                prep = fw_search_pair.prepare(bd1, q1, p1, bd2, q2, p2, cfg)
                ms, how = device_ms(lambda: fw_search_pair.launch(prep), "fw_search_kernel")
                wrapper_ms = cuda_ms(lambda: fw_search_pair(bd1, q1, p1, bd2, q2, p2, cfg))
                plain_ms = cuda_ms(lambda: search_pair_raw_plain(bd1, q1, p1, bd2, q2, p2, cfg), n=3, warm=1)
                # each input read once (verts, faces, the poses, two constant
                # blocks), each output written once
                es = q1.element_size()
                nbytes = (bd1.verts.numel() + 14 * R + 16) * es + 8 * bd1.faces_t.numel() + R * F * (
                    13 * es + 2) + R * (es + 4)
                flops = k3_flops(F, R, iters_run, cfg.contact_polish_iters if bd1.is_sdf else 0)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
                line += (f"; kernel {ms:.4f} ms ({how}; wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                         f"({'bytes' if bytes_ms > ops_ms else 'operations'}), FW iterations per pose {sorted(set(iters_run.tolist()))}")
                rows[(dtype, label)] = dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                            bytes_ms=bytes_ms, ops_ms=ops_ms)
                if label.endswith("R=3") or label.startswith("sphere20480"):
                    line += f"; {fmt_k3_info(fw_search_pair.info(bd1, bd2, dtype, R))}"
            print(line)
            check(errs["max_pen"] <= atol, f"{tag}: max_pen differs by {errs['max_pen']} (atol {atol})")
            if label.startswith(("floor->sphere", "sphere->floor", "sphere20480")):
                # the bench pairs and the 20,480-face sphere: every per-face
                # output. Other kinds' box
                # and cylinder gradients have exact-tie "failsafe" branches
                # on their template vertices, where kernel and plain version
                # may settle on different, equally valid points (the JAX
                # package's own Pallas-vs-XLA test makes the same
                # exception); there max_pen, which decides acceptance, is held.
                check(mis <= allowed, f"{tag}: {mis} mask mismatches")
                check(err <= atol, f"{tag}: kernel differs from the plain version by {err} (atol {atol})")
    return rows


# ---------------------------------------------------------------- phase 3b


def k2_flops(invQ, G, A, k, fd):
    """FLOPs the backward KKT solve needs for the batch (`reduced_flops`):
    the base block, one factor (K's assembly and its LU) and one KKT solve,
    i.e. one reduced LU solve (2/3 m2^3 + 2 m2^2) and the products around
    it."""
    red = reduced_flops(invQ, G, A, k, fd)
    return int(G.shape[0] * (red["base"] + red["factor"] + red["solve"]))


def phase_k2():
    """K2 against its plain version on the same inputs: the bench LCPs of
    phase 2, their plain solution (x, y, z, s) turned into the backward's
    diagonal d as the replay's backward does, and a seeded rx. float64: 1e-9
    relative to the largest entry, at 1, 6 and 576 problems (one
    contacting substep; a seed sweep's batch). float32: both against the plain version
    run in float64 on the same (float32-rounded) inputs, the kernel within
    1e-4 relative; the plain float32 path keeps the JAX XLA path's d-clip to
    [1e-5, 1e5] and ridge, which move its answer at these d (down to 1e-8),
    so its error is reported, not held. float64 also holds K2 against
    ``fric_reduced_solve`` (the plain version of its reduced Schur solve,
    1e-9 relative) and times the library yardstick: one
    ``torch.linalg.solve_ex`` of the full (nz + nineq + neq) KKT system
    [[Q, G', A'], [G, -(D^-1 + F), 0], [A, 0, 0]] with right-hand side
    (-rx, 0, 0), whose solution is (dx, dlam, dnu); its assembly is not
    timed."""
    import torch
    from diffsdfsim_torch.ops.qp import blockdiag_inv3, fric_reduced_solve, kkt_grad_plain, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    rows = {}
    for dtype in (torch.float64, torch.float32):
        for k, B in ((4, 1), (4, 6), (4, 576), (8, 1)):
            structure = ("fric", k, 8)
            f64 = dtype == torch.float64
            Q, p, G, h, A, b, F, invQ = physics_lcps(B, seed=B, device="cuda", dtype=dtype, k=k)
            x, y, z, s = pdipm_solve_raw(Q, p, G, h, A, b, F, 10, 1e-12 if f64 else 1e-6, 3, structure)
            d = torch.clamp(torch.clamp(z, min=1e-8) / torch.clamp(s, min=1e-8), max=1e12 if f64 else 1e5)
            rx = torch.tensor(np.random.default_rng(B).normal(size=tuple(x.shape)), dtype=dtype, device="cuda")
            iq = blockdiag_inv3(Q)
            ins = (iq, G, A, F, d, rx)
            out_k = kkt_grad_fric(*ins, structure)
            syncs = int(kkt_grad_fric.last_syncs.max())
            info = kkt_grad_fric.info(dtype, 12, 6, k * 10, k, 8)
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
            # coefficients mu (the kernel reads those, and forms the
            # reduced Schur block from invQ, G and A)
            nbytes = sum(t.numel() * t.element_size() for t in (iq, G, A, d, rx) + tuple(out_k)) + B * k * G.element_size()
            flops = k2_flops(iq, G, A, k, 8)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
            tol = 1e-9 if f64 else 1e-4
            tag = f"K2 {str(dtype).split('.')[1]} k={k} B={B}"
            extra, library_ms = "", None
            if f64:
                # the reduced Schur solve's plain version: (dnu, dlam) = -S^-1 [A; G] Q^-1 rx
                iqrx = (iq @ rx[..., None])[..., 0]
                hv = torch.cat([(A @ iqrx[..., None])[..., 0], (G @ iqrx[..., None])[..., 0]], -1)
                w_red = -fric_reduced_solve(iq, G, A, F, d, hv, structure)
                err_red = rel(torch.cat([out_k[2], out_k[1]], -1), w_red)
                check(err_red <= tol, f"{tag}: kernel differs from fric_reduced_solve by {err_red} (relative)")
                # the library yardstick on the assembled full KKT system
                n, neq = 12 + k * 10 + 6, 6
                kkt = torch.zeros((B, n, n), dtype=dtype, device="cuda")
                kkt[:, :12, :12] = Q
                kkt[:, :12, 12 : n - neq] = G.transpose(-1, -2)
                kkt[:, :12, n - neq :] = A.transpose(-1, -2)
                kkt[:, 12 : n - neq, :12] = G
                kkt[:, 12 : n - neq, 12 : n - neq] = -(torch.diag_embed(1.0 / d) + F)
                kkt[:, n - neq :, :12] = A
                rhs = torch.zeros((B, n, 1), dtype=dtype, device="cuda")
                rhs[:, :12, 0] = -rx
                sol_lib = torch.linalg.solve_ex(kkt, rhs)[0][..., 0]
                err_lib = max(rel(sol_lib[:, :12], out_p[0]), rel(sol_lib[:, 12 : n - neq], out_p[1]),
                              rel(sol_lib[:, n - neq :], out_p[2]))
                library_ms, lib_how = device_ms(lambda: torch.linalg.solve_ex(kkt, rhs), None)
                extra = (f"; vs fric_reduced_solve {err_red:.3e} (tol {tol:g}); torch.linalg.solve_ex of the "
                         f"{n}x{n} KKT system {library_ms:.4f} ms ({lib_how}, all its kernels; its solution "
                         f"{err_lib:.1e} from the plain version's)")
            print(f"{tag}: max abs err {abs_err:.3e}, max rel err {err:.3e} vs the plain version{'' if f64 else ' in float64'} (tol {tol:g})"
                  f"{'' if f64 else f'; the plain float32 path is off by {err_plain:.3e}'}; kernel {ms:.4f} ms ({how}) "
                  f"(wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, {flops} FLOP){extra}; "
                  f"barriers per launch {syncs}; {fmt_info(info)}")
            check(err <= tol, f"{tag}: kernel differs from the plain version by {err} (relative)")
            rows[(dtype, k, B)] = dict(err=abs_err, rel_err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                       bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=library_ms)
    return rows


# ---------------------------------------------------------------- phase 3c


def igr_net(dtype, dims=(128,) * 8, skip_in=(4,), seed=1234, d_in=5):
    """The shape-space decoder at the reference's width (latent size 2,
    geometric init toward radius 0.55, weights from a numpy seed as the
    golden file's); d_in = 259 with dims (512,) * 8 is IGR's own shape-space
    decoder (a 256-dim latent)."""
    from diffsdfsim_torch.models.igr import init_implicit_net

    return init_implicit_net(d_in, dims, skip_in, radius_init=0.55, generator=np.random.default_rng(seed),
                             dtype=dtype).to("cuda")


def igr_flops(params, n):
    """FLOPs of the decoder on n points: two per multiply-add of every
    layer, four per softplus (scale, compare, exp, log1p and divide counted
    as one each but the compare)."""
    macs = sum(w.shape[0] * w.shape[1] for w in params.weights)
    acts = sum(w.shape[0] for w in params.weights[:-1])
    return n * (2 * macs + 4 * acts)


def fmt_k4_info(info):
    return (f"{info['threads']} threads x cluster of {info['cluster']} ({info['slices']} column slices each), "
            f"{info['tile']} points per cluster, "
            f"{info['smem_bytes']} B shared per CTA, {info['regs']} registers, {info['spill_bytes']} B spilled, "
            f"{info['blocks_per_sm']} CTAs/SM, {info['max_clusters']} clusters at once")


def k4_case(params, n, rtol, tiles=(0,)):
    """K4 at n points against implicit_net_apply (relative to the largest
    value, tolerance rtol), with its device time at each tile in `tiles`
    (0: the wrapper's choice by n), wrapper, plain and bound times. The
    launches made here are comparisons, not the main path's."""
    import torch
    from diffsdfsim_torch.models.igr import implicit_net_apply
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp

    dtype = params.weights[0].dtype
    rng = np.random.default_rng(n)
    x = np.concatenate([rng.normal(size=(n, params.d_in - 3)) * 0.3, rng.uniform(-1.0, 1.0, (n, 3))], axis=1)
    x = torch.tensor(x, dtype=dtype, device="cuda")
    ref = implicit_net_apply(params, x)
    errs, times = [], {}
    for tile in tiles:
        out = igr_mlp.run(params, x, tile)
        torch.cuda.synchronize()
        errs.append(float((out - ref).abs().max()))
        times[tile], how = device_ms(lambda: igr_mlp.run(params, x, tile), "igr_mlp_kernel")
    err = max(errs)
    rel = err / float(ref.abs().max())
    wrapper_ms = cuda_ms(lambda: igr_mlp(params, x))
    plain_ms = cuda_ms(lambda: implicit_net_apply(params, x))
    esize = x.element_size()
    nbytes = (x.numel() + n + sum(t.numel() for t in params.weights + params.biases)) * esize
    flops = igr_flops(params, n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_MATMUL_FLOPS[str(dtype).split(".")[1]] * 1e3
    width = max(w.shape[0] for w in params.weights)
    tag = f"K4 {str(dtype).split('.')[1]}{f' width {width} d_in {params.d_in}' if width != 128 else ''} N={n}"
    tiles_s = ", ".join(f"tile {t} {ms:.4f}" for t, ms in times.items() if t)
    print(f"{tag}: max abs err {err:.3e}, rel {rel:.3e} (tol {rtol:g}); kernel {times[0]:.4f} ms ({how}"
          f"{'; ' + tiles_s if tiles_s else ''}) (wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {max(bytes_ms, ops_ms):.6f} ms ({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, "
          f"{flops} FLOP); library: none")
    check(rel <= rtol, f"{tag}: kernel differs from the plain version by {rel} (relative)")
    return dict(err=err, ms=times[0], wrapper_ms=wrapper_ms, plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)


K4_RTOL = {"float64": 1e-12, "float32": 1e-5}


def phase_k4():
    """K4 against implicit_net_apply at N = 100 (template projection),
    2304 (a 3-rung Frank-Wolfe step over the 768-face floor) and 65536, at
    the reference's width, each at 32 and 40 points per cluster besides the
    wrapper's choice; and IGR's shape-space decoder ((512,) * 8, a 256-dim
    latent: d_in 259) at the latent drop's two most frequent N, 576 and
    2304, at the wrapper's choice (16 points per cluster in float64) and 8.
    Tolerance: 1e-12 (float64) and 1e-5 (float32) relative to the largest
    value (the kernel sums each dot product in its own order, the plain
    version in cuBLAS's)."""
    import torch
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp

    rows = {}
    for dtype in (torch.float64, torch.float32):
        params = igr_net(dtype).params()
        for tile in (32, 40):
            print(f"K4 {str(dtype).split('.')[1]} resources, tile {tile}: {fmt_k4_info(igr_mlp.info(params, dtype, tile))}")
        for n in (100, 2304, 65536):
            rows[(dtype, n)] = k4_case(params, n, K4_RTOL[str(dtype).split(".")[1]], tiles=(0, 32, 40))
        wide = igr_net(dtype, (512,) * 8, (4,), d_in=259).params()
        print(f"K4 {str(dtype).split('.')[1]} width 512 d_in 259 resources, wrapper's choice: "
              f"{fmt_k4_info(igr_mlp.info(wide, dtype, 0, 2304))}")
        for n in (576, 2304):
            rows[(dtype, "512", n)] = k4_case(wide, n, K4_RTOL[str(dtype).split(".")[1]], tiles=(0, 8))
    return rows


# ---------------------------------------------------------------- phase 3d


def sphere_grid(res):
    """A res^3 grid of the sphere SDF of radius 0.5 / 0.75 over [-1, 1]^3
    (numpy; tests/golden/gen_torch_shape_golden.py's voxelized sphere)."""
    lin = np.linspace(-1.0, 1.0, res)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    return np.sqrt(np.maximum(np.sum(pts * pts, axis=-1), 1e-24)) - 0.5 / 0.75


def grid_sample_fn(grid, inds):
    """torch's grid_sample computing what K5 computes at in-bounds points:
    trilinear ("bilinear" on a 5-D input), align_corners=True, its last
    coordinate axis ordered (z, y, x). Returns (C, N)."""
    import torch

    g4 = grid if grid.dim() == 4 else grid[None]
    size = torch.tensor(g4.shape[1:], dtype=inds.dtype, device=inds.device)
    coords = (inds / (size - 1.0) * 2.0 - 1.0).flip(-1).reshape(1, 1, 1, -1, 3)

    def run():
        return torch.nn.functional.grid_sample(g4[None], coords, mode="bilinear", padding_mode="border",
                                               align_corners=True).reshape(g4.shape[0], -1)

    return run


def k5_query_points(res, scale, n, seed):
    """n metric points for a query of a res^3 grid at this scale: ~85 %
    inside the grid, 5 % on its faces (one axis or several), the rest out
    to 1.2 scale, some just outside the faces (numpy)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2 * scale, 1.2 * scale, (n, 3))
    k = int(0.85 * n)
    pts[:k] = rng.uniform(-scale, scale, (k, 3))
    for i in range(k, k + n // 20):
        axes = rng.choice(3, size=1 + i % 3, replace=False)
        pts[i, axes] = scale * rng.choice([-1.0, 1.0], size=len(axes))
    pts[-(n // 50):] = scale * (1.0 + 1e-15 * rng.uniform(1, 8, (n // 50, 3)))
    return pts


def k5_query_plain(pts, grid, scale):
    """The plain version's (sdf, grad, grad_in, grad_raw) of a fused query
    (grid_interp.cu ``grid_query``): the query's value and gradient (with a
    scale), grid_sdf_grad of the normalized points, and the interpolated
    central differences before normalize and masks."""
    import torch
    from diffsdfsim_torch.ops import sdf

    pts_in = pts if scale is None else pts / scale
    inds, valid = sdf._grid_inds(pts_in, grid.shape)
    safe = torch.where(valid[:, None], inds, torch.zeros_like(inds))
    raw = sdf.grid_interp(sdf.grid_grad_volume(grid), safe).T
    if scale is None:
        return sdf.grid_sdf_raw(pts, grid), None, sdf.grid_sdf_grad(pts, grid), raw
    sdfs, grads = sdf.grid_query(pts, grid, scale)
    return sdfs, grads, sdf.grid_sdf_grad(pts_in, grid), raw


def ulps(a, b):
    """The largest distance between a and b in units in the last place of
    the larger (0 where they are equal, NaN with NaN)."""
    a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    if a.shape != b.shape:
        return float("inf")
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b))))
    return float(np.nan_to_num(d, nan=np.inf).max()) if d.size else 0.0


# How the fused query is held against its plain version on the card:
# bitwise, every output. The value and the interpolated gradient take the
# same correctly rounded operations in the same order; normalize's sum of
# squares is a reduction, whose order is torch's choice: on an H100 it is
# (a^2 + b^2) + c^2 for both of the query's normalizes
# (tools/normalize_rounding_check.py), as the kernel adds them.
K5_ULPS = 0


def k5_query_errors(outs, ref, max_ulps=K5_ULPS):
    """{output: ulps} of the kernel's (sdf, grad, grad_in, grad_raw) against
    k5_query_plain's, for the outputs the kernel wrote, and whether they
    pass: the value and the interpolated gradient bitwise, the normalized
    gradients within max_ulps units in the last place."""
    errs = {name: ulps(o, r) for name, o, r in zip(("value", "grad", "grad_in", "grad_raw"), outs, ref)
            if o is not None}
    ok = all(v == 0.0 if name in ("value", "grad_raw") else v <= max_ulps for name, v in errs.items())
    return errs, ok


def phase_k5():
    """K5's two entry points against their plain versions.

    The sampler against sdf.grid_interp on 33^3, 64^3 and 128^3 grids, C = 1
    and 3, N = 10^3 and 10^5 fractional voxel coordinates, ~4 % of them
    outside the grid (extrapolated by the clamped base corner) and some
    exactly on the upper faces. Tolerance 0: the kernel repeats the plain
    version's products in the same order.

    The fused query (a GridShape's whole query_sdfs in one launch) against
    k5_query_plain on the same grids, float64 and float32, at the grid drop's
    most frequent N (960: a 3-rung search over the ball's 320 faces) and at
    10^5, with every output and value only, held as k5_query_errors says;
    one GridShape query through the public path makes exactly one launch and
    no synchronizing host copy. Its time: kernel (device), the public query's
    wrapper (CUDA events), the plain composition, and grid_sample on a
    4-channel (value and gradient) volume as the library column; the bound
    counts min(32 N, X Y Z) grid values, the points and the outputs."""
    import torch
    from diffsdfsim_torch.ops import sdf
    from diffsdfsim_torch.ops.grid_cuda import grid_interp, grid_query_kernel
    from diffsdfsim_torch.physics import GridShape
    from diffsdfsim_torch.physics.shapes import query_sdfs

    rows = {}
    for dtype in (torch.float64, torch.float32):
        for res in (33, 64, 128) if dtype == torch.float64 else (64,):
            for C in (1, 3):
                for n in (1000, 100000):
                    rng = np.random.default_rng(res * 10 + C)
                    grid = torch.tensor(rng.normal(size=(C, res, res, res) if C > 1 else (res, res, res)),
                                        dtype=dtype, device="cuda")
                    inds = rng.uniform(-0.02, 1.02, (n, 3)) * (res - 1)
                    inds[:: 50, rng.integers(0, 3)] = res - 1  # on an upper face
                    inds = torch.tensor(inds, dtype=dtype, device="cuda")
                    out = grid_interp(grid, inds)
                    ref = sdf.grid_interp(grid, inds)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    ms, how = device_ms(lambda: grid_interp.run(grid, inds), "grid_interp_kernel")
                    tag = f"K5 sampler {str(dtype).split('.')[1]} {res}^3 C={C} N={n}"
                    print(f"{tag}: max abs err {err:.3e} (tol 0); kernel {ms:.4f} ms ({how})")
                    check(err == 0.0, f"{tag}: kernel differs from the plain version by {err}")
            for n in (960, 100000):
                grid = torch.tensor(sphere_grid(res), dtype=dtype, device="cuda")
                scale = torch.tensor(0.75, dtype=dtype, device="cuda")
                pts = torch.tensor(k5_query_points(res, 0.75, n, seed=res + n), dtype=dtype, device="cuda")
                ref = k5_query_plain(pts, grid, scale)
                outs = grid_query_kernel.run(pts, grid, scale, True, True, True)
                errs, ok = k5_query_errors(outs, ref)
                abs_err = max(float((o - r).abs().max()) for o, r in zip(outs, ref))
                errs_v, ok_v = k5_query_errors(grid_query_kernel.run(pts, grid, scale), ref)
                pin = pts / scale
                errs_n, ok_n = k5_query_errors(grid_query_kernel.run(pin, grid, None, grad_in=True, grad_raw=True),
                                               k5_query_plain(pin, grid, None))
                torch.cuda.synchronize()
                tag = f"K5 query {str(dtype).split('.')[1]} {res}^3 N={n}"
                line = (f"{tag}: max abs err {abs_err:.3e}; ulps " + ", ".join(f"{k} {v:g}" for k, v in errs.items())
                        + f"; value only {errs_v['value']:g}; normalized frame "
                        + ", ".join(f"{k} {v:g}" for k, v in errs_n.items()))
                check(ok and ok_v and ok_n, f"{tag}: the fused query differs from the plain version: {line}")
                shape = GridShape(grid=grid, scale_=scale)
                # one public query: one launch, no synchronizing operation
                before = grid_query_kernel.launches
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    query_sdfs(shape, pts)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                check(grid_query_kernel.launches == before + 1, f"{tag}: a GridShape query made "
                      f"{grid_query_kernel.launches - before} launches")
                ms, how = device_ms(lambda: grid_query_kernel.run(pts, grid, scale, grad=True), "grid_query_kernel")
                wrapper_ms = cuda_ms(lambda: query_sdfs(shape, pts))
                plain_ms = cuda_ms(lambda: sdf.grid_query(pts, grid, scale))
                vol4 = torch.cat([grid[None], sdf.grid_grad_volume(grid)])
                inds, valid = sdf._grid_inds(pin, grid.shape)
                lib = grid_sample_fn(vol4, torch.where(valid[:, None], inds, torch.zeros_like(inds)))
                library_ms = cuda_ms(lib)
                esize = grid.element_size()
                # the grid values the points' corners and stencils touch, the
                # points, the scale, the value and gradient written
                nbytes = (min(32 * n, grid.numel()) + 3 * n + 1 + 4 * n) * esize
                flops = 240 * n  # per point: value 30, 24 differences and 3 blends 114, two normalizes 24, masks
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
                print(f"{line}; one query: 1 launch, no sync; kernel {ms:.4f} ms ({how}) (wrapper {wrapper_ms:.4f} ms), "
                      f"plain {plain_ms:.4f} ms, grid_sample C=4 {library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} "
                      f"ms ({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, {flops} FLOP)")
                rows[(dtype, res, n)] = dict(err=abs_err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                             library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)
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
              f"{golden[f'toc_{n}_grad']!r}: rel {e:.2e} (tol {RTOL_GRAD_SHORT[n]:g})")
        check(e <= RTOL_GRAD_SHORT[n], f"{n}-frame gradient differs from the golden value by {e} (relative)")
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


# ---------------------------------------------------------------- phase 6


def reset_counts():
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.ops.grid_cuda import grid_interp, grid_query_kernel
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric, pdipm_fric

    for k in (pdipm_fric, fw_search_pair, kkt_grad_fric, igr_mlp, grid_interp, grid_query_kernel):
        k.launches = 0


def read_counts():
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.ops.grid_cuda import grid_interp, grid_query_kernel
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric, pdipm_fric

    return {"pdipm_fwd": pdipm_fric.launches, "fw_search": fw_search_pair.launches,
            "kkt_bwd": kkt_grad_fric.launches, "igr_mlp": igr_mlp.launches, "grid_query": grid_query_kernel.launches,
            "grid_interp": grid_interp.launches}


def synced(fn):
    """(fn(), seconds, device reads): fn run to a device synchronization,
    its synchronizing operations counted by torch's sync debug mode."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, wall, sum("synchroniz" in str(w.message) for w in caught)


def busy_share(fn):
    """(wall ms, device busy ms, distinct kernels) of fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
        if dev > 0:
            kern[ev.key] = dev / 1e3
    return wall * 1e3, sum(kern.values()), kern


def compare_shape_traj(traj, ref, label, atol):
    """Identical discrete decisions, every pose and velocity within atol."""
    tr = {k: v.detach().cpu().numpy() for k, v in traj._asdict().items()}
    for key in ("valid", "n_halvings", "bisect_failed", "truncated"):
        check(np.array_equal(tr[key], ref[f"traj_{key}"]), f"{label}: {key} differs")
    errs = {key: float(np.abs(tr[key] - ref[f"traj_{key}"]).max()) for key in ("pos", "quat", "v")}
    check(max(errs.values()) <= atol, f"{label}: differs from the JAX golden by {errs} (atol {atol})")
    return tr, errs


def phase_grid_path():
    """The voxel-grid body on CUDA: the 16-frame drop of a voxelized sphere
    on a 64^3 float64 grid (tests/test_world_extra.py:53-67 at a voxel-SDF
    user's size) through K5 (every query of the grid body, template
    projection included, is one fused-query launch: checked by counting the
    queries, and no gradient volume is built) and K1, against the JAX golden
    file; K3 is never launched (no pair of this scene is one of its
    analytic kinds)."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops import grid_cuda, sdf
    from diffsdfsim_torch.physics import (BoxShape, Gravity3D, GridShape, TotalConstraint3D, make_body,
                                          make_world, rollout)

    golden = dict(np.load(GRID_GOLDEN))
    cfg = SimConfig(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                    max_bisect=6)
    grid = torch.tensor(sphere_grid(int(golden["res"])), device="cuda")

    def run(n_frames):
        floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3, device="cuda")
        ball = make_body(GridShape(grid=grid, scale_=torch.tensor(0.75)), fric_coeff=0.25, template="ico",
                         subdiv=2, project_iters=16, device="cuda")
        spec, state = make_world([floor, ball], [[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, 1.0, 0]],
                                 np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                                 forces=((), (Gravity3D(10.0),)), cfg=cfg, device="cuda")
        return ball, rollout(spec, state, n_frames)[1]

    run(2)  # warm-up
    queries, volumes = [0], [0]
    query, volume = grid_cuda.grid_query, sdf.grid_grad_volume

    def counted_query(*args, **kwargs):
        queries[0] += 1
        return query(*args, **kwargs)

    def counted_volume(grid):
        volumes[0] += 1
        return volume(grid)

    grid_cuda.grid_query, sdf.grid_grad_volume = counted_query, counted_volume
    try:
        reset_counts()
        (ball, traj), wall, syncs = synced(lambda: run(int(golden["frames"])))
        launches = read_counts()
    finally:
        grid_cuda.grid_query, sdf.grid_grad_volume = query, volume
    check(launches["grid_query"] > 0 and launches["fw_search"] == 0 and launches["grid_interp"] == 0,
          f"the grid path must launch K5's query and not K3 or the sampler: {launches}")
    check(launches["grid_query"] == queries[0] and volumes[0] == 0,
          f"the grid path made {launches['grid_query']} K5 launches for {queries[0]} grid queries and built "
          f"{volumes[0]} gradient volumes")
    check(float((ball.verts.cpu() - torch.tensor(golden["verts"])).abs().max()) <= 1e-12, "grid body verts differ")
    _, errs = compare_shape_traj(traj, golden, "grid path vs JAX golden", ATOL_SHAPE_PATH)
    n_sub = int(traj.valid.sum())
    pwall, busy, kern = busy_share(lambda: run(int(golden["frames"])))
    print(f"grid path: {int(golden['frames'])} frames on a {int(golden['res'])}^3 grid in {wall:.3f} s wall "
          f"(make_body and make_world included), {n_sub} substeps, {syncs} device reads; {queries[0]} grid queries, "
          f"{volumes[0]} gradient volumes; launches {launches}; "
          f"vs JAX golden " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; profiled: wall {pwall:.1f} ms, device busy {busy:.1f} ms (idle {100 - 100 * busy / pwall:.1f}%)")
    return launches


# ---------------------------------------------------------------- phase 7


def phase_latent_path():
    """The shape-space body on CUDA at the reference's full width, through
    K4 (every decoder value), K1 and, in the gradient, K2; K3 is never
    launched. optim_shapespace's 36-frame drop at the target latent against
    the JAX golden file, then two Adam steps of the fit from the start
    latent (each a taped rollout and its backward), whose losses, gradients
    and latents are held against JAX's."""
    import torch
    from diffsdfsim_torch.experiments import optim_shapespace as oss

    golden = dict(np.load(LATENT_GOLDEN))
    net = igr_net(torch.float64, tuple(golden["dims"].tolist()), tuple(golden["skip_in"].tolist()),
                  int(golden["weight_seed"]))
    c = dict(oss.DEFAULTS, run_time=int(golden["frames"]) / 30.0)
    cfg = oss.build_cfg(c)
    target, start, quat0 = (torch.tensor(golden[k], device="cuda") for k in ("target_latent", "start_latent", "quat0"))

    oss.simulate(target, quat0, net, dict(c, run_time=2 / 30.0), cfg, device="cuda")  # warm-up
    # record N of every K4 launch of the drop
    from collections import Counter

    from diffsdfsim_torch.ops.igr_cuda import igr_mlp

    sizes = Counter()
    run = igr_mlp.run

    def recording_run(params, x, tile=0):
        sizes[x.shape[0]] += 1
        return run(params, x, tile)

    igr_mlp.run = recording_run
    try:
        reset_counts()
        (_, traj), wall, syncs = synced(lambda: oss.simulate(target, quat0, net, c, cfg, device="cuda"))
        launches = read_counts()
    finally:
        del igr_mlp.run
    check(launches["igr_mlp"] > 0 and launches["pdipm_fwd"] > 0 and launches["fw_search"] == 0,
          f"the latent forward must launch K4 and K1 and not K3: {launches}")
    check(traj.pos.grad_fn is None, "the latent forward recorded a tape with nothing requiring grad")
    _, errs = compare_shape_traj(traj, golden, "latent path vs JAX golden", ATOL_SHAPE_PATH)
    n_frames, n_sub = int(golden["frames"]), int(traj.valid.sum())
    print(f"latent path, forward: {n_frames} frames in {wall:.3f} s wall = {n_frames / wall:.2f} forward steps/s "
          f"(make_body and make_world included), {n_sub} substeps, {syncs} device reads "
          f"({syncs / n_sub:.1f} per substep); launches {launches}; vs JAX golden "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    mode_n = sizes.most_common(1)[0][0]
    print(f"latent path, forward: K4 launches by N (N: launches) {dict(sorted(sizes.items()))}; most frequent N {mode_n}")
    k4_case(net.params(), mode_n, K4_RTOL["float64"])

    reset_counts()
    out, fit_wall, fit_syncs = synced(lambda: oss.fit(net, target, start, quat0, c, cfg, device="cuda", max_iter=2))
    fit_launches = read_counts()
    check(fit_launches["igr_mlp"] > 0 and fit_launches["pdipm_fwd"] > 0 and fit_launches["kkt_bwd"] > 0
          and fit_launches["fw_search"] == 0, f"the fit must launch K4, K1 and K2 and not K3: {fit_launches}")
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())  # noqa: E731
    e_loss = max(rel(out["loss_hist"][i].cpu().numpy(), golden[f"loss_{i}"]) for i in range(2))
    e_grad = max(rel(out["grad_hist"][i].cpu().numpy(), golden[f"grad_{i}"]) for i in range(2))
    e_lat = float(np.abs(out["final_latent"].cpu().numpy() - golden["latent_2"]).max())
    print(f"latent path, fit: 2 Adam steps (target rollout, then 2 taped rollouts with their backward) in "
          f"{fit_wall:.3f} s wall, {fit_syncs} device reads; launches {fit_launches}; d loss / d latent "
          f"{[g.cpu().numpy().tolist() for g in out['grad_hist']]} vs JAX {[golden[f'grad_{i}'].tolist() for i in range(2)]}: "
          f"rel {e_grad:.2e} (tol {RTOL_LATENT_GRAD:g}); losses rel {e_loss:.2e} (tol {RTOL_LATENT_GRAD:g}); "
          f"latent after 2 steps {out['final_latent'].cpu().numpy().tolist()} vs JAX {golden['latent_2'].tolist()}: "
          f"{e_lat:.2e} (tol {ATOL_LATENT_Z:g})")
    check(e_grad <= RTOL_LATENT_GRAD and e_loss <= RTOL_LATENT_GRAD, "latent fit: loss or gradient differs from JAX")
    check(e_lat <= ATOL_LATENT_Z, f"latent fit: latent differs from JAX by {e_lat}")

    short = dict(c, run_time=20 / 30.0)
    pwall, busy, kern = busy_share(lambda: oss.simulate(target, quat0, net, short, cfg, device="cuda"))
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
    print(f"latent path, 20 profiled frames forward: wall {pwall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle {100 - 100 * busy / pwall:.1f}%); top kernels (ms): "
          + "; ".join(f"{k[:40]} {v:.2f}" for k, v in top) + f"; {len(kern)} distinct kernels")
    return launches, fit_launches


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
    k4 = phase_k4()
    k5 = phase_k5()
    launches, wall, n_sub = phase_main_path()  # in grad mode, as a forward-only caller runs it
    grad_launches = phase_gradient()
    grid_launches = phase_grid_path()
    latent_launches, _ = phase_latent_path()

    f64 = torch.float64
    k1r = k1[(f64, 4, 3)]
    k3r = k3[(f64, "sphere->floor touch R=3")]  # the pair that finds the contacts
    k2r = k2[(f64, 4, 1)]  # one problem per contacting substep on the main path
    k4r = k4[(f64, 2304)]  # a 3-rung Frank-Wolfe step over the floor's 768 faces
    k5r = k5[(f64, 64, 960)]  # the grid path's grid at its most frequent query size
    kernels = [
        dict(name="pdipm_fwd", route="cuda", source="diffsdfsim_torch/ops/csrc/pdipm_fwd.cu",
             replaces="diffsdfsim_tpu/ops/qp_pallas.py:247", launches=launches["pdipm_fwd"],
             max_abs_err=max(r["err"] for (dt, _, _), r in k1.items() if dt == f64), ms=k1r["ms"], plain_ms=k1r["plain_ms"],
             bound_ms=max(k1r["bytes_ms"], k1r["ops_ms"]),
             bound_by="bytes" if k1r["bytes_ms"] > k1r["ops_ms"] else "operations", library_ms=None),
        dict(name="fw_search", route="cuda", source="diffsdfsim_torch/ops/csrc/fw_search.cu",
             replaces="diffsdfsim_tpu/ops/fw_pallas.py:193", launches=launches["fw_search"],
             max_abs_err=max(r["err"] for (dt, _), r in k3.items() if dt == f64), ms=k3r["ms"], plain_ms=k3r["plain_ms"],
             bound_ms=max(k3r["bytes_ms"], k3r["ops_ms"]),
             bound_by="bytes" if k3r["bytes_ms"] > k3r["ops_ms"] else "operations", library_ms=None),
        dict(name="kkt_bwd", route="cuda", source="diffsdfsim_torch/ops/csrc/kkt_bwd.cu",
             replaces="diffsdfsim_tpu/ops/qp_pallas.py:712", launches=grad_launches["kkt_bwd"],
             max_abs_err=max(r["err"] for (dt, _, _), r in k2.items() if dt == f64), ms=k2r["ms"],
             plain_ms=k2r["plain_ms"], bound_ms=max(k2r["bytes_ms"], k2r["ops_ms"]),
             bound_by="bytes" if k2r["bytes_ms"] > k2r["ops_ms"] else "operations", library_ms=k2r["library_ms"]),
        dict(name="igr_mlp", route="cuda", source="diffsdfsim_torch/ops/csrc/igr_mlp.cu",
             replaces="diffsdfsim_tpu/ops/pallas_kernels.py:40", launches=latent_launches["igr_mlp"],
             max_abs_err=max(r["err"] for (dt, *_), r in k4.items() if dt == f64), ms=k4r["ms"],
             plain_ms=k4r["plain_ms"], bound_ms=max(k4r["bytes_ms"], k4r["ops_ms"]),
             bound_by="bytes" if k4r["bytes_ms"] > k4r["ops_ms"] else "operations", library_ms=None),
        dict(name="grid_query", route="cuda", source="diffsdfsim_torch/ops/csrc/grid_interp.cu",
             replaces="diffsdfsim_tpu/ops/pallas_kernels.py:106", launches=grid_launches["grid_query"],
             max_abs_err=max(r["err"] for (dt, *_), r in k5.items() if dt == f64), ms=k5r["ms"],
             plain_ms=k5r["plain_ms"], bound_ms=max(k5r["bytes_ms"], k5r["ops_ms"]),
             bound_by="bytes" if k5r["bytes_ms"] > k5r["ops_ms"] else "operations", library_ms=k5r["library_ms"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
