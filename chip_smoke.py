#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``diffsdfsim_torch/ops/csrc``
(one nvcc per source, all started together), holds each kernel against its
plain PyTorch version on the card (K3 also with a sphere of another radius
in each lane, at a sweep's probe stage of 48 and 192 poses, and with the
sysid floor and cube both lane bodies at 48 and 96; K1 and K2 also at
optim_sphere's room LCPs and optim_pointcloud's, k = 4 at fd = 4; K2 also
on a case whose contacts' friction cones are all tight, against the exact
solution in float64 and float32; K4 also refusing weights that require
grad; K5's lane entry also at 16 lanes of their own 64^3 grid against its
plain version and against one single launch per lane), then drives
seventeen paths of the port on CUDA (float64, and one in float32):

- the forward path: the bench scene's 100-frame bounce rollout through K1
  (PDIPM) and K3 (Frank-Wolfe search), held against the plain CPU rollout
  and the JAX package's committed golden trajectory;
- the gradient path: d loss / d rad of bench.py's 100-frame loss through
  K1, K3 and K2 (the LCP backward's KKT solve), held against the plain CPU
  gradient and the JAX package's committed golden gradients;
- the batched path: bench.py's seed sweep (``--batch=B``), the bench world
  at B radii in one batched-native rollout, B = 16 and 64, 100 frames
  forward and fwd+bwd through K1, K3 and K2: one K1 launch and one K3
  launch per directed pair for each probe stage of the whole batch, one
  host read per whole-batch decision, and lanes held against the single
  path;
- the grid path: a voxelized sphere on a 64^3 grid dropped for 16 frames
  through K5 (one fused launch per grid-SDF query, checked by counting the
  queries; no gradient volume built) and K1, against its JAX golden;
- the latent path: optim_shapespace's 36-frame drop of a shape-space body
  (the reference's IGR decoder at full width) through K4 (the fused
  decoder) and K1, then two Adam steps of the latent fit through K4, K1 and
  K2, against the JAX golden drop, gradients and latents; the drop's K4
  launches are counted by N, and K4 is checked at the most frequent N;
- the fitting experiments as their users' seed sweeps: optim_sphere (50
  seeds, 45 frames, targets and 2 GD iterations), optim_sysid for mass,
  force and friction (16 seeds, 30 frames, targets and one Adam step) and
  optim_shapespace (8 seeds at the full decoder width, 36 frames, targets
  and one Adam step): launches per probe stage, K4 launches per decoder
  query, lanes against the single path and one lane against the JAX
  golden (sysid: up to the first contact tie, which is printed);
- the observation layer: optim_pointcloud's scene rendered (128 x 96, 30
  frames) on the card against the CPU port, the latent and grid bodies
  rendered through K4 / K5 (one launch per SDF query, counted), its main
  with its iterations cut through K1, K3 and K2, its first-frame and
  trajectory losses and gradients against the JAX golden, and
  optim_pointcloud_real's main on a synthetic recording;
- shape from inertia: optim_primitives (box, sphere, cylinder; the mesh's
  Mirtich inertia, the analytic one, the analytic mesh) and
  optim_shapespace_inertia at the reference's decoder width, two Adam
  steps each, single and as 50- and 8-seed sweeps, against the JAX goldens
  and the single path; worlds with no contact pair, so no K1, K2 or K3,
  and one K4 launch per decoder query of a whole sweep batch;
- the trained shape space and the body builders: igr_train at full width
  on the card against the CPU port, the trained space's drop and Adam step
  (K4, K1, K2), the marble in the bowl and the 14^3 marching torus's drop
  and d / d scale against the JAX goldens, and the 64^3 torus (K5, K1);
- the 2D facade: the JAX package's 2D scenes uncut (circle drop, hull
  stack, the narrowphase parity scenes under the Frank-Wolfe search and
  the analytic narrowphase, pendulum, weld, the 65 x 65 grid drop) and
  two gradients, against the JAX goldens and the CPU port, the search's
  scenes up to their first contact tie (witnessed); K3 on circle / rect
  pairs, none under the analytic narrowphase;
- the solver fallback (K1 relaunched on the whole batch) on under-solved
  LCPs and the under-iterated bench, single and at B = 16, and
  post-stabilization on a 16-lane sweep, lane by lane against the single
  path;
- seed sweeps of lane bodies of every shape class (tests/scenes_lanes.py):
  16 voxel-grid balls on 64^3 grids with d / d scale (one K5 lane launch
  per grid query of the batch, counted), 8 bowls, 4 scaled hull stacks
  under the analytic narrowphase and 4 65 x 65 2D grid circles with d
  height / d grid values, against the JAX goldens and every lane against
  the single path on the card;
- the MeshSDF demo (diffsdfsim_torch.demos.meshsdf) at the reference
  decoder's full width with the JAX demo's weights: 2 SGD iterations
  against the JAX golden (K4, K1, K2);
- the seed sweep split over worker processes (diffsdfsim_torch.parallel):
  dryrun_multichip's seed_step at the bench's scale, 16 lanes, 20 frames
  fwd+bwd, unsharded, over a worker per visible card and over four
  workers on card 0, each chunk's K1, K3 and K2 launches counted in its
  worker, every run's lanes against the JAX golden and the unsharded run;
- float32, the JAX package's accelerator dtype, at bench.py's float32
  tolerance: the bench's 100-frame rollout (K1, K3) and d loss / d rad at
  12, 20 and 27 frames (K1, K3, K2) against the JAX package's float32
  kernels (its ``pallas`` golden) and, up to where the JAX package's two
  float32 paths part, against its plain path and the CPU port; the seed
  sweep at B = 16 (30 frames fwd+bwd), the 64^3 grid drop (K5) and the
  full-width latent drop and first Adam step (K4, K1, K2).

The kernel checks run first, with the card to themselves. The paths then
run in four groups, each a process of this script (``--group``), all on the
one card at once: each path keeps the host busy and the device idle most of
its wall, so the groups barely slow one another. Each group's output is
printed when all have ended; its walls are taken with the other groups
running. Each path runs with the kernels' launch counts (per process) set
to 0 just before it and read just after. Every check that fails raises, so any failure exits
non-zero. Without a CUDA device it exits non-zero before printing any
result.
"""

import contextlib
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
# bench.py's float32 tolerance (the reference's float64 tol 1e-8 is below
# float32's resolution)
F32_TOL = 1e-5
# the seed sweep's batch sizes (bench.py's batch16 / batch64)
SWEEP_B = (16, 64)
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
    logs = _build.build_all(_build.KERNELS)
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


def physics_lcps(B, seed, device, dtype, k=4, fd=8):
    """B mixed LCPs of the bench scene at contact (floor -> sphere, k
    contact slots, some invalid, fd friction directions), assembled by the
    port's engine: k = 4 is the bench's contact buffer, k = 8 the
    shape-space scene's; fd = 4 optim_pointcloud's friction pyramid."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import Gravity3D, TotalConstraint3D
    from diffsdfsim_torch.physics.contacts import Contacts
    from diffsdfsim_torch.physics.engine import dump_contact_lcp, mass_matrix_inv
    from diffsdfsim_torch.physics.world import WorldState
    from diffsdfsim_torch.utils.spherical import normalize

    cfg = SimConfig(**dict(BENCH_CFG, max_contacts_total=k, fric_dirs=fd))
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


def structured_lcps(B, neq, k, fd, dtype, seed, device="cuda"):
    """B seeded mixed LCPs with the physics friction layout (as in
    tests/test_qp_fric_reduced.py: nz = 12, a block-diagonal Q, k contacts
    of fd friction directions, neq random equality rows); the emulator's
    structured cases (tests/cuda_emu/emu_check.py)."""
    import torch
    from diffsdfsim_torch.ops.qp import blockdiag_inv3

    rng = np.random.default_rng(seed)
    nz = 12
    blocks = rng.normal(size=(B, 4, 3, 3))
    Q = np.zeros((B, nz, nz))
    for i in range(4):
        Q[:, 3 * i : 3 * i + 3, 3 * i : 3 * i + 3] = blocks[:, i] @ blocks[:, i].transpose(0, 2, 1) + 3 * np.eye(3)
    Jc = rng.normal(size=(B, k, nz))
    Jb = rng.normal(size=(B, k, fd // 2, nz))
    G = np.concatenate([Jc, np.concatenate([Jb, -Jb], axis=2).reshape(B, k * fd, nz), np.zeros((B, k, nz))], axis=1)
    nineq = k * (2 + fd)
    E = np.repeat(np.eye(k), fd, axis=0)
    F = np.zeros((B, nineq, nineq))
    F[:, k : k + k * fd, -k:] = E
    F[:, -k:, :k] = np.eye(k) * rng.uniform(0.1, 0.9, size=(B, 1, k))
    F[:, -k:, k : k + k * fd] = -E.T
    h = np.concatenate([rng.uniform(size=(B, k)) + 0.5, np.zeros((B, k * fd + k))], axis=1)
    out = [Q, rng.normal(size=(B, nz)), G, h, rng.normal(size=(B, neq, nz)), np.zeros((B, neq)), F]
    out = [torch.tensor(x, dtype=dtype, device=device) for x in out]
    return out + [blockdiag_inv3(out[0])]


def tight_k2_case(dtype, device="cuda"):
    """The emulator's "tight neq=6 k=4 fd=4" K2 case (B = 2): the structured
    LCPs, d drawn log-uniform in [0.01, 100] with every contact's cone row
    at 3e8 (float64) or at the backward's float32 cap 1e5 (a whole contact's
    cone tight), and a seeded rx. Returns (invQ, G, A, F, d, rx), structure."""
    import torch

    B, k, neq, fd = 2, 4, 6, 4
    Q, p, G, h, A, b, F, invQ = structured_lcps(B, neq, k, fd, dtype, seed=B + k, device=device)
    rng = np.random.default_rng(B)
    d = torch.tensor(np.exp(rng.uniform(np.log(0.01), np.log(100.0), size=tuple(h.shape))))
    d[:, -k:] = 3e8 if dtype == torch.float64 else 1e5
    rx = torch.tensor(rng.normal(size=tuple(p.shape)), dtype=dtype, device=device)
    return (invQ, G, A, F, d.to(device=device, dtype=dtype), rx), ("fric", k, fd), Q


def room_lcps(B, seed, device, dtype):
    """B mixed LCPs of optim_sphere's room at the sphere's wall and floor
    contacts, assembled by the port's engine: the floor and the wall (each
    fixed by a TotalConstraint3D) and a sphere of radius 0.4-2.0 in the
    corner, its 8 contact slots split between the floor (slots 0-3) and the
    wall (4-7), some invalid; nz 18, neq 12, k 8, fd 8 (m2 = 52, K1's and
    K2's runtime-sized instantiation)."""
    import torch
    from diffsdfsim_torch.experiments import optim_sphere as osp
    from diffsdfsim_torch.physics import Gravity3D, SphereShape, TotalConstraint3D, make_body
    from diffsdfsim_torch.physics.contacts import Contacts
    from diffsdfsim_torch.physics.engine import dump_contact_lcp, mass_matrix_inv
    from diffsdfsim_torch.physics.world import WorldState
    from diffsdfsim_torch.utils.spherical import normalize

    c = dict(osp.DEFAULTS)
    cfg = osp.build_cfg(c)
    room = osp.room_bodies(c, "cpu", torch.float64)
    f64 = lambda x: torch.tensor(np.asarray(x, dtype=np.float64))  # noqa: E731
    rng = np.random.default_rng(seed)
    k = cfg.max_contacts_total
    out = [[] for _ in range(8)]
    for _ in range(B):
        r = rng.uniform(c["min_dim"], c["max_dim"])
        sphere = make_body(SphereShape(torch.tensor(r)), restitution=0.5, fric_coeff=0.25, subdiv=1, device="cpu")
        bodies = [*room, sphere]
        centre = np.array([4.5 - r, r, 0.0])
        valid = rng.random(k) < 0.7
        valid[[0, 4]] = True
        n = np.array([[0.0, 1.0, 0.0]] * 4 + [[-1.0, 0.0, 0.0]] * 4) + 0.05 * rng.normal(size=(k, 3))
        along = np.array([[1.0, 0.0, 1.0]] * 4 + [[0.0, 1.0, 1.0]] * 4)  # in the floor's / the wall's plane
        hit = np.array([[4.5 - r, 0.0, 0.0]] * 4 + [[4.5, r, 0.0]] * 4) + 0.05 * rng.normal(size=(k, 3)) * along
        ctr = np.array([[0.0, -0.5, 0.0]] * 4 + [[5.0, 5.0, 0.0]] * 4)
        contacts = Contacts(
            normal=normalize(f64(n)), p1=f64(hit - ctr), p2=f64(hit - centre), pen=f64(np.zeros(k)),
            valid=torch.tensor(valid), i1=torch.tensor([0] * 4 + [1] * 4), i2=torch.full((k,), 2),
            pair_id=torch.tensor([0] * 4 + [1] * 4), max_pen_all=f64(0.0), pair_active=torch.ones(2, dtype=torch.bool),
        )
        v = np.zeros((3, 6))
        v[2, :3] = rng.normal(size=3) * 0.5
        v[2, 3:] = [3.0 * rng.random() + 0.1, -3.0 * rng.random() - 0.1, rng.normal() * 0.3]
        q2 = np.array([1.0, *(0.1 * rng.normal(size=3))])
        quat = f64([[1.0, 0, 0, 0], [1.0, 0, 0, 0], q2 / np.linalg.norm(q2)])
        state = WorldState(quat=quat, pos=f64([[0.0, -0.5, 0.0], [5.0, 5.0, 0.0], centre]), v=f64(v), t=f64(0.0),
                           contacts=contacts, last_dt=f64(cfg.dt), had_toc=torch.tensor(False))
        dt = cfg.dt * 0.5 ** int(rng.integers(0, 3))
        args, structure = dump_contact_lcp(bodies, (TotalConstraint3D(body1=0), TotalConstraint3D(body1=1)),
                                           ((), (), (Gravity3D(10.0),)), state, contacts, dt, cfg)
        check(structure == ("fric", 8, 8) and args[0].shape[-1] == 18 and args[4].shape[-2] == 12,
              f"room LCP: structure {structure}, Q {tuple(args[0].shape)}, A {tuple(args[4].shape)}")
        for i, a in enumerate(args):
            out[i].append(a[0])
        out[7].append(mass_matrix_inv(bodies, quat))
    return [torch.stack(o).to(device=device, dtype=dtype).contiguous() for o in out]


def case_lcps(case, B, seed, device, dtype):
    """The LCPs of a kernel case: (k, B) on the bench scene (``physics_lcps``),
    ("room", B) on optim_sphere's room (``room_lcps``) or ("pc", B) at
    optim_pointcloud's shape (the bench scene at k = 4, fd = 4)."""
    if case == "room":
        return room_lcps(B, seed, device, dtype)
    if case == "pc":
        return physics_lcps(B, seed, device, dtype, k=4, fd=4)
    return physics_lcps(B, seed, device, dtype, k=case)


def case_fd(case):
    return 4 if case == "pc" else 8


def case_tag(case, k):
    return "room" if case == "room" else ("k=4 fd=4" if case == "pc" else f"k={k}")


def lcp_dims(G, A, fd=8):
    """(nz, neq, nineq, k) of a batch of fric LCPs with fd directions."""
    nineq = G.shape[-2]
    return G.shape[-1], A.shape[-2], nineq, nineq // (2 + fd)


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
    # shape-space scene's buffer, at its probe batches of 3 and 4 rungs;
    # "room": optim_sphere's room (nz 18, neq 12, k 8: the runtime-sized
    # instantiation) at the single path's shallow stage (3 rungs) and the
    # 50-seed sweep's (150 problems)
    # "pc": optim_pointcloud's LCPs (k = 4, fd = 4: the runtime-sized
    # instantiation) at its probe stage of 3 rungs
    cases = ([(4, B) for B in (3, 6, 576)] + [(8, B) for B in (3, 4)] + [("room", B) for B in (3, 150)]
             + [("pc", 3)])
    for dtype, eps, tol_x in ((torch.float64, 1e-12, 1e-8), (torch.float32, 1e-6, 1e-2)):
        for case, B in cases:
            Q, p, G, h, A, b, F, invQ = case_lcps(case, B, seed=B, device="cuda", dtype=dtype)
            fd = case_fd(case)
            nz, neq, nineq, k = lcp_dims(G, A, fd)
            structure = ("fric", k, fd)
            args = (Q, p, G, h, A, b, F)
            sol_k = pdipm_fric(*args, invQ, 10, eps, 3, structure)
            done_it = pdipm_fric.last_done_it.clone()
            syncs = pdipm_fric.last_syncs.cpu()
            info = pdipm_fric.info(dtype, nz, neq, nineq, k, fd)
            static = case not in ("room", "pc")
            check(bool(info["static_m2"]) == static,
                  f"K1 {case} B={B}: the {'static' if static else 'runtime-sized'} instantiation expected, info {info}")
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
            flops = k1_flops(done_it, 10, Q, G, A, F, invQ, k, fd)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
            tag = f"K1 {str(dtype).split('.')[1]} {case_tag(case, k)} B={B}"
            print(f"{tag}: max|dx| {err:.3e} (tol {tol_x:g}, {int(solved.sum())}/{B} lanes), resid kernel max {float(res_k.max()):.3e} "
                  f"plain max {float(res_p.max()):.3e}, worse lanes {bad_res}; kernel {ms:.4f} ms ({how}) "
                  f"(wrapper with its tensor glue {wrapper_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, {flops} FLOP); "
                  f"barriers per Mehrotra iteration {int(syncs[0, 0])}, per launch {int(syncs[:, 1].max())}; "
                  f"{fmt_info(info)}")
            check(err <= tol_x, f"{tag}: kernel x differs from the plain version by {err}")
            check(bad_res == 0, f"{tag}: {bad_res} lanes with a worse KKT residual than the plain version")
            rows[(dtype, case, B)] = dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
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


def lane_rads(B):
    """bench.py's sweep radii for B lanes."""
    return np.linspace(0.42, 0.58, B)


def k3_lane_cases(device, dtype, B, D):
    """[(label, bd1, bd2, q1, p1, q2, p2)] at R = B D poses: a sphere of
    another radius in each lane (``lane_rads``), D rung poses per lane
    0..2e-4 apart from touching the floor, both directed pairs, as a sweep's
    probe stage searches them."""
    import torch
    from diffsdfsim_torch.physics import SphereShape, make_body
    from diffsdfsim_torch.physics.bodies import stack_lanes

    floor, _ = bench_bodies(device, dtype)
    rads = lane_rads(B)
    sph = stack_lanes([make_body(SphereShape(torch.tensor(float(r))), subdiv=2, fric_coeff=0.25, device=device,
                                 dtype=dtype) for r in rads])
    ys = np.repeat(rads, D) + 1e-6 - 2e-4 * np.tile(np.arange(D), B) / max(D - 1, 1)
    R = B * D
    q = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device).expand(R, 4)
    ps = torch.tensor(np.stack([np.zeros(R), ys, np.zeros(R)], 1), dtype=dtype, device=device)
    fp = torch.tensor([0.0, -0.5, 0.0], dtype=dtype, device=device).expand(R, 3)
    return [(f"lanes sphere->floor B={B} D={D}", sph, floor, q, ps, q, fp),
            (f"lanes floor->sphere B={B} D={D}", floor, sph, q, fp, q, ps)]


def k3_sysid_cases(device, dtype, B, D):
    """[(label, bd1, bd2, q1, p1, q2, p2)] at R = B D poses: optim_sysid's
    friction sweep at a probe stage of D rungs, where the floor and the cube
    are both lane bodies (box against box, both with lane strides). Each
    lane's boxes are sized apart (the cube's edge 0.9-1.1 m, the floor
    1.1-0.9 m thick, its top at 0), so a lane that read another lane's
    geometry would show; the cube rests flat on the floor, its D rungs
    1e-6 above to 2e-4 into it; both directed pairs."""
    import torch
    from diffsdfsim_torch.physics import BoxShape, make_body
    from diffsdfsim_torch.physics.bodies import stack_lanes

    edge = np.linspace(0.9, 1.1, B)
    thick = edge[::-1].copy()
    fric = np.linspace(0.15, 0.55, B)
    floor = stack_lanes([make_body(BoxShape(torch.tensor([20.0, float(t), 20.0])), fric_coeff=float(f), subdiv=3,
                                   device=device, dtype=dtype) for t, f in zip(thick, fric)])
    cube = stack_lanes([make_body(BoxShape(torch.tensor([float(e)] * 3)), fric_coeff=float(f), subdiv=2,
                                  device=device, dtype=dtype) for e, f in zip(edge, fric)])
    R = B * D
    ys = np.repeat(edge / 2, D) + 1e-6 - 2e-4 * np.tile(np.arange(D), B) / max(D - 1, 1)
    tt = lambda x: torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)  # noqa: E731
    q = tt([1.0, 0, 0, 0]).expand(R, 4)
    pc = tt(np.stack([0.01 * np.arange(R), ys, np.zeros(R)], 1))
    pf = tt(np.stack([np.zeros(R), -np.repeat(thick, D) / 2, np.zeros(R)], 1))
    return [(f"sysid lanes cube->floor B={B} D={D}", cube, floor, q, pc, q, pf),
            (f"sysid lanes floor->cube B={B} D={D}", floor, cube, q, pf, q, pc)]


def k3_lane_mismatches(bd1, q1, p1, bd2, q2, p2, cfg, out):
    """A lane-body launch of K3 against one launch per lane on that lane's
    own bodies (``lanes``: the lanes of the body with the most; R / lanes
    consecutive poses each): the fields of ``out`` that differ in any bit,
    [] when every lane's are identical."""
    import torch
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair

    R = q1.shape[0]
    L = max(bd1.lanes, bd2.lanes)
    D = R // L

    def lane(bd, i):
        if not bd.lanes:
            return bd
        return bd.with_tensors({k: v[i * bd.lanes // L] for k, v in bd.tensors().items()}, 0)

    bad = set()
    for i in range(L):
        sl = slice(i * D, (i + 1) * D)
        one = fw_search_pair(lane(bd1, i), q1[sl], p1[sl], lane(bd2, i), q2[sl], p2[sl], cfg)
        bad.update(f for f in out._fields if not torch.equal(getattr(one, f), getattr(out, f)[sl]))
    return sorted(bad)


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
    from diffsdfsim_torch.ops.fw_cuda import NBODY, fw_search_pair
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    rows = {}
    for dtype, tol, eps, atol, mis_frac in (
        (torch.float64, 1e-8, 1e-3, 1e-6, 0.0),
        (torch.float32, 1e-5, 1e-3, 2e-3, 0.005),
    ):
        cfg = SimConfig(**{**BENCH_CFG, "tol": tol, "eps": eps})
        big = [c for R in (3, 9) for c in k3_big_cases("cuda", dtype, R)] if dtype == torch.float64 else []
        lanes = [c for B in SWEEP_B for c in k3_lane_cases("cuda", dtype, B, 3)] if dtype == torch.float64 else []
        sysid = [c for D in (3, 6) for c in k3_sysid_cases("cuda", dtype, SYSID_B, D)] if dtype == torch.float64 else []
        for label, bd1, bd2, q1, p1, q2, p2 in k3_cases("cuda", dtype) + big + lanes + sysid:
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
            if "R=576" in label or label.startswith(("lanes", "sysid")) or any(
                    label.startswith(f"{pair} touch R={R}")
                    for pair in ("floor->sphere", "sphere->floor", "sphere20480->floor") for R in (3, 9)):
                R = q1.shape[0]
                prep = fw_search_pair.prepare(bd1, q1, p1, bd2, q2, p2, cfg)
                ms, how = device_ms(lambda: fw_search_pair.launch(prep), "fw_search_kernel")
                wrapper_ms = cuda_ms(lambda: fw_search_pair(bd1, q1, p1, bd2, q2, p2, cfg))
                plain_ms = cuda_ms(lambda: search_pair_raw_plain(bd1, q1, p1, bd2, q2, p2, cfg), n=3, warm=1)
                # each input read once (verts, faces, the poses, the constant
                # blocks, one per lane of a lane body), each output written once
                es = q1.element_size()
                n_consts = NBODY * (max(bd1.lanes, 1) + max(bd2.lanes, 1))
                nbytes = (bd1.verts.numel() + 14 * R + n_consts) * es + 8 * bd1.faces_t.numel() + R * F * (
                    13 * es + 2) + R * (es + 4)
                flops = k3_flops(F, R, iters_run, cfg.contact_polish_iters if bd1.is_sdf else 0)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
                line += (f"; kernel {ms:.4f} ms ({how}; wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                         f"({'bytes' if bytes_ms > ops_ms else 'operations'}), FW iterations per pose {sorted(set(iters_run.tolist()))}")
                # the sysid boxes' held fields (their anchors tie, below)
                held = max(errs[f] for f in ("n_ng", "pen", "abc", "max_pen")) if label.startswith("sysid") else err
                rows[(dtype, label)] = dict(err=held, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                            bytes_ms=bytes_ms, ops_ms=ops_ms)
                if label.endswith("R=3") or label.startswith(("sphere20480", "lanes", "sysid")):
                    line += f"; {fmt_k3_info(fw_search_pair.info(bd1, bd2, dtype, R))}"
            if " lanes " in f" {label} ":
                # each lane of the lane-body launch bitwise its own launch
                bad = k3_lane_mismatches(bd1, q1, p1, bd2, q2, p2, cfg, out_k)
                line += f"; against one launch per lane: {'bitwise' if not bad else 'differs in ' + ', '.join(bad)}"
                check(not bad, f"{tag}: lanes differ from their own launches in {bad}")
            print(line)
            check(errs["max_pen"] <= atol, f"{tag}: max_pen differs by {errs['max_pen']} (atol {atol})")
            if label.startswith(("floor->sphere", "sphere->floor", "sphere20480", "lanes")):
                # the bench pairs and the 20,480-face sphere: every per-face
                # output. Other kinds' box
                # and cylinder gradients have exact-tie "failsafe" branches
                # on their template vertices, where kernel and plain version
                # may settle on different, equally valid points (the JAX
                # package's own Pallas-vs-XLA test makes the same
                # exception); there max_pen, which decides acceptance, is held.
                check(mis <= allowed, f"{tag}: {mis} mask mismatches")
                check(err <= atol, f"{tag}: kernel differs from the plain version by {err} (atol {atol})")
            elif label.startswith("sysid"):
                # the cube rests flat on the floor: every point of a face
                # touching the floor has the same depth, so the per-face
                # anchor (p1_ng, x1) is decided by rounding; the masks and
                # the tie-free fields are held
                tie_free = max(errs[f] for f in ("n_ng", "pen", "abc", "max_pen"))
                check(mis == 0, f"{tag}: {mis} mask mismatches")
                check(tie_free <= atol, f"{tag}: n_ng, pen, abc or max_pen differ by {tie_free} (atol {atol})")
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
    contacting substep; a seed sweep's batch); optim_sphere's room LCPs at 1
    and 50 problems within RTOL_K2_ROOM, and also held against the KKT
    system's exact solution there (every float64 case is, within
    RTOL_K2_EXACT). float32: both against the plain version
    run in float64 on the same (float32-rounded) inputs, the kernel within
    1e-4 relative; the plain float32 path keeps the JAX XLA path's d-clip to
    [1e-5, 1e5] and ridge, which move its answer at these d (down to 1e-8),
    so its error is reported, not held. float64 also holds K2 against
    ``kkt_grad_reduced`` (the plain version of its algorithm: the reduced
    Schur solve and two steps of iterative refinement, 1e-9 relative) and
    times the library yardstick: one
    ``torch.linalg.solve_ex`` of the full (nz + nineq + neq) KKT system
    [[Q, G', A'], [G, -(D^-1 + F), 0], [A, 0, 0]] with right-hand side
    (-rx, 0, 0), whose solution is (dx, dlam, dnu); its assembly is not
    timed."""
    import torch
    from diffsdfsim_torch.ops.qp import blockdiag_inv3, kkt_grad_plain, kkt_grad_reduced, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    rows = {}
    for dtype in (torch.float64, torch.float32):
        # the room in float64 only: its KKT systems' condition numbers reach
        # ~1e16 (d over 1e-9..1e9), beyond what float32 can be held to
        room = (("room", 1), ("room", 50)) if dtype == torch.float64 else ()
        # "pc": optim_pointcloud's LCPs (k = 4, fd = 4, runtime-sized) at one
        # replay and at a probe stage's 6
        for case, B in ((4, 1), (4, 6), (4, 576), (8, 1)) + room + (("pc", 1), ("pc", 6)):
            f64 = dtype == torch.float64
            Q, p, G, h, A, b, F, invQ = case_lcps(case, B, seed=B, device="cuda", dtype=dtype)
            fd = case_fd(case)
            nz, neq, nineq, k = lcp_dims(G, A, fd)
            structure = ("fric", k, fd)
            x, y, z, s = pdipm_solve_raw(Q, p, G, h, A, b, F, 10, 1e-12 if f64 else 1e-6, 3, structure)
            d = torch.clamp(torch.clamp(z, min=1e-8) / torch.clamp(s, min=1e-8), max=1e12 if f64 else 1e5)
            rx = torch.tensor(np.random.default_rng(B).normal(size=tuple(x.shape)), dtype=dtype, device="cuda")
            iq = blockdiag_inv3(Q)
            ins = (iq, G, A, F, d, rx)
            out_k = kkt_grad_fric(*ins, structure)
            syncs = int(kkt_grad_fric.last_syncs.max())
            info = kkt_grad_fric.info(dtype, nz, neq, nineq, k, fd)
            check(bool(info["static_m2"]) == (case not in ("room", "pc")), f"K2 {case} B={B}: instantiation {info}")
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
            flops = k2_flops(iq, G, A, k, fd)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
            tol = 1e-9 if f64 else 1e-4
            tag = f"K2 {str(dtype).split('.')[1]} {case_tag(case, k)} B={B}"
            extra, library_ms = "", None
            if f64:
                # the kernel's algorithm in plain PyTorch
                out_red = kkt_grad_reduced(*ins, structure)
                err_red = max(rel(a, r) for a, r in zip(out_k, out_red))
                check(err_red <= tol, f"{tag}: kernel differs from kkt_grad_reduced by {err_red} (relative)")
                # the library yardstick on the assembled full KKT system
                n = nz + nineq + neq
                kkt, rhs = kkt_system(Q, G, A, F, d, rx)
                sol_lib = torch.linalg.solve_ex(kkt, rhs)[0][..., 0]
                err_lib = max(rel(sol_lib[:, :nz], out_p[0]), rel(sol_lib[:, nz : n - neq], out_p[1]),
                              rel(sol_lib[:, n - neq :], out_p[2]))
                library_ms, lib_how = device_ms(lambda: torch.linalg.solve_ex(kkt, rhs), None)
                # the system's exact solution
                ex = kkt_exact(kkt, rhs)
                ex = (ex[:, :nz], ex[:, nz : n - neq], ex[:, n - neq :])
                e_k = max(rel(a, r) for a, r in zip(out_k, ex))
                e_p = max(rel(a, r) for a, r in zip(out_p, ex))
                check(e_k <= RTOL_K2_EXACT, f"{tag}: kernel {e_k} from the exact solution (relative)")
                extra = (f"; vs kkt_grad_reduced {err_red:.3e} (tol {tol:g}); against the exact solution (LAPACK on "
                         f"the full KKT system, one extended-precision refinement): kernel {e_k:.3e} (tol "
                         f"{RTOL_K2_EXACT:g}), plain version {e_p:.3e}, torch.linalg.solve_ex "
                         f"{max(rel(sol_lib[:, :nz], ex[0]), rel(sol_lib[:, nz : n - neq], ex[1])):.3e}; "
                         f"torch.linalg.solve_ex of the "
                         f"{n}x{n} KKT system {library_ms:.4f} ms ({lib_how}, all its kernels; its solution "
                         f"{err_lib:.1e} from the plain version's)")
            else:
                # the library yardstick in float32 (timed, not held: a
                # float32 LU of these systems is not accurate)
                kkt, rhs = kkt_system(Q, G, A, F, d, rx)
                library_ms, lib_how = device_ms(lambda: torch.linalg.solve_ex(kkt, rhs), None)
                extra = f"; torch.linalg.solve_ex of the KKT system in float32 {library_ms:.4f} ms ({lib_how})"
            print(f"{tag}: max abs err {abs_err:.3e}, max rel err {err:.3e} vs the plain version{'' if f64 else ' in float64'} (tol {tol:g})"
                  f"{'' if f64 else f'; the plain float32 path is off by {err_plain:.3e}'}; kernel {ms:.4f} ms ({how}) "
                  f"(wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, {flops} FLOP){extra}; "
                  f"barriers per launch {syncs}; {fmt_info(info)}")
            check(err <= (RTOL_K2_ROOM if case == "room" else tol),
                  f"{tag}: kernel differs from the plain version by {err} (relative)")
            rows[(dtype, case, B)] = dict(err=abs_err, rel_err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                          bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=library_ms)
    for dtype in (torch.float64, torch.float32):
        k2_tight(dtype)
    return rows


def k2_tight(dtype):
    """K2 on the tight case (tight_k2_case) against the KKT system's exact
    solution (kkt_exact of the float64-widened inputs): float64 within 1e-9
    relative; float32 within 1e-4 and no farther from it than the plain
    float32 path (K2 computes in float64 for float32 inputs; a float32
    reduced factor was 4.2x its answer off here after two refinement
    steps, the plain float32 path 0.7x)."""
    import torch
    from diffsdfsim_torch.ops.qp import kkt_grad_plain, kkt_grad_reduced
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    ins, structure, Q = tight_k2_case(dtype)
    nz, nineq = Q.shape[-1], ins[1].shape[-2]
    ins64 = [t.double() for t in ins]
    kkt, rhs = kkt_system(Q.double(), *ins64[1:])
    ex = kkt_exact(kkt, rhs)
    ex = (ex[:, :nz], ex[:, nz : nz + nineq], ex[:, nz + nineq :])
    rel = lambda outs: max(float((a.double() - r).abs().max()) / float(r.abs().max())  # noqa: E731
                           for a, r in zip(outs, ex) if r.numel())
    e_k, e_red = rel(kkt_grad_fric(*ins, structure)), rel(kkt_grad_reduced(*ins, structure))
    e_plain, e_plain64 = rel(kkt_grad_plain(*ins, structure)), rel(kkt_grad_plain(*ins64, structure))
    f64 = dtype == torch.float64
    tol = 1e-9 if f64 else 1e-4
    tag = f"K2 {str(dtype).split('.')[1]} tight cones (d = {'3e8' if f64 else '1e5'}) neq=6 k=4 fd=4 B=2"
    print(f"{tag}: rel err vs the exact solution: kernel {e_k:.3e} (tol {tol:g}), kkt_grad_reduced {e_red:.3e}, "
          f"the plain path in {str(dtype).split('.')[1]} {e_plain:.3e}, in float64 {e_plain64:.3e}")
    check(e_k <= tol and (f64 or e_k <= e_plain), f"{tag}: kernel {e_k} from the exact solution (plain {e_plain})")


# K2 at the room's size, float64: the kernel within RTOL_K2_ROOM of the
# plain version (relative to the largest entry). The plain version factors
# the Schur complement by Cholesky and Woodbury (the JAX package's XLA path);
# the kernel folds it into the m2 = 52 reduced block and inverts that by
# pivot-free Gauss-Jordan (the Pallas kernel's algorithm). At
# room_lcps(1, seed=1) the reduced block's condition number is 2.1e10
# (pivots 1.5e-2 .. 3.1e8): the reduced solve alone lands ~cond * eps from
# the exact solution (1.6e-8 on the CPU emulator, 2.5e-8 on an H100 before
# the kernel refined it; tools/k2_room_conditioning.py), the plain version
# 2.5e-9. The kernel's two refinement steps take it to the exact solution:
# every float64 case within RTOL_K2_EXACT of it (kkt_exact), so the room's
# kernel-vs-plain reading is the plain version's own error.
RTOL_K2_ROOM = 1e-8
RTOL_K2_EXACT = 1e-12


def kkt_system(Q, G, A, F, d, rx):
    """The backward's full KKT systems [[Q, G', A'], [G, -(D^-1 + F), 0],
    [A, 0, 0]] and right-hand sides (-rx, 0, 0), whose solutions are (dx,
    dlam, dnu): (B, n, n), (B, n, 1)."""
    import torch

    B, nineq, nz = G.shape
    neq = A.shape[-2]
    n = nz + nineq + neq
    kkt = torch.zeros((B, n, n), dtype=Q.dtype, device=Q.device)
    kkt[:, :nz, :nz] = Q
    kkt[:, :nz, nz : n - neq] = G.transpose(-1, -2)
    kkt[:, :nz, n - neq :] = A.transpose(-1, -2)
    kkt[:, nz : n - neq, :nz] = G
    kkt[:, nz : n - neq, nz : n - neq] = -(torch.diag_embed(1.0 / d) + F)
    kkt[:, n - neq :, :nz] = A
    rhs = torch.zeros((B, n, 1), dtype=Q.dtype, device=Q.device)
    rhs[:, :nz, 0] = -rx
    return kkt, rhs


def kkt_exact(kkt, rhs):
    """The systems' solutions to float64 accuracy, (B, n) on kkt's device:
    LAPACK's partially pivoted solve on the host, then one refinement with
    the residual formed in extended precision (numpy's longdouble); on the
    room's systems this agrees with a 34-digit mpmath solve to the last
    float64 bit."""
    import torch

    K, b = kkt.double().cpu().numpy(), rhs.double().cpu().numpy()[..., 0]
    x = np.linalg.solve(K, b[..., None])[..., 0]
    res = b.astype(np.longdouble) - np.einsum("bij,bj->bi", K.astype(np.longdouble), x.astype(np.longdouble))
    x = x + np.linalg.solve(K, res.astype(np.float64)[..., None])[..., 0]
    return torch.tensor(x, device=kkt.device)


# ---------------------------------------------------------------- phase 3c


def igr_net(dtype, dims=(128,) * 8, skip_in=(4,), seed=1234, d_in=5, device="cuda"):
    """The shape-space decoder at the reference's width (latent size 2,
    geometric init toward radius 0.55, weights from a numpy seed as the
    golden file's); d_in = 259 with dims (512,) * 8 is IGR's own shape-space
    decoder (a 256-dim latent)."""
    from diffsdfsim_torch.models.igr import init_implicit_net

    return init_implicit_net(d_in, dims, skip_in, radius_init=0.55, generator=np.random.default_rng(seed),
                             dtype=dtype).to(device)


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
    k4_guard()
    return rows


def k4_guard():
    """K4 differentiates with respect to x only: a call whose weights require
    grad in grad mode raises on the card (and launches nothing); under
    no_grad it runs."""
    import torch
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp

    p = igr_net(torch.float64).params()
    p = p._replace(weights=tuple(w.detach().clone().requires_grad_(True) for w in p.weights))
    x = torch.rand((64, 5), dtype=torch.float64, device="cuda")
    n0 = igr_mlp.launches
    try:
        igr_mlp(p, x)
        raised = False
    except ValueError:
        raised = True
    check(raised and igr_mlp.launches == n0, "K4 ran with weights that require grad in grad mode")
    with torch.no_grad():
        igr_mlp(p, x)
    check(igr_mlp.launches == n0 + 1, "K4 under no_grad did not launch")
    print("K4 guard: weights that require grad raise in grad mode (no launch); under no_grad one launch")


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
        rows[(dtype, "lanes")] = k5_lanes(dtype)
    return rows


# the K5 lane entry's case: a seed sweep of K5_LANES grid bodies on 64^3
# grids (phase_lanes_3d's grid sweep), a probe stage of K5_LANE_POSES rungs of
# the ball's 320 faces per lane (the single grid drop's most frequent query
# size, 960 points, in every lane)
K5_LANES, K5_LANE_POSES, K5_LANE_N = 16, 3, 320


def k5_lanes(dtype, res=64):
    """K5's lane entry (grid_query_lanes) at K5_LANES lanes of their own
    grid and scale, against its plain version (torch.func.vmap of
    sdf.grid_query, every output as k5_query_errors holds the single query)
    and bitwise against one single launch per lane, also with one grid every
    lane shares (lane stride 0); the public lane query and a GridShape lane
    body's query (torch.func.vmap, the Function's vmap rule) are one launch
    each with no synchronizing host copy, and make_body_lanes builds a grid
    lane body through lane launches alone. Its time: kernel, the public
    query's wrapper, the plain version, and grid_sample on the lanes'
    4-channel volumes as one batched call; the bound counts each lane's
    min(32 M, X Y Z) grid values, the points, scales and outputs."""
    import torch
    from diffsdfsim_torch.ops import sdf
    from diffsdfsim_torch.ops.grid_cuda import grid_query_kernel, grid_query_lanes, grid_query_lanes_kernel
    from diffsdfsim_torch.physics import GridShape, make_body
    from diffsdfsim_torch.physics.bodies import make_body_lanes, stack_lanes

    L, d, n = K5_LANES, K5_LANE_POSES, K5_LANE_N
    M = d * n
    rads = np.linspace(0.4, 0.6, L)
    grids = torch.tensor(np.stack([sphere_grid(res) + (0.5 - r) / 0.75 for r in rads]), dtype=dtype, device="cuda")
    scales = torch.tensor(np.linspace(0.7, 0.8, L), dtype=dtype, device="cuda")
    pts = torch.tensor(np.stack([k5_query_points(res, float(scales[i // d]), n, seed=100 + i) for i in range(L * d)]),
                       dtype=dtype, device="cuda")  # (R, N, 3), lane-major
    x = pts.reshape(L, M, 3)
    tag = f"K5 lane entry {str(dtype).split('.')[1]} {res}^3 L={L} d={d} N={n}"
    worst, errs_all, bitwise, abs_err = True, {}, True, 0.0
    for shared in (False, True):
        g = grids[0] if shared else grids
        outs = grid_query_lanes_kernel.run(x, g, scales, True, True, True)
        for lane in range(L):
            gl = g if shared else grids[lane]
            ref = k5_query_plain(x[lane], gl, scales[lane])
            mine = [o[lane] for o in outs]
            errs, ok = k5_query_errors(mine, ref)
            worst = worst and ok
            errs_all = {k: max(v, errs_all.get(k, 0.0)) for k, v in errs.items()}
            abs_err = max(abs_err, max(float((o - r).abs().max()) for o, r in zip(mine, ref)))
            one = grid_query_kernel.run(x[lane], gl, scales[lane], True, True, True)
            bitwise = bitwise and all(torch.equal(a, b) for a, b in zip(mine, one))
    torch.cuda.synchronize()
    line = (f"{tag}: against the plain version max abs err {abs_err:.3e}, ulps "
            + ", ".join(f"{k} {v:g}" for k, v in errs_all.items())
            + f" (tol {K5_ULPS}); bitwise one single launch per lane {bitwise} (per-lane and shared grids)")
    check(worst and bitwise, f"{tag}: the lane entry differs: {line}")
    # the public lane query and a GridShape lane body's query: one launch, no sync
    bodies = [make_body(GridShape(grids[i], scales[i]), template="ico", subdiv=2, project_iters=16, device="cuda",
                        dtype=dtype) for i in range(2)]
    lane_body = stack_lanes(bodies)
    bpts = pts[:2 * d].reshape(2, M, 3)
    for what, fn in (("grid_query_lanes", lambda: grid_query_lanes(pts, grids, scales)),
                     ("a GridShape lane body's query", lambda: lane_body.query_sdfs(bpts))):
        b0, s0 = grid_query_lanes_kernel.launches, grid_query_kernel.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(grid_query_lanes_kernel.launches == b0 + 1 and grid_query_kernel.launches == s0,
              f"{tag}: {what} made {grid_query_lanes_kernel.launches - b0} lane and "
              f"{grid_query_kernel.launches - s0} single launches")
    ref_body = [query_sdfs_plain(bodies[i].shape, bpts[i]) for i in range(2)]
    check(all(torch.equal(out[k][i], ref_body[i][k]) for i in range(2) for k in range(2)),
          f"{tag}: a lane body's query differs from each lane's single query")
    # a grid lane body built by one vmapped construction: every projection
    # query one lane launch, the body each lane's make_body
    b0, s0 = grid_query_lanes_kernel.launches, grid_query_kernel.launches
    built = make_body_lanes(lambda p: GridShape(p[0], p[1]), (grids[:2], scales[:2]), template="ico", subdiv=2,
                            project_iters=16, device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    n_lane, n_single = grid_query_lanes_kernel.launches - b0, grid_query_kernel.launches - s0
    e_body = max(float((built.tensors()[k] - v).abs().max()) for k, v in lane_body.tensors().items())
    print(f"{tag}: make_body_lanes of 2 grid bodies: {n_lane} lane launches, {n_single} single launches, "
          f"{e_body:.2e} from stack_lanes of each lane's make_body")
    # the vmapped construction's reductions (the inertia's sums) may round
    # otherwise than one lane's: 1.6e-19 in float64, 9.2e-11 in float32 on an H100
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    check(n_lane > 0 and n_single == 0 and e_body <= tol, f"{tag}: make_body_lanes: {n_lane} lane and {n_single} "
          f"single launches, {e_body:.2e} from each lane's make_body (tol {tol:g})")
    ms, how = device_ms(lambda: grid_query_lanes_kernel.run(x, grids, scales, grad=True), "grid_query_kernel")
    wrapper_ms = cuda_ms(lambda: grid_query_lanes(pts, grids, scales))
    plain = torch.func.vmap(lambda p, g, s: sdf.grid_query(p, g, s))
    plain_ms = cuda_ms(lambda: plain(x, grids, scales))
    vols = torch.stack([torch.cat([grids[i][None], sdf.grid_grad_volume(grids[i])]) for i in range(L)])
    pin = x / scales[:, None, None]
    inds, valid = sdf._grid_inds(pin, grids.shape[1:])
    inds = torch.where(valid[..., None], inds, torch.zeros_like(inds))
    size = torch.tensor(grids.shape[1:], dtype=dtype, device="cuda")
    coords = (inds / (size - 1.0) * 2.0 - 1.0).flip(-1).reshape(L, 1, 1, M, 3)
    library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(vols, coords, mode="bilinear",
                                                                 padding_mode="border", align_corners=True))
    del vols
    esize = grids.element_size()
    N = L * M
    nbytes = (L * min(32 * M, grids[0].numel()) + 3 * N + L + 4 * N) * esize
    flops = 240 * N
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
    print(f"{line}; one public query and one lane body's query: 1 launch each, no sync; kernel {ms:.4f} ms ({how}) "
          f"(wrapper {wrapper_ms:.4f} ms), plain (vmap) {plain_ms:.4f} ms, grid_sample (L={L}, C=4) "
          f"{library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
          f"({'bytes' if bytes_ms > ops_ms else 'operations'}: {nbytes} B, {flops} FLOP)")
    return dict(err=abs_err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes_ms=bytes_ms, ops_ms=ops_ms)


def query_sdfs_plain(shape, pts):
    """A GridShape's query by the plain version (ops/sdf.grid_query)."""
    from diffsdfsim_torch.ops import sdf

    return sdf.grid_query(pts, shape.grid, shape.scale_)


# ---------------------------------------------------------------- phase 4


def run_rollout(device, dtype=None):
    """The bench world (float64, or float32 with bench.py's f32 tol 1e-5)."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import Gravity3D, TotalConstraint3D, make_world, rollout

    dtype = dtype or torch.float64
    cfg = dict(BENCH_CFG, tol=F32_TOL) if dtype == torch.float32 else BENCH_CFG
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
    traj, rad, spec = bench_traj(device, n_frames)
    return prefix_loss(traj, n_frames), rad, spec


def bench_traj(device, n_frames, dtype=None):
    """The bench rollout from a radius that requires grad, taped, in
    ``dtype`` (float64; float32 with bench.py's float32 tol 1e-5):
    (trajectory, rad, spec)."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import (BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body,
                                          make_world, rollout)

    dtype = dtype or torch.float64
    cfg = dict(BENCH_CFG, tol=F32_TOL) if dtype == torch.float32 else BENCH_CFG
    rad = torch.tensor(0.5, dtype=dtype, device=device, requires_grad=True)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25, device=device,
                      dtype=dtype)
    sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25, device=device, dtype=dtype)
    poses = [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]]
    spec, state = make_world([floor, sphere], poses, np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                             forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**cfg), device=device)
    _, traj = rollout(spec, state, n_frames)
    return traj, rad, spec


def prefix_loss(traj, n):
    """bench.py's loss over the first n frames of a single trajectory."""
    import torch

    return torch.sum(traj.pos[:n, :, 1, :] ** 2 * traj.valid[:n, :, None])


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


# ---------------------------------------------------------------- phase 5b


_FLOORS = {}


def sweep_world(rad, device="cuda"):
    """bench.py's world of one sweep lane: the bench scene at radius ``rad``
    (a tensor, whose dtype the world takes: float32 with bench.py's float32
    tol 1e-5), built on ``device``; the floor, the same in every lane and
    requiring no grad, is built once per device and dtype."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world

    dtype = rad.dtype
    if (device, dtype) not in _FLOORS:
        _FLOORS[device, dtype] = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25,
                                           device=device, dtype=dtype)
    floor = _FLOORS[device, dtype]
    sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25, device=device, dtype=dtype)
    poses = [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]]
    cfg = dict(BENCH_CFG, tol=F32_TOL) if dtype == torch.float32 else BENCH_CFG
    return make_world([floor, sphere], poses, np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**cfg), device=device)


def lane_losses(traj, n):
    """bench.py's loss of each lane over the first n frames of a
    ``rollout_batched`` trajectory ((T, S, B, ...) leaves)."""
    import torch

    return torch.sum(traj.pos[:n, :, :, 1, :] ** 2 * traj.valid[:n, :, :, None], dim=(0, 1, 3))


def single_reference(rad, n_frames):
    """The single path at one radius on CUDA (n_frames >= 27): its trajectory
    (numpy), d loss / d rad over its first 20, 27 and n_frames frames, and
    the fwd+bwd wall of its n_frames-frame loss. The 20- and 27-frame
    gradients come from a 27-frame rollout: a loss over the first frames of
    a longer rollout back-propagates zeros through the rest of its tape."""
    import torch
    from diffsdfsim_torch.physics import rollout

    def run(n, ns):
        r = torch.tensor(float(rad), dtype=torch.float64, device="cuda", requires_grad=True)
        spec, state = sweep_world(r)
        _, traj = rollout(spec, state, n)
        return traj, {m: float(torch.autograd.grad(torch.sum(traj.pos[:m, :, 1, :] ** 2 * traj.valid[:m, :, None]),
                                                   r, retain_graph=True)[0]) for m in ns}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj, grads = run(n_frames, (n_frames,) if n_frames > 27 else (27, 20))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if n_frames > 27:
        grads.update(run(27, (27, 20))[1])
    return {k: v.detach().cpu().numpy() for k, v in traj._asdict().items()}, grads, wall


def lane_traj(tr, i):
    """Lane i of a batched trajectory (numpy (T, S, B, ...) leaves, truncated (T, B))."""
    return {k: v[:, i] if k == "truncated" else v[:, :, i] for k, v in tr.items()}


def phase_batched():
    """The seed sweep (``physics/batched.py``, bench.py's ``--batch=B``):
    the bench world at B radii ``lane_rads(B)`` for B = 16 and 64, 100
    frames forward and fwd+bwd through K1, K3 and K2. Each probe stage of the
    batch is one K1 launch (when some lane starts with a contact) and one
    K3 launch per directed pair, each whole-batch decision one host read;
    lanes against the single path (lanes 0 and 15 of 16 at 27 frames;
    lane 63 of 64 over the 100 frames): identical decisions, the bounce
    as the single path is held against its golden, d loss / d rad at 20
    and 27 frames within RTOL_GRAD_SHORT (the 100-frame gradient, decided
    by rounding at the touchdowns, is reported). Where the host time of 20
    frames fwd+bwd goes at B = 64: ``batched_regions``."""
    import torch
    from diffsdfsim_torch.physics import make_world_batched, rollout_batched

    rows = {}
    for B in SWEEP_B:
        rads = lane_rads(B)
        parts, mark = {}, [time.perf_counter()]

        def part(name):
            # the phase's wall by part, for the time budget of the script
            now = time.perf_counter()
            parts[name] = parts.get(name, 0.0) + now - mark[0]
            mark[0] = now

        def build(grad):
            t = time.perf_counter()
            r = torch.tensor(rads, dtype=torch.float64, device="cuda", requires_grad=grad)
            spec, bodies_b, state_b = make_world_batched(sweep_world, r)
            torch.cuda.synchronize()
            spent = time.perf_counter() - t
            parts["build"] = parts.get("build", 0.0) + spent
            mark[0] += spent
            return r, spec, bodies_b, state_b

        # warm-up at this batch size: fwd+bwd through every lane's first touchdown
        r, spec, bodies_b, state_b = build(True)
        _, traj = rollout_batched(spec, bodies_b, state_b, 14)
        torch.autograd.grad(lane_losses(traj, 14).sum(), r)
        part("warm-up")

        # forward, in grad mode with nothing requiring grad
        _, spec, bodies_b, state_b = build(False)
        reset_counts()
        t0 = time.perf_counter()
        _, traj_f = rollout_batched(spec, bodies_b, state_b, N_FRAMES)
        torch.cuda.synchronize()
        fwd_wall = time.perf_counter() - t0
        fwd_launches = read_counts()
        check(traj_f.pos.grad_fn is None, f"B={B}: the forward recorded a tape with nothing requiring grad")
        fwd_stages, fwd_reads = dict(spec.stages), dict(spec.host_reads)
        part("forward")

        # fwd+bwd of the sum of the lanes' losses
        r, spec, bodies_b, state_b = build(True)
        reset_counts()
        t0 = time.perf_counter()
        _, traj = rollout_batched(spec, bodies_b, state_b, N_FRAMES)
        loss = lane_losses(traj, N_FRAMES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (g100,) = torch.autograd.grad(loss.sum(), r)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_counts()
        wall = t2 - t0
        part("fwd+bwd")
        # the 20- and 27-frame gradients from a 27-frame rollout (see single_reference)
        r27, spec27, bodies27, state27 = build(True)
        _, traj27 = rollout_batched(spec27, bodies27, state27, 27)
        grads = {n: torch.autograd.grad(lane_losses(traj27, n).sum(), r27, retain_graph=True)[0].cpu().numpy()
                 for n in (20, 27)}
        grads[N_FRAMES] = g100.cpu().numpy()
        part("20- and 27-frame gradients")
        check(bool(np.isfinite(grads[N_FRAMES]).all()), f"B={B}: a lane's gradient is not finite")
        tr = {k: v.detach().cpu().numpy() for k, v in traj._asdict().items()}
        trf = {k: v.cpu().numpy() for k, v in traj_f._asdict().items()}
        tr27 = {k: v.detach().cpu().numpy() for k, v in traj27._asdict().items()}
        for key in ("valid", "n_halvings", "bisect_failed", "truncated"):
            check(np.array_equal(tr[key], trf[key]), f"B={B}: the taped run's {key} differs from the forward's")
            check(np.array_equal(tr[key][:27], tr27[key]), f"B={B}: the 27-frame run's {key} differs")

        # one launch per probe stage, one host read per decision
        st, reads = spec.stages, spec.host_reads
        stages = st["shallow"] + st["deep"]
        n_pairs = len(spec.directed_pairs)
        for tag, lc, sg, rd in (("forward", fwd_launches, fwd_stages, fwd_reads),
                                ("fwd+bwd", launches, dict(st), dict(reads))):
            n_st = sg["shallow"] + sg.get("deep", 0)
            check(lc["pdipm_fwd"] == sg["lcp"] > 0, f"B={B} {tag}: {lc['pdipm_fwd']} K1 launches for "
                  f"{sg['lcp']} probe stages that solve the LCP")
            check(lc["fw_search"] == n_pairs * n_st, f"B={B} {tag}: {lc['fw_search']} K3 launches for {n_st} probe "
                  f"stages of {n_pairs} directed pairs")
            check(rd["contact"] == rd["deep"] == sg["shallow"] == sg["substep"] == rd["recompute"],
                  f"B={B} {tag}: host reads {rd} for stages {sg}")
            check(sg["substep"] <= rd["substep"] <= sg["substep"] + N_FRAMES, f"B={B} {tag}: substep reads {rd}")
        check(launches["kkt_bwd"] == st["replay_lcp"] > 0,
              f"B={B}: {launches['kkt_bwd']} K2 launches for {st['replay_lcp']} taped LCP replays")
        check(sum(reads.values()) == spec.host_syncs, f"B={B}: {spec.host_syncs} host reads, {dict(reads)} by kind")

        # lanes against the single path
        # two lanes of 16 at 27 frames, one of 64 over the 100 frames: the
        # single-path references take most of this phase's time
        n_chk, lanes = (27, (0, 15)) if B == 16 else (N_FRAMES, (63,))
        errs, gerr, single_walls = {}, {20: 0.0, 27: 0.0, N_FRAMES: 0.0}, []
        for i in lanes:
            ref, g_ref, w = single_reference(rads[i], n_chk)
            single_walls += [w] if n_chk == N_FRAMES else []
            lt = lane_traj(tr, i)
            e = compare_traj({k: v[:n_chk] for k, v in lt.items()}, ref, f"B={B} lane {i} vs the single path")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0), v) if k != "first_frame_over_1e-7" else min(errs.get(k, n_chk), v)
            for n in (20, 27) + ((N_FRAMES,) if n_chk == N_FRAMES else ()):
                rel = abs(float(grads[n][i]) - g_ref[n]) / abs(g_ref[n])
                gerr[n] = max(gerr[n], rel)
                tol = RTOL_GRAD_SHORT.get(n, np.inf)
                check(rel <= tol, f"B={B} lane {i}: d loss / d rad over {n} frames {float(grads[n][i])!r} vs the "
                      f"single path's {g_ref[n]!r}: rel {rel:.2e} (tol {tol:g})")

        part("single path")

        # device busy share of 20 profiled frames fwd+bwd (the worlds built before)
        def twenty():
            r20, s20, b20, st20 = build(True)

            def run():
                _, tr20 = rollout_batched(s20, b20, st20, 20)
                torch.autograd.grad(lane_losses(tr20, 20).sum(), r20)
            return run

        pwall, busy, kern = busy_share(twenty(), cpu=False)
        part("profile")
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        valid = tr["valid"]
        hist = np.bincount(tr["n_halvings"][valid], minlength=BENCH_CFG["max_bisect"] + 1).tolist()
        rate, fwd_rate = B * N_FRAMES / wall, B * N_FRAMES / fwd_wall
        print(f"batched B={B}: forward {N_FRAMES} frames in {fwd_wall:.3f} s wall = {fwd_rate:.2f} lane-steps/s; "
              f"fwd+bwd in {wall:.3f} s wall = {rate:.2f} lane-steps/s (forward {t1 - t0:.3f} s, backward "
              f"{t2 - t1:.3f} s, backward share {(t2 - t1) / wall:.3f})")
        print(f"batched B={B}: {st['substep']} whole-batch substeps ({int(valid.sum())} lane substeps, accepted-rung "
              f"histogram {hist}); probe stages shallow {st['shallow']}, deep {st['deep']}, solving the LCP "
              f"{st['lcp']}; host reads by decision kind {dict(sorted(reads.items()))} ({spec.host_syncs} in all, "
              f"{spec.host_syncs / st['substep']:.2f} per substep); launches forward {fwd_launches}, fwd+bwd "
              f"{launches}: K1 {launches['pdipm_fwd'] / max(st['lcp'], 1):.2f} per LCP stage, K3 "
              f"{launches['fw_search'] / stages:.2f} per stage, K2 {launches['kkt_bwd']} for {st['replay_lcp']} "
              f"taped LCP replays")
        fmt = lambda e: ", ".join(f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}" for k, v in e.items())  # noqa: E731
        print(f"batched B={B}: lanes {list(lanes)} vs the single path over {n_chk} frames: decisions identical; "
              f"{fmt(errs)}; d loss / d rad max rel " + ", ".join(f"{n} frames {v:.2e}" for n, v in gerr.items()
                                                                  if n <= n_chk))
        if single_walls:
            single_rate = N_FRAMES / np.mean(single_walls)
            print(f"batched B={B}: single path fwd+bwd in this run {single_rate:.2f} steps/s (lanes {list(lanes)}: "
                  + ", ".join(f"{w:.3f}" for w in single_walls) + f" s); the batch {rate / single_rate:.1f}x that "
                  f"in lane-steps/s")
        print(f"batched B={B}, 20 profiled frames fwd+bwd (device activity traced alone): wall {pwall:.1f} ms, "
              f"device busy {busy:.1f} ms ({100 * busy / pwall:.1f}%, idle {100 - 100 * busy / pwall:.1f}%); top kernels (ms): "
              + "; ".join(f"{k[:48]} {v:.2f}" for k, v in top) + f"; {len(kern)} distinct kernels")
        if B == SWEEP_B[-1]:
            regions, total = batched_regions(twenty())
            print(f"batched B={B}, 20 frames fwd+bwd by region (host wall, synchronized at each region's ends): "
                  f"{total:.3f} s; " + "; ".join(f"{k} {v:.3f} s ({100 * v / total:.1f}%)"
                                               for k, v in regions.items()))
            part("regions")
        print(f"batched B={B}: phase wall by part (s): " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
        rows[B] = dict(launches=launches, rate=rate, fwd_rate=fwd_rate, stages=dict(st), reads=dict(reads))
    return rows


def batched_regions(fn):
    """({region: seconds}, total seconds) of fn() (a batched rollout and its
    backward), the batched path's stages wrapped with a device
    synchronization at each end: the probe's dynamics (K1 and its
    assembly), search (K3) and filter, the replay's dynamics, contact
    recompute and TOC block, the per-lane selects, the backward, and the
    rest of the forward."""
    import torch
    from diffsdfsim_torch.physics import batched

    names = ("probe_dynamics_lanes", "search_contacts_raw", "finish_contacts_lanes", "replay_dynamics_lanes",
             "find_contacts_lanes", "_toc_recompute", "_select_lanes")
    spent = dict.fromkeys(names + ("backward", "rest of the forward"), 0.0)
    saved = {name: getattr(batched, name) for name in names}
    depth = [0]

    def timed(name, f):
        def g(*a, **k):
            if depth[0]:
                return f(*a, **k)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                depth[0] -= 1
        return g

    grad = torch.autograd.grad

    def backward(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grad(*a, **k)
        torch.cuda.synchronize()
        spent["backward"] += time.perf_counter() - t0
        return out

    for name in names:
        setattr(batched, name, timed(name, saved[name]))
    torch.autograd.grad = backward
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name in names:
            setattr(batched, name, saved[name])
        torch.autograd.grad = grad
    spent["rest of the forward"] = total - sum(spent.values())
    return spent, total


# ---------------------------------------------------------------- phase 6


def reset_counts():
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.ops.grid_cuda import grid_interp, grid_query_kernel, grid_query_lanes_kernel
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric, pdipm_fric

    for k in (pdipm_fric, fw_search_pair, kkt_grad_fric, igr_mlp, grid_interp, grid_query_kernel,
              grid_query_lanes_kernel):
        k.launches = 0


def read_counts():
    from diffsdfsim_torch.parallel import launch_counts

    return launch_counts()


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


def busy_share(fn, cpu=True):
    """(wall ms, device busy ms, {kernel: ms}) of fn() under torch.profiler;
    ``cpu=False`` traces the device's activity alone. The device's events
    are summed from the profiler's raw kineto events: building its event
    tree (which ``acc_events`` or ``key_averages()`` do) took 150 s on the
    H100's host after one 19 s iteration of the 50-seed sphere sweep, the
    raw events 31 s."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    raw = getattr(prof.profiler, "kineto_results", None)
    check(raw is not None, "busy_share: this torch.profiler exposes no raw kineto events")
    kern = {}
    for ev in raw.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA and ev.duration_ns() > 0:
            kern[ev.name()] = kern.get(ev.name(), 0.0) + ev.duration_ns() / 1e6
    return wall * 1e3, sum(kern.values()), kern


def compare_shape_traj(traj, ref, label, atol):
    """Identical discrete decisions, every pose and velocity within atol."""
    tr = {k: v.detach().cpu().numpy() for k, v in traj._asdict().items()}
    for key in ("valid", "n_halvings", "bisect_failed", "truncated"):
        check(np.array_equal(tr[key], ref[f"traj_{key}"]), f"{label}: {key} differs")
    errs = {key: float(np.abs(tr[key] - ref[f"traj_{key}"]).max()) for key in ("pos", "quat", "v")}
    check(max(errs.values()) <= atol, f"{label}: differs from the JAX golden by {errs} (atol {atol})")
    return tr, errs


def counted_grid_run(fn):
    """(fn(), launches, grid queries, gradient volumes built, seconds,
    device reads) of fn() run with the launch counts set to 0 and every
    ``GridShape`` query and gradient volume counted."""
    from diffsdfsim_torch.ops import grid_cuda, sdf

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
        out, wall, syncs = synced(fn)
        launches = read_counts()
    finally:
        grid_cuda.grid_query, sdf.grid_grad_volume = query, volume
    return out, launches, queries[0], volumes[0], wall, syncs


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
    (ball, traj), launches, queries, volumes, wall, syncs = counted_grid_run(lambda: run(int(golden["frames"])))
    check(launches["grid_query"] > 0 and launches["fw_search"] == 0 and launches["grid_interp"] == 0,
          f"the grid path must launch K5's query and not K3 or the sampler: {launches}")
    check(launches["grid_query"] == queries and volumes == 0,
          f"the grid path made {launches['grid_query']} K5 launches for {queries} grid queries and built "
          f"{volumes} gradient volumes")
    check(float((ball.verts.cpu() - torch.tensor(golden["verts"])).abs().max()) <= 1e-12, "grid body verts differ")
    _, errs = compare_shape_traj(traj, golden, "grid path vs JAX golden", ATOL_SHAPE_PATH)
    n_sub = int(traj.valid.sum())
    pwall, busy, kern = busy_share(lambda: run(int(golden["frames"])))
    print(f"grid path: {int(golden['frames'])} frames on a {int(golden['res'])}^3 grid in {wall:.3f} s wall "
          f"(make_body and make_world included), {n_sub} substeps, {syncs} device reads; {queries} grid queries, "
          f"{volumes} gradient volumes; launches {launches}; "
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


# ---------------------------------------------------------------- phase float32


# float32, the dtype the JAX package runs on its accelerator, held against
# the JAX package's own float32 runs (tests/golden/gen_torch_f32_golden.py,
# ``<case>_<mode>_f32.npz``): "pallas", its PDIPM, KKT and Frank-Wolfe
# kernels (interpret mode; what it computes on its accelerator), and "xla",
# its plain path (off it). The card runs K1 and K3 as the Pallas kernels
# do (K1 without the XLA path's float32 d-clip and ridge; K2 in float64
# for float32 inputs), so its runs are held to "pallas"; the CPU port's
# plain float32 path copies "xla" (tests/test_torch_f32.py).
F32_GOLDEN = os.path.join(ROOT, "tests", "golden", "{}_{}_f32.npz")
F32_GRAD_FRAMES = (12, 20, 27)
F32_SWEEP_B, F32_SWEEP_FRAMES, F32_SWEEP_LANES = 16, 30, (0, 15)
# How a float32 run is held against a reference over its frames: identical
# discrete decisions, the sphere's height within ATOL32_Y (~170 ulps of 1
# m) and its vertical velocity within ATOL32_VY (~210 ulps of 4 m/s), every
# component within ATOL_ALL (the touchdown tie of ROADMAP queue 3 item 1
# decides the tangential state, in float32 from the first touchdown: the
# JAX package's two float32 paths part by 1e-3 there, its 64^3 grid ball by
# 1.9e-2 between float32 and float64). Against the CPU port and the "xla"
# golden only up to the frame where the two JAX references part by more
# than these bounds: the resting sphere's contact is decided there by the
# XLA path's float32 d-clip and ridge, which the card's K1 does not have.
ATOL32_Y, ATOL32_VY = 2e-5, 1e-4
# d loss / d rad against the "pallas" golden, relative: float32's epsilon
# is 1.19e-7 (an H100 read <= 2.3e-7 at 12, 20 and 27 frames; the "xla"
# path is 5.9e-3, 4.7e-2 and 2.7e-3 from it)
RTOL32_GRAD = 1e-5
# The full-width latent drop: its float32 rounding spread, witnessed by the
# CPU port against its op-for-op "xla" golden (height 2.1e-5, vertical
# velocity 3.0e-4, the decoder's sums in another order), bounds it against
# "pallas": height ATOL32_LATENT_Y, vertical velocity ATOL32_LATENT_VY
ATOL32_LATENT_Y, ATOL32_LATENT_VY = 1e-4, 1e-3
# The latent fit's first Adam step against "pallas": the loss within
# RTOL32_FIT_LOSS relative (an H100 read 3.5e-5; the "xla" golden is 9e-4
# from "pallas"), d loss / d latent within RTOL32_FIT_GRAD relative to its
# largest component: the float32 gradient of this fit is decided by
# rounding to a few per cent (the JAX package's two float32 paths are 3.6e-2
# apart, and 4.2e-2 and 5.9e-2 from the float64 gradient at the same
# inputs; an H100 read 3.9e-2 from "pallas", 1.7e-2 from float64), so it is
# also held no farther from the float64 gradient at the same inputs than
# the JAX package's float32 gradients are; the latent after the step
# (lr times the gradient's sign) within ATOL32_FIT_Z
RTOL32_FIT_LOSS, RTOL32_FIT_GRAD, ATOL32_FIT_Z = 1e-4, 5e-2, 1e-7


def f32_golden(case, mode):
    return dict(np.load(F32_GOLDEN.format(case, mode)))


def decision_parting(tr, ref, n):
    """The first of n frames where two trajectories' discrete decisions
    differ (n: none)."""
    bad = np.zeros(n, dtype=bool)
    for key in DECISIONS:
        bad |= (np.asarray(tr[key])[:n] != np.asarray(ref[key])[:n]).reshape(n, -1).any(axis=1)
    over = np.nonzero(bad)[0]
    return int(over[0]) if len(over) else n


def f32_errors(tr, ref, n):
    """The largest differences of a trajectory from a reference over the
    first n frames: every pose and velocity component, and the dropped body's
    (body 1's) height and vertical velocity (numpy dicts, any lane layout
    with bodies second to last)."""
    d = lambda key: np.abs(np.asarray(tr[key])[:n].astype(np.float64) - np.asarray(ref[key])[:n])  # noqa: E731
    errs = {key: float(d(key).max()) if n else 0.0 for key in ("pos", "quat", "v")}
    errs["pos_y"] = float(d("pos")[..., 1, 1].max()) if n else 0.0
    errs["v_y"] = float(d("v")[..., 1, 4].max()) if n else 0.0
    return errs


def reference_parting(a, b):
    """The first frame where two float32 references part beyond the bounds
    a run is held to (decisions, height, vertical velocity)."""
    n = len(a["pos"])
    for i in range(decision_parting(a, b, n)):
        e = f32_errors({k: v[i:] for k, v in a.items()}, {k: v[i:] for k, v in b.items()}, 1)
        if e["pos_y"] > ATOL32_Y or e["v_y"] > ATOL32_VY:
            return i
    return decision_parting(a, b, n)


def hold_f32(tr, ref, label, upto=None, atol_y=ATOL32_Y, atol_vy=ATOL32_VY):
    """Hold a float32 trajectory against a reference over its first
    ``upto`` frames (None: all); returns (the first decision parting, the
    errors held, the errors over the whole run)."""
    n = len(tr["pos"])
    upto = n if upto is None else min(upto, n)
    part = decision_parting(tr, ref, n)
    check(part >= upto, f"{label}: the decisions part at frame {part}, within the {upto} frames held")
    held, whole = f32_errors(tr, ref, upto), f32_errors(tr, ref, n)
    check(held["pos_y"] <= atol_y and held["v_y"] <= atol_vy,
          f"{label}: over {upto} frames the height differs by {held['pos_y']} (atol {atol_y}), the vertical "
          f"velocity by {held['v_y']} (atol {atol_vy})")
    check(max(held[k] for k in ("pos", "quat", "v")) <= ATOL_ALL, f"{label}: over {upto} frames: {held}")
    return part, held, whole


def fmt_errs(e):
    return ", ".join(f"{k} {v:.2e}" for k, v in e.items())


def f32_bench_forward():
    """The bench's 100-frame rollout in float32 through K1 and K3 against
    the "pallas" golden, the "xla" golden and the CPU port's plain float32
    rollout; its wall beside the float64 rollout's."""
    import torch

    spec, state, rollout = run_rollout("cuda", torch.float32)
    rollout(spec, state, 5)  # warm-up of the float32 path
    walls = {}
    for dtype in (torch.float64, torch.float32):
        spec, state, _ = run_rollout("cuda", dtype)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        _, traj = rollout(spec, state, N_FRAMES)
        torch.cuda.synchronize()
        walls[dtype] = time.perf_counter() - t0
    launches = read_counts()
    check(launches["pdipm_fwd"] > 0 and launches["fw_search"] > 0 and launches["kkt_bwd"] == 0,
          f"the float32 forward must launch K1 and K3 and not K2: {launches}")
    check(traj.pos.dtype == torch.float32 and traj.v.dtype == torch.float32, f"float32 rollout in {traj.pos.dtype}")
    tr = {k: v.cpu().numpy() for k, v in traj._asdict().items()}
    check(all(np.isfinite(tr[k]).all() for k in ("pos", "quat", "v")), "float32 rollout: non-finite state")
    pallas, xla = f32_golden("bench", "pallas"), f32_golden("bench", "xla")
    witness = reference_parting(pallas, xla)
    spec_c, state_c, _ = run_rollout("cpu", torch.float32)
    t0 = time.perf_counter()
    _, traj_c = rollout(spec_c, state_c, N_FRAMES)
    cpu_wall = time.perf_counter() - t0
    trc = {k: v.numpy() for k, v in traj_c._asdict().items()}
    res = {"the pallas golden": hold_f32(tr, pallas, "float32 bench vs the pallas golden"),
           "the CPU port": hold_f32(tr, trc, "float32 bench vs the CPU port", witness),
           "the xla golden": hold_f32(tr, xla, "float32 bench vs the xla golden", witness)}
    n_sub = int(tr["valid"].sum())
    print(f"float32 bench: {N_FRAMES} frames in {walls[torch.float32]:.3f} s wall (float64 in this process "
          f"{walls[torch.float64]:.3f} s), {n_sub} substeps (pallas golden {int(pallas['valid'].sum())}, xla golden "
          f"{int(xla['valid'].sum())}, float64 golden {int(np.load(GOLDEN)['valid'].sum())}), host syncs "
          f"{spec.host_syncs}; launches {launches}; the JAX package's pallas and xla paths part at frame "
          f"{witness} (decisions at frame {decision_parting(pallas, xla, N_FRAMES)}); the CPU rollout "
          f"{cpu_wall:.2f} s on the host")
    for name, (part, held, whole) in res.items():
        print(f"float32 bench vs {name}: held over {N_FRAMES if name.endswith('pallas golden') else witness} "
              f"frames: {fmt_errs(held)}; decisions part at frame {part}; whole run {fmt_errs(whole)}")
    return launches


def f32_bench_gradients():
    """d loss / d rad of the bench loss over 12, 20 and 27 frames in
    float32 through K1, K3 and K2 (one taped 27-frame rollout) against the
    "pallas" golden; its distance from the "xla" golden and from the
    float64 gradient of the card."""
    import torch

    grads, walls, launches = {}, {}, None
    for dtype in (torch.float64, torch.float32):  # warm-up of both taped paths
        traj, rad, _ = bench_traj("cuda", 2, dtype)
        torch.autograd.grad(prefix_loss(traj, 2), rad)
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        traj, rad, _ = bench_traj("cuda", max(F32_GRAD_FRAMES), dtype)
        grads[dtype] = {n: float(torch.autograd.grad(prefix_loss(traj, n), rad, retain_graph=True)[0])
                        for n in F32_GRAD_FRAMES}
        torch.cuda.synchronize()
        walls[dtype] = time.perf_counter() - t0
        launches = read_counts()
    check(all(launches[k] > 0 for k in ("pdipm_fwd", "fw_search", "kkt_bwd")),
          f"the float32 gradient must launch K1, K3 and K2: {launches}")
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    for n in F32_GRAD_FRAMES:
        g = grads[torch.float32][n]
        gp, gx = (float(f32_golden(f"grad_{n}", m)["grad"]) for m in ("pallas", "xla"))
        e_p, e_x, e_64 = rel(g, gp), rel(g, gx), rel(g, grads[torch.float64][n])
        print(f"float32 gradient, {n} frames: d loss / d rad {g!r}; pallas golden {gp!r} (rel {e_p:.2e}, tol "
              f"{RTOL32_GRAD:g}); xla golden {gx!r} (rel {e_x:.2e}); float64 on the card "
              f"{grads[torch.float64][n]!r} (rel {e_64:.2e})")
        check(np.isfinite(g) and e_p <= RTOL32_GRAD, f"float32 {n}-frame gradient {g} vs pallas {gp}: rel {e_p}")
        check(e_p < rel(gx, gp), f"float32 {n}-frame gradient {g} is no closer to the pallas golden {gp} than the "
              f"xla golden {gx} is")
    print(f"float32 gradient: {max(F32_GRAD_FRAMES)} frames fwd+bwd with three prefix losses in "
          f"{walls[torch.float32]:.3f} s wall (float64 {walls[torch.float64]:.3f} s); launches {launches}")
    return launches


def f32_sweep():
    """The seed sweep in float32: B = 16 radii, 30 frames, fwd+bwd through
    K1, K3 and K2, against the "pallas" golden of the JAX package's
    ``rollout_batched`` lane by lane, and lanes 0 and 15 against the single
    float32 path on the card."""
    import torch
    from diffsdfsim_torch.physics import make_world_batched, rollout, rollout_batched

    B, n = F32_SWEEP_B, F32_SWEEP_FRAMES
    golden = f32_golden(f"batched_{B}", "pallas")
    rads = golden["rads"]
    r = torch.tensor(rads, device="cuda", requires_grad=True)
    spec, bodies_b, state_b = make_world_batched(sweep_world, r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, traj = rollout_batched(spec, bodies_b, state_b, n)
    losses = lane_losses(traj, n)
    (grad,) = torch.autograd.grad(losses.sum(), r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = spec.stages
    check(launches["pdipm_fwd"] == st["lcp"] > 0 and launches["kkt_bwd"] == st["replay_lcp"] > 0
          and launches["fw_search"] == len(spec.directed_pairs) * (st["shallow"] + st["deep"]),
          f"float32 sweep: launches {launches} for stages {dict(st)}")
    tr = {k: v.detach().cpu().numpy() for k, v in traj._asdict().items()}
    gtr = {k: golden[k] for k in tr}
    losses, grad = losses.detach().cpu().numpy(), grad.cpu().numpy()
    e_loss, e_grad = rel_err(losses, golden["loss"]), np.abs(grad / golden["grad"] - 1)
    held = [hold_f32(lane_traj(tr, i), lane_traj(gtr, i), f"float32 sweep lane {i} vs the pallas golden")[1]
            for i in range(B)]
    print(f"float32 sweep B={B}: {n} frames fwd+bwd in {wall:.3f} s wall ({B * n / wall:.2f} lane-steps/s), "
          f"{st['substep']} whole-batch substeps, launches {launches}; vs the pallas golden: decisions identical "
          f"in every lane, height {max(e['pos_y'] for e in held):.2e}, losses rel {e_loss:.2e}, d loss / d rad rel "
          f"max {e_grad.max():.2e} (lanes {np.round(e_grad, 6).tolist()})")
    check(e_loss <= RTOL32_GRAD and e_grad.max() <= RTOL32_GRAD,
          f"float32 sweep: losses rel {e_loss}, d loss / d rad rel {e_grad.max()} from the pallas golden")
    errs, gerr = {}, 0.0
    for i in F32_SWEEP_LANES:
        rs = torch.tensor(rads[i], device="cuda", requires_grad=True)
        s1, st1 = sweep_world(rs)
        _, t1 = rollout(s1, st1, n)
        (g1,) = torch.autograd.grad(prefix_loss(t1, n), rs)
        ref = {k: v.detach().cpu().numpy() for k, v in t1._asdict().items()}
        _, held, _ = hold_f32(lane_traj(tr, i), ref, f"float32 sweep lane {i} vs the single path")
        for k, v in held.items():
            errs[k] = max(errs.get(k, 0.0), v)
        gerr = max(gerr, rel_err(grad[i], float(g1)))
    print(f"float32 sweep B={B}: lanes {list(F32_SWEEP_LANES)} vs the single float32 path: decisions identical; "
          f"{fmt_errs(errs)}; d loss / d rad rel {gerr:.2e}")
    check(gerr <= RTOL32_GRAD, f"float32 sweep lanes: d loss / d rad {gerr} from the single path")
    return launches


def f32_grid():
    """The 64^3 grid drop in float32 through K5 (one launch per grid query,
    counted) and K1, against the "xla" and "pallas" goldens."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import (BoxShape, Gravity3D, GridShape, TotalConstraint3D, make_body,
                                          make_world, rollout)

    xla, pallas = f32_golden("grid64", "xla"), f32_golden("grid64", "pallas")
    cfg = SimConfig(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                    max_bisect=6, tol=F32_TOL)
    f32 = torch.float32
    grid = torch.tensor(sphere_grid(int(xla["res"])), dtype=f32, device="cuda")

    def run(n_frames):
        floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3, device="cuda",
                          dtype=f32)
        ball = make_body(GridShape(grid=grid, scale_=torch.tensor(0.75)), fric_coeff=0.25, template="ico",
                         subdiv=2, project_iters=16, device="cuda", dtype=f32)
        spec, state = make_world([floor, ball], [[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, 1.0, 0]],
                                 np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                                 forces=((), (Gravity3D(10.0),)), cfg=cfg, device="cuda")
        return ball, rollout(spec, state, n_frames)[1]

    run(2)  # warm-up
    (ball, traj), launches, queries, volumes, wall, _ = counted_grid_run(lambda: run(int(xla["frames"])))
    check(launches["grid_query"] > 0 and launches["grid_query"] == queries and volumes == 0
          and launches["fw_search"] == 0 and launches["pdipm_fwd"] > 0,
          f"float32 grid drop: launches {launches} for {queries} grid queries, {volumes} gradient volumes")
    tr = {k: v.cpu().numpy() for k, v in traj._asdict().items()}
    e_verts = float(np.abs(ball.verts.cpu().numpy() - xla["verts"]).max())
    res = {name: hold_f32(tr, ref, f"float32 grid drop vs the {name} golden")
           for name, ref in (("xla", xla), ("pallas", pallas))}
    # the witness of the touchdown tie: the JAX package's float32 and
    # float64 balls part at the touchdown
    g64 = {k[len("traj_"):]: v for k, v in np.load(GRID_GOLDEN).items() if k.startswith("traj_")}
    tie = f32_errors(xla, g64, len(tr["pos"]))
    print(f"float32 grid drop: {int(xla['frames'])} frames on a 64^3 grid in {wall:.3f} s wall, "
          f"{int(tr['valid'].sum())} substeps, {queries} grid queries, launches {launches}; verts vs JAX "
          f"{e_verts:.2e}; " + "; ".join(f"vs the {k} golden: {fmt_errs(held)}" for k, (_, held, _) in res.items())
          + f"; the JAX package's own float32 vs float64 runs: {fmt_errs(tie)}")
    check(e_verts <= ATOL32_Y, f"float32 grid drop: verts differ from JAX's by {e_verts}")
    return launches


def f32_latent():
    """optim_shapespace at the decoder's full width in float32: the
    36-frame drop at the target latent through K4 and K1, then the fit's
    first Adam step through K4, K1 and K2, against the "xla" and "pallas"
    goldens."""
    import torch
    from diffsdfsim_torch.experiments import optim_shapespace as oss

    xla, pallas = f32_golden("latent128", "xla"), f32_golden("latent128", "pallas")
    # the golden's float64 draws of the weights, rounded to float32
    net = igr_net(torch.float64, tuple(xla["dims"].tolist()), tuple(xla["skip_in"].tolist())).to(torch.float32)
    c = dict(oss.DEFAULTS, run_time=int(xla["frames"]) / 30.0)
    cfg = oss.build_cfg(c, torch.float32)
    target, start, quat0 = (torch.tensor(xla[k], device="cuda") for k in ("target_latent", "start_latent", "quat0"))
    reset_counts()
    (_, traj), wall, syncs = synced(lambda: oss.simulate(target, quat0, net, c, cfg, device="cuda"))
    launches = read_counts()
    check(launches["igr_mlp"] > 0 and launches["pdipm_fwd"] > 0 and launches["fw_search"] == 0,
          f"the float32 latent drop must launch K4 and K1 and not K3: {launches}")
    tr = {k: v.cpu().numpy() for k, v in traj._asdict().items()}
    traj_ref = lambda g: {k: g[f"traj_{k}"] for k in DECISIONS + ("pos", "quat", "v")}  # noqa: E731
    part, held, _ = hold_f32(tr, traj_ref(pallas), "float32 latent drop vs the pallas golden",
                             atol_y=ATOL32_LATENT_Y, atol_vy=ATOL32_LATENT_VY)
    e_xla = f32_errors(tr, traj_ref(xla), len(tr["pos"]))
    reset_counts()
    out, fit_wall, _ = synced(lambda: oss.fit(net, target, start, quat0, c, cfg, device="cuda", max_iter=1))
    fit_launches = read_counts()
    check(all(fit_launches[k] > 0 for k in ("igr_mlp", "pdipm_fwd", "kkt_bwd")) and fit_launches["fw_search"] == 0,
          f"the float32 latent fit must launch K4, K1 and K2 and not K3: {fit_launches}")
    loss, grad = float(out["loss_hist"][0]), out["grad_hist"][0].cpu().numpy()
    lat = out["final_latent"].cpu().numpy()
    fit = {name: (rel_err(loss, ref["loss_0"]), rel_err(grad, ref["grad_0"]),
                  float(np.abs(lat - ref["latent_1"]).max())) for name, ref in (("xla", xla), ("pallas", pallas))}
    print(f"float32 latent drop: {len(tr['pos'])} frames in {wall:.3f} s wall, {int(tr['valid'].sum())} substeps, "
          f"{syncs} device reads, launches {launches}; vs the pallas golden: {fmt_errs(held)} (decisions part at "
          f"frame {part} of {len(tr['pos'])}); vs the xla golden: {fmt_errs(e_xla)}")
    print(f"float32 latent fit, first Adam step in {fit_wall:.3f} s wall, launches {fit_launches}: loss {loss!r}, "
          f"d loss / d latent {grad.tolist()}, latent {lat.tolist()}; " + "; ".join(
              f"vs the {k} golden: loss rel {a:.2e}, gradient rel {b:.2e}, latent {z:.2e}"
              for k, (a, b, z) in fit.items()))
    # the witness of the gradient's float32 spread: the float64 gradient at
    # the same inputs (the float32 weights and draws, tol 1e-5)
    net64 = igr_net(torch.float64, tuple(xla["dims"].tolist()), tuple(xla["skip_in"].tolist())).to(
        torch.float32).to(torch.float64)
    out64 = oss.fit(net64, target.double(), start.double(), quat0.double(), c, cfg, device="cuda", max_iter=1)
    g64 = out64["grad_hist"][0].cpu().numpy()
    spread = {name: rel_err(g, g64) for name, g in (("card", grad), ("pallas", pallas["grad_0"]), ("xla", xla["grad_0"]))}
    print(f"float32 latent fit: the float64 gradient at the same inputs {g64.tolist()}; float32 gradients rel to it: "
          + ", ".join(f"{k} {v:.2e}" for k, v in spread.items()))
    check(fit["pallas"][0] <= RTOL32_FIT_LOSS and fit["pallas"][1] <= RTOL32_FIT_GRAD
          and fit["pallas"][2] <= ATOL32_FIT_Z,
          f"float32 latent fit vs the pallas golden: loss rel {fit['pallas'][0]}, gradient rel {fit['pallas'][1]}, "
          f"latent {fit['pallas'][2]}")
    check(spread["card"] <= max(spread["pallas"], spread["xla"]),
          f"float32 latent fit: the gradient is farther from the float64 one at the same inputs ({spread['card']}) "
          f"than the JAX package's float32 gradients are ({spread['pallas']}, {spread['xla']})")
    return launches, fit_launches


def phase_float32():
    """float32, the JAX package's accelerator dtype, through the entry
    points on the card against the JAX package's own float32 runs: the
    bench forward (K1, K3) and its gradient at 12, 20 and 27 frames (K1,
    K3, K2) against the "pallas" golden, the seed sweep at B = 16 (K1, K3,
    K2), the 64^3 grid drop (K5, K1) and the full-width latent drop and
    first Adam step (K4, K1, K2). Returns each kernel's launches."""
    fwd = f32_bench_forward()
    grad = f32_bench_gradients()
    sweep = f32_sweep()
    grid = f32_grid()
    latent, fit = f32_latent()
    return dict(bench=fwd, gradient=grad, sweep=sweep, grid=grid, latent=latent, fit=fit)


# ---------------------------------------------------------------- phases 8-10


# the fitting experiments' seed sweeps at the sizes their users run
SPHERE_B, SYSID_B, SHAPE_B = 50, 16, 8
SYSID_PARAMS = ("mass", "force", "friction")
# the shape-space lanes held against the single path (each a 36-frame drop
# and a taped one on the single path, ~17 s on an H100's host; lane 2's
# target drop parts from the single path's at a touchdown tie)
SHAPE_LANES = (1, 2, 7)
DEVICE = "cuda"  # the device the sweep phases run on
SPHERE_GOLDEN = os.path.join(ROOT, "tests", "golden", "full_sphere_f64.npz")
SYSID_GOLDEN = os.path.join(ROOT, "tests", "golden", "full_sysid_{}_f64.npz")
# How a sweep's lanes are held. Against the single path on the card at the
# same draws: identical discrete decisions, each lane's first loss and
# gradient within RTOL_LANE relative. Against the JAX golden (one lane per
# experiment, carrying the golden's draws): identical decisions, the loss
# and gradient within RTOL_EXP_GOLDEN relative.
RTOL_LANE = 1e-6
RTOL_EXP_GOLDEN = 1e-6
# The shape-space lanes against the single path: looser than 1e-6 because
# of the touchdown tie (ROADMAP queue 3, item 1): a lane's target drop may
# part from the single path's after a touchdown (on an H100 lane 2's at
# frame 31, by 7.7e-4 in its poses, its loss 2.5e-4 relative from the
# single path's, the other six lanes within 4e-8)
RTOL_SHAPE_LANE = 1e-3
# K2 on the sysid friction sweep's replays: the friction-cone rows of dlam
# (and with them dF and d loss / d mu) against the plain KKT solve. Where a
# cone is tight (its d ~3e8, sticking friction) the reduced solve recovers
# them as d times a difference of its outputs, which it has to ~1e-12
# absolute: before the kernel refined its solve they read 4.0e-4 on an H100,
# d loss / d mu 6.1e-4 per replay; with its two refinement steps 6.0e-10 and
# 1.03e-9, the plain version's own error at these systems (on the CPU, on the
# single path's replays, the kernel's algorithm reads 1e-13 from the exact
# solution, the plain version 1.4e-12; ROADMAP queue 3, item 13), so K2 is
# also held against the exact solution (RTOL_K2_REPLAY_EXACT)
RTOL_K2_CONE = 1e-8
# K2 on taped replays against the KKT systems' exact solution (kkt_exact):
# their condition numbers reach 1.6e16 (optim_pointcloud's touchdowns, d up
# to 7e8), where the kernel's algorithm on the CPU (kkt_grad_reduced) reads
# 4.1e-12 from it and the plain version 9.9e-9; so there K2 is held against
# the plain version within RTOL_K2_PC_PLAIN only
RTOL_K2_REPLAY_EXACT = 1e-10
RTOL_K2_PC_PLAIN = 1e-6
# Two runs of one sysid world, held up to the substep where their accepted
# contacts first differ (``tie_witness``): their poses within ATOL_TIE_FREE
# (read at most 2.8e-17 on an H100) and, at that substep, the deepest
# penetration their searches found within ATOL_TIE_PEN metres (read at most
# 3.4e-10: the cube's face touches the floor flat, every point of it at one
# depth to ~1e-9, and the runs keep other points of it; another contact, or a
# lane that read another lane's geometry, would be off by far more)
ATOL_TIE_FREE, ATOL_TIE_PEN = 1e-9, 1e-8
DECISIONS = ("valid", "n_halvings", "bisect_failed", "truncated")


def rel_err(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


class Recorder:
    """Keeps each ``rollout_batched`` call's (spec, lanes-first trajectory,
    lane bodies) made through ``module.rollout_batched`` while active."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __enter__(self):
        from diffsdfsim_torch.physics import trajectory_lanes_first

        orig = self.orig = self.module.rollout_batched

        def rec(spec, *a, **k):
            out = orig(spec, *a, **k)
            self.calls.append((spec, trajectory_lanes_first(out[1]), a[0]))
            return out

        self.module.rollout_batched = rec
        return self

    def __exit__(self, *exc):
        self.module.rollout_batched = self.orig


def check_sweep(tag, launches, spec, lanes, taped, k3=True):
    """One batched rollout's launches and host reads, its lanes' world
    construction included: one K1 launch per probe stage that solves the
    LCP, one K3 launch per directed pair per stage and per lane's
    construction-time search (``make_world`` searches each lane's initial
    contacts; ``k3``: the pairs are analytic, a latent pair takes the plain
    search and no K3), one K2 launch per taped LCP replay, one host read
    per whole-batch decision."""
    st, rd = spec.stages, spec.host_reads
    n_st = st["shallow"] + st["deep"]
    n_pairs = len(spec.directed_pairs)
    check(launches["pdipm_fwd"] == st["lcp"] > 0, f"{tag}: {launches['pdipm_fwd']} K1 launches for {st['lcp']} "
          f"probe stages that solve the LCP")
    check(launches["fw_search"] == (n_pairs * (n_st + lanes) if k3 else 0), f"{tag}: {launches['fw_search']} K3 "
          f"launches for {n_st} probe stages and {lanes} lanes' construction of {n_pairs} directed pairs")
    check(launches["kkt_bwd"] == (st["replay_lcp"] if taped else 0) and (st["replay_lcp"] > 0) == taped,
          f"{tag}: {launches['kkt_bwd']} K2 launches for {st['replay_lcp']} taped LCP replays")
    check(rd["contact"] == rd["deep"] == st["shallow"] == st["substep"] == rd["recompute"],
          f"{tag}: host reads {dict(rd)} for stages {dict(st)}")
    check(sum(rd.values()) == spec.host_syncs, f"{tag}: {spec.host_syncs} host reads, {dict(rd)} by kind")
    return (f"{st['substep']} whole-batch substeps, stages shallow {st['shallow']} deep {st['deep']} "
            f"(LCP {st['lcp']}, taped replays {st['replay_lcp']}), host reads {dict(sorted(rd.items()))}, "
            f"launches {launches}")


def lane_decisions(traj, i):
    """Lane i's discrete decisions of a lanes-first trajectory, as numpy."""
    return {k: getattr(traj, k)[i].cpu().numpy() for k in DECISIONS}


def first_parting(a, b, atol=1e-7):
    """The first frame where two trajectories' poses part by more than atol
    (None: never), and their largest difference, over their common frames."""
    n = min(len(a), len(b))
    d = np.abs(np.asarray(a)[:n] - np.asarray(b)[:n]).reshape(n, -1).max(axis=-1)
    over = np.nonzero(d > atol)[0]
    return (int(over[0]) if len(over) else None), float(d.max())


def timed_sweep_steps(vg, n_steps, profile_last=True):
    """``vg`` wrapped for ``fitting.descend``: each call's wall, launches
    and (for the last call, ``profile_last``) the device's busy share."""
    import torch

    walls, counts, busy = [], [], {}

    def wrapped(x):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile_last and len(walls) == n_steps - 1:
            out = []
            pwall, pbusy, kern = busy_share(lambda: out.append(vg(x)), cpu=False)
            busy.update(wall_ms=pwall, busy_ms=pbusy, top=sorted(kern.items(), key=lambda kv: -kv[1])[:5])
            out = out[0]
        else:
            out = vg(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(read_counts())
        return out

    return wrapped, walls, counts, busy


def phase_sphere_sweep():
    """optim_sphere's seed sweep at the reference run's size: 50 seeds
    (generate_sphere.sh's count), 45 frames (run_time 1.5), the sphere at
    subdiv 2, fric_dirs 8, max_bisect 12, float64, in the room of a floor and
    a wall: the targets as one batched forward, then 2 GD iterations of
    ``run_sweep_hostloop``'s batched-native sweep (K1, K3 on 4 directed
    pairs, K2). Lane 0 carries the JAX golden's draws
    (tests/golden/full_sphere_f64.npz); the lanes of the smallest and the
    largest start radius are held against the single path."""
    import torch
    from diffsdfsim_torch.experiments import fitting
    from diffsdfsim_torch.experiments import optim_sphere as osp

    golden = dict(np.load(SPHERE_GOLDEN))
    c = dict(osp.DEFAULTS, n_par=SPHERE_B)
    cfg = osp.build_cfg(c)
    targets, starts = osp.draws(c, DEVICE)
    targets[0], starts[0] = float(golden["target"]), float(golden["start"])
    n_fr = osp.n_frames(c, cfg)
    target_trajs, losses = osp.make_loss_batched(c, cfg, DEVICE)

    with Recorder(osp) as rec:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tgt = target_trajs(targets)
        torch.cuda.synchronize()
        fwd_wall = time.perf_counter() - t0
        fwd_line = check_sweep("sphere sweep targets", read_counts(), rec.calls[0][0], SPHERE_B, taped=False)
        n_steps = 2
        vg, walls, counts, busy = timed_sweep_steps(osp._value_and_grad(losses, tgt), n_steps)
        out = osp._descend(vg, targets, starts, c, n_steps)
        lines = [check_sweep(f"sphere sweep iteration {i}", counts[i], rec.calls[1 + i][0], SPHERE_B, taped=True)
                 for i in range(n_steps)]
    start_traj = rec.calls[1][1]
    loss0, grad0 = out["loss_hist"][0].cpu().numpy(), out["grad_hist"][0].cpu().numpy()
    check(bool(np.isfinite(loss0).all() and np.isfinite(grad0).all()), "sphere sweep: a lane's loss or gradient "
          "is not finite")

    # lane 0 against the JAX golden (its draws)
    tgt_lanes = {k: getattr(tgt, k)[0].cpu().numpy() for k in DECISIONS}
    for key in DECISIONS:
        check(np.array_equal(tgt_lanes[key], golden[f"tgt_{key}"]), f"sphere sweep lane 0: target {key} differs "
              f"from the JAX golden")
        check(np.array_equal(lane_decisions(start_traj, 0)[key], golden[f"start_{key}"]),
              f"sphere sweep lane 0: {key} at the start radius differs from the JAX golden")
    frame, dmax = first_parting(start_traj.pos[0].detach().cpu().numpy(), golden["start_pos"])
    e_loss, e_grad = rel_err(loss0[0], golden["loss"]), rel_err(grad0[0], golden["grad"])
    print(f"sphere sweep lane 0 vs JAX golden: decisions identical; loss {loss0[0]!r} vs {float(golden['loss'])!r} "
          f"rel {e_loss:.2e}, d loss / d rad {grad0[0]!r} vs {float(golden['grad'])!r} rel {e_grad:.2e} "
          f"(tol {RTOL_EXP_GOLDEN:g}); poses part from JAX's (1e-7) at frame {frame}, at most {dmax:.2e}")
    check(e_loss <= RTOL_EXP_GOLDEN and e_grad <= RTOL_EXP_GOLDEN, "sphere sweep lane 0: loss or gradient differs "
          "from the JAX golden")

    # the smallest and the largest start radius against the single path
    s_np = starts.cpu().numpy()
    for i in (int(np.argmin(s_np)), int(np.argmax(s_np))):
        one = osp.fit(targets[i], starts[i], c, cfg, DEVICE, max_iter=1)
        el = rel_err(loss0[i], one["loss_hist"][0].cpu().numpy())
        eg = rel_err(grad0[i], one["grad_hist"][0].cpu().numpy())
        print(f"sphere sweep lane {i} (start radius {s_np[i]:.4f}) vs the single path: loss rel {el:.2e}, "
              f"d loss / d rad rel {eg:.2e} (tol {RTOL_LANE:g})")
        check(el <= RTOL_LANE and eg <= RTOL_LANE, f"sphere sweep lane {i}: differs from the single path")

    errs = np.abs(out["rad_hist"][-1].cpu().numpy() - targets.cpu().numpy())
    lane_steps = SPHERE_B * n_fr
    print(f"sphere sweep B={SPHERE_B}, {n_fr} frames: targets forward {fwd_wall:.3f} s = {lane_steps / fwd_wall:.2f} "
          f"lane-steps/s ({fwd_line}); GD iterations (fwd+bwd) " + ", ".join(f"{w:.3f}" for w in walls)
          + f" s (the second under the profiler) = {lane_steps / walls[0]:.2f} lane-steps/s; iteration 1: {lines[0]}")
    print(f"sphere sweep, iteration 2 profiled (device activity alone): wall {busy['wall_ms']:.1f} ms, device busy "
          f"{busy['busy_ms']:.1f} ms (idle {100 - 100 * busy['busy_ms'] / busy['wall_ms']:.1f}%); top kernels (ms): "
          + "; ".join(f"{k[:40]} {v:.2f}" for k, v in busy["top"]))
    print(f"sphere sweep: radius error after {n_steps} GD steps mean {errs.mean():.4f}, max {errs.max():.4f} "
          f"(start {np.abs(s_np - targets.cpu().numpy()).mean():.4f})")
    return dict(fwd_wall=fwd_wall, walls=walls, counts=counts)


def traj_np(traj):
    return {k: v.detach().cpu().numpy() for k, v in traj._asdict().items()}


def partings(named):
    """'a vs b frame F (max d)' for consecutive pairs of named trajectories
    (numpy dicts): the first frame where their poses part by 1e-7 (None:
    never) and whether their discrete decisions agree."""
    out = []
    names = list(named)
    for x, y in zip(names, names[1:]):
        f, d = first_parting(named[x]["pos"], named[y]["pos"])
        same = all(np.array_equal(named[x][k][: len(named[y][k])], named[y][k][: len(named[x][k])]) for k in DECISIONS)
        out.append(f"{x} vs {y}: part at frame {f} (max {d:.2e}), decisions {'equal' if same else 'differ'}")
    return "; ".join(out)


class ContactLog:
    """While active, keeps every substep's accepted contacts (valid, p1,
    pen, max_pen_all) of the single path (``world.step_dt``) and of
    the batched rollout (``batched.step_dt_batched``, every lane), by frame
    and substep slot, for the rollout begun last (``begin``)."""

    def __init__(self):
        self.runs = {}
        self.cur = None

    def begin(self, name):
        self.cur = self.runs[name] = []

    def __enter__(self):
        from diffsdfsim_torch.physics import batched, world

        self.patched = [(world, "step_frame"), (world, "step_dt"), (batched, "step_frame_batched"),
                        (batched, "step_dt_batched")]
        self.orig = [getattr(m, n) for m, n in self.patched]

        def frame(fn):
            def wrapped(*a, **k):
                if self.cur is not None:
                    self.cur.append([])
                return fn(*a, **k)
            return wrapped

        def substep(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                if self.cur is not None:
                    c = out[0].contacts
                    self.cur[-1].append(tuple(x.detach().clone() for x in (c.valid, c.p1, c.pen, c.max_pen_all)))
                return out
            return wrapped

        for (m, n), fn in zip(self.patched, self.orig):
            setattr(m, n, (frame if "frame" in n else substep)(fn))
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.patched, self.orig):
            setattr(m, n, fn)
        self.cur = None

    def lane(self, name, i=None):
        """The run's contacts as [frame][slot] -> (valid, p1, pen, max_pen_all);
        ``i``: lane i of a batched run."""
        return [[tuple((x if i is None else x[i]).cpu().numpy() for x in c) for c in fr] for fr in self.runs[name]]


def contact_parting(a, b, va, vb, atol=1e-6):
    """The first substep where two runs' accepted contacts differ: a
    substep one run took and the other did not, another count of valid
    contacts, or a point of one farther than ``atol`` from every point of the
    other. a, b: ``ContactLog.lane``; va, vb: the runs' (T, S) valid masks.
    Returns None, or (frame, slot, a's contacts, b's contacts, the largest
    distance from a point to the other set)."""
    for f in range(min(len(a), len(b), len(va), len(vb))):
        for s in range(va.shape[1]):
            if va[f, s] != vb[f, s]:
                return f, s, None, None, float("inf")
            if not va[f, s]:
                continue
            ca, cb = a[f][s], b[f][s]
            pa, pb = ca[1][ca[0]], cb[1][cb[0]]
            if len(pa) != len(pb):
                return f, s, ca, cb, float("inf")
            if len(pa):
                dist = np.linalg.norm(pa[:, None] - pb[None], axis=-1)
                d = max(dist.min(1).max(), dist.min(0).max())
                if d > atol:
                    return f, s, ca, cb, float(d)
    return None


def fmt_contacts(c):
    if c is None:
        return "no substep"
    v = c[0]
    return (f"{int(v.sum())} valid at " + ", ".join(f"({x:+.4f}, {y:+.4f}, {z:+.4f})" for x, y, z in c[1][v])
            + " pens " + ", ".join(f"{p:.6e}" for p in c[2][v]) + f", max_pen_all {float(c[3]):.6e}")


def tie_witness(tag, a, b, logs, va, vb, pa, pb):
    """Holds two runs of one world (a, b: ContactLog run names, each ``(name,
    lane)``) against each other up to their first contact parting: their
    poses (pa, pb: (T, S, nb, 3)) may not part (1e-7) before their accepted
    contacts do, and over the frames before that they agree within
    ATOL_TIE_FREE with identical decisions; where the contacts part, the
    deepest penetration of all candidates agrees within ATOL_TIE_PEN: the
    runs kept other points of the same contact, not another contact. Prints
    the contacts at the parting (the witness of the tie). Returns (contact parting frame or None,
    pose parting frame or None, the line)."""
    ca, cb = logs.lane(*a), logs.lane(*b)
    cp = contact_parting(ca, cb, va, vb)
    fp, dmax = first_parting(pa, pb)
    fc = None if cp is None else cp[0]
    n = len(pa) if fc is None else fc
    d_before = float(np.abs(np.asarray(pa[:n]) - np.asarray(pb[:n])).max()) if n else 0.0
    same = bool(np.array_equal(va[:n], vb[:n]))
    line = (f"{tag}: contacts part at " + ("no substep" if cp is None else f"frame {cp[0]} substep {cp[1]}")
            + f", poses (1e-7) at frame {fp} (max {dmax:.2e}); before frame {n}: poses within {d_before:.2e}, "
            f"decisions {'equal' if same else 'differ'}")
    if cp is not None:
        line += (f"; at the parting (points up to {cp[4]:.3e} m apart) {a[0]}: {fmt_contacts(cp[2])}; "
                 f"{b[0]}: {fmt_contacts(cp[3])}")
    print(line)
    check(fp is None or (fc is not None and fp >= fc), f"{tag}: the poses part (frame {fp}) before the contacts "
          f"(frame {fc})")
    if cp is not None and cp[2] is not None:
        # a tie: the kept points differ, the deepest penetration the
        # search found does not
        d_pen = abs(float(cp[2][3]) - float(cp[3][3]))
        check(d_pen <= ATOL_TIE_PEN, f"{tag}: at the contact parting the deepest penetrations differ by {d_pen:.3e} "
              f"(tol {ATOL_TIE_PEN:g})")
    check(d_before <= ATOL_TIE_FREE and same, f"{tag}: over the {n} frames before the contacts part the poses "
          f"differ by {d_before:.3e} (tol {ATOL_TIE_FREE:g}) or the decisions differ")
    return fc, fp, line


class Calls:
    """While active, keeps the (args, result) of every call of
    ``module.name`` for which ``keep(*args)`` holds."""

    def __init__(self, module, name, keep=lambda *a: True):
        self.module, self.name, self.keep, self.calls = module, name, keep, []

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def wrapped(*a):
            out = orig(*a)
            if self.keep(*a):
                self.calls.append((a, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def check_sysid_k3_calls(calls, cfg):
    """K3 where the friction sweep's path gave it both bodies as lane bodies
    (box against box): every 8th launch's lanes bitwise their own launches,
    and the first 12 launches' max_pen within 1e-6 of the plain search's
    (the per-face anchors tie on the flat face, as in phase_k3)."""
    import torch
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    check(len(calls) > 0, "sysid friction: no K3 launch with two lane bodies")
    bad, err, rs = [], 0.0, sorted({a[2].shape[0] for a, _ in calls})
    for j, (a, out) in enumerate(calls):
        if j % 8 == 0:
            bad += k3_lane_mismatches(*a[:6], cfg, out)
        if j < 12:
            pl = search_pair_raw_plain(*a[:6], cfg)
            fin = torch.isfinite(out.max_pen) & torch.isfinite(pl.max_pen)
            check(bool(torch.equal(torch.isfinite(out.max_pen), torch.isfinite(pl.max_pen))),
                  "sysid friction K3: max_pen finiteness differs from the plain search")
            if bool(fin.any()):
                err = max(err, float((out.max_pen - pl.max_pen)[fin].abs().max()))
    line = (f"sysid friction K3 (both bodies lane bodies, {calls[0][0][0].lanes} and {calls[0][0][3].lanes} lanes, "
            f"R {rs}): {len(calls)} launches, each lane of every 8th against its own launch "
            f"{'bitwise' if not bad else 'differs in ' + ', '.join(sorted(set(bad)))}; max_pen of the first "
            f"{min(len(calls), 12)} within {err:.3e} of the plain search (tol 1e-6)")
    print(line)
    check(not bad and err <= 1e-6, line)


def check_k2_replays(calls, tag="sysid friction", rtol_tight=1e-9, rtol_cone=None, rtol_exact=None):
    """K2 on taped replays (by default the sysid friction sweep's, the lane
    axis on F's friction coefficients), against the plain KKT solve, each
    gradient relative to its largest entry: dx and dnu (so dQ, dp, dA, db)
    and dlam's rows but the friction-cone rows within ``rtol_tight``; the
    cone rows (so dh, dG, dF and d loss / d mu, dF's cone diagonal, which
    the friction coefficients' gradient sums) within ``rtol_cone``
    (RTOL_K2_CONE); dlam within ``rtol_exact`` (RTOL_K2_REPLAY_EXACT) of the
    KKT systems' exact solution (``kkt_exact``; the plain version's
    distance from it is printed); and each lane bitwise its own K2 launch.
    Returns the largest d loss / d mu error."""
    import torch
    from diffsdfsim_torch.ops import qp

    rtol_cone = RTOL_K2_CONE if rtol_cone is None else rtol_cone
    rtol_exact = RTOL_K2_REPLAY_EXACT if rtol_exact is None else rtol_exact
    check(len(calls) > 0, f"{tag}: no taped K2 replay")
    rel = lambda a, r: float((a - r).abs().max()) / max(float(r.abs().max()), 1e-300)  # noqa: E731
    tight, cone, dmu_err, bad, B = 0.0, 0.0, 0.0, set(), calls[0][0][0].shape[0]
    ex_k, ex_p = 0.0, 0.0
    with torch.no_grad():
        for a, out in calls:
            plain = qp._lcp_bwd(*a[:10], None)
            k = a[9][1]
            dl_k, dl_p = -out[3], -plain[3]
            scale = max(float(dl_p.abs().max()), 1e-300)
            tight = max(tight, *(rel(out[i], plain[i]) for i in (0, 1, 4, 5)),
                        float((dl_k[:, :-k] - dl_p[:, :-k]).abs().max()) / scale)
            cone = max(cone, *(rel(out[i], plain[i]) for i in (2, 3, 6)))
            dmu_k, dmu_p = (torch.diagonal(g[6][:, -k:, :k], dim1=-2, dim2=-1) for g in (out, plain))
            dmu_err = max(dmu_err, float(((dmu_k - dmu_p).abs().amax(-1)
                                          / dmu_p.abs().amax(-1).clamp(min=1e-300)).max()))
            # the replay's KKT systems at the backward's diagonal (_lcp_bwd's d)
            Q, G, A, F, lam, slack, dl = a[0], a[1], a[2], a[3], a[6], a[7], a[8]
            d = torch.clamp(torch.clamp(lam, min=1e-8) / torch.clamp(slack, min=1e-8), max=1e12)
            nz, nineq = Q.shape[-1], G.shape[-2]
            ex = kkt_exact(*kkt_system(Q, G, A, F, d, dl))[:, nz : nz + nineq]
            ex_k, ex_p = max(ex_k, rel(dl_k, ex)), max(ex_p, rel(dl_p, ex))
            for i in range(a[0].shape[0]):
                one = qp._lcp_bwd(*(t[i : i + 1] for t in a[:9]), *a[9:])
                bad.update(n for n, x, y in zip("dQ dp dG dh dA db dF".split(), one, out)
                           if not torch.equal(x, y[i : i + 1]))
    line = (f"{tag} K2 ({len(calls)} taped replays of B = {B} lanes, structure {calls[0][0][9]}): through K2 "
            f"against the plain KKT solve: dx, dnu and dlam but its cone rows {tight:.3e} (tol {rtol_tight:g}), the "
            f"cone rows (dh, dG, dF) {cone:.3e} and d loss / d mu per lane {dmu_err:.3e} (tol {rtol_cone:g}); dlam "
            f"against the exact solution: K2 {ex_k:.3e} (tol {rtol_exact:g}), the plain version {ex_p:.3e}; each "
            f"lane against its own launch {'bitwise' if not bad else 'differs in ' + ', '.join(sorted(bad))}")
    print(line)
    check(tight <= rtol_tight and cone <= rtol_cone and dmu_err <= rtol_cone and ex_k <= rtol_exact and not bad,
          line)
    return dmu_err


def sysid_first_step(osy, target, start, c, cfg, device, logs, tag):
    """``optim_sysid.fit``'s first step on the single path: (loss, d loss /
    d theta, the target trajectory and the taped one as numpy); ``logs``, a
    ContactLog, records the two runs as ``tag`` target / start."""
    import torch
    from diffsdfsim_torch.experiments.losses import trajectory_loss

    logs.begin(f"{tag} target")
    with torch.no_grad():
        _, tgt = osy.simulate(torch.as_tensor(target, dtype=torch.float64, device=device), c, cfg, device)
    th = torch.tensor(float(start), dtype=torch.float64, device=device, requires_grad=True)
    logs.begin(f"{tag} start")
    _, traj = osy.simulate(th, c, cfg, device)
    loss = trajectory_loss(traj, tgt, body=1)
    (g,) = torch.autograd.grad(loss, th)
    return float(loss.detach()), float(g), traj_np(tgt), traj_np(traj)


def phase_sysid_sweep():
    """optim_sysid's seed sweep for each parameter: 16 seeds, 30 frames
    (run_time 1.0), its build_cfg (mesh_subdiv 2, max_bisect 6, no TOC): the
    targets, then one Adam step through the batched-native rollout (K1, K3 on
    the cube-floor pair both ways, K2). mass: the cube a lane body;
    friction: the floor and the cube lane bodies, each with a per-lane
    friction coefficient on the tape; force: the push magnitude per lane.

    Held: the launches and host reads, the lane axes, finite losses and
    gradients; under friction, every K3 launch with two lane bodies and
    every taped K2 replay against one launch per lane (bitwise) and the
    plain version (``check_sysid_k3_calls``, ``check_k2_replays``).
    The cube rests face down on the floor, so the contacts it keeps are
    decided by exact ties (its bottom face's points reach the same
    penetration; ROADMAP queue 3, items 3 and 11): any other order of the
    same arithmetic (K3 or the plain search, K1 or the plain solver, a lane
    of a batch or the single path, the card or the CPU) may keep other
    points, and the trajectories then part by up to metres. So each pair of
    runs of one world (lanes 0 and 15 against the single path on the card,
    target and start; lane 0's draws on the card and on the CPU port) is
    held by ``tie_witness`` up to the
    substep where their accepted contacts first differ, and the contacts
    there are printed; where neither of a lane's runs parts, its loss and
    gradient are held within RTOL_LANE of the single path's. Lane 0 carries
    the JAX golden's draws (tests/golden/full_sysid_<param>_f64.npz): its
    target and start runs are held within ATOL_SHAPE_PATH of JAX's, with
    identical decisions, over the frames before the first pose parting
    (1e-7) on the way lane 0 -> card single -> CPU port -> JAX; its loss and
    gradient are reported."""
    import torch
    from diffsdfsim_torch.experiments import fitting
    from diffsdfsim_torch.experiments import optim_sysid as osy
    from diffsdfsim_torch.ops import qp
    from diffsdfsim_torch.physics import contacts as pc

    rows = {}
    for param in SYSID_PARAMS:
        golden = dict(np.load(SYSID_GOLDEN.format(param)))
        c = dict(osy.DEFAULTS, param=param, n_par=SYSID_B)
        cfg = osy.build_cfg(c)
        targets, starts = osy.draws(c, DEVICE)
        targets[0], starts[0] = float(golden["target"]), float(golden["start"])
        lo_hi = osy.param_range(c)
        both_lanes = lambda bd1, q1, p1, bd2, *a: bd1.lanes > 0 and bd2.lanes > 0  # noqa: E731
        batch_bwd = lambda Q, *a: Q.shape[0] == SYSID_B  # noqa: E731
        with Recorder(osy) as rec, ContactLog() as logs, Calls(pc, "search_pair_raw", both_lanes) as k3_calls, \
                Calls(qp, "_lcp_bwd", batch_bwd) as k2_calls:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs.begin("batch target")
            with torch.no_grad():
                _, tgt = osy.simulate_batched(targets, c, cfg, DEVICE)
            torch.cuda.synchronize()
            fwd_wall = time.perf_counter() - t0
            fwd_line = check_sweep(f"sysid {param} targets", read_counts(), rec.calls[0][0], SYSID_B, taped=False)
            logs.begin("batch start")

            def value_and_grad(th):
                th = th.clone().requires_grad_(True)
                ls = fitting.lane_losses(osy.simulate_batched(th, c, cfg, DEVICE)[1], tgt, body=1)
                return ls.detach(), torch.autograd.grad(ls.sum(), th)[0]

            vg, walls, counts, _ = timed_sweep_steps(value_and_grad, 1, profile_last=False)
            out = fitting.descend(vg, starts, fitting.Adam(c["lr"]), 1, clip=lo_hi)
            line = check_sweep(f"sysid {param} step", counts[0], rec.calls[1][0], SYSID_B, taped=True)
            logs.cur = None
            lane_axes = [bd.lanes for bd in rec.calls[1][2]]
            check(lane_axes == {"mass": [0, SYSID_B], "force": [0, 0], "friction": [SYSID_B, SYSID_B]}[param],
                  f"sysid {param}: lane axes of (floor, cube) {lane_axes}")
            loss0, grad0 = out[1][0].cpu().numpy(), out[3][0].cpu().numpy()
            check(bool(np.isfinite(loss0).all() and np.isfinite(grad0).all()), f"sysid {param}: not finite")
            batch = {"target": traj_np(tgt), "start": traj_np(rec.calls[1][1])}

            # lanes 0 and 15 against the single path on the card
            singles, fcs = {}, {}
            for i in (0, SYSID_B - 1):
                singles[i] = sysid_first_step(osy, targets[i], starts[i], c, cfg, DEVICE, logs, f"single {i}")
                for j, run in enumerate(("target", "start")):
                    lane, one = {k: v[i] for k, v in batch[run].items()}, singles[i][2 + j]
                    fcs[(i, run)] = tie_witness(f"sysid {param} lane {i} vs the single path, {run}",
                                                (f"batch {run}", i), (f"single {i} {run}", None), logs,
                                                lane["valid"], one["valid"], lane["pos"], one["pos"])[0]
                el, eg = rel_err(loss0[i], singles[i][0]), rel_err(grad0[i], singles[i][1])
                untied = fcs[(i, "target")] is None and fcs[(i, "start")] is None
                print(f"sysid {param} lane {i} vs the single path: loss rel {el:.2e}, gradient rel {eg:.2e} "
                      + (f"(tol {RTOL_LANE:g}: neither run's contacts part)" if untied
                         else "(reported: the contacts part, above)"))
                if untied:
                    check(el <= RTOL_LANE and eg <= RTOL_LANE, f"sysid {param} lane {i}: differs from the single path")

            # lane 0's draws on the CPU port: the witness of the card
            # against the CPU, and the way to JAX
            cpu = sysid_first_step(osy, float(golden["target"]), float(golden["start"]), c, cfg, "cpu", logs, "cpu")
        if param == "friction":
            check_sysid_k3_calls(k3_calls.calls, cfg)
            check_k2_replays(k2_calls.calls)
            # the step's gradient again, every replay's KKT solve the plain one
            from diffsdfsim_torch.ops.qp import blockdiag_inv3, kkt_grad_plain
            from diffsdfsim_torch.physics import engine

            solve = engine._replay_kkt_solve
            engine._replay_kkt_solve = lambda Q, *a: kkt_grad_plain(blockdiag_inv3(Q), *a)
            try:
                g_plain = value_and_grad(starts)[1].cpu().numpy()
            finally:
                engine._replay_kkt_solve = solve
            e_g = float((np.abs(grad0 - g_plain) / np.maximum(np.abs(g_plain), 1e-300)).max())
            print(f"sysid friction: d loss / d mu of the {SYSID_B} lanes through K2 against the same step through the "
                  f"plain KKT solve: max rel {e_g:.3e} (tol {RTOL_K2_CONE:g})")
            check(e_g <= RTOL_K2_CONE, f"sysid friction: the gradient through K2 differs by {e_g:.3e}")
        s0 = singles[0][3]
        fc_cpu = tie_witness(f"sysid {param} lane 0 draws, single path on the card vs the CPU port",
                             ("single 0 start", None), ("cpu start", None), logs, s0["valid"], cpu[3]["valid"],
                             s0["pos"], cpu[3]["pos"])[0]
        # lane 0's target and start runs against JAX's, over the frames
        # before the first pose parting on the way lane 0 -> card single ->
        # CPU port -> JAX
        jax_lines = []
        for j, (run, key) in enumerate((("target", "tgt"), ("start", "start"))):
            jax_traj = {k: golden[f"{key}_{k}"] for k in ("pos",) + DECISIONS}
            lane0 = {k: v[0] for k, v in batch[run].items()}
            way = (lane0, singles[0][2 + j], cpu[2 + j], jax_traj)
            chain = [first_parting(x["pos"], y["pos"])[0] for x, y in zip(way, way[1:])]
            window = min([x for x in chain if x is not None] + [len(jax_traj["pos"]), len(lane0["pos"])])
            d_jax = float(np.abs(lane0["pos"][:window] - jax_traj["pos"][:window]).max()) if window else 0.0
            same = all(np.array_equal(lane0[k][:window], jax_traj[k][:window]) for k in DECISIONS)
            jax_lines.append(f"{run}: poses part (1e-7) lane 0 vs card single at frame {chain[0]}, card single vs CPU "
                             f"port at {chain[1]}, CPU port vs JAX at {chain[2]}; lane 0 vs JAX over frames 0..{window - 1}"
                             f" within {d_jax:.2e} (tol {ATOL_SHAPE_PATH:g}), decisions {'equal' if same else 'differ'}")
            check(d_jax <= ATOL_SHAPE_PATH and same, f"sysid {param} lane 0 {run}: differs from JAX before the first "
                  f"parting")
        e_loss, e_grad = rel_err(loss0[0], golden["loss"]), rel_err(grad0[0], golden["grad"])
        print(f"sysid {param} lane 0 (theta {float(golden['start']):.4f} toward {float(golden['target']):.4f}): "
              + "; ".join(jax_lines) + f"; loss card {loss0[0]!r}, CPU port {cpu[0]!r}, JAX "
              f"{float(golden['loss'])!r}; gradient card {grad0[0]!r}, CPU port {cpu[1]!r}, "
              f"JAX {float(golden['grad'])!r}; card vs JAX rel {e_loss:.2e} / {e_grad:.2e} (reported); first contact "
              f"partings: lane 0 vs single {fcs[(0, 'start')]}, card vs CPU port {fc_cpu}")
        lane_steps = SYSID_B * osy.n_frames(c, cfg)
        print(f"sysid {param} B={SYSID_B}: targets forward {fwd_wall:.3f} s = {lane_steps / fwd_wall:.2f} lane-steps/s "
              f"({fwd_line}); lane axes of (floor, cube) {lane_axes}; Adam step (fwd+bwd) {walls[0]:.3f} s = "
              f"{lane_steps / walls[0]:.2f} lane-steps/s ({line})")
        rows[param] = dict(fwd_wall=fwd_wall, walls=walls, counts=counts)
    return rows


def phase_shapespace_sweep():
    """optim_shapespace's seed sweep at the full decoder width (latent 2,
    (128,)*8, skip at 4, the seeded weights of the latent path), 8 seeds, 36
    frames: the target drops, then one Adam step, through K4 (every decoder
    value; the latent lane body's queries map the single-body code over the
    lanes, and each query of the whole batch must be one K4 launch), K1 and
    K2; K3 is never launched. Lane 0 carries the latent golden's draws
    (tests/golden/latent128_f64.npz) and is held against its first fit
    step (RTOL_LATENT_GRAD); lanes SHAPE_LANES against the single path on
    the card (RTOL_SHAPE_LANE)."""
    import torch
    from diffsdfsim_torch.experiments import optim_shapespace as oss
    from diffsdfsim_torch.experiments.losses import trajectory_loss
    from diffsdfsim_torch.models import igr

    golden = dict(np.load(LATENT_GOLDEN))
    net = igr_net(torch.float64, tuple(golden["dims"].tolist()), tuple(golden["skip_in"].tolist()),
                  int(golden["weight_seed"]), device=DEVICE)
    c = dict(oss.DEFAULTS, run_time=int(golden["frames"]) / 30.0, n_par=SHAPE_B)
    cfg = oss.build_cfg(c)
    codes = torch.tensor(golden["codes"], device=DEVICE)
    targets, starts, quats = (x.clone() for x in oss.draws(codes, c))
    for x, k in ((targets, "target_latent"), (starts, "start_latent"), (quats, "quat0")):
        x[0] = torch.tensor(golden[k], device=DEVICE)

    queries = [0]
    decode = igr.decode

    def counted(*a, **k):
        queries[0] += 1
        return decode(*a, **k)

    igr.decode = counted
    try:
        with Recorder(oss) as rec:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                _, tgt = oss.simulate_batched(targets, quats, net, c, cfg, DEVICE)
            torch.cuda.synchronize()
            fwd_wall = time.perf_counter() - t0
            fwd_counts, fwd_queries = read_counts(), queries[0]
            fwd_line = check_sweep("shape-space sweep targets", fwd_counts, rec.calls[0][0], SHAPE_B, taped=False,
                                   k3=False)
            queries[0] = 0
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = starts.clone().requires_grad_(True)
            ls = fitting_losses(oss, z, quats, net, c, cfg, tgt)
            (g,) = torch.autograd.grad(ls.sum(), z)
            torch.cuda.synchronize()
            step_wall = time.perf_counter() - t0
            step_counts, step_queries = read_counts(), queries[0]
            line = check_sweep("shape-space sweep step", step_counts, rec.calls[1][0], SHAPE_B, taped=True, k3=False)
    finally:
        igr.decode = decode
    check(fwd_counts["igr_mlp"] == fwd_queries > 0 and step_counts["igr_mlp"] == step_queries > 0,
          f"shape-space sweep: K4 launches {fwd_counts['igr_mlp']} / {step_counts['igr_mlp']} for "
          f"{fwd_queries} / {step_queries} decoder queries (forward / step)")
    check([bd.lanes for bd in rec.calls[1][2]] == [0, SHAPE_B], "shape-space sweep: the latent body must be a "
          "lane body (its code per lane), the floor shared")
    loss0, grad0 = ls.detach().cpu().numpy(), g.cpu().numpy()
    batch = traj_np(rec.calls[1][1])
    e_loss, e_grad = rel_err(loss0[0], golden["loss_0"]), rel_err(grad0[0], golden["grad_0"])
    print(f"shape-space sweep lane 0 vs JAX golden: loss rel {e_loss:.2e}, d loss / d latent {grad0[0].tolist()} vs "
          f"{golden['grad_0'].tolist()} rel {e_grad:.2e} (tol {RTOL_LATENT_GRAD:g}); "
          + partings({"card lane 0": {k: v[0] for k, v in batch.items()},
                      "JAX": {k: golden[f"start_traj_{k}"] for k in ("pos",) + DECISIONS}}))
    failed = [] if e_loss <= RTOL_LATENT_GRAD and e_grad <= RTOL_LATENT_GRAD else ["lane 0 vs JAX"]
    for i in SHAPE_LANES:
        with torch.no_grad():
            _, tgt_i = oss.simulate(targets[i], quats[i], net, c, cfg, DEVICE)
        zi = starts[i].clone().requires_grad_(True)
        _, traj_i = oss.simulate(zi, quats[i], net, c, cfg, DEVICE)
        li = trajectory_loss(traj_i, tgt_i, body=1) + c["latent_reg"] * torch.sum(zi**2)
        (gi,) = torch.autograd.grad(li, zi)
        el, eg = rel_err(loss0[i], float(li.detach())), rel_err(grad0[i], gi.cpu().numpy())
        print(f"shape-space sweep lane {i} vs the single path: loss rel {el:.2e}, gradient rel {eg:.2e} "
              f"(tol {RTOL_SHAPE_LANE:g}); "
              + partings({"lane": {k: v[i] for k, v in batch.items()}, "single": traj_np(traj_i)}))
        if not (el <= RTOL_SHAPE_LANE and eg <= RTOL_SHAPE_LANE):
            failed.append(f"lane {i} vs the single path (loss rel {el:.2e}, gradient rel {eg:.2e})")
    n_fr = int(golden["frames"])
    print(f"shape-space sweep B={SHAPE_B}, {n_fr} frames: target drops {fwd_wall:.3f} s = "
          f"{SHAPE_B * n_fr / fwd_wall:.2f} lane-steps/s ({fwd_line}; {fwd_queries} decoder queries); Adam step "
          f"(fwd+bwd) {step_wall:.3f} s = {SHAPE_B * n_fr / step_wall:.2f} lane-steps/s ({line}; {step_queries} "
          f"decoder queries)")
    check(not failed, "shape-space sweep: " + "; ".join(failed))
    return dict(fwd_counts=fwd_counts, step_counts=step_counts)


# ---------------------------------------------------------------- phase 11


PC_GOLDEN = os.path.join(ROOT, "tests", "golden", "pointcloud_{}_f64.npz")
# How optim_pointcloud is held (phase_pointcloud). Renders of one trajectory
# on the card and on the CPU port: the segmentation equal but in at most
# MAX_SEG_DIFF pixels a frame (a grazing ray can hit on one device and miss
# on the other), the depth within ATOL_DEPTH where both hit. On JAX's
# observations (tests/golden/pointcloud_sphere_f64.npz): the first-frame
# loss and gradient within RTOL_PC_FRAME relative; the trajectory loss and
# gradient within RTOL_PC_TRAJ of the CPU port's over the frames before the
# card's and the CPU port's kept contacts first differ (a touchdown tie,
# ROADMAP queue 3, item 1: tie_witness prints it), and of JAX's where they
# never do (tests/test_torch_pointcloud.py holds the CPU port to JAX's). The
# cube is decided by box ties (items 3 and 11): its values are reported.
MAX_SEG_DIFF, ATOL_DEPTH = 2, 1e-9
RTOL_PC_FRAME, RTOL_PC_TRAJ = 1e-8, 1e-6
# optim_pointcloud.main's Adam steps a phase on the card (60 and 40 at its
# defaults), the frames the latent and grid bodies are rendered at, and a
# frame's SDF queries of each body (64 march steps, then the segmentation)
PC_ITERS, N_RENDER, QUERIES_PER_FRAME = 2, 3, 65


def pc_observations(g, device):
    """JAX's observations of a point-cloud golden: [(t, pc (H, W, 3), seg (H,
    W))], the points set where the body's mask is."""
    import torch

    seg = torch.tensor(g["seg"]).to(torch.int32)
    pcs = torch.zeros(tuple(seg.shape) + (3,), dtype=torch.float64)
    pcs[seg == 1] = torch.tensor(g["obs_pts"])
    seg, pcs = seg.to(device), pcs.to(device)
    return [(torch.tensor(t, device=device), pcs[i], seg[i]) for i, t in enumerate(g["obs_t"])]


class CountedBody:
    """A body with the renderer's surface (``scale``, ``query_sdfs``) whose
    SDF queries are counted."""

    def __init__(self, body):
        self.body, self.queries = body, 0

    def scale(self):
        return self.body.scale()

    def query_sdfs(self, pts, return_grads=True):
        self.queries += 1
        return self.body.query_sdfs(pts, return_grads=return_grads)


def render_compare(tag, frames_a, frames_b):
    """Two renders of the same frames ([(depth, seg)]) held as MAX_SEG_DIFF
    and ATOL_DEPTH say."""
    n_seg, d_depth, n_hit = 0, 0.0, 0
    for (da, sa), (db, sb) in zip(frames_a, frames_b):
        sa, sb = sa.cpu().numpy(), sb.cpu().numpy()
        n_seg = max(n_seg, int((sa != sb).sum()))
        both = (sa >= 0) & (sb >= 0)
        n_hit += int(both.sum())
        if both.any():
            d_depth = max(d_depth, float(np.abs(da.cpu().numpy()[both] - db.cpu().numpy()[both]).max()))
    line = (f"{tag}: {len(frames_a)} frames, segmentation differs in at most {n_seg} pixels a frame (tol "
            f"{MAX_SEG_DIFF}), depth where both hit ({n_hit} pixels) within {d_depth:.3e} (tol {ATOL_DEPTH:g})")
    print(line)
    check(n_seg <= MAX_SEG_DIFF and d_depth <= ATOL_DEPTH and n_hit > 0, line)


def render_counted(tag, spec, state, cam, pose, kernel):
    """N_RENDER frames of a world's second body at heights 2.0, 1.6, 1.2 m
    (the first, the floor, analytic): its SDF queries counted against the
    launches of ``kernel`` (K4 for a latent body, K5 for a grid body)."""
    import torch
    from diffsdfsim_torch.rendering import render_depth_seg

    body = CountedBody(spec.bodies[1])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for y in (2.0, 1.6, 1.2)[:N_RENDER]:
            pos = state.pos.clone()
            pos[1, 1] = y
            _, seg = render_depth_seg([spec.bodies[0], body], state.quat, pos, cam, pose)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = QUERIES_PER_FRAME * N_RENDER
    line = (f"pointcloud render of the {tag} body at {cam.width} x {cam.height} (N = {cam.width * cam.height} "
            f"points a query), {N_RENDER} frames in {wall:.3f} s: {body.queries} queries of the body, launches "
            f"{launches}, its pixels in the last frame {int((seg == 1).sum())}")
    print(line)
    check(body.queries == want and launches[kernel] == want and int((seg == 1).sum()) > 0, line)
    return wall


def phase_pointcloud():
    """optim_pointcloud at its full width (128 x 96, mesh_subdiv 2,
    run_time 1.0: 30 frames, fric_dirs 4) with its iterations cut, and the
    renderer on the latent and grid bodies:

    1. the target scene at the JAX golden's draws: its rollout on the card
       and on the CPU port (held up to their first contact parting by
       tie_witness; the CPU port against JAX's target), its 30 frames
       rendered on the card and on the CPU port (render_compare), no kernel
       launched by the analytic render;
    2. the latent drop's body (the reference's decoder at full width) and
       the grid drop's (64^3) rendered at N_RENDER frames: each SDF query of
       the body is one K4 / K5 launch, QUERIES_PER_FRAME a frame; K4 timed
       at N = 128 * 96 = 12,288;
    3. ``optim_pointcloud.main`` with PC_ITERS Adam steps a phase: K1, K3
       and K2 launched, its taped replays' K2 (k 4, fd 4, runtime-sized)
       held against the plain KKT solve and the exact solution;
    4. on JAX's observations: the first-frame loss and gradient at JAX's
       iterates, the trajectory loss and gradient at the trajectory fit's
       start (RTOL_PC_FRAME, RTOL_PC_TRAJ; the cube reported);
    5. ``optim_pointcloud_real.main`` (3 Adam steps) on the synthetic
       recording of tests/test_pointcloud_real.py against its golden (K3
       launched).

    K1 and K2 at the point-cloud LCP shape are also held by phase_k1 /
    phase_k2 ("pc"). Prints each part's wall time and the device's idle
    share over one trajectory loss and its gradient."""
    import json
    import tempfile

    import torch
    from diffsdfsim_torch.experiments import optim_pointcloud as op
    from diffsdfsim_torch.experiments import optim_pointcloud_real as opr
    from diffsdfsim_torch.experiments import optim_shapespace as oss
    from diffsdfsim_torch.ops import qp
    from diffsdfsim_torch.physics import GridShape, make_body, rollout
    from diffsdfsim_torch.rendering import render_depth_seg

    walls = {}

    def part(name, t0):
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0

    f64 = torch.float64
    golden = dict(np.load(PC_GOLDEN.format("sphere")))
    c = dict(op.DEFAULTS)
    cfg = op.build_cfg(c)
    n = op.n_frames(c, cfg)
    cam, pose = op.camera_setup(c, "cuda")

    # 1. the target scene
    runs = {}
    with ContactLog() as logs:
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            logs.begin(dev)
            spec, state = op.make_scene(c, cfg, torch.tensor(golden["target_size"], device=dev),
                                        torch.tensor(op.TARGET_POS, dtype=f64, device=dev),
                                        torch.tensor(golden["target_quat"], device=dev), dev)
            with torch.no_grad():
                _, traj = rollout(spec, state, n)
            runs[dev] = (spec, traj_np(traj), traj)
            part(f"target rollout ({dev})", t0)
    (spec_g, tg, traj_g), (spec_c, tc, _) = runs["cuda"], runs["cpu"]
    tie_witness("pointcloud target, card vs CPU port", ("cuda", None), ("cpu", None), logs, tg["valid"], tc["valid"],
                tg["pos"], tc["pos"])
    e_jax = max(float(np.abs(tc[k] - golden[f"tgt_{k}"]).max()) for k in ("pos", "quat"))
    same = np.array_equal(tc["valid"], golden["tgt_valid"]) and np.array_equal(tc["n_halvings"],
                                                                                golden["tgt_n_halvings"])
    print(f"pointcloud target, CPU port vs JAX golden: poses within {e_jax:.2e} (tol {ATOL_SHAPE_PATH:g}), decisions "
          f"{'equal' if same else 'differ'}")
    check(e_jax <= ATOL_SHAPE_PATH and same, "pointcloud target: the CPU port differs from JAX's")
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        frames_g = [render_depth_seg(spec_g.bodies, traj_g.quat[i, 0], traj_g.pos[i, 0], cam, pose) for i in range(n)]
    part("render 30 frames (card)", t0)
    check(all(v == 0 for v in read_counts().values()), f"the analytic render launched {read_counts()}")
    qc, pc_, pose_c = traj_g.quat.cpu(), traj_g.pos.cpu(), pose.cpu()
    t0 = time.perf_counter()
    frames_c = [render_depth_seg(spec_c.bodies, qc[i, 0], pc_[i, 0], cam, pose_c) for i in range(n)]
    walls["render 30 frames (CPU port)"] = time.perf_counter() - t0
    render_compare("pointcloud target renders of the card's trajectory, card vs CPU port", frames_g, frames_c)

    # 2. the latent and grid bodies
    lat = dict(np.load(LATENT_GOLDEN))
    net = igr_net(f64, tuple(lat["dims"].tolist()), tuple(lat["skip_in"].tolist()), int(lat["weight_seed"]))
    oc = dict(oss.DEFAULTS)
    spec_l, state_l = oss.build_world(torch.tensor(lat["target_latent"], device="cuda"),
                                      torch.tensor(lat["quat0"], device="cuda"), net, oc, oss.build_cfg(oc), "cuda")
    walls["render the latent body"] = render_counted("latent", spec_l, state_l, cam, pose, "igr_mlp")
    k4 = k4_case(net.params(), cam.width * cam.height, K4_RTOL["float64"])
    grid = torch.tensor(sphere_grid(64), device="cuda")
    ball = make_body(GridShape(grid=grid, scale_=torch.tensor(0.75)), template="ico", subdiv=2, project_iters=16,
                     device="cuda")
    spec_q = type("Spec", (), {"bodies": [spec_l.bodies[0], ball]})
    walls["render the grid body"] = render_counted("grid", spec_q, state_l, cam, pose, "grid_query")

    # 3. main, its iterations cut
    with tempfile.TemporaryDirectory() as tmp, Calls(qp, "_lcp_bwd") as k2_calls:
        reset_counts()
        t0 = time.perf_counter()
        out = op.main(["with", f"frame_fit_iters={PC_ITERS}", f"traj_fit_iters={PC_ITERS}", f"base_dir={tmp}"],
                      device="cuda")
        part("optim_pointcloud.main", t0)
        main_launches = read_counts()
    errs = {k: (out[k]["pos_err"], out[k]["rot_err"], out[k]["size_err"]) for k in ("init", "frame_fit", "traj_fit")}
    line = (f"optim_pointcloud.main on the card ({PC_ITERS} Adam steps a phase): {walls['optim_pointcloud.main']:.3f} s, "
            f"launches {main_launches}, (pos, rot, size) errors {errs}")
    print(line)
    check(main_launches["pdipm_fwd"] > 0 and main_launches["fw_search"] > 0 and main_launches["kkt_bwd"] > 0
          and bool(np.isfinite(np.array(list(errs.values()))).all()), line)
    check_k2_replays(k2_calls.calls, "pointcloud trajectory fit", RTOL_K2_PC_PLAIN, RTOL_K2_PC_PLAIN)

    # 4. on JAX's observations
    obs = {dev: pc_observations(golden, dev) for dev in ("cuda", "cpu")}
    masks = {dev: [o[2] == 1 for o in obs[dev]] for dev in obs}
    pose_d = {"cuda": pose, "cpu": pose_c}
    e_frame = 0.0
    for i in range(len(golden["frame_loss"])):
        x = torch.tensor(golden["frame_x"][i], device="cuda", requires_grad=True)
        v = op.frame_loss(x, c, obs["cuda"][0][1], masks["cuda"][0], pose)
        (g,) = torch.autograd.grad(v, x)
        e_frame = max(e_frame, rel_err(float(v), golden["frame_loss"][i]),
                      rel_err(g.cpu().numpy(), golden["frame_grad"][i]))
    line = f"pointcloud first-frame loss and gradient at JAX's 3 iterates vs JAX: rel {e_frame:.2e} (tol {RTOL_PC_FRAME:g})"
    print(line)
    check(e_frame <= RTOL_PC_FRAME, line)
    res = {}
    with ContactLog() as logs:
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            logs.begin(dev)
            x = torch.tensor(golden["traj_x"][0], device=dev, requires_grad=True)
            traj = op.simulate(x, c, cfg, dev)
            res[dev] = (x, traj_np(traj), op.frame_losses(traj, x, c, obs[dev], masks[dev], pose_d[dev]))
            part(f"trajectory loss, forward ({dev})", t0)
    (xg, tg, flg), (xc, tc, flc) = res["cuda"], res["cpu"]
    fc, _, _ = tie_witness("pointcloud trajectory fit's start, card vs CPU port", ("cuda", None), ("cpu", None), logs,
                           tg["valid"], tc["valid"], tg["pos"], tc["pos"])

    def loss_grad(x, fl, m):
        v = 0.0
        for t in fl[:m]:
            v = v + t
        v = v / len(fl)
        if m == 0:
            return 0.0, np.zeros(8)
        t0 = time.perf_counter()
        (g,) = torch.autograd.grad(v, x, retain_graph=True)
        walls[f"trajectory loss, backward ({x.device.type}, {m} frames)"] = time.perf_counter() - t0
        return float(v), g.cpu().numpy()

    m = n if fc is None else fc
    (lg, gg), (lc, gc) = loss_grad(xg, flg, m), loss_grad(xc, flc, m)
    e_cpu = max(rel_err(lg, lc), rel_err(gg, gc))
    full_l, full_g = loss_grad(xg, flg, n) if m < n else (lg, gg)
    e_jax = max(rel_err(full_l, golden["traj_loss"][0]), rel_err(full_g, golden["traj_grad"][0]))
    line = (f"pointcloud trajectory loss and gradient at the trajectory fit's start over the {m} frames before the "
            f"contacts part: card vs CPU port rel {e_cpu:.2e} (tol {RTOL_PC_TRAJ:g}); all {n} frames: loss card "
            f"{full_l!r}, JAX {float(golden['traj_loss'][0])!r}, gradient card {full_g.tolist()}, JAX "
            f"{golden['traj_grad'][0].tolist()}: card vs JAX rel {e_jax:.2e} "
            + (f"(tol {RTOL_PC_TRAJ:g})" if fc is None else "(reported: the contacts part)"))
    print(line)
    check(e_cpu <= RTOL_PC_TRAJ and (fc is not None or e_jax <= RTOL_PC_TRAJ), line)
    x = torch.tensor(golden["traj_x"][0], device="cuda", requires_grad=True)
    pwall, busy, kern = busy_share(lambda: torch.autograd.grad(
        op.traj_loss(x, c, cfg, obs["cuda"], masks["cuda"], pose, "cuda"), x))
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
    print(f"pointcloud trajectory loss and gradient, profiled: wall {pwall:.1f} ms, device busy {busy:.1f} ms (idle "
          f"{100 - 100 * busy / pwall:.1f}%); top kernels (ms): " + "; ".join(f"{k[:40]} {v:.2f}" for k, v in top))
    # the cube, reported
    cube = dict(np.load(PC_GOLDEN.format("cube")))
    cc = dict(c, shape="cube")
    obs_q = pc_observations(cube, "cuda")
    mask_q = [o[2] == 1 for o in obs_q]
    x = torch.tensor(cube["frame_x"][0], device="cuda", requires_grad=True)
    v = op.frame_loss(x, cc, obs_q[0][1], mask_q[0], pose)
    e_cf = max(rel_err(float(v), cube["frame_loss"][0]),
               rel_err(torch.autograd.grad(v, x)[0].cpu().numpy(), cube["frame_grad"][0]))
    x = torch.tensor(cube["traj_x"][0], device="cuda", requires_grad=True)
    v = op.traj_loss(x, cc, op.build_cfg(cc), obs_q, mask_q, pose, "cuda")
    g = torch.autograd.grad(v, x)[0].cpu().numpy()
    print(f"pointcloud cube (reported; box ties): first-frame loss and gradient vs JAX rel {e_cf:.2e}; trajectory "
          f"loss {float(v)!r} vs JAX {float(cube['traj_loss'][0])!r}, gradient rel {rel_err(g, cube['traj_grad'][0]):.2e}")

    # 5. optim_pointcloud_real on the synthetic recording
    real = dict(np.load(PC_GOLDEN.format("real")))
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "rec.pkl")
        opr.synthetic_recording(rec)
        reset_counts()
        t0 = time.perf_counter()
        out = opr.main(["with", f"data_path={rec}", "max_iter=3", "mesh_subdiv=1", f"base_dir={tmp}"], device="cuda")
        part("optim_pointcloud_real.main (3 steps)", t0)
        real_launches = read_counts()
        losses = json.loads(open(os.path.join(tmp, "pointcloud_real", "1", "metrics.json")).read())["loss"]["values"]
    # the rotation's gradient is ~0 for a sphere: rot0 held absolutely
    e_real = max(rel_err(losses, real["loss"]), *(rel_err(out[k], real[k]) for k in ("size", "pos0")))
    e_rot = float(np.abs(out["rot0"] - real["rot0"]).max())
    line = (f"optim_pointcloud_real.main on the card, 3 Adam steps on the synthetic recording: losses {losses}, size "
            f"{float(out['size'])!r}; vs JAX golden: losses, size and pos0 rel {e_real:.2e} (tol {RTOL_PC_TRAJ:g}), "
            f"rot0 {e_rot:.2e} (tol {RTOL_PC_TRAJ:g}); launches {real_launches}")
    print(line)
    # the sphere starts at its first-frame points' centroid and falls for the
    # recording's 4 frames without reaching the floor: K3 searches, no LCP
    check(e_real <= RTOL_PC_TRAJ and e_rot <= RTOL_PC_TRAJ and real_launches["fw_search"] > 0, line)
    print("pointcloud walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return dict(main_launches=main_launches, k4=k4, walls=walls)


def fitting_losses(oss, z, quats, net, c, cfg, tgt):
    """optim_shapespace.fit_batched's per-lane losses at latents z."""
    from diffsdfsim_torch.experiments.fitting import lane_losses

    traj = oss.simulate_batched(z, quats, net, c, cfg, DEVICE)[1]
    return lane_losses(traj, tgt, body=1) + c["latent_reg"] * (z**2).sum(-1)


# ---------------------------------------------------------------- phases 12-13


INERTIA_GOLDEN = os.path.join(ROOT, "tests", "golden", "inertia_{}_f64.npz")
MESH_GOLDEN = os.path.join(ROOT, "tests", "golden", "meshes_{}_f64.npz")
# optim_primitives' cases on the card: box, sphere and cylinder with the
# Mirtich inertia of the projection mesh and with custom_inertia, the box
# also with its analytic mesh (custom_mesh)
PRIM_CASES = ("box", "box_ci", "box_cm", "sphere", "sphere_ci", "cylinder", "cylinder_ci")
PRIM_B, SSI_B = 50, 8
# against the JAX golden: primitives' loss and gradient at the start, both
# steps' losses and the first step's parameters, relative (the second
# step's parameters are printed: at the cylinder's first step the cube
# template's 8 rim vertices project 1 ulp from JAX's, onto an exact tie of
# the failsafe normal in JAX and off it here, which moves d inertia / d
# params by 2.3e-3 and the second step by 2.4e-6; ROADMAP queue 3);
# the latent body's (the decoder's 8 layers between the latent and the
# inertia); a sweep lane against the single path on the card
RTOL_PRIM, RTOL_SSI, RTOL_INERTIA_LANE = 1e-8, 1e-6, 1e-9
# the golden generator's scenes (tests/golden/gen_torch_meshes_golden.py)
TORUS_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=2, max_substeps=2,
                 max_bisect=4, tol=1e-6, time_of_contact_diff=False)
BOWL_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                max_bisect=6, time_of_contact_diff=False)
IGR_STEPS = 3  # igr_train's steps on the card and on the CPU
ATOL_MESH_POSE = 1e-7


def no_contact_kernels(tag, counts):
    check(counts["pdipm_fwd"] == counts["fw_search"] == counts["kkt_bwd"] == 0,
          f"{tag}: a world with no contact pair launched K1, K3 or K2: {counts}")


@contextlib.contextmanager
def counted_decodes():
    """A context whose value ([n]) counts decoder queries (``igr.decode``
    calls; under vmap one call is the query of every lane)."""
    from diffsdfsim_torch.models import igr

    n, decode = [0], igr.decode

    def counted(*a, **k):
        n[0] += 1
        return decode(*a, **k)

    igr.decode = counted
    try:
        yield n
    finally:
        igr.decode = decode


def lanes_vs_single(tag, sweep, singles, keys, rtol):
    """Each (lane, single-path result) of a sweep: rel errors of ``keys``."""
    failed = []
    for i, ref in singles:
        errs = {k: rel_err(sweep[k][:, i].cpu().numpy() if k.endswith("_hist") else sweep[k][i].cpu().numpy(),
                           ref[k].cpu().numpy()) for k in keys}
        print(f"{tag} lane {i} vs the single path: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol {rtol:g})")
        failed += [f"lane {i} {k}" for k, v in errs.items() if not v <= rtol]
    return failed


def phase_inertia():
    """The inertia-fitting experiments on CUDA, worlds of one pinned body
    and no contact pair (every step the joint solve; no K1, K3 or K2):
    optim_primitives at its defaults (27 frames) for PRIM_CASES, two Adam
    steps single and as a PRIM_B-seed batched-native sweep, lane 0 carrying
    the JAX golden's draws (tests/golden/inertia_prim_<case>_f64.npz: loss
    and gradient at the start, both steps' losses, the first step's
    parameters, RTOL_PRIM) and lanes 0 and
    PRIM_B - 1 held against the single path (RTOL_INERTIA_LANE); then
    optim_shapespace_inertia at its defaults (the reference's decoder,
    latent 2, (128,)*8, skip at 4; mesh_subdiv 2; 60 frames), two Adam steps
    single and at SSI_B seeds, against inertia_ssi_full_f64.npz (RTOL_SSI)
    and the single path, with K4 launches counted against decoder queries:
    one per query, the whole sweep batch's included."""
    import torch
    from diffsdfsim_torch.experiments import optim_primitives as op
    from diffsdfsim_torch.experiments import optim_shapespace_inertia as ssi
    from diffsdfsim_torch.models.igr import ImplicitNet

    failed = []
    prim_keys = ("loss_hist", "grad_hist", "param_hist")
    for case in PRIM_CASES:
        g = dict(np.load(INERTIA_GOLDEN.format("prim_" + case)))
        shape, _, variant = case.partition("_")
        c = dict(op.DEFAULTS, shape=shape, custom_inertia=variant == "ci", custom_mesh=variant == "cm", n_par=PRIM_B)
        cfg = op.build_cfg(c)
        targets, starts, axes = (x.clone() for x in op.draws(c, "cuda"))
        for x, k in ((targets, "target"), (starts, "start"), (axes, "axis")):
            x[0] = torch.tensor(g[k], device="cuda")
        reset_counts()
        single, w1, r1 = synced(lambda: op.fit(targets[0], starts[0], axes[0], c, cfg, "cuda", max_iter=2))
        n1 = read_counts()
        reset_counts()
        sweep, wb, rb = synced(lambda: op.fit_batched(targets, starts, axes, c, cfg, "cuda", max_iter=2))
        nb = read_counts()
        no_contact_kernels(f"primitives {case}", n1)
        no_contact_kernels(f"primitives {case} sweep", nb)
        last = op.fit(targets[-1], starts[-1], axes[-1], c, cfg, "cuda", max_iter=2)
        errs = dict(loss0=rel_err(single["loss_hist"][0].cpu(), g["loss0"]),
                    grad0=rel_err(single["grad_hist"][0].cpu(), g["grad0"]),
                    loss_hist=rel_err(single["loss_hist"].cpu(), g["loss_hist"]),
                    step1=rel_err(single["param_hist"][0].cpu(), g["param_hist"][0]))
        step2 = rel_err(single["param_hist"][1].cpu(), g["param_hist"][1])
        print(f"primitives {case}: single 2 steps {w1:.3f} s ({r1} device reads), sweep B={PRIM_B} 2 steps "
              f"{wb:.3f} s ({rb} device reads) = {PRIM_B * 2 / wb:.1f} lane-steps/s; launches {nb}; vs JAX golden "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {RTOL_PRIM:g}); the second step's "
              f"parameters {step2:.2e}, not held: a rim vertex's failsafe normal there can turn on a rounding tie "
              f"(ROADMAP queue 3)")
        failed += [f"{case} {k}" for k, v in errs.items() if not v <= RTOL_PRIM]
        failed += lanes_vs_single(f"primitives {case}", sweep, ((0, single), (PRIM_B - 1, last)), prim_keys,
                                  RTOL_INERTIA_LANE)

    g0, c0 = dict(np.load(INERTIA_GOLDEN.format("prim_box"))), dict(op.DEFAULTS, shape="box")
    g = dict(np.load(INERTIA_GOLDEN.format("ssi_full")))
    n = sum(1 for k in g if k[0] == "w" and k[1:].isdigit())
    net = ImplicitNet.from_arrays([g[f"w{i}"] for i in range(n)], [g[f"b{i}"] for i in range(n)],
                                  skip_in=tuple(int(i) for i in g["skip_in"]), device="cuda")
    c = dict(ssi.DEFAULTS, n_par=SSI_B)
    cfg = ssi.build_cfg(c)
    codes = torch.tensor(g["codes"], device="cuda")
    targets, starts, axes = (x.clone() for x in ssi.draws(codes, c))
    for x, k in ((targets, "target"), (starts, "start"), (axes, "axis")):
        x[0] = torch.tensor(g[k], device="cuda")
    with counted_decodes() as q1:
        reset_counts()
        single, w1, r1 = synced(lambda: ssi.fit(net, targets[0], starts[0], axes[0], c, cfg, "cuda", max_iter=2))
        n1 = read_counts()
    with counted_decodes() as qb:
        reset_counts()
        sweep, wb, rb = synced(lambda: ssi.fit_batched(net, targets, starts, axes, c, cfg, "cuda", max_iter=2))
        nb = read_counts()
    no_contact_kernels("shape-space inertia", n1)
    no_contact_kernels("shape-space inertia sweep", nb)
    check(n1["igr_mlp"] == q1[0] > 0 and nb["igr_mlp"] == qb[0] == q1[0],
          f"shape-space inertia: K4 launches {n1['igr_mlp']} single / {nb['igr_mlp']} sweep for {q1[0]} / {qb[0]} "
          f"decoder queries (one launch per query of the whole batch)")
    errs = dict(loss0=rel_err(single["loss_hist"][0].cpu(), g["loss0"]),
                grad0=rel_err(single["grad_hist"][0].cpu(), g["grad0"]))
    errs.update({k: rel_err(single[k].cpu(), g[k]) for k in ("loss_hist", "dist_hist", "latent_err_hist",
                                                             "final_latent", "final_chamfer")})
    print(f"shape-space inertia, {int(round(c['run_time'] * 30))} frames: single 2 steps {w1:.3f} s ({r1} device "
          f"reads; {q1[0]} decoder queries = K4 launches), sweep B={SSI_B} 2 steps {wb:.3f} s ({rb} device reads; "
          f"{qb[0]} K4 launches); d loss / d latent {single['grad_hist'][0].tolist()} vs JAX {g['grad0'].tolist()}; "
          "vs JAX golden " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {RTOL_SSI:g})")
    failed += [f"shape-space inertia {k}" for k, v in errs.items() if not v <= RTOL_SSI]
    last = ssi.fit(net, targets[-1], starts[-1], axes[-1], c, cfg, "cuda", max_iter=2)
    failed += lanes_vs_single("shape-space inertia", sweep, ((0, single), (SSI_B - 1, last)),
                              ("loss_hist", "grad_hist", "dist_hist", "final_latent"), RTOL_INERTIA_LANE)
    check(not failed, "inertia: " + "; ".join(failed))
    for tag, fn in (("a primitives (box) step", lambda: op.fit(*(torch.tensor(g0[k], device="cuda") for k in (
                        "target", "start", "axis")), c0, op.build_cfg(c0), "cuda", max_iter=1)),
                    ("a shape-space inertia step", lambda: ssi.fit(net, targets[0], starts[0], axes[0], c, cfg,
                                                                   "cuda", max_iter=1))):
        pwall, busy, _ = busy_share(fn)
        print(f"inertia, profiled {tag} (target spin, spin and backward): wall {pwall:.1f} ms, device busy "
              f"{busy:.1f} ms (idle {100 - 100 * busy / pwall:.1f}%)")
    return dict(single=n1, sweep=nb)


def torus_grid(res, r_maj=0.55, r_min=0.25):
    """tests/test_marching_body.py's torus SDF on a res^3 grid over [-1, 1]^3."""
    lin = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt((np.sqrt(x**2 + z**2) - r_maj) ** 2 + y**2) - r_min


def mesh_traj_check(tag, traj, g, prefix):
    """Discrete decisions equal to the golden's, poses within ATOL_MESH_POSE."""
    for k in DECISIONS:
        check(np.array_equal(getattr(traj, k).cpu().numpy(), g[f"{prefix}_{k}"]), f"{tag}: {k} differs from JAX")
    valid = g[f"{prefix}_valid"]
    errs = {k: float(np.abs(getattr(traj, k).detach().cpu().numpy() - g[f"{prefix}_{k}"])[valid].max())
            for k in ("pos", "quat")}
    check(max(errs.values()) <= ATOL_MESH_POSE, f"{tag}: poses differ from JAX: {errs}")
    return errs


def torus_world(grid, scale, device, **body_kw):
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import (BoxShape, Gravity3D, GridShape, TotalConstraint3D, make_body,
                                          make_world)

    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device=device)
    tor = make_body(GridShape(grid, scale), mesher="marching", device=device, **body_kw)
    return make_world([floor, tor], [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]],
                      np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)),
                      cfg=SimConfig(**TORUS_CFG), device=device)


def phase_meshes():
    """The trained shape space and the remaining body builders on CUDA:
    igr_train at full width (latent 2, (128,)*8, skip at 4, 4 shapes, 512
    points a step) for IGR_STEPS steps on the card and on the CPU port from
    the same draws (it trains through the plain decoder: no K4 launch); the
    trained space through optim_shapespace's trained_space branch (its
    cache) dropped and one Adam step (K4, K1, K2; no K3); the marble in the
    bowl (30 frames) and the 14^3 torus drop with d loss / d scale (16
    frames) against the JAX goldens (the same discrete decisions, poses
    within ATOL_MESH_POSE, the derivative within 1e-6 relative); and the
    torus on a 64^3 grid (the grid path's size) with the default max_tris:
    its MeshSDF correction one K5 launch, its drop's K5 launches counted
    against grid queries, K1 launched, K3 never (grid and bowl pairs take
    the plain search)."""
    import tempfile

    import torch
    from diffsdfsim_torch import interop
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.experiments import optim_shapespace as oss
    from diffsdfsim_torch.models.igr_train import train_tiny_shapespace
    from diffsdfsim_torch.ops import grid_cuda
    from diffsdfsim_torch.physics import (BowlShape, Gravity3D, GridShape, SphereShape, TotalConstraint3D,
                                          make_body, make_world, rollout)

    # igr_train, card against CPU
    runs = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        t0 = time.perf_counter()
        runs[dev] = train_tiny_shapespace(torch.Generator().manual_seed(7), dims=(128,) * 8, n_steps=IGR_STEPS,
                                          n_pts=512, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            check(read_counts()["igr_mlp"] == 0, "igr_train launched K4: it trains through implicit_net_apply")
        runs[dev + "_s"] = time.perf_counter() - t0
    (net, codes, loss), (net_c, codes_c, loss_c) = runs["cuda"], runs["cpu"]
    e_loss = rel_err(float(loss), float(loss_c))
    e_w = max(float((a.cpu() - b).abs().max()) for a, b in zip(net.params().weights + net.params().biases + (codes,),
                                                              net_c.params().weights + net_c.params().biases + (codes_c,)))
    print(f"igr_train (128,)*8, 4 shapes, 512 points, {IGR_STEPS} steps: card {runs['cuda_s']:.2f} s, CPU "
          f"{runs['cpu_s']:.2f} s; last loss {float(loss):.6e} vs CPU rel {e_loss:.2e} (tol 1e-9); weights, biases "
          f"and codes max abs diff {e_w:.2e} (tol 1e-9)")
    check(e_loss <= 1e-9 and e_w <= 1e-9, "igr_train: the card's training differs from the CPU port's")

    # the trained space through optim_shapespace's trained_space branch
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "space.pkl")
        interop.write_space(cache, net, codes)
        c = dict(oss.DEFAULTS, trained_space=True, space_cache=cache)
        dec, dcodes = oss.load_decoder(c, "cuda")
    cfg = oss.build_cfg(c)
    target, start, quat0 = oss.draw_problem(dcodes, torch.Generator().manual_seed(0))
    with counted_decodes() as q:
        reset_counts()
        out, wall, reads = synced(lambda: oss.fit(dec, target, start, quat0, c, cfg, "cuda", max_iter=1))
        counts = read_counts()
    check(counts["igr_mlp"] == q[0] > 0 and counts["pdipm_fwd"] > 0 and counts["kkt_bwd"] > 0
          and counts["fw_search"] == 0, f"trained-space fit: launches {counts} for {q[0]} decoder queries")
    check(bool(torch.isfinite(out["loss_hist"]).all() and torch.isfinite(out["grad_hist"]).all()),
          "trained-space fit: loss or gradient not finite")
    print(f"trained-space drop ({int(round(c['run_time'] * 30))} frames) and one Adam step: {wall:.3f} s, "
          f"{reads} device reads; launches {counts} ({q[0]} decoder queries); loss {float(out['loss_hist'][0]):.6e}, "
          f"d loss / d latent {out['grad_hist'][0].tolist()}")

    # the marble in the bowl
    g = dict(np.load(MESH_GOLDEN.format("bowl")))
    reset_counts()

    def marble():
        bowl = make_body(BowlShape(torch.tensor(1.0), torch.tensor(0.1)), custom_mesh=True, device="cuda")
        ball = make_body(SphereShape(torch.tensor(0.2)), subdiv=1, fric_coeff=0.3, device="cuda")
        s = float(np.sqrt(0.5))
        spec, state = make_world([bowl, ball], [[s, -s, 0, 0, 0.0, 0.0, 0.0], [1.0, 0, 0, 0, 0.15, 1.2, 0.0]],
                                 np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                                 forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**BOWL_CFG), device="cuda")
        with torch.no_grad():
            return rollout(spec, state, 30)[1]

    traj, wall, reads = synced(marble)
    counts = read_counts()
    check(counts["pdipm_fwd"] > 0 and counts["fw_search"] == 0, f"marble in bowl: launches {counts}")
    errs = mesh_traj_check("marble in bowl", traj, g, "bowl")
    print(f"marble in bowl, 30 frames: {wall:.3f} s, {reads} device reads, {int(traj.valid.sum())} substeps; "
          f"launches {counts}; vs JAX golden " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    # the torus: 14^3 against JAX, then 64^3
    g = dict(np.load(MESH_GOLDEN.format("torus")))
    queries, query = [0], grid_cuda.grid_query

    def counted_query(*a, **k):
        queries[0] += 1
        return query(*a, **k)

    grid_cuda.grid_query = counted_query
    try:
        grid14 = torch.tensor(torus_grid(14), device="cuda")
        scale = torch.tensor(1.0, dtype=torch.float64, device="cuda", requires_grad=True)
        reset_counts()
        queries[0] = 0

        def torus14():
            spec, state = torus_world(grid14, scale, "cuda")
            final, traj = rollout(spec, state, 16)
            loss = torch.sum(final.pos[1] ** 2)
            return spec, traj, loss, torch.autograd.grad(loss, scale)[0]

        (spec, traj, loss, dscale), wall, reads = synced(torus14)
        counts, nq = read_counts(), queries[0]
        check(counts["grid_query"] == nq > 0 and counts["pdipm_fwd"] > 0 and counts["kkt_bwd"] > 0
              and counts["fw_search"] == 0, f"torus 14^3: launches {counts} for {nq} grid queries")
        tris = spec.bodies[1].verts.detach().reshape(-1, 3, 3).cpu()
        check(tris.shape == g["torus_tris"].shape
              and float((tris - torch.tensor(g["torus_tris"])).abs().max()) <= 1e-12,
              "torus 14^3: triangles differ from JAX's valid ones")
        errs = mesh_traj_check("torus 14^3", traj, g, "torus")
        e_d = rel_err(float(dscale), float(g["torus_dscale"]))
        print(f"torus 14^3 ({tris.shape[0]} triangles), 16 frames with d loss / d scale: {wall:.3f} s, {reads} device "
              f"reads; launches {counts} ({nq} grid queries); vs JAX golden "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f", d loss / d scale {float(dscale):.10e} vs {float(g['torus_dscale']):.10e} rel {e_d:.2e} (tol 1e-6)")
        check(e_d <= 1e-6, "torus 14^3: d loss / d scale differs from JAX")

        grid64 = torch.tensor(torus_grid(64), device="cuda")
        one = torch.tensor(1.0, dtype=torch.float64, device="cuda")
        reset_counts()
        queries[0] = 0
        t0 = time.perf_counter()
        tor = make_body(GridShape(grid64, one), mesher="marching", device="cuda")
        torch.cuda.synchronize()
        build_s, build_counts = time.perf_counter() - t0, read_counts()
        check(build_counts["grid_query"] == queries[0] == 1, f"torus 64^3 body: {build_counts} for {queries[0]} queries")
        reset_counts()
        queries[0] = 0

        def torus64():
            spec, state = torus_world(grid64, one, "cuda")
            with torch.no_grad():
                return rollout(spec, state, 16)[1]

        traj, wall, reads = synced(torus64)
        counts, nq = read_counts(), queries[0]
    finally:
        grid_cuda.grid_query = query
    check(counts["grid_query"] == nq > 0 and counts["pdipm_fwd"] > 0 and counts["fw_search"] == 0,
          f"torus 64^3: launches {counts} for {nq} grid queries")
    ys = torch.where(traj.valid, traj.pos[:, :, 1, 1], torch.full_like(traj.pos[:, :, 1, 1], float("inf")))
    min_y = float(ys.min())
    print(f"torus 64^3 body: {tor.faces.shape[0]} triangles (max_tris {8 * 64 * 64}) built in {build_s:.3f} s "
          f"({build_counts['grid_query']} K5 launch); 16 frames {wall:.3f} s, {reads} device reads, "
          f"{int(traj.valid.sum())} substeps; launches {counts} ({nq} grid queries); lowest centre {min_y:.4f} m")
    check(0.2 < min_y < 0.35, f"torus 64^3: not resting on the floor (lowest centre {min_y})")
    for tag, fn in (("the marble in the bowl", marble), ("the 64^3 torus's 16 frames", torus64)):
        pwall, busy, _ = busy_share(fn)
        print(f"meshes, profiled {tag}: wall {pwall:.1f} ms, device busy {busy:.1f} ms "
              f"(idle {100 - 100 * busy / pwall:.1f}%)")
    return counts


SCENES2D_GOLDEN = os.path.join(ROOT, "tests", "golden", "scenes2d_f64.npz")
FALLBACK_GOLDEN = os.path.join(ROOT, "tests", "golden", "fallback_f64.npz")
# the JAX package's 2D scenes on the card, uncut (tests/scenes2d.py)
PHASE_2D_CASES = ("circle_fw", "circle_analytic", "hull_stack_fw", "hull_stack_analytic", "stack_fw",
                  "stack_analytic", "hulls_fw", "hulls_analytic", "pendulum", "fixed", "grid")
# those the CPU port also runs in the phase, the card held against it (the
# others' plain searches over hull and grid SDFs take 10-90 s of one CPU
# thread each)
PHASE_2D_CPU = ("circle_fw", "circle_analytic", "stack_fw", "stack_analytic", "hulls_analytic", "pendulum", "fixed",
                "grid_low")
# the gradients on the card: the circle's radius (analytic narrowphase), the
# grid's values (plain search) from 1 m over 25 frames and from 0.05 m over 8
PHASE_2D_GRADS = ("grad_circle", "grad_grid", "grad_grid_low")
# poses and velocities against the JAX golden and the CPU port (the CPU
# tests' tolerance; the CPU port reads 1e-10..1e-16 on these scenes); a
# Frank-Wolfe scene up to its first contact parting (scenes2d.hold: a tie
# must be witnessed there); gradients relative
ATOL_2D_POSE, RTOL_2D_GRAD = 1e-8, 1e-6
# K3 launches the scenes must make: a pair of circles and rects (cylinder and
# box kinds) under the Frank-Wolfe search; hull and grid pairs take the plain
# search, the analytic narrowphase none
K3_2D_CASES = ("circle_fw", "stack_fw", "hulls_fw")
K1_FREE_2D = ("pendulum", "fixed")  # no contact pair


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def scenes2d_module():
    """tests/scenes2d.py (numpy only at import; the port's namespace)."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import scenes2d

    return scenes2d


def phase_2d():
    """The 2D facade on CUDA: the JAX package's 2D scenes uncut (the circle
    drop on a 20 x 1 Rect, the hull-on-hull stack, the parity scenes under
    both narrowphases, the revolute pendulum, the fixed joint, the 65 x 65
    grid-circle drop), each against its JAX golden (scenes2d_f64.npz) and
    the cheap ones also against the CPU port: the same discrete decisions,
    poses within ATOL_2D_POSE, a Frank-Wolfe scene up to its first contact
    parting where a tie is witnessed (scenes2d.hold). Launches per scene:
    K3 on the circle / rect pairs under the search, none under the analytic
    narrowphase, K1 on every contact scene. The gradients: d(final height) /
    d(radius) of the circle drop under the analytic narrowphase and d(final
    height) / d(grid values) of the grid drop (K1, K2; the grid's plain
    search), against the golden and the CPU port within RTOL_2D_GRAD (the
    25-frame grid gradient is past its touchdown's tie and reported)."""
    import torch

    S = scenes2d_module()
    golden = dict(np.load(SCENES2D_GOLDEN))
    Pg, Pc = S.namespace("torch", DEVICE), S.namespace("torch", "cpu")
    failed = []
    for case in PHASE_2D_CASES + tuple(c for c in PHASE_2D_CPU if c not in PHASE_2D_CASES):
        runs = {}
        for dev, P in ((DEVICE, Pg), ("cpu", Pc)):
            if dev == "cpu" and case not in PHASE_2D_CPU:
                continue
            (spec, state), n = S.build(P, case)
            syncs0 = spec.host_syncs
            reset_counts()
            if dev != "cpu":
                (_, traj), wall, reads = synced(lambda: P.rollout(spec, state, n))
                counts = read_counts()
            else:
                t0 = time.perf_counter()
                _, traj = P.rollout(spec, state, n)
                wall, reads = time.perf_counter() - t0, None
            runs[dev] = (spec, S.traj_numpy(traj), wall)
            if dev != "cpu":
                tr = runs[dev][1]
                print(f"2d {case} (cuda): {n} frames in {wall:.2f} s, {int(tr['valid'].sum())} substeps, launches "
                      f"K1 {counts['pdipm_fwd']} K3 {counts['fw_search']} K2 {counts['kkt_bwd']}, host reads "
                      f"{spec.host_syncs - syncs0}, device reads {reads}")
                if case in K3_2D_CASES:
                    check(counts["fw_search"] > 0, f"2d {case}: no K3 launch on a circle / rect pair")
                if case.endswith("_analytic") or case.startswith(("hull_stack", "grid")) or case in K1_FREE_2D:
                    check(counts["fw_search"] == 0, f"2d {case}: K3 launched ({counts['fw_search']})")
                if case not in K1_FREE_2D:
                    check(counts["pdipm_fwd"] > 0, f"2d {case}: no K1 launch")
        for dev, (spec, tr, _) in runs.items():
            ok, _, line = S.hold_run(spec, tr, golden, case, ATOL_2D_POSE)
            print(f"2d {dev} vs JAX {line}")
            if not ok:
                failed.append(f"{case} {dev} vs JAX")
        if "cpu" in runs:
            (sg, trg, wg), (sc, trc, wc) = runs[DEVICE], runs["cpu"]
            fw = case in S.FW_CASES
            ok, _, line = S.hold(trg, trc, ATOL_2D_POSE, f"{case} card vs CPU port",
                                 S.port_contacts_at(sg, trg) if fw else None,
                                 S.port_contacts_at(sc, trc) if fw else None)
            print(f"2d {line} (CPU {wc:.2f} s)")
            if not ok:
                failed.append(f"{case} card vs CPU")

    for name in PHASE_2D_GRADS:
        n = S.GRADS[name][2]
        res = {}
        for dev, P in ((DEVICE, Pg), ("cpu", Pc)):
            if dev == "cpu" and name == "grad_grid":
                continue  # 10 s of one CPU thread; the card is held against JAX up to its tie
            param = torch.tensor(S.grad_param(name), dtype=torch.float64, device=dev, requires_grad=True)
            reset_counts()
            t0 = time.perf_counter()
            spec, state = S.grad_world(P, name, param)
            final, traj = P.rollout(spec, state, n)
            (g,) = torch.autograd.grad(final.pos[1, 1], param)
            if dev != "cpu":
                sync()
            wall = time.perf_counter() - t0
            res[dev] = (float(final.pos[1, 1].detach()), g.detach().cpu().numpy(), spec, S.traj_numpy(traj))
            if dev != "cpu":
                counts = read_counts()
                print(f"2d {name} (cuda): {n} frames fwd+bwd {wall:.2f} s, launches K1 {counts['pdipm_fwd']} "
                      f"K3 {counts['fw_search']} K2 {counts['kkt_bwd']}")
                check(counts["pdipm_fwd"] > 0 and counts["kkt_bwd"] > 0, f"2d {name}: K1 or K2 not launched")
                check(counts["fw_search"] == 0, f"2d {name}: K3 launched (analytic narrowphase / grid pairs)")
        val, g, spec, tr = res[DEVICE]
        e_val = abs(val - float(golden[f"{name}/value"]))
        e_g = rel_err(g, golden[f"{name}/grad"])
        held = True
        if name.startswith("grad_grid"):
            ok, held, line = S.hold_run(spec, tr, golden, name[5:], ATOL_2D_POSE)
            print(f"2d {name} cuda vs JAX {line}")
            if not ok:
                failed.append(f"{name} trajectory")
        print(f"2d {name}: height {val:.12f} ({e_val:.2e} from JAX's), gradient {e_g:.2e} (relative) from JAX's"
              + ("" if held else " (past the witnessed tie: reported)")
              + ("" if "cpu" not in res else f", {rel_err(g, res['cpu'][1]):.2e} from the CPU port's"))
        if held and not (e_val <= ATOL_2D_POSE and e_g <= RTOL_2D_GRAD):
            failed.append(f"{name} against JAX")
        if "cpu" in res and not rel_err(g, res["cpu"][1]) <= RTOL_2D_GRAD:
            failed.append(f"{name} card vs CPU")
    check(not failed, f"2d: {failed}")


def phase_fallback():
    """The solver fallback and post-stabilization on the lane axis on CUDA:
    JAX tests/test_qp.py:139-165's under-iterated LCP through
    pdipm_solve_checked (its generic rows are not K1's layout: the plain
    solver on the card) against the JAX golden; bench LCPs under-solved by
    K1 (one iteration) and relaunched once on the whole batch, against the
    plain fallback within 1e-10; the bench world with solver_max_iter=2 and
    the fallback, 20 frames, single (radius 0.5 and 0.58) and at B = 16
    (lane 0 at 0.5, lane 15 at 0.58) against the JAX goldens at the bench's
    tolerances and lanes against the single path, one fallback read per
    probe solve, one re-solve (one K1 launch) of the whole batch per
    triggering stage; and a 16-lane post-stabilized sweep (the sideways
    sphere of tests/test_batched.py, 10 frames) lane by lane against the
    single path, as phase_batched holds lanes, and the golden's three radii
    against JAX."""
    import torch
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops import qp as tqp
    from diffsdfsim_torch.ops.qp_cuda import pdipm_fric
    from diffsdfsim_torch.physics import (BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world,
                                          make_world_batched, rollout, rollout_batched, trajectory_lanes_first)

    g = dict(np.load(FALLBACK_GOLDEN))
    dev = DEVICE
    # the JAX package's test problem
    args = [torch.tensor(g[f"qp/{k}"], dtype=torch.float64, device=dev) for k in "Q p G h A b F".split()]
    for it in (1, 20):
        sol, res, bad = tqp.pdipm_solve_checked(*args, max_iter=it, eps=1e-12, fallback_iters=25, fallback_thresh=1e-6)
        err = max(float(np.abs(x.cpu().numpy() - g[f"qp/it{it}/{k}"]).max()) for k, x in zip("xyzs", sol))
        print(f"fallback: test_qp's LCP at {it} iterations: fell back {bool(bad)} (JAX {bool(g[f'qp/it{it}/fell_back'])}),"
              f" solution {err:.2e} from JAX's, residual {float(res.max()):.2e}")
        check(bool(bad) == bool(g[f"qp/it{it}/fell_back"]) and err <= 1e-10, "fallback: test_qp's LCP differs from JAX")
    # K1 relaunched on under-solved bench LCPs
    for B in (3, 16):
        Q, p, G, h, A, b, F, invQ = physics_lcps(B, seed=B, device=dev, dtype=torch.float64)
        lcp, structure = (Q, p, G, h, A, b, F), ("fric", 4, 8)
        rough = pdipm_fric(*lcp, invQ, 1, 1e-12, 3, structure)
        n0 = pdipm_fric.launches
        sol = tqp.escalated_resolve(*lcp, invQ, rough, iters_hi=30, eps=1e-12, thresh=1e-3, structure=structure,
                                    read=bool)
        sync()
        relaunches = pdipm_fric.launches - n0
        plain = tqp.pdipm_solve_raw(*lcp, 30, 1e-12, 6, structure)
        err = float((sol[0] - plain[0]).abs().max())
        print(f"fallback: K1 at 1 iteration on {B} bench LCPs: residual {float(tqp.lcp_residuals(*lcp, rough).max()):.2e}"
              f", {relaunches} relaunch at 30 iterations: x {err:.2e} from the plain fallback's, residual "
              f"{float(tqp.lcp_residuals(*lcp, sol).max()):.2e}")
        check(relaunches == 1 and err <= 1e-10, f"fallback: K1's relaunch ({relaunches}) or its x ({err:.2e})")

    fb_cfg = dict(BENCH_CFG, solver_max_iter=2, solver_fallback=True)
    ps_cfg = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=1, max_substeps=4,
                  max_bisect=4, post_stab=True)
    floors = {}

    def world(rad, cfg_kw, floor_subdiv, sphere_subdiv, v_side, device=dev):
        key = (floor_subdiv, device)
        if key not in floors:
            floors[key] = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=floor_subdiv, fric_coeff=0.25,
                                    device=device)
        sphere = make_body(SphereShape(rad), subdiv=sphere_subdiv, fric_coeff=0.25, device=device)
        vels = np.zeros((2, 6))
        vels[1, 3] = v_side
        return make_world([floors[key], sphere], [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]],
                          vels, joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)),
                          cfg=SimConfig(**cfg_kw), device=device)

    def np_traj(traj):
        return {k: v.detach().cpu().numpy() for k, v in traj._asdict().items()}

    def golden_of(key):
        return {k: g[f"{key}/{k}"] for k in ("pos", "quat", "v", "valid", "n_halvings", "bisect_failed",
                                             "truncated")}

    singles = {}
    for rad in (0.5, 0.58):
        spec, state = world(torch.tensor(rad, dtype=torch.float64, device=dev), fb_cfg, 3, 2, 0.0)
        reset_counts()
        t0 = time.perf_counter()
        _, traj = rollout(spec, state, 20)
        sync()
        wall, counts = time.perf_counter() - t0, read_counts()
        singles[rad] = np_traj(traj)
        errs = compare_traj(singles[rad], golden_of(f"fb{rad}"), f"fallback single {rad}")
        print(f"fallback: bench at radius {rad}, max_iter 2, 20 frames in {wall:.2f} s: launches K1 "
              f"{counts['pdipm_fwd']} K3 {counts['fw_search']}, fallback reads {spec.host_reads['fallback']}, "
              f"re-solves {spec.stages['resolve']}; against JAX: height {errs['pos_y']:.2e}, "
              f"vertical velocity {errs['v_y']:.2e}")
        check(spec.stages["resolve"] > 0, "fallback: the under-iterated bench triggered no re-solve")
    rads = np.linspace(0.42, 0.58, 16)
    rads[0] = 0.5
    r = torch.tensor(rads, dtype=torch.float64, device=dev)
    spec, bodies_b, state_b = make_world_batched(lambda x: world(x, fb_cfg, 3, 2, 0.0), r)
    reset_counts()
    t0 = time.perf_counter()
    _, traj = rollout_batched(spec, bodies_b, state_b, 20)
    sync()
    wall, counts = time.perf_counter() - t0, read_counts()
    lanes = np_traj(trajectory_lanes_first(traj))
    print(f"fallback: bench sweep B = 16, 20 frames in {wall:.2f} s: stages {dict(spec.stages)}, host reads "
          f"{dict(spec.host_reads)}, launches K1 {counts['pdipm_fwd']} K3 {counts['fw_search']}")
    check(spec.host_reads["fallback"] == spec.stages["lcp"] and 0 < spec.stages["resolve"] <= spec.stages["lcp"],
          "fallback: not one read per probe solve, or no re-solve")
    check(counts["pdipm_fwd"] == spec.stages["lcp"] + spec.stages["resolve"],
          f"fallback: K1 launches {counts['pdipm_fwd']}, expected one per probe solve and one per re-solve")
    for i, rad in ((0, 0.5), (15, 0.58)):
        lane = {k: x[i] for k, x in lanes.items()}
        e_jax = compare_traj(lane, golden_of(f"fb{rad}"), f"fallback lane {i}")
        e_single = compare_traj(lane, singles[rad], f"fallback lane {i} vs single")
        print(f"fallback: lane {i} (radius {rad}) against JAX: height {e_jax['pos_y']:.2e}; against the single path: "
              f"height {e_single['pos_y']:.2e}, every component {max(e_single['pos'], e_single['v']):.2e}")

    # post-stabilization on the lane axis
    rads = np.linspace(0.45, 0.8, 16)
    rads[7] = 0.6
    r = torch.tensor(rads, dtype=torch.float64, device=dev)
    spec, bodies_b, state_b = make_world_batched(lambda x: world(x, ps_cfg, 2, 1, 2.0), r)
    reset_counts()
    t0 = time.perf_counter()
    _, traj = rollout_batched(spec, bodies_b, state_b, 10)
    sync()
    wall, counts = time.perf_counter() - t0, read_counts()
    lanes = np_traj(trajectory_lanes_first(traj))
    print(f"fallback: post-stabilized sweep B = 16, 10 frames in {wall:.2f} s: stages {dict(spec.stages)}, host reads "
          f"{dict(spec.host_reads)}, launches K1 {counts['pdipm_fwd']} K3 {counts['fw_search']}")
    check(spec.stages["post_stab_lcp"] > 0, "fallback: the post-stabilized sweep solved no LCP")
    for i in (0, 7, 15):
        s_spec, s_state = world(torch.tensor(rads[i], dtype=torch.float64, device=dev), ps_cfg, 2, 1, 2.0)
        _, s_traj = rollout(s_spec, s_state, 10)
        single = np_traj(s_traj)
        lane = {k: x[i] for k, x in lanes.items()}
        for k in DECISIONS:
            check(np.array_equal(lane[k], single[k]), f"post_stab lane {i}: {k} differs from the single path")
        d = max(float(np.abs(lane[k] - single[k]).max()) for k in ("pos", "quat", "v"))
        dy = float(np.abs(lane["pos"][..., 1, 1] - single["pos"][..., 1, 1]).max())
        line = f"post_stab lane {i} (radius {rads[i]:.4f}) vs the single path: height {dy:.2e}, every component {d:.2e}"
        key = f"ps{rads[i]:g}"
        if f"{key}/pos" in g:
            ref = golden_of(key)
            for k in DECISIONS:
                check(np.array_equal(single[k], ref[k]), f"post_stab single {rads[i]}: {k} differs from JAX's")
            dj = max(float(np.abs(single[k] - ref[k]).max()) for k in ("pos", "quat", "v"))
            line += f"; the single path vs JAX {dj:.2e}"
            check(dj <= 1e-8, f"post_stab single {rads[i]}: {dj:.2e} from JAX's")
        print(line)
        check(dy <= ATOL_Y and d <= ATOL_ALL, f"post_stab lane {i}: height {dy:.2e} / {d:.2e} from the single path")


LANES_GOLDEN = os.path.join(ROOT, "tests", "golden", "lanes_card_f64.npz")
DEMO_GOLDEN = os.path.join(ROOT, "tests", "golden", "demo_card_f64.npz")
# How the sweeps of grid, bowl, hull and 2D-grid bodies are held against
# the JAX goldens: the same discrete decisions, poses within the single
# scene's tolerance (the grid drop 1e-7, the marble 1e-7, the 2D scenes
# 1e-8; the 2D grid up to a witnessed tie), d / d scale and d height / d
# grid values within RTOL_LANE_GRAD relative; and each lane against the
# port's single path on the card over all frames: decisions equal, poses
# within ATOL_LANE_SINGLE, values and gradients within RTOL_LANE_SINGLE
# relative. A 2D grid lane is held at the 2D scenes' 1e-8: on an H100 the
# batched ops round a lane 1.8e-16 from its single run before its
# touchdown, which moves it 8.0e-10 there (the same under K1's per-lane
# stopping rule; the CPU lanes are bitwise their single runs). Where such
# a lane parts from its single run with no tie of the kept contacts, it is
# accepted only where the single world itself, restarted a frame before
# and moved by 1e-12 m, parts from itself there (scenes_lanes.hold_single:
# rounding decides those frames).
ATOL_LANE_JAX = {"grid": 1e-7, "bowl": 1e-7, "hull": 1e-8, "grid2d": 1e-8}
ATOL_LANE_SINGLE = {"grid": 1e-10, "bowl": 1e-10, "hull": 1e-10, "grid2d": 1e-8}
RTOL_LANE_GRAD, RTOL_LANE_SINGLE = 1e-6, 1e-8
# the demo's losses and latents against the JAX golden, relative
RTOL_DEMO = 1e-6
LANES_SIZE = "card"  # tests/scenes_lanes.py's size of the sweeps (the golden's)


def lanes_module():
    """tests/scenes_lanes.py (numpy only at import; the port's namespace)."""
    scenes2d_module()
    import scenes_lanes

    return scenes_lanes


def lane_sweeps(sweeps):
    """Seed sweeps of lane bodies of every shape class on CUDA
    (tests/scenes_lanes.py, card size), each against the JAX golden
    (lanes_card_f64.npz) and every lane against the port's single path on
    the card over all frames (a 2D grid lane up to a witnessed tie or to
    frames that rounding decides; its gradient, where the poses hold,
    reported where the kept contacts part at a witnessed tie). Returns the
    grid sweep's forward launches (None without it)."""
    import torch
    from diffsdfsim_torch.ops import grid_cuda, sdf
    from diffsdfsim_torch.physics import make_world_batched, rollout, rollout_batched, trajectory_lanes_first

    SL, S = lanes_module(), scenes2d_module()
    golden = dict(np.load(LANES_GOLDEN))
    P = SL.namespace("torch", DEVICE)
    failed, grid_counts = [], None
    queries, volumes = [0], [0]
    query, volume = grid_cuda.grid_query, sdf.grid_grad_volume

    def counted_query(*args, **kwargs):
        queries[0] += 1
        return query(*args, **kwargs)

    def counted_volume(grid):
        volumes[0] += 1
        return volume(grid)

    for sweep in sweeps:
        n, body = SL.frames(sweep, LANES_SIZE), 2 if sweep == "hull" else 1
        diff = {"grid": 1, "grid2d": 0}.get(sweep)
        build = SL.world_fn(P, sweep, LANES_SIZE)

        def inputs(grad):
            ins = [torch.tensor(x, device=DEVICE) for x in SL.inputs(sweep, LANES_SIZE)]
            if grad:
                ins[diff].requires_grad_(True)
            return ins

        # forward, counted
        spec, bodies_b, state_b = make_world_batched(build, *inputs(False))
        B = state_b.pos.shape[0]
        grid_cuda.grid_query, sdf.grid_grad_volume = counted_query, counted_volume
        try:
            queries[0] = volumes[0] = 0
            reset_counts()
            with torch.no_grad():
                (_, traj), wall, reads = synced(lambda: rollout_batched(spec, bodies_b, state_b, n))
            counts, nq, nv = read_counts(), queries[0], volumes[0]
        finally:
            grid_cuda.grid_query, sdf.grid_grad_volume = query, volume
        tr = {k: v.detach().cpu().numpy() for k, v in trajectory_lanes_first(traj)._asdict().items()}
        print(f"lanes {sweep} (B = {B}, {n} frames) forward: {wall:.2f} s, {int(tr['valid'].sum())} lane substeps, "
              f"stages {dict(spec.stages)}, host reads {sum(spec.host_reads.values())}, device reads {reads}; "
              f"launches {counts}; {nq} grid queries, {nv} gradient volumes")
        check(counts["fw_search"] == 0 and counts["pdipm_fwd"] == spec.stages["lcp"] > 0,
              f"lanes {sweep}: launches {counts} for {spec.stages['lcp']} probe stages that solve the LCP (no K3)")
        if sweep == "grid":
            check(counts["grid_query_lanes"] == nq > 0 and counts["grid_query"] == 0 and nv == 0,
                  f"lanes grid: {counts['grid_query_lanes']} lane launches, {counts['grid_query']} single launches "
                  f"for {nq} grid queries of the batch; {nv} gradient volumes built")
            grid_counts = counts
        # fwd+bwd where the sweep differentiates
        value = grad = None
        if diff is not None:
            ins = inputs(True)
            spec_g, bodies_g, state_g = make_world_batched(build, *ins)
            reset_counts()
            t0 = time.perf_counter()
            final, traj_g = rollout_batched(spec_g, bodies_g, state_g, n)
            heights = final.pos[:, body, 1]
            # a lane's height depends on its own input alone: the gradient
            # of their sum holds each lane's in its slice
            (grad,) = torch.autograd.grad(heights.sum(), ins[diff])
            sync()
            wall_g, counts_g = time.perf_counter() - t0, read_counts()
            value, grad = heights.detach().cpu().numpy(), grad.cpu().numpy()
            check(counts_g["kkt_bwd"] == spec_g.stages["replay_lcp"] > 0 and counts_g["fw_search"] == 0,
                  f"lanes {sweep} fwd+bwd: launches {counts_g} for {spec_g.stages['replay_lcp']} taped replays")
            print(f"lanes {sweep} fwd+bwd: {wall_g:.2f} s, launches {counts_g}")
        # against JAX
        for i in range(B):
            a = {k: v[i] for k, v in tr.items()}
            tag = f"lanes {sweep} lane {i} vs JAX"
            if sweep == "grid2d":
                single_spec, _ = build(torch.tensor(SL.inputs(sweep, LANES_SIZE)[0][i], device=DEVICE))
                ok, held, line = SL.hold_lane(a, golden, sweep, i, ATOL_LANE_JAX[sweep], tag,
                                              S.port_contacts_at(single_spec, a))
                if held:
                    e_v = abs(float(value[i]) - float(golden["grid2d/value"][i]))
                    e_g = rel_err(grad[i], golden["grid2d/grad"][i])
                    line += f"; height {e_v:.2e} from JAX's, d height / d grid {e_g:.2e} (relative)"
                    ok = ok and e_v <= ATOL_LANE_JAX[sweep]
                    if e_g > RTOL_LANE_GRAD:
                        # the poses hold; a gradient may still part at a tie of the kept points
                        tie = SL.kept_contacts_tie(a, {k: golden[f"grid2d/{k}"][i] for k in S.TRAJ_KEYS},
                                                   S.port_contacts_at(single_spec, a),
                                                   SL.golden_contacts(golden, "grid2d", i))
                        ok = ok and tie is not None
                        line += ("; no tie of the kept contacts witnessed" if tie is None else
                                 f" (reported, not held: the kept contacts part at frame {tie[0]} substep {tie[1]}, "
                                 f"points {tie[2]:.3e} m apart, deepest penetrations {tie[3]:.1e} apart: a tie)")
            else:
                b = {k: golden[f"{sweep}/{k}"][i] for k in S.TRAJ_KEYS}
                ok, _, line = S.hold(a, b, ATOL_LANE_JAX[sweep], tag)
            print(line)
            if not ok:
                failed.append(tag)
        if sweep == "grid":
            e_v = abs(float(value.sum()) - float(golden["grid/value"]))
            e_g = rel_err(grad, golden["grid/grad"])
            print(f"lanes grid: summed final height {float(value.sum()):.12f} ({e_v:.2e} from JAX's), d / d scales "
                  f"{e_g:.2e} (relative) from JAX's")
            if not (e_v <= ATOL_LANE_JAX["grid"] and e_g <= RTOL_LANE_GRAD):
                failed.append("lanes grid value / gradient vs JAX")
        # every lane against the single path on the card, over all frames
        worst = {}
        for i in range(B):
            ins = [torch.tensor(x[i], device=DEVICE) for x in SL.inputs(sweep, LANES_SIZE)]
            if diff is not None:
                ins[diff].requires_grad_(True)
            s_spec, s_state = build(*ins)
            with torch.set_grad_enabled(diff is not None):
                final, s_traj = rollout(s_spec, s_state, n)
                if diff is not None:
                    (g1,) = torch.autograd.grad(final.pos[body, 1], ins[diff])
                    e_g, e_v = rel_err(grad[i], g1.cpu().numpy()), rel_err(value[i], float(final.pos[body, 1].detach()))
            single = S.traj_numpy(s_traj)
            a = {k: v[i] for k, v in tr.items()}
            tag = f"lanes {sweep} lane {i} vs single"
            if sweep == "grid2d":
                ok, held, line = SL.hold_single(
                    a, single, ATOL_LANE_SINGLE[sweep], tag, S.port_contacts_at(s_spec, a),
                    S.port_contacts_at(s_spec, single),
                    lambda fp: SL.rounding_parting(P, s_spec, s_state, single, fp, body, ATOL_LANE_SINGLE[sweep]))
            else:
                ok, held, line = S.hold(a, single, ATOL_LANE_SINGLE[sweep], tag)
            if not held:  # parted: at a witnessed tie, or where rounding decides, where ok
                per_frame = [max(float(np.abs(a[k][f] - single[k][f]).max()) for k in ("pos", "quat", "v"))
                             for f in range(a["pos"].shape[0])]
                print(line + "; per frame " + ", ".join(f"{d:.1e}" for d in per_frame))
                if not ok:
                    failed.append(tag)
                continue
            worst["poses"] = max(worst.get("poses", 0.0), S.compare(a, single)[1])
            if diff is not None and max(e_g, e_v) > RTOL_LANE_SINGLE:
                tie = SL.kept_contacts_tie(a, single, S.port_contacts_at(s_spec, a), S.port_contacts_at(s_spec, single))
                print(f"{tag}: value {e_v:.2e}, gradient {e_g:.2e} (relative) "
                      + ("with no tie of the kept contacts witnessed" if tie is None else
                         f"(reported, not held: the kept contacts part at frame {tie[0]} substep {tie[1]}, points "
                         f"{tie[2]:.3e} m apart, deepest penetrations {tie[3]:.1e} apart: a tie)"))
                ok = ok and tie is not None
            elif diff is not None:
                worst["grad"], worst["value"] = max(worst.get("grad", 0.0), e_g), max(worst.get("value", 0.0), e_v)
            if not ok:
                failed.append(tag)
        print(f"lanes {sweep}: the lanes held throughout against the single path on the card: "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
        if sweep in ("grid", "bowl"):
            pwall, busy, _ = busy_share(lambda: rollout_batched(spec, bodies_b, state_b, n))
            print(f"lanes {sweep}, profiled forward: wall {pwall:.1f} ms, device busy {busy:.1f} ms "
                  f"(idle {100 - 100 * busy / pwall:.1f}%)")
    check(not failed, f"lanes: {failed}")
    return grid_counts


def phase_lanes_3d():
    """The 3D sweeps of lane bodies that differ between lanes (lane_sweeps):

    - the grid sweep: 16 voxelized spheres of their own radius on 64^3
      float64 grids, each with its own scale requiring grad, dropped for 16
      frames (the grid path's scene); forward, then fwd+bwd of the summed
      final heights with respect to the scales. The forward makes exactly
      one K5 lane launch per grid query of the batch (queries counted as
      phase_grid_path counts them), no single launch, no gradient volume,
      no K3 launch;
    - the bowl sweep: the marble into 8 bowls of their own (r, d), 30
      frames, no gradient.

    Returns the grid sweep's forward launches (the kernels line's)."""
    return lane_sweeps(("grid", "bowl"))


def phase_lanes_2d():
    """The 2D sweeps (lane_sweeps): the hull stack under the analytic
    narrowphase at B = 4, the hulls scaled per lane, 8 frames; the 65 x 65
    grid-circle drop at B = 4, a circle of its own radius in each lane, 8
    frames, with each lane's d height / d grid values, held up to a
    witnessed tie (scenes_lanes.hold_lane)."""
    lane_sweeps(("hull", "grid2d"))


def phase_demo():
    """The MeshSDF demo (diffsdfsim_torch.demos.meshsdf) on CUDA at the JAX
    demo's defaults (30 frames, the body at mesh subdiv 2 with 16
    projection steps, fric_dirs 4), the decoder at the reference's full
    width (latent 2, (128,)*8, skip at 4) with the JAX demo's PRNGKey(7)
    weights (demo_card_f64.npz): 2 SGD iterations, each loss and latent
    within RTOL_DEMO of the JAX golden; the wall and K1-K4 launches of each
    iteration (the latent body's pairs take the plain search: no K3)."""
    import torch
    from diffsdfsim_torch.demos import meshsdf as D
    from diffsdfsim_torch.models.igr import ImplicitNet

    g = dict(np.load(DEMO_GOLDEN))
    dev = DEVICE
    nl = sum(1 for k in g if k.startswith("w"))
    decoder = ImplicitNet.from_arrays([g[f"w{i}"] for i in range(nl)], [g[f"b{i}"] for i in range(nl)],
                                      skip_in=tuple(int(i) for i in g["skip_in"]), device=DEVICE)
    c = dict(D.DEFAULTS, iters=int(g["iters"]), run_time=float(g["run_time"]))
    fixed = D.fixed_bodies(dev)
    walls, counts, last = [], [], [0.0]

    def log(msg):
        sync()
        now = time.perf_counter()
        walls.append(now - last[0])
        counts.append(read_counts())
        print(f"demo {msg}: {walls[-1]:.2f} s, launches {counts[-1]}")
        reset_counts()
        last[0] = time.perf_counter()

    reset_counts()
    last[0] = time.perf_counter()
    hist = D.optimize(decoder, torch.zeros(2, dtype=torch.float64, device=DEVICE), c, D.build_cfg(), fixed, log=log)
    for i, cnt in enumerate(counts):
        check(cnt["pdipm_fwd"] > 0 and cnt["kkt_bwd"] > 0 and cnt["igr_mlp"] > 0 and cnt["fw_search"] == 0,
              f"demo iteration {i}: launches {cnt}")
    e_loss = rel_err(hist["loss"], g["loss"])
    e_z = rel_err(np.stack(hist["latent"]), g["latent"])
    print(f"demo: {len(walls)} SGD iterations, wall per iteration {', '.join(f'{w:.2f}' for w in walls)} s; losses "
          f"{hist['loss']} ({e_loss:.2e} from JAX's, relative), latents {np.stack(hist['latent']).tolist()} "
          f"({e_z:.2e}), d loss / d latent {np.stack(hist['grad']).tolist()}")
    check(e_loss <= RTOL_DEMO and e_z <= RTOL_DEMO, f"demo: loss {e_loss:.2e} / latent {e_z:.2e} from JAX's")


# ---------------------------------------------------------------- the sharded sweep

SHARDING_GOLDEN = os.path.join(ROOT, "tests", "golden", "sharding_card_f64.npz")
# each lane's loss and updated radius between the runs and against the JAX
# golden: the 20-frame gradient gate (the decisions identical)
RTOL_SHARDING = RTOL_GRAD_SHORT[20]
SHARDING_WORKERS_ON_ONE_CARD = 4


def sharding_module():
    """tests/scenes_sharding.py (numpy only at import)."""
    scenes2d_module()
    import scenes_sharding

    return scenes_sharding


def lane_rel(a, b):
    """The largest per-lane relative difference of a from b."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_sharding():
    """The seed sweep split over worker processes (``diffsdfsim_torch.parallel``):
    ``dryrun_multichip``'s ``seed_step`` at the bench's scale
    (``tests/scenes_sharding.py``, ``card``: 16 lanes, 20 frames, fwd+bwd
    and the simulated update), unsharded in this process, over
    ``make_mesh()`` (a worker per visible card) and over four workers on
    card 0, two calls each (the second on the warm pool). Each call's lanes
    are held against the JAX golden (sharding_card_f64.npz) and against the
    unsharded run's first call: identical decisions, each lane's loss and
    updated radius within RTOL_SHARDING relative. Each chunk's K1, K3 and
    K2 launches, counted in its worker, must match its stages
    (``check_sweep``); the caller launches none while a mesh runs."""
    import functools

    import torch
    from diffsdfsim_torch.parallel import batched_rollout, make_mesh

    ss = sharding_module()
    g = dict(np.load(SHARDING_GOLDEN))
    B, T = ss.SIZES["card"]["lanes"], ss.SIZES["card"]["frames"]
    rads, drops = ss.seeds("card")
    check(np.array_equal(rads, g["rads"]) and np.array_equal(drops, g["drops"]), "sharding: the golden's seeds differ")
    batch = tuple(torch.tensor(x, device="cuda") for x in (rads, drops))
    fn = functools.partial(ss.seed_step, "card")
    ref = {}

    def run(tag, mesh):
        step = batched_rollout(fn, mesh, device="cuda", has_aux=True)
        for call in range(2):
            reset_counts()
            t0 = time.perf_counter()
            out, aux = step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            caller = read_counts()
            out = {k: v.cpu().numpy() for k, v in out.items()}
            label = f"sharding {tag}, call {call}"
            for i, (st, a) in enumerate(zip(step.stats, aux)):
                check_sweep(f"{label}, chunk {i}", st["launches"], a, len(st["lanes"]), taped=True)
            if mesh is None:
                check(caller == step.stats[0]["launches"], f"{label}: launches {caller} vs {step.stats[0]['launches']}")
            else:
                check(not any(caller.values()), f"{label}: the caller launched {caller} while the mesh ran")
            check(bool(out["bounced"].all()), f"{label}: lanes {np.nonzero(~out['bounced'])[0].tolist()} never "
                  "touched the floor")
            if not ref:
                ref.update(out)
            errs = {}
            for name, other in (("JAX golden", g), ("unsharded run", ref)):
                for key in ss.DECISIONS:
                    check(np.array_equal(out[key], other[key]), f"{label}: {key} differs from the {name}'s")
                for key in ("loss", "rad"):
                    errs[f"{key} vs {name}"] = e = lane_rel(out[key], other[key])
                    check(e <= RTOL_SHARDING, f"{label}: a lane's {key} is {e:.2e} from the {name}'s (relative; tol "
                          f"{RTOL_SHARDING:g})")
            errs["d_rad vs JAX golden"] = lane_rel(out["d_rad"], g["d_rad"])
            print(f"{label}: {wall:.3f} s wall = {B * T / wall:.2f} lane-steps/s ({B} lanes x {T} frames, fwd+bwd); "
                  + "; ".join(f"{st['device']} lanes {st['lanes'].start}-{st['lanes'].stop - 1} {st['seconds']:.3f} s, "
                              f"K1 {st['launches']['pdipm_fwd']} K3 {st['launches']['fw_search']} K2 "
                              f"{st['launches']['kkt_bwd']}, {a.host_syncs} host reads, {a.stages['substep']} substeps"
                              for st, a in zip(step.stats, aux)))
            print(f"{label}: decisions identical to the JAX golden's and the unsharded run's; max per-lane relative "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    run("unsharded (this process)", None)
    for tag, devices in (("every visible card", None), (f"{SHARDING_WORKERS_ON_ONE_CARD} workers on card 0",
                                                       ["cuda:0"] * SHARDING_WORKERS_ON_ONE_CARD)):
        t0 = time.perf_counter()
        with make_mesh(devices=devices) as mesh:
            print(f"sharding {tag}: {len(mesh)} workers on {[str(d) for d in mesh.devices]} started in "
                  f"{mesh.start_seconds:.2f} s ({time.perf_counter() - t0:.2f} s with make_mesh's kernel build check)")
            run(tag, mesh)


# The paths after the kernel checks, in groups that run as concurrent
# processes on the one card: every path is host-bound (the device is idle
# 93-96 % of each path's wall), so four processes share the card with
# little contention and the script ends well inside its time limit. Each
# group takes about the same wall; the kernel checks, whose times the
# ``kernels`` line reports, run before them with the card to themselves.
PATH_GROUPS = (
    ("phase_batched", "phase_grid_path", "phase_meshes", "phase_lanes_3d"),
    ("phase_sphere_sweep", "phase_pointcloud", "phase_latent_path", "phase_shapespace_sweep", "phase_demo",
     "phase_sharding"),
    ("phase_sysid_sweep", "phase_inertia", "phase_main_path", "phase_lanes_2d", "phase_float32"),
    ("phase_gradient", "phase_2d", "phase_fallback"),
)
# the paths whose results the kernels line reads (the others return None)
PATH_RESULTS = ("phase_main_path", "phase_gradient", "phase_grid_path", "phase_latent_path", "phase_lanes_3d",
                "phase_float32")
# the parent stops every group that is still running at this many seconds
# of script time, and fails
PATH_DEADLINE_S = 1120


def setup_torch(threads=None):
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if threads:
        torch.set_num_threads(threads)
    return torch


def timed(phase, t_start, tag=""):
    t0 = time.perf_counter()
    out = phase()
    print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s ({tag}script so far {time.perf_counter() - t_start:.1f} s)",
          flush=True)
    return out


def run_group(names, result_path, t_start, threads):
    """One group of paths in this process (a child of ``run_path_groups``):
    runs each phase in order and writes the results the kernels line reads
    to ``result_path`` (a pickle). A failing check raises, so the process
    exits non-zero."""
    import pickle

    torch = setup_torch(threads)
    if not torch.cuda.is_available():
        raise Failure("no CUDA device available")
    out = {}
    for name in names:
        res = timed(globals()[name], t_start, "in its group; ")
        out[name] = res if name in PATH_RESULTS else None
    with open(result_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def run_path_groups(t_start):
    """Run PATH_GROUPS as concurrent processes of this script on the one
    card, each with its output in a file; print each group's output when
    all have ended. Fails (after stopping the others) as soon as one group
    fails, or when the deadline passes. Returns {phase name: result}."""
    import pickle
    import tempfile

    threads = max(1, (os.cpu_count() or 8) // len(PATH_GROUPS))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for g, names in enumerate(PATH_GROUPS):
                log = open(os.path.join(tmp, f"group{g}.log"), "w")
                cmd = [sys.executable, "-u", os.path.abspath(__file__), "--group", str(g),
                       "--result", os.path.join(tmp, f"group{g}.pkl"), "--t0", repr(time.time() - (time.perf_counter() - t_start)),
                       "--threads", str(threads)]
                procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
            print(f"paths: {len(PATH_GROUPS)} groups as concurrent processes on the card ({threads} host threads each): "
                  + "; ".join(", ".join(names) for names in PATH_GROUPS), flush=True)
            failed = []
            while True:
                rcs = [p.poll() for p, _ in procs]
                failed = [g for g, rc in enumerate(rcs) if rc not in (None, 0)]
                if failed or all(rc == 0 for rc in rcs):
                    break
                if time.perf_counter() - t_start > PATH_DEADLINE_S:
                    failed = [g for g, rc in enumerate(rcs) if rc is None]
                    print(f"paths: groups {failed} still running at {PATH_DEADLINE_S} s of script time", flush=True)
                    break
                time.sleep(0.5)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()
        results = {}
        for g, (p, _) in enumerate(procs):
            with open(os.path.join(tmp, f"group{g}.log")) as f:
                text = f.read()
            print(f"---- group {g} ({', '.join(PATH_GROUPS[g])}): exit code {p.returncode}", flush=True)
            sys.stdout.write(text if text.endswith("\n") or not text else text + "\n")
            sys.stdout.flush()
            if p.returncode == 0:
                with open(os.path.join(tmp, f"group{g}.pkl"), "rb") as f:
                    results.update(pickle.load(f))
        check(not failed and all(p.returncode == 0 for p, _ in procs),
              f"path groups {failed or [g for g, (p, _) in enumerate(procs) if p.returncode]} failed "
              "(their output is above)")
    print(f"paths: all groups ended at {time.perf_counter() - t_start:.1f} s of script time", flush=True)
    return results


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--group", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.group is not None:
        # a child: the script's start on this process's clock
        return run_group(PATH_GROUPS[args.group], args.result, time.perf_counter() - (time.time() - args.t0),
                         args.threads)

    torch = setup_torch()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    name, smi = timed(phase_device_and_build, t_start)
    k1 = timed(phase_k1, t_start)
    k3 = timed(phase_k3, t_start)
    k2 = timed(phase_k2, t_start)
    k4 = timed(phase_k4, t_start)
    k5 = timed(phase_k5, t_start)
    paths = run_path_groups(t_start)
    launches = paths["phase_main_path"][0]  # in grad mode, as a forward-only caller runs it
    grad_launches = paths["phase_gradient"]
    grid_launches = paths["phase_grid_path"]
    latent_launches = paths["phase_latent_path"][0]

    f64 = torch.float64
    k1r = k1[(f64, 4, 3)]
    k3r = k3[(f64, "sphere->floor touch R=3")]  # the pair that finds the contacts
    k2r = k2[(f64, 4, 1)]  # one problem per contacting substep on the main path
    k4r = k4[(f64, 2304)]  # a 3-rung Frank-Wolfe step over the floor's 768 faces
    k5r = k5[(f64, 64, 960)]  # the grid path's grid at its most frequent query size
    k5l = k5[(f64, "lanes")]  # the grid sweep's 16 lanes at that size each
    lane_launches = paths["phase_lanes_3d"]
    f32_runs = paths["phase_float32"]
    f32 = torch.float32
    # each kernel's float32 row at the same shapes, and its launches on the
    # float32 paths (phase_float32)
    f32_rows = {"pdipm_fwd": (k1[(f32, 4, 3)], f32_runs["bench"]), "fw_search": (
        k3[(f32, "sphere->floor touch R=3")], f32_runs["bench"]), "kkt_bwd": (k2[(f32, 4, 1)], f32_runs["gradient"]),
        "igr_mlp": (k4[(f32, 2304)], f32_runs["latent"]), "grid_query": (k5[(f32, 64, 960)], f32_runs["grid"]),
        "grid_query_lanes": (k5[(f32, "lanes")], f32_runs["grid"])}
    f32_err = {"pdipm_fwd": max(r["err"] for (dt, _, _), r in k1.items() if dt == f32),
               "fw_search": max(r["err"] for (dt, _), r in k3.items() if dt == f32),
               "kkt_bwd": max(r["err"] for (dt, _, _), r in k2.items() if dt == f32),
               "igr_mlp": max(r["err"] for (dt, *_), r in k4.items() if dt == f32),
               "grid_query": max(r["err"] for (dt, *_), r in k5.items() if dt == f32),
               "grid_query_lanes": k5[(f32, "lanes")]["err"]}
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
        dict(name="grid_query_lanes", route="cuda", source="diffsdfsim_torch/ops/csrc/grid_interp.cu",
             replaces="diffsdfsim_tpu/ops/pallas_kernels.py:106", launches=lane_launches["grid_query_lanes"],
             max_abs_err=k5l["err"], ms=k5l["ms"], plain_ms=k5l["plain_ms"], bound_ms=max(k5l["bytes_ms"], k5l["ops_ms"]),
             bound_by="bytes" if k5l["bytes_ms"] > k5l["ops_ms"] else "operations", library_ms=k5l["library_ms"]),
    ]
    for row in kernels:
        r, runs = f32_rows[row["name"]]
        row.update(launches_f32=runs[row["name"]], max_abs_err_f32=f32_err[row["name"]], ms_f32=r["ms"],
                   plain_ms_f32=r["plain_ms"], bound_ms_f32=max(r["bytes_ms"], r["ops_ms"]),
                   bound_by_f32="bytes" if r["bytes_ms"] > r["ops_ms"] else "operations",
                   library_ms_f32=r.get("library_ms"))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
