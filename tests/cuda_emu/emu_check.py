"""Run the K1, K2, K3 and K4 CUDA sources on the CPU, one OS thread per CUDA
thread, and hold them against their plain PyTorch versions: a check of the
kernels' indexing, barriers, cluster exchanges and arithmetic without a card
(not of their speed, not of the asynchrony of cp.async, and not of what only
the GPU compiler would refuse).

    python tests/cuda_emu/emu_check.py

or, case by case, ``pytest -m slow tests/test_torch_cuda_emu.py``. Each
source is rewritten (``kernel<<<grid, block, bytes, stream>>>(...)``
becomes ``emu::launch(grid, block, bytes, kernel, ...)``, the dynamic shared
memory each block's own buffer; a cluster launch goes through the stand-in's
``cudaLaunchKernelEx``), compiled with g++
(C++20) against ``tests/cuda_emu/cuda_runtime.h`` into a shared library with
the same C interface, and called through the wrappers' ``prepare`` and
``finish`` on CPU tensors. Cases: the bench LCPs of ``chip_smoke.py`` at
k = 4 and 8 contacts (the two compile-time shapes) and seeded structured
problems of other sizes (the runtime-sized instantiation, neq = 0 padded
included), float64 and float32. Tolerances as on the card: K1's residuals no
worse than 10x the plain PDIPM's (float32: or than 1e-2) and, in float64,
its x within 1e-8 of it; K2 within 1e-9 relative of the KKT system's
exact solution (``chip_smoke.kkt_exact``) and of ``kkt_grad_reduced`` (its
algorithm, the refinement steps included; float64), 1e-4 of them (float32),
also where the friction cones are tight (their d at 3e8, where the plain
version reads 4e-7 from the exact solution). K4 (``K4_CASES``): nets whose clusters have 2, 3
and 4 CTAs (the reference's (128,)*8 with its skip), 32 and 40 points per
cluster, within 1e-12 (float64) and 1e-5 (float32) relative of
``implicit_net_apply``. K3 (``K3_CASES``): the bench pairs at contact, a
tilted box, the sphere on a cylinder (the 768-face floor's poses on
clusters of 12 CTAs), and a 3072-face floor whose poses spread over
clusters of 16 CTAs, and both bench pairs with a sphere of a different
radius in each of 3 lanes at 2 poses a lane (the seed sweep's per-lane
bodies), held against ``search_pair_raw_plain`` as ``chip_smoke.py`` holds
them. K5 (``K5_CASES``): the fused query and the sampler against their
plain versions, and the lane entry (``grid_query_lanes``, 3 lanes of 2
poses, lane grids or one shared grid) bitwise against one single launch
per lane. Takes about 40 s.
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "diffsdfsim_torch", "ops", "csrc")
STUB = os.path.dirname(os.path.abspath(__file__))

from diffsdfsim_torch.ops import qp_cuda  # noqa: E402
from diffsdfsim_torch.ops.qp import (blockdiag_inv3, kkt_grad_plain, kkt_grad_reduced, lcp_residuals,  # noqa: E402
                                     pdipm_solve_raw)

LAUNCH = re.compile(r"(\w+<[^<>;]*>)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\(")
SMEM = "extern __shared__ __align__(16) unsigned char smem_raw[];"


def build(name, out_dir):
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    src = LAUNCH.sub(r"emu::launch(\2, \3, \4, \1, ", src).replace(SMEM, "unsigned char* smem_raw = emu::smem();")
    path = os.path.join(out_dir, f"{name}.cpp")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", f"-I{STUB}", f"-I{CSRC}",
                    "-o", lib, path], check=True)
    return ctypes.CDLL(lib)


def run(lib, name, wrapper, args):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = wrapper._argtypes()
    extra = [args["eps"]] if "eps" in args else []
    err = fn(*args["dims"], *extra, *[t.data_ptr() for t in args["ins"] + args["outs"]], None)
    assert err == 0, f"{name}: error {err}"
    return wrapper.finish(args)


def structured(B, neq, k, fd, dtype, seed):
    """B mixed LCPs with the physics friction layout (chip_smoke.structured_lcps)."""
    import chip_smoke

    return chip_smoke.structured_lcps(B, neq, k, fd, dtype, seed, device="cpu")


# (label, B, k, (neq, fd) of a seeded structured problem, or None for the
# bench LCPs at fd = 8); "tight" sets K2's cone rows' d to 3e8 (sticking
# contacts, where the reduced solve alone loses the cone rows' digits)
CASES = [("bench k=4", 3, 4, None), ("bench k=8", 2, 8, None), ("neq=3 k=2 fd=4", 2, 2, (3, 4)),
         ("neq=0 k=1 fd=2", 2, 1, (0, 2)), ("tight neq=6 k=4 fd=4", 2, 4, (6, 4))]
# the (case, dtype) pairs run. In float32 the tight case sets the cones at
# the backward's cap d = 1e5; K2 computes in float64 for float32 inputs,
# since a float32 reduced factor was 4.2x its answer off the exact solution
# there after the two refinement steps (ROADMAP queue 3, item 18); it must
# come no farther from the exact solution than the plain float32 path
K12_RUNS = [(c, dt) for dt in (torch.float64, torch.float32) for c in CASES]


def build_libs(out_dir):
    """The kernels compiled for the CPU into out_dir."""
    return {n: build(n, out_dir) for n in ("pdipm_fwd", "kkt_bwd", "igr_mlp", "fw_search", "grid_interp")}


def check_case(libs, dtype, case):
    """K1 and K2 on one case: [(report line, passed)] for each kernel."""
    import chip_smoke

    label, B, k, other = case
    f64 = dtype == torch.float64
    if other is None:
        lcp = chip_smoke.physics_lcps(B, seed=B, device="cpu", dtype=dtype, k=k)
        fd = 8
    else:
        neq, fd = other
        lcp = structured(B, neq, k, fd, dtype, seed=B + k)
    Q, p, G, h, A, b, F, invQ = lcp
    structure = ("fric", k, fd)
    eps = 1e-12 if f64 else 1e-6
    out = []
    # K1
    args = qp_cuda.pdipm_fric.prepare(Q, p, G, h, A, b, F, invQ, 10, eps, 3, structure)
    sol_k = run(libs["pdipm_fwd"], "pdipm_fwd", qp_cuda.pdipm_fric, args)
    sol_p = pdipm_solve_raw(Q, p, G, h, A, b, F, 10, eps, 3, structure)
    res_k = lcp_residuals(Q, p, G, h, A, b, F, sol_k)
    res_p = lcp_residuals(Q, p, G, h, A, b, F, sol_p)
    dx = float((sol_k[0] - sol_p[0]).abs().max())
    syncs = qp_cuda.pdipm_fric.last_syncs[0].tolist()
    ok = bool(torch.all(res_k <= torch.clamp(10 * res_p, min=1e-6 if f64 else 1e-2)))
    if f64:
        ok &= dx <= 1e-8
    out.append((f"K1 {str(dtype)[6:]} {label}: max|dx| {dx:.2e}, "
                f"resid kernel {float(res_k.max()):.2e} plain {float(res_p.max()):.2e}, stop its "
                f"{qp_cuda.pdipm_fric.last_done_it.tolist()}, barriers first iteration / all {syncs}", ok))
    # K2 at the plain solution's diagonal (bench LCPs, clipped as
    # chip_smoke.py does) or at a seeded one in [0.01, 100]
    rng = np.random.default_rng(B)
    if other is None:
        x, y, z, s = pdipm_solve_raw(*(t.double() for t in (Q, p, G, h, A, b, F)), 10, 1e-12, 3, structure)
        d = torch.clamp(torch.clamp(z, min=1e-8) / torch.clamp(s, min=1e-8), max=1e12 if f64 else 1e5)
    else:
        d = torch.tensor(np.exp(rng.uniform(np.log(0.01), np.log(100.0), size=tuple(h.shape))))
        if label.startswith("tight"):
            d[:, -k:] = 3e8 if f64 else 1e5  # float32: the backward's cap on d
    d = d.to(dtype)
    rx = torch.tensor(rng.normal(size=tuple(p.shape)), dtype=dtype)
    ins = (invQ, G, A, F, d, rx)
    args = qp_cuda.kkt_grad_fric.prepare(*ins, structure)
    out_k = run(libs["kkt_bwd"], "kkt_bwd", qp_cuda.kkt_grad_fric, args)
    ins64 = [t.double() for t in ins]
    # the system's exact solution (chip_smoke.kkt_exact), the plain
    # version, and the kernel's algorithm in plain PyTorch
    kkt, rhs = chip_smoke.kkt_system(Q.double(), *ins64[1:])
    ex = chip_smoke.kkt_exact(kkt, rhs)
    nz, nineq = Q.shape[-1], G.shape[-2]
    out_ex = (ex[:, :nz], ex[:, nz : nz + nineq], ex[:, nz + nineq :])

    def rel(outs, refs):
        return max(float((a.double() - r).abs().max()) / float(r.abs().max()) for a, r in zip(outs, refs)
                   if r.numel())

    rel_ex, rel_red = rel(out_k, out_ex), rel(out_k, kkt_grad_reduced(*ins64, structure))
    rel_plain = rel(kkt_grad_plain(*ins64, structure), out_ex)
    rel_plain_dt = rel(kkt_grad_plain(*ins, structure), out_ex)
    tol = 1e-9 if f64 else 1e-4
    ok = rel_ex <= tol and rel_red <= tol and rel_ex <= max(rel_plain_dt, tol)
    out.append((f"K2 {str(dtype)[6:]} {label}: rel err vs the exact solution {rel_ex:.2e}, vs kkt_grad_reduced "
                f"{rel_red:.2e} (tol {tol:g}; the plain version in float64 {rel_plain:.2e}, in "
                f"{str(dtype)[6:]} {rel_plain_dt:.2e}), barriers {qp_cuda.kkt_grad_fric.last_syncs.tolist()}", ok))
    return out


# (label, hidden widths, skip layers, points, points per cluster, input
# size): a cluster of 2 CTAs with a partial last tile; 3 CTAs (an output
# count that is no multiple of 32 and an uneven split of the last layer's
# rows) at 40 points per cluster; the reference's (128,)*8 net with its skip
# at layer 4 (a cluster of 4, layer 3's 123 outputs padded to 128) at 32
# points per cluster and at the kernel's own choice; IGR's shape-space
# decoder, (512,)*8 with a 256-dim latent (8 CTAs of two 32-column slices
# each, 16 points per cluster in float64, 32 in float32); and a 320-wide net
# (slices 8, 9 of 10 on CTAs 0 and 1 only) at 8 points
K4_CASES = [("K4 width 64 x 4", (64,) * 4, (2,), 40, 32, 5), ("K4 width 90 x 3", (90,) * 3, (1,), 70, 40, 5),
            ("K4 reference net", (128,) * 8, (4,), 36, 32, 5),
            ("K4 reference net, tile by waves", (128,) * 8, (4,), 45, 0, 5),
            ("K4 shape-space decoder 512", (512,) * 8, (4,), 20, 0, 259), ("K4 width 320 x 3", (320,) * 3, (1,), 11, 8, 7)]


def check_k4_case(libs, dtype, case):
    """K4 on one net against implicit_net_apply: [(report line, passed)]."""
    from diffsdfsim_torch.models.igr import implicit_net_apply, init_implicit_net
    from diffsdfsim_torch.ops import igr_cuda

    label, dims, skip_in, n, tile, d_in = case
    rng = np.random.default_rng(len(dims) * 100 + n)
    params = init_implicit_net(d_in, dims, skip_in, radius_init=0.55, generator=rng, dtype=dtype).params()
    # the geometric init keeps the net near a sphere; perturb the biases so
    # that softplus sees both of its branches
    params = params._replace(biases=tuple(b + torch.tensor(rng.normal(size=b.shape) * 0.05, dtype=dtype)
                                          for b in params.biases))
    x = torch.tensor(np.concatenate([rng.normal(size=(n, d_in - 3)) * 0.3, rng.uniform(-1, 1, (n, 3))], 1),
                     dtype=dtype)
    prm, dims_a, offs = igr_cuda.pack_params(params)
    out = torch.full((n,), float("nan"), dtype=dtype)
    fn = libs["igr_mlp"].igr_mlp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_double] + [ctypes.c_void_p] * 6
    err = fn(1 if dtype == torch.float64 else 0, tile, n, len(params.weights), d_in, params.beta, dims_a.ctypes.data,
             offs.ctypes.data, x.data_ptr(), prm.data_ptr(), out.data_ptr(), None)
    assert err == 0, f"igr_mlp: error {err}"
    ref = implicit_net_apply(params, x)
    rel = float((out - ref).abs().max()) / float(ref.abs().max())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    return [(f"{label} {str(dtype)[6:]} N={n} tile {tile}: rel err {rel:.2e} (tol {tol:g})", rel <= tol)]


# K3 cases: labels of chip_smoke.k3_cases (the bench pairs at contact, a
# tilted box, the sphere on a cylinder), a coarse box 1-5 cm above the
# sphere (several Frank-Wolfe iterations on a curved SDF), a floor of 3072
# faces, which a pose spreads over a cluster of 16 CTAs, and the sphere at
# subdiv 5 (20,480 faces, past the one-face-per-thread cap: 16 CTAs of 512
# threads loop over 2-3 faces each) touching the floor and above the bench
# sphere (chip_smoke.k3_big_cases)
K3_CASES = ["sphere->floor touch R=3", "floor->sphere pen1e-3 R=3", "box->floor tilted R=6", "sphere->cylinder R=6",
            "box->sphere gap R=2", "floor3072->sphere touch R=2", "sphere20480->floor touch R=2",
            "sphere20480->sphere gap R=2", "lanes sphere->floor B=3 D=2", "lanes floor->sphere B=3 D=2"]


def k3_case(label, dtype):
    """(bd1, bd2, q1, p1, q2, p2) of a K3 case, on the CPU."""
    import chip_smoke
    from diffsdfsim_torch.physics import BoxShape, make_body

    if label.startswith("lanes"):
        return next(c[1:] for c in chip_smoke.k3_lane_cases("cpu", dtype, 3, 2) if c[0] == label)
    if label.startswith("sphere20480"):
        return next(c[1:] for c in chip_smoke.k3_big_cases("cpu", dtype, 2) if c[0] == label)
    if label.startswith("floor3072"):
        floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=4, device="cpu", dtype=dtype)
        _, sphere = chip_smoke.bench_bodies("cpu", dtype)
        q = torch.tensor([[1.0, 0, 0, 0], [0.99, 0.1, 0.05, 0.0]], dtype=dtype)
        q = q / q.norm(dim=-1, keepdim=True)
        ps = torch.tensor([[0.0, 0.5 + 1e-6, 0.0], [0.01, 0.5 - 1e-3, 0.02]], dtype=dtype)
        return floor, sphere, q[:1].expand(2, 4), torch.tensor([0.0, -0.5, 0.0], dtype=dtype).expand(2, 3), q, ps
    if label.startswith("box->sphere"):
        box = make_body(BoxShape(torch.tensor([0.6, 0.4, 0.5])), subdiv=1, device="cpu", dtype=dtype)
        _, sphere = chip_smoke.bench_bodies("cpu", dtype)
        q = torch.tensor([0.95, 0.2, 0.1, 0.05], dtype=dtype)
        p1 = torch.tensor([[0.05, 0.71, 0.03], [0.0, 0.8, 0.0]], dtype=dtype)
        eye = torch.tensor([1.0, 0, 0, 0], dtype=dtype).expand(2, 4)
        return box, sphere, (q / q.norm()).expand(2, 4), p1, eye, torch.zeros((2, 3), dtype=dtype)
    for case in chip_smoke.k3_cases("cpu", dtype):
        if case[0] == label:
            return case[1:]
    raise KeyError(label)


def check_k3_case(libs, dtype, label):
    """K3 on one pair against search_pair_raw_plain: [(report line, passed)].
    Tolerances as chip_smoke.py's: float64 1e-6 and no mask mismatch, float32
    2e-3 and 0.5 % of the masks."""
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops import fw_cuda
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain
    import chip_smoke

    f64 = dtype == torch.float64
    cfg = SimConfig(**{**chip_smoke.BENCH_CFG, "tol": 1e-8 if f64 else 1e-5, "eps": 1e-3})
    bd1, bd2, q1, p1, q2, p2 = k3_case(label, dtype)
    args = fw_search_pair.prepare(bd1, q1, p1, bd2, q2, p2, cfg)
    args["buf"].view(torch.uint8).fill_(0xFF)  # NaN bytes: an output the kernel misses shows
    fn = libs["fw_search"].fw_search
    fn.restype = ctypes.c_int
    fn.argtypes = fw_cuda.ARGTYPES
    err = fn(*args["dims"], *args["tols"], *args["ptrs"], None)
    assert err == 0, f"fw_search: error {err}"
    out_k = fw_search_pair.finish(args)
    out_p = search_pair_raw_plain(bd1, q1, p1, bd2, q2, p2, cfg)
    mis = int((out_k.cand != out_p.cand).sum() + (out_k.cmask != out_p.cmask).sum())
    both, agree = out_k.cmask & out_p.cmask, out_k.cand == out_p.cand
    errs = {f: float((getattr(out_k, f) - getattr(out_p, f)).abs()[both].max()) if bool(both.any()) else 0.0
            for f in ("n_ng", "p1_ng", "x1", "pen")}
    errs["abc"] = float((out_k.abc - out_p.abc).abs()[agree].max()) if bool(agree.any()) else 0.0
    same_inf = bool(torch.equal(torch.isfinite(out_k.max_pen), torch.isfinite(out_p.max_pen)))
    fin = torch.isfinite(out_k.max_pen) & torch.isfinite(out_p.max_pen)
    errs["max_pen"] = float((out_k.max_pen - out_p.max_pen).abs()[fin].max()) if bool(fin.any()) else 0.0
    atol, allowed = (1e-6, 0) if f64 else (2e-3, int(0.005 * out_k.cand.numel()))
    # as on the card: the bench pairs are held on every output, the other
    # kinds on max_pen (exact-tie failsafe gradients, chip_smoke.phase_k3)
    bench = label.startswith(("floor", "sphere->floor", "sphere20480", "lanes"))
    ok = same_inf and errs["max_pen"] <= atol and (not bench or (mis <= allowed and max(errs.values()) <= atol))
    return [(f"K3 {str(dtype)[6:]} {label}: errs " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
             + f", mask mismatches {mis} (allowed {allowed}), cmask faces {int(out_k.cmask.sum())}, "
             f"FW iterations {fw_search_pair.last_iters.tolist()}", ok)]


# K5 cases: (label, grid shape, scaled, gradient outputs): the fused query
# of a 33^3 sphere grid at scale 0.75 with every output, value only, and in
# the normalized frame (no scale); an uneven random grid; and the sampler
# on a 3-channel stack
K5_CASES = [("K5 query 33^3", (33, 33, 33), True, True), ("K5 query 33^3 value only", (33, 33, 33), True, False),
            ("K5 query 33^3 normalized frame", (33, 33, 33), False, True), ("K5 query 9x7x8", (9, 7, 8), True, True),
            ("K5 sampler C=3 9x7x8", (9, 7, 8), None, None), ("K5 query lanes 17^3", (17, 17, 17), True, True),
            ("K5 query lanes 17^3 shared grid", (17, 17, 17), True, True)]


def k5_query_fn(lib):
    """grid_query_lanes, the K5 query entry (one body's query: one lane)."""
    fn = lib.grid_query_lanes
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5)
    return fn


def check_k5_lanes(lib, dtype, label, res):
    """The lane entry (grid_query_lanes) on L = 3 lanes of d = 2 poses of 60
    points each, a grid (or one shared grid) and a scale per lane: every
    output bitwise equal to one launch of one lane per lane, and held
    against the plain version of each lane as check_k5_case holds the
    single query."""
    import chip_smoke

    L, d, n = 3, 2, 60
    rng = np.random.default_rng(7)
    shared = "shared" in label
    grids = torch.tensor(np.stack([chip_smoke.sphere_grid(res[0]) * (1.0 + 0.1 * i) for i in range(L)]), dtype=dtype)
    if shared:
        grids = grids[0]
    scales = torch.tensor([0.7, 0.75, 0.8], dtype=dtype)
    pts = torch.tensor(np.stack([chip_smoke.k5_query_points(res[0], float(scales[i // d]), n, seed=i)
                                 for i in range(L * d)]), dtype=dtype)
    f64 = 1 if dtype == torch.float64 else 0
    M = d * n
    outs = [torch.full((L * M,), float("nan"), dtype=dtype)] + [torch.full((L * M, 3), float("nan"), dtype=dtype)
                                                              for _ in range(3)]
    fn = k5_query_fn(lib)
    err = fn(f64, L, *res, M, grids.data_ptr(), 0 if shared else grids[0].numel(), pts.data_ptr(), scales.data_ptr(),
             1, *[o.data_ptr() for o in outs], None)
    assert err == 0, f"grid_query_lanes: error {err}"
    same, errs_all, ok_all = True, {}, True
    for lane in range(L):
        g = grids if shared else grids[lane]
        p = pts[lane * d:(lane + 1) * d].reshape(-1, 3).contiguous()
        ref = [torch.full((M,), float("nan"), dtype=dtype)] + [torch.full((M, 3), float("nan"), dtype=dtype)
                                                               for _ in range(3)]
        assert fn(f64, 1, *res, M, g.data_ptr(), 0, p.data_ptr(), scales[lane].data_ptr(), 0,
                  *[o.data_ptr() for o in ref], None) == 0
        mine = [o[lane * M:(lane + 1) * M] for o in outs]
        same = same and all(torch.equal(a, b) for a, b in zip(mine, ref))
        errs, ok = chip_smoke.k5_query_errors(mine, chip_smoke.k5_query_plain(p, g, scales[lane]), max_ulps=2)
        ok_all = ok_all and ok
        errs_all = {k: max(v, errs_all.get(k, 0.0)) for k, v in errs.items()}
    return [(f"{label} {str(dtype)[6:]}: bitwise one launch per lane {same}; ulps "
             + ", ".join(f"{k} {v:g}" for k, v in errs_all.items()), same and ok_all)]


def check_k5_case(libs, dtype, case):
    """K5 on one case against its plain version (chip_smoke.k5_query_plain,
    sdf.grid_interp): the value and the interpolated gradient bitwise, the
    normalized gradients within 2 ulps; outputs not asked for stay
    untouched. [(report line, passed)]"""
    import chip_smoke
    from diffsdfsim_torch.ops import sdf

    label, res, scaled, grads = case
    if "lanes" in label:
        return check_k5_lanes(libs["grid_interp"], dtype, label, res)
    rng = np.random.default_rng(sum(res))
    grid = chip_smoke.sphere_grid(res[0]) if res[0] == res[1] == res[2] else rng.normal(size=res)
    lib = libs["grid_interp"]
    f64 = 1 if dtype == torch.float64 else 0
    if scaled is None:
        stack = torch.tensor(np.stack([grid, 2 * grid, -grid]), dtype=dtype)
        inds = torch.tensor(rng.uniform(-0.05, 1.05, (300, 3)) * (np.array(res) - 1), dtype=dtype)
        out = torch.full((3, 300), float("nan"), dtype=dtype)
        fn = lib.grid_interp
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
        assert fn(f64, 3, *res, 300, stack.data_ptr(), inds.data_ptr(), out.data_ptr(), None) == 0
        err = float((out - sdf.grid_interp(stack, inds)).abs().max())
        return [(f"{label} {str(dtype)[6:]}: max abs err {err:.1e} (tol 0)", err == 0.0)]
    grid = torch.tensor(grid, dtype=dtype)
    scale = torch.tensor(0.75, dtype=dtype) if scaled else None
    pts = torch.tensor(chip_smoke.k5_query_points(res[0], 0.75, 400, seed=len(label)), dtype=dtype)
    if not scaled:
        pts = pts / 0.75
    n = pts.shape[0]
    outs = [torch.full((n,), float("nan"), dtype=dtype)] + [torch.full((n, 3), float("nan"), dtype=dtype)
                                                           for _ in range(3)]
    asked = [True, bool(grads and scaled), bool(grads), bool(grads)]
    err = k5_query_fn(lib)(f64, 1, *res, n, grid.data_ptr(), 0, pts.data_ptr(),
                           scale.data_ptr() if scaled else None, 0,
                           *[o.data_ptr() if a else None for o, a in zip(outs, asked)], None)
    assert err == 0, f"grid_query_lanes: error {err}"
    untouched = all(bool(torch.isnan(o).all()) for o, a in zip(outs, asked) if not a)
    # the normalized gradients within 2 units in the last place: the plain
    # version on the CPU sums normalize's three squares in another order
    # than torch on the card, whose order the kernel takes
    errs, ok = chip_smoke.k5_query_errors([o if a else None for o, a in zip(outs, asked)],
                                          chip_smoke.k5_query_plain(pts, grid, scale), max_ulps=2)
    return [(f"{label} {str(dtype)[6:]}: ulps " + ", ".join(f"{k} {v:g}" for k, v in errs.items())
             + f"; outputs not asked for untouched {untouched}", ok and untouched)]


def main():
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs(tmp)
        runs = K12_RUNS + [(c, dt) for dt in (torch.float64, torch.float32) for c in K4_CASES + K3_CASES + K5_CASES]
        for case, dtype in runs:
            check = (check_k4_case if case in K4_CASES else check_k3_case if case in K3_CASES
                     else check_k5_case if case in K5_CASES else check_case)
            for line, ok in check(libs, dtype, case):
                print(f"{line}: {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(line.split(":")[0])
    if failures:
        print("FAILED:", failures)
        return 1
    print("all emulated kernel checks passed")
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
