"""Run the K1 and K2 CUDA sources on the CPU, one OS thread per CUDA thread,
and hold them against their plain PyTorch versions: a check of the kernels'
indexing, barriers and arithmetic without a card (not of their speed, and
not of what only the GPU compiler would refuse).

    python tests/cuda_emu/emu_check.py

or, case by case, ``pytest -m slow tests/test_torch_cuda_emu.py``. Each
source is rewritten (``kernel<<<grid, block, bytes, stream>>>(...)``
becomes ``emu::launch(grid, block, bytes, kernel, ...)``), compiled with g++
(C++20) against ``tests/cuda_emu/cuda_runtime.h`` into a shared library with
the same C interface, and called through the wrappers' ``prepare`` and
``finish`` on CPU tensors. Cases: the bench LCPs of ``chip_smoke.py`` at
k = 4 and 8 contacts (the two compile-time shapes) and seeded structured
problems of other sizes (the runtime-sized instantiation, neq = 0 padded
included), float64 and float32. Tolerances as on the card: K1's residuals no
worse than 10x the plain PDIPM's (float32: or than 1e-2) and, in float64,
its x within 1e-8 of it; K2 within 1e-9 relative of
``kkt_grad_plain`` and of ``fric_reduced_solve`` (float64), 1e-4 of a
float64 solve (float32). Takes about 20 s.
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
from diffsdfsim_torch.ops.qp import (blockdiag_inv3, fric_reduced_solve, kkt_grad_plain, lcp_residuals,  # noqa: E402
                                     pdipm_solve_raw)

LAUNCH = re.compile(r"(\w+<[^<>;]*>)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\(")


def build(name, out_dir):
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    src = LAUNCH.sub(r"emu::launch(\2, \3, \4, \1, ", src)
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
    """B mixed LCPs with the physics friction layout (as in
    tests/test_qp_fric_reduced.py), with a block-diagonal Q."""
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
    out = [torch.tensor(x, dtype=dtype) for x in out]
    return out + [blockdiag_inv3(out[0])]


# (label, B, k, (neq, fd) of a seeded structured problem, or None for the
# bench LCPs at fd = 8)
CASES = [("bench k=4", 3, 4, None), ("bench k=8", 2, 8, None), ("neq=3 k=2 fd=4", 2, 2, (3, 4)),
         ("neq=0 k=1 fd=2", 2, 1, (0, 2))]


def build_libs(out_dir):
    """Both kernels compiled for the CPU into out_dir."""
    return {n: build(n, out_dir) for n in ("pdipm_fwd", "kkt_bwd")}


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
    d = d.to(dtype)
    rx = torch.tensor(rng.normal(size=tuple(p.shape)), dtype=dtype)
    ins = (invQ, G, A, F, d, rx)
    args = qp_cuda.kkt_grad_fric.prepare(*ins, structure)
    out_k = run(libs["kkt_bwd"], "kkt_bwd", qp_cuda.kkt_grad_fric, args)
    ins64 = [t.double() for t in ins]
    out_r = kkt_grad_plain(*ins64, structure)
    rel = max(float((a.double() - r).abs().max()) / float(r.abs().max()) for a, r in zip(out_k, out_r) if r.numel())
    # the same solve through fric_reduced_solve: w = -S^-1 [A; G] Q^-1 rx = (dnu, dlam)
    iqrx = (ins64[0] @ ins64[5][..., None])[..., 0]
    hv = torch.cat([(ins64[2] @ iqrx[..., None])[..., 0], (ins64[1] @ iqrx[..., None])[..., 0]], -1)
    wr = -fric_reduced_solve(*ins64[:5], hv, structure)
    wk = torch.cat([out_k[2], out_k[1]], -1).double()
    rel_red = float((wk - wr).abs().max()) / float(wr.abs().max())
    tol = 1e-9 if f64 else 1e-4
    out.append((f"K2 {str(dtype)[6:]} {label}: rel err vs plain {rel:.2e}, vs fric_reduced_solve {rel_red:.2e} "
                f"(tol {tol:g}), barriers {qp_cuda.kkt_grad_fric.last_syncs.tolist()}",
                rel <= tol and rel_red <= tol))
    return out


def main():
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs(tmp)
        for dtype in (torch.float64, torch.float32):
            for case in CASES:
                for line, ok in check_case(libs, dtype, case):
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
