#!/usr/bin/env python3
"""How far any order of K2's arithmetic may land from the exact solution at
optim_sphere's room LCPs (nz 18, neq 12, k 8, fd 8: m2 = 52), on the CPU.

    python3 tools/k2_room_conditioning.py [--draws N] [--emulate]

For ``chip_smoke.room_lcps(B, seed=B)`` at B = 1 and 50, the backward's
inputs as ``phase_k2`` forms them, it prints:

- the error of the plain version (``kkt_grad_plain``: Cholesky and Woodbury,
  the JAX package's XLA path) and of ``fric_reduced_solve`` (the kernel's
  algorithm: the folded m2 x m2 reduced block inverted by pivot-free
  Gauss-Jordan) against the exact solution of the full KKT system
  (``chip_smoke.kkt_exact``), relative to its largest entry;
- the reduced block's condition number and the magnitudes of its pivots;
- the spread of ``fric_reduced_solve``'s error when each entry of its base
  block and of the reduced block is moved by -1, 0 or +1 ulp (N seeded
  draws, default 300): what a different rounding order alone can do;
- with ``--emulate``, the kernel's own source run on the CPU
  (``tests/cuda_emu``; g++, no fused multiply-add) against the same exact
  solution.
"""

import argparse
import inspect
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from diffsdfsim_torch.ops import qp  # noqa: E402
from diffsdfsim_torch.ops.qp import blockdiag_inv3, kkt_grad_plain, pdipm_solve_raw  # noqa: E402


def rel(a, r):
    return float((a - r).abs().max()) / float(r.abs().max())


def perturbable_reduced_solve():
    """``fric_reduced_solve`` with hooks on its base block and its reduced
    block (``hooks["base"]``, ``hooks["K"]``), the reduced block kept in
    ``hooks["last_K"]``."""
    src = inspect.getsource(qp.fric_reduced_solve).replace("def fric_reduced_solve(", "def reduced_solve(")
    for old, new in (
        ("base_red = (AG[:, idx] @ invQ) @ AG[:, idx].transpose(-1, -2)",
         "base_red = HOOKS['base']((AG[:, idx] @ invQ) @ AG[:, idx].transpose(-1, -2))"),
        ("invK = _gj_inverse(K)", "K = HOOKS['K'](K)\n    HOOKS['last_K'] = K\n    invK = _gj_inverse(K)"),
    ):
        assert old in src, old
        src = src.replace(old, new)
    ns = dict(vars(qp), HOOKS={"base": lambda t: t, "K": lambda t: t})
    exec(src, ns)
    return ns["reduced_solve"], ns["HOOKS"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=300)
    ap.add_argument("--emulate", action="store_true")
    opts = ap.parse_args()
    solve, hooks = perturbable_reduced_solve()
    lib = None
    if opts.emulate:
        sys.path.insert(0, os.path.join(ROOT, "tests", "cuda_emu"))
        import emu_check

        lib = emu_check.build("kkt_bwd", tempfile.mkdtemp())
    for B in (1, 50):
        Q, p, G, h, A, b, F, _ = cs.room_lcps(B, seed=B, device="cpu", dtype=torch.float64)
        nz, neq, nineq, k = cs.lcp_dims(G, A)
        st = ("fric", k, 8)
        x, y, z, s = pdipm_solve_raw(Q, p, G, h, A, b, F, 10, 1e-12, 3, st)
        d = torch.clamp(torch.clamp(z, min=1e-8) / torch.clamp(s, min=1e-8), max=1e12)
        rx = torch.tensor(np.random.default_rng(B).normal(size=tuple(x.shape)), dtype=torch.float64)
        iq = blockdiag_inv3(Q)
        kkt, rhs = cs.kkt_system(Q, G, A, F, d, rx)
        n = nz + nineq + neq
        ex = cs.kkt_exact(kkt, rhs)
        ex3 = (ex[:, :nz], ex[:, nz : n - neq], ex[:, n - neq :])
        ex_w = torch.cat([ex3[2], ex3[1]], -1)  # (dnu, dlam), the reduced solve's w
        iqrx = (iq @ rx[..., None])[..., 0]
        hv = torch.cat([(A @ iqrx[..., None])[..., 0], (G @ iqrx[..., None])[..., 0]], -1)
        hooks.update(base=lambda t: t, K=lambda t: t)
        e_red = rel(-solve(iq, G, A, F, d, hv, st), ex_w)
        K = hooks["last_K"]
        e_plain = max(rel(a, r) for a, r in zip(kkt_grad_plain(iq, G, A, F, d, rx, st), ex3))
        conds = torch.linalg.cond(K)
        pivots = []
        for Kb in K.numpy():
            M = Kb.copy()
            for i in range(M.shape[0]):
                pivots.append(abs(M[i, i]))
                M[i + 1 :] -= np.outer(M[i + 1 :, i] / M[i, i], M[i])
        print(f"B={B}: against the exact solution: plain version {e_plain:.3e}, fric_reduced_solve {e_red:.3e}; "
              f"reduced block (m2 {K.shape[-1]}) condition number max {float(conds.max()):.3e}, pivots "
              f"{min(pivots):.3e} .. {max(pivots):.3e}")
        rng = np.random.default_rng(0)
        errs = []
        for _ in range(opts.draws):
            def ulp(t):
                return t * (1 + torch.tensor(rng.choice([-1.0, 0.0, 1.0], size=tuple(t.shape))) * 2.0**-52)

            hooks.update(base=ulp, K=ulp)
            errs.append(rel(-solve(iq, G, A, F, d, hv, st), ex_w))
        hooks.update(base=lambda t: t, K=lambda t: t)
        errs = np.array(errs)
        print(f"B={B}: one-ulp moves of the base and reduced blocks ({opts.draws} draws): fric_reduced_solve's "
              f"error min {errs.min():.3e}, median {np.median(errs):.3e}, 90th percentile "
              f"{np.quantile(errs, 0.9):.3e}, max {errs.max():.3e}")
        if lib is not None:
            from diffsdfsim_torch.ops import qp_cuda

            out = emu_check.run(lib, "kkt_bwd", qp_cuda.kkt_grad_fric,
                                qp_cuda.kkt_grad_fric.prepare(iq, G, A, F, d, rx, st))
            print(f"B={B}: the kernel's source on the CPU emulator: {max(rel(a, r) for a, r in zip(out, ex3)):.3e} "
                  f"from the exact solution, {max(rel(a, r) for a, r in zip(out, kkt_grad_plain(iq, G, A, F, d, rx, st))):.3e} "
                  f"from the plain version")


if __name__ == "__main__":
    main()
