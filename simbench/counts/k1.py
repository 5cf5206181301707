"""K1, the PDIPM forward (``ops/csrc/pdipm_fwd.cu``): B friction LCPs.

Least work per problem: forming the reduced KKT system once and one Newton
step on it (one LU and one solve, ``_schur``), whatever the number of
Mehrotra iterations a solver runs. Bytes: the launch's inputs Q, Q^-1
(nz x nz), G (nineq x nz), A (neq x nz), F (nineq x nineq), p, h, b read
once; the solution x, y, z, s written once.
"""

from . import _schur, element_size

KERNEL = "pdipm_fwd_kernel"
PEAK = "float64"
HOOK = ("diffsdfsim_torch.ops.qp_cuda", "pdipm_fric", "launch")


def sizes(args, *_, **__) -> dict:
    is64, B, nz, _neq_pad, neq, nineq, k, fd = args["dims"][:8]
    return dict(is64=is64, B=B, nz=nz, neq=neq, nineq=nineq, k=k, fd=fd)


def count(s: dict):
    B, nz, neq, nineq, k, fd = (s[x] for x in ("B", "nz", "neq", "nineq", "k", "fd"))
    ops = B * (_schur.base(nz, neq, k, fd) + _schur.lu_solve(neq, k, fd))
    elems_in = 2 * nz * nz + nineq * nz + neq * nz + nineq * nineq + nz + nineq + neq
    elems_out = nz + neq + 2 * nineq
    return ops, B * (elems_in + elems_out) * element_size(s["is64"])
