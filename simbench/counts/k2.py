"""K2, the LCP backward's KKT solve (``ops/csrc/kkt_bwd.cu``): B problems.

Least work per problem: forming the reduced KKT system at the solution's
diagonal and one LU solve of it (``_schur``). Bytes: Q^-1, G, A, F, the
diagonal d (nineq) and the right-hand side rx (nz) read once; dx, dlam and
dnu written once.
"""

from . import _schur, element_size

KERNEL = "kkt_bwd_kernel"
PEAK = "float64"
HOOK = ("diffsdfsim_torch.ops.qp_cuda", "kkt_grad_fric", "launch")


def sizes(args, *_, **__) -> dict:
    is64, B, nz, _neq_pad, neq, nineq, k, fd = args["dims"][:8]
    return dict(is64=is64, B=B, nz=nz, neq=neq, nineq=nineq, k=k, fd=fd)


def count(s: dict):
    B, nz, neq, nineq, k, fd = (s[x] for x in ("B", "nz", "neq", "nineq", "k", "fd"))
    ops = B * (_schur.base(nz, neq, k, fd) + _schur.lu_solve(neq, k, fd))
    elems_in = nz * nz + nineq * nz + neq * nz + nineq * nineq + nineq + nz
    elems_out = nz + nineq + neq
    return ops, B * (elems_in + elems_out) * element_size(s["is64"])
