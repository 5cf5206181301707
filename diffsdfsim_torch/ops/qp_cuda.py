"""K1 and K2 wrappers: the LCP solver's hand-written CUDA kernels.

- ``pdipm_fric`` (K1, ``ops/csrc/pdipm_fwd.cu``) replaces the Pallas kernel
  ``diffsdfsim_tpu/ops/qp_pallas.py`` ``_make_kernel`` (wrapper
  ``_pdipm_pallas_flat``, public ``pdipm_pallas``): the batched PDIPM
  forward, run by every contact probe.
- ``kkt_grad_fric`` (K2, ``ops/csrc/kkt_bwd.cu``) replaces
  ``_make_grad_kernel`` (wrapper ``_kkt_grad_flat``, public
  ``kkt_grad_pallas``): the backward KKT solve of the LCP's implicit
  differentiation, run by the replay's backward in every contacting
  substep.

Both take only ``structure=("fric", k, fd)``, the physics friction layout.
They dispatch on the tensors' device alone: CUDA tensors launch the kernel
(or raise), CPU tensors take the plain version (``ops/qp.pdipm_solve_raw``,
``ops/qp.kkt_grad_plain``). As in the JAX wrappers, Q^-1 (the analytic
inverse of the block-diagonal mass matrix), base = [A;G] Q^-1 [A;G]' and its
reduced block, and the cone coefficients mu are computed outside the kernels
with plain tensor ops (``fric_inputs``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .qp import kkt_grad_plain, pdipm_solve_raw


def fric_ok(structure, nineq: int) -> bool:
    """Can the reduced friction-structure solve be used? (JAX ``_fric_ok``)."""
    if structure is None or structure[0] != "fric":
        return False
    _, k, fd = structure
    return k > 0 and fd >= 2 and fd % 2 == 0 and nineq == k * (2 + fd)


def _check(kernel, structure, tensors, want):
    """Raise on anything a kernel does not take: a structure other than the
    physics friction layout, mixed devices or dtypes, a dtype other than
    float32/float64, or inconsistent shapes."""
    nineq = tensors["G"].shape[-2]
    if not fric_ok(structure, nineq):
        raise ValueError(
            f"the {kernel} kernel takes only structure=('fric', k, fd) with the "
            f"physics row layout; got {structure} for nineq={nineq}"
        )
    dtype, device = tensors["G"].dtype, tensors["G"].device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the {kernel} kernel takes float32 or float64, not {dtype}")
    for name, t in tensors.items():
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected {dtype} on {device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want[name]}")


def check_inputs(Q, p, G, h, A, b, F, invQ, structure):
    """Validate the PDIPM kernel's inputs (see ``_check``)."""
    B, nineq, nz = G.shape
    neq = A.shape[-2]
    want = dict(
        Q=(B, nz, nz), p=(B, nz), G=(B, nineq, nz), h=(B, nineq), A=(B, neq, nz),
        b=(B, neq), F=(B, nineq, nineq), invQ=(B, nz, nz),
    )
    _check("PDIPM", structure, dict(Q=Q, p=p, G=G, h=h, A=A, b=b, F=F, invQ=invQ), want)


def check_grad_inputs(invQ, G, A, F, d, rx, structure):
    """Validate the backward KKT kernel's inputs (see ``_check``)."""
    B, nineq, nz = G.shape
    want = dict(invQ=(B, nz, nz), G=(B, nineq, nz), A=(B, A.shape[-2], nz), F=(B, nineq, nineq),
                d=(B, nineq), rx=(B, nz))
    _check("KKT backward", structure, dict(invQ=invQ, G=G, A=A, F=F, d=d, rx=rx), want)


@functools.lru_cache(maxsize=None)
def _red_index(neq: int, k: int, fd: int, device: str) -> torch.Tensor:
    """Rows [eq, n, f+] of the Schur frame (the reduced system's rows)."""
    fd2 = fd // 2
    nf2 = k * fd2
    idx = np.concatenate(
        [np.arange(neq + k), neq + k + (np.arange(nf2) // fd2) * fd + np.arange(nf2) % fd2]
    )
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def fric_inputs(invQ, G, A, F, structure):
    """The reduced-Schur inputs both kernels read. Returns (A with at least
    one row (a padded zero row is pinned by the kernels' pad_reg,
    qp_pallas.py:493-498), neq, base_red (B, m2, m2), mu (B, k))."""
    B, nineq, nz = G.shape
    _, k, fd = structure
    neq = max(A.shape[-2], 1)
    if A.shape[-2] == 0:
        A = torch.zeros((B, 1, nz), dtype=G.dtype, device=G.device)
    AG = torch.cat([A, G], dim=-2)
    base = AG @ invQ @ AG.transpose(-1, -2)
    idx = _red_index(neq, k, fd, str(G.device))
    base_red = base.index_select(1, idx).index_select(2, idx).contiguous()
    mu = torch.diagonal(F[:, k * (1 + fd) :, :k], dim1=-2, dim2=-1).contiguous()
    return A, neq, base_red, mu


def _check_buffers(name, tensors, device):
    for t in tensors:
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: kernel buffers must be contiguous on one device")


class _PdipmKernel:
    """Callable wrapper of the K1 launch; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self.last_done_it = None  # (B,) stop iteration of each lane in the last launch
        self._fn = None

    def _lib_fn(self):
        if self._fn is None:
            from ._build import load

            fn = load("pdipm_fwd").pdipm_fwd
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 10 + [ctypes.c_double] + [ctypes.c_void_p] * 15
            self._fn = fn
        return self._fn

    def __call__(self, Q, p, G, h, A, b, F, invQ, max_iter, eps, not_improved_lim, structure):
        """Solve the batch; returns (x, y, z, s) like ``pdipm_solve_raw``."""
        if not G.is_cuda:
            return pdipm_solve_raw(Q, p, G, h, A, b, F, max_iter, eps, not_improved_lim, structure)
        args = self.prepare(Q, p, G, h, A, b, F, invQ, max_iter, eps, not_improved_lim, structure)
        self.launch(args)
        return self.finish(args)

    def prepare(self, Q, p, G, h, A, b, F, invQ, max_iter, eps, not_improved_lim, structure):
        """Validate, build the kernel's inputs and allocate its outputs."""
        check_inputs(Q, p, G, h, A, b, F, invQ, structure)
        B, nineq, nz = G.shape
        dtype, device = G.dtype, G.device
        _, k, fd = structure
        neq_real = A.shape[-2]
        A, neq, base_red, mu = fric_inputs(invQ, G, A, F, structure)
        if neq_real == 0:
            b = torch.zeros((B, 1), dtype=dtype, device=device)
        ins = [t.contiguous() for t in (Q, invQ, G, A, F)] + [base_red, mu] + [
            t.contiguous() for t in (p, h, b)
        ]
        nsol = nz + 2 * nineq + neq
        outs = [
            torch.empty((B, nsol), dtype=dtype, device=device),  # best iterate
            torch.empty((B, nsol), dtype=dtype, device=device),  # current iterate
            torch.empty((B,), dtype=torch.int32, device=device),  # stop iteration
            torch.empty((B,), dtype=torch.int32, device=device),  # current improves best
        ]
        _check_buffers("pdipm_fwd", ins + outs, device)
        dims = (1 if dtype == torch.float64 else 0, B, nz, neq, neq_real, nineq, k, fd,
                int(max_iter), int(not_improved_lim))
        return dict(dims=dims, eps=float(eps), ins=ins, outs=outs, device=device)

    def launch(self, args):
        """One kernel launch on the current stream (the only place that counts)."""
        err = self._lib_fn()(
            *args["dims"], args["eps"], *[t.data_ptr() for t in args["ins"] + args["outs"]],
            torch.cuda.current_stream(args["device"]).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"pdipm_fwd kernel launch failed: CUDA error {err}")
        self.launches += 1

    def finish(self, args):
        """The solution (x, y, z, s) from the kernel's outputs."""
        _, B, nz, neq, neq_real, nineq, _, _, max_iter, _ = args["dims"]
        best, cur, done_it, cur_imp = args["outs"]
        self.last_done_it = done_it
        # The batch's loop ran n_run iterations; a lane that stopped at
        # iteration i had its last step checked for improvement only if the
        # loop ran an iteration i + 1 (ops/qp.py _pdipm_forward).
        n_run = torch.clamp(done_it.max() + 1, max=max_iter)
        never = done_it >= max_iter
        use_cur = (cur_imp != 0) & (never | (done_it + 1 < n_run))
        sol = torch.where(use_cur[:, None], cur, best)
        x = sol[:, :nz]
        s = sol[:, nz : nz + nineq]
        z = sol[:, nz + nineq : nz + 2 * nineq]
        y = sol[:, nz + 2 * nineq : nz + 2 * nineq + neq_real]
        return x, y, z, s


pdipm_fric = _PdipmKernel()


class _KktGradKernel:
    """Callable wrapper of the K2 launch; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _lib_fn(self):
        if self._fn is None:
            from ._build import load

            fn = load("kkt_bwd").kkt_bwd
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 11
            self._fn = fn
        return self._fn

    def __call__(self, invQ, G, A, F, d, rx, structure):
        """The backward KKT solve with rhs (rx, 0, 0, 0) at diagonal d for a
        batch; returns (dx, dlam, dnu) like ``kkt_grad_plain``."""
        if not G.is_cuda:
            return kkt_grad_plain(invQ, G, A, F, d, rx, structure)
        args = self.prepare(invQ, G, A, F, d, rx, structure)
        self.launch(args)
        return self.finish(args)

    def prepare(self, invQ, G, A, F, d, rx, structure):
        """Validate, build the kernel's inputs and allocate its outputs."""
        B, nineq, nz = G.shape
        neq_real = A.shape[-2]
        dtype, device = G.dtype, G.device
        check_grad_inputs(invQ, G, A, F, d, rx, structure)
        _, k, fd = structure
        A, neq, base_red, mu = fric_inputs(invQ, G, A, F, structure)
        ins = [t.contiguous() for t in (invQ, G, A)] + [base_red, mu] + [t.contiguous() for t in (d, rx)]
        outs = [
            torch.empty((B, nz), dtype=dtype, device=device),  # dx
            torch.empty((B, nineq), dtype=dtype, device=device),  # dlam
            torch.empty((B, neq), dtype=dtype, device=device),  # dnu (padded rows included)
        ]
        _check_buffers("kkt_bwd", ins + outs, device)
        dims = (1 if dtype == torch.float64 else 0, B, nz, neq, neq_real, nineq, k, fd)
        return dict(dims=dims, ins=ins, outs=outs, device=device, neq_real=neq_real)

    def launch(self, args):
        """One kernel launch on the current stream (the only place that counts)."""
        err = self._lib_fn()(
            *args["dims"], *[t.data_ptr() for t in args["ins"] + args["outs"]],
            torch.cuda.current_stream(args["device"]).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"kkt_bwd kernel launch failed: CUDA error {err}")
        self.launches += 1

    def finish(self, args):
        dx, dlam, dnu = args["outs"]
        return dx, dlam, dnu[:, : args["neq_real"]]


kkt_grad_fric = _KktGradKernel()
