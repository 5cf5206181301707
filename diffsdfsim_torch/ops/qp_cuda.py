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

Both take only ``structure=("fric", k, fd)``, the physics friction layout,
with a reduced system of m2 = neq + k + k*fd/2 rows; a launch fails with
cudaErrorInvalidValue past the kernels' limit (``fric_schur.cuh``
``M2_MAX``). They dispatch on
the tensors' device alone: CUDA tensors launch the kernel (or raise), CPU
tensors take the plain version (``ops/qp.pdipm_solve_raw``,
``ops/qp.kkt_grad_plain``). Q^-1 (the analytic inverse of the block-diagonal
mass matrix) comes from the caller; the kernels form the reduced Schur base
block and read the cone coefficients from F themselves, so a launch runs no
tensor ops besides allocating its outputs (and padding A when there is no
equality row).
"""

from __future__ import annotations

import ctypes

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


def _pad_eq(A, b=None):
    """A (and b) with at least one row: a padded zero row is pinned by the
    kernels' pad_reg (qp_pallas.py:493-498)."""
    if A.shape[-2] > 0:
        return A, b
    B, _, nz = A.shape
    A = torch.zeros((B, 1, nz), dtype=A.dtype, device=A.device)
    return A, None if b is None else torch.zeros((B, 1), dtype=A.dtype, device=A.device)


def _buffers(name, tensors, device):
    out = [t.contiguous() for t in tensors]
    for t in out:
        if t.device != device:
            raise ValueError(f"{name}: kernel buffers must lie on one device")
    return out


class _Kernel:
    """A ctypes-bound kernel library; ``launches`` counts kernel launches."""

    lib = ""  # the source's name in ops/csrc
    n_int = 0  # int arguments before the pointers

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._info = None

    def _lib_fn(self):
        if self._fn is None:
            from ._build import load

            lib = load(self.lib)
            fn = getattr(lib, self.lib)
            fn.restype = ctypes.c_int
            fn.argtypes = self._argtypes()
            info = getattr(lib, f"{self.lib}_info")
            info.restype = ctypes.c_int
            info.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
            self._fn, self._info = fn, info
        return self._fn

    def info(self, dtype, nz, neq, nineq, k, fd):
        """The launch's resources at these sizes: threads per block, shared
        bytes per block, registers and local (spill) bytes per thread,
        blocks per SM, and the static m2 of the instantiation (0: sizes read
        at run time)."""
        self._lib_fn()
        out = (ctypes.c_longlong * 6)()
        err = self._info(1 if dtype == torch.float64 else 0, nz, neq, nineq, k, fd, out)
        if err != 0:
            raise RuntimeError(f"{self.lib}_info failed: CUDA error {err}")
        return dict(zip(("threads", "smem_bytes", "regs", "spill_bytes", "blocks_per_sm", "static_m2"), out))

    def launch(self, args):
        """One kernel launch on the current stream (the only place that counts)."""
        err = self._lib_fn()(
            *args["dims"], *[t.data_ptr() for t in args["ins"] + args["outs"]],
            torch.cuda.current_stream(args["device"]).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{self.lib} kernel launch failed: CUDA error {err}")
        self.launches += 1


class _PdipmKernel(_Kernel):
    """Callable wrapper of the K1 launch."""

    lib = "pdipm_fwd"

    def __init__(self):
        super().__init__()
        self.last_done_it = None  # (B,) stop iteration of each lane in the last launch
        self.last_syncs = None  # (B, 2) barriers in the first Mehrotra iteration and in all

    def _argtypes(self):
        return [ctypes.c_int] * 10 + [ctypes.c_double] + [ctypes.c_void_p] * 11

    def __call__(self, Q, p, G, h, A, b, F, invQ, max_iter, eps, not_improved_lim, structure):
        """Solve the batch; returns (x, y, z, s) like ``pdipm_solve_raw``."""
        if not G.is_cuda:
            return pdipm_solve_raw(Q, p, G, h, A, b, F, max_iter, eps, not_improved_lim, structure)
        args = self.prepare(Q, p, G, h, A, b, F, invQ, max_iter, eps, not_improved_lim, structure)
        self.launch(args)
        return self.finish(args)

    def prepare(self, Q, p, G, h, A, b, F, invQ, max_iter, eps, not_improved_lim, structure):
        """Validate, pad A and b when there is no equality row, and allocate
        the outputs."""
        check_inputs(Q, p, G, h, A, b, F, invQ, structure)
        B, nineq, nz = G.shape
        dtype, device = G.dtype, G.device
        _, k, fd = structure
        neq_real = A.shape[-2]
        A, b = _pad_eq(A, b)
        neq = A.shape[-2]
        ins = _buffers("pdipm_fwd", (Q, invQ, G, A, F, p, h, b), device)
        outs = [
            torch.empty((2, B, nz + 2 * nineq + neq), dtype=dtype, device=device),  # best, current iterate
            torch.empty((B, 4), dtype=torch.int32, device=device),  # stop it, current improves, barriers
        ]
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
        sol2, ints = args["outs"]
        best, cur = sol2[0], sol2[1]
        done_it, cur_imp = ints[:, 0], ints[:, 1]
        self.last_done_it = done_it
        self.last_syncs = ints[:, 2:]
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


class _KktGradKernel(_Kernel):
    """Callable wrapper of the K2 launch."""

    lib = "kkt_bwd"

    def __init__(self):
        super().__init__()
        self.last_syncs = None  # (B,) barriers of each block in the last launch

    def _argtypes(self):
        return [ctypes.c_int] * 8 + [ctypes.c_void_p] * 11

    def __call__(self, invQ, G, A, F, d, rx, structure):
        """The backward KKT solve with rhs (rx, 0, 0, 0) at diagonal d for a
        batch; returns (dx, dlam, dnu) like ``kkt_grad_plain``."""
        if not G.is_cuda:
            return kkt_grad_plain(invQ, G, A, F, d, rx, structure)
        args = self.prepare(invQ, G, A, F, d, rx, structure)
        self.launch(args)
        return self.finish(args)

    def prepare(self, invQ, G, A, F, d, rx, structure):
        """Validate, pad A when there is no equality row, and allocate the
        outputs."""
        check_grad_inputs(invQ, G, A, F, d, rx, structure)
        B, nineq, nz = G.shape
        neq_real = A.shape[-2]
        dtype, device = G.dtype, G.device
        _, k, fd = structure
        A, _ = _pad_eq(A)
        neq = A.shape[-2]
        ins = _buffers("kkt_bwd", (invQ, G, A, F, d, rx), device)
        outs = [
            torch.empty((B, nz), dtype=dtype, device=device),  # dx
            torch.empty((B, nineq), dtype=dtype, device=device),  # dlam
            torch.empty((B, neq), dtype=dtype, device=device),  # dnu (padded rows included)
            torch.empty((B,), dtype=torch.int32, device=device),  # barriers per block
        ]
        dims = (1 if dtype == torch.float64 else 0, B, nz, neq, neq_real, nineq, k, fd)
        return dict(dims=dims, ins=ins, outs=outs, device=device, neq_real=neq_real)

    def finish(self, args):
        dx, dlam, dnu, syncs = args["outs"]
        self.last_syncs = syncs
        return dx, dlam, dnu[:, : args["neq_real"]]


kkt_grad_fric = _KktGradKernel()
