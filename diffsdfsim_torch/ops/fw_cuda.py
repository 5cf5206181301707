"""K3 wrapper: the Frank-Wolfe contact search as a hand-written CUDA kernel.

Replaces the Pallas kernel ``diffsdfsim_tpu/ops/fw_pallas.py``
``_make_kernel`` (wrapper ``_fw_pallas_flat``, public ``fw_search_pair``).
One launch runs, for one directed pair at R poses (the probe ladder's
rungs), the whole gradient-free search: the candidate gate, min-corner
init, up to ``fw_iters`` FW steps with the per-pair early stop, the surface
push, the contact-point polish, the contact test, the no-grad contact
quantities and max_pen. The source is ``ops/csrc/fw_search.cu``.

The kernel forms its own inputs (body 1's corners in body 2's frame, the
frames) from the vertices, faces and poses, so a launch runs no tensor op
before it: the wrapper looks up the per-body constant block (scale and kind
parameters, built once per body and cached by the shape parameters'
storage and version), allocates one output buffer, whose views are the
nine outputs, and calls the kernel.

``fw_search_pair`` dispatches on the tensors' device alone: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain version,
``physics/contacts.search_pair_raw_plain``. The kernel knows the analytic
shapes only; ``supported_pair`` says, by shape kind, which directed pairs it
takes (the JAX package's ``fw_pallas.supported_pair``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

NBODY = 8  # per-body constants: scale, kind parameters (4), padding
SUPPORTED_KINDS = (0, 1, 2, 3, 4)  # physics/shapes.py KIND_* tags; -1 is a plain mesh
FACE_CAP = 8192  # faces a pose runs one per thread (fw_search.cu FACE_CAP); past it, a scratch state
NSTATE = 19  # per-face state values in that scratch (fw_search.cu NSTATE)


def body_consts(shape, dtype, device):
    """A body's constant block (NBODY,): its scale, then its normalized kind
    parameters (``kernel_params``), zero-padded."""
    prm = [torch.as_tensor(v, dtype=dtype, device=device).detach() for v in shape.kernel_params()]
    vals = [shape.scale().detach().to(dtype=dtype, device=device)] + prm
    vals += [torch.zeros((), dtype=dtype, device=device)] * (NBODY - len(vals))
    return torch.stack(vals).contiguous()


def shape_kind(shape):
    """The kernel's kind tag of a shape, or None where the kernel has none."""
    return shape.kind if shape.kind in SUPPORTED_KINDS else None


def supported_pair(bd1, bd2) -> bool:
    """Can this directed pair (body 1's mesh against body 2's SDF) run
    through the kernel? Body 2 must be an analytic SDF, and body 1 an
    analytic SDF or a plain mesh."""
    if not bd2.is_sdf or shape_kind(bd2.shape) is None:
        return False
    return not bd1.is_sdf or shape_kind(bd1.shape) is not None


def check_pair(bd1, bd2, F: int, dtype):
    """Raise on a pair the kernel does not take."""
    if not supported_pair(bd1, bd2):
        raise ValueError(f"FW kernel: unsupported pair {type(bd1.shape).__name__} -> {type(bd2.shape).__name__}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"FW kernel takes float32 or float64, not {dtype}")
    if F < 1:
        raise ValueError(f"FW kernel takes a body with faces, got {F}")


def out_layout(R: int, F: int, esize: int):
    """The kernel's one output buffer (fw_search.cu ``out_views``), in
    elements of the float type: abc, normal, p1, x1 (R, 3, F), pen (R, F)
    and max_pen (R,); then, 16-byte aligned, cand and cmask (R, F) bytes
    and, 4-byte aligned, the FW iterations run (R,) int32. Returns (byte
    offset of cand, byte offset of the iterations, total elements)."""
    b_cand = ((13 * R * F + R) * esize + 15) // 16 * 16
    b_iters = b_cand + (2 * R * F + 3) // 4 * 4
    return b_cand, b_iters, (b_iters + 4 * R + esize - 1) // esize


class _FwKernel:
    """Callable wrapper of the K3 launch; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._last = None  # (buffer, byte offset, R) of the last launch's FW iteration counts
        self._fn = None
        self._info = None
        self._consts = {}  # (kind, dtype, device, parameter storage and versions) -> (params, block)

    def _lib_fn(self):
        if self._fn is None:
            from ._build import load

            lib = load("fw_search")
            fn = lib.fw_search
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 12
            info = lib.fw_search_info
            info.restype = ctypes.c_int
            info.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
            self._fn, self._info = fn, info
        return self._fn

    @property
    def last_iters(self):
        """(R,) int32: the FW iterations each pose of the last launch ran."""
        buf, off, R = self._last
        return buf.view(torch.int32)[off // 4:off // 4 + R]

    def consts(self, shape, dtype, device):
        """The body's constant block, built once per shape parameters: the
        key holds each parameter tensor's storage and version, so an in-place
        update (an optimizer step on ``rad``) rebuilds it."""
        params = [getattr(shape, f.name) for f in dataclasses.fields(shape)]
        key = (shape.kind, dtype, device) + tuple((t.data_ptr(), t._version) for t in params)
        hit = self._consts.get(key)
        if hit is None:
            if len(self._consts) >= 16:
                self._consts.clear()
            # the entry holds the parameters, so their storage is not reused under its key
            hit = self._consts[key] = (params, body_consts(shape, dtype, device))
        return hit[1]

    def info(self, bd1, bd2, dtype, R: int):
        """The launch's resources for this pair at R poses: threads per CTA,
        CTAs per pose (cluster), shared bytes per CTA, registers and local
        (spill) bytes per thread, CTAs per SM."""
        self._lib_fn()
        out = (ctypes.c_longlong * 6)()
        err = self._info(1 if dtype == torch.float64 else 0, bd1.kind, bd2.kind, R, bd1.faces_t.shape[0],
                         ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"fw_search_info failed: CUDA error {err}")
        return dict(zip(("threads", "cluster", "smem_bytes", "regs", "spill_bytes", "blocks_per_sm"), out))

    def __call__(self, bd1, q1, pos1, bd2, q2, pos2, cfg):
        """One directed pair at R poses (q*/pos* (R,4)/(R,3)). Returns a
        ``physics.contacts.RawPairSearch``."""
        if not q1.is_cuda:
            from ..physics.contacts import search_pair_raw_plain

            return search_pair_raw_plain(bd1, q1, pos1, bd2, q2, pos2, cfg)
        args = self.prepare(bd1, q1, pos1, bd2, q2, pos2, cfg)
        self.launch(args)
        return self.finish(args)

    def prepare(self, bd1, q1, pos1, bd2, q2, pos2, cfg):
        """Validate, look up the bodies' constant blocks and allocate the
        output buffer (and, past FACE_CAP faces, the search's scratch
        state)."""
        R = q1.shape[0]
        F = bd1.faces_t.shape[0]
        dtype, device = q1.dtype, q1.device
        check_pair(bd1, bd2, F, dtype)
        for t in (pos1, q2, pos2, bd1.verts):
            if t.dtype != dtype or t.device != device:
                raise TypeError(f"FW kernel: mixed inputs {t.dtype} on {t.device}")
        for t, shape in ((q1, (R, 4)), (pos1, (R, 3)), (q2, (R, 4)), (pos2, (R, 3))):
            if tuple(t.shape) != shape:
                raise ValueError(f"FW kernel: a pose of shape {tuple(t.shape)}, expected {shape}")
        verts, faces = bd1.verts, bd1.faces_t
        if not (verts.is_contiguous() and faces.is_contiguous() and faces.dtype == torch.int64
                and faces.device == device):
            raise ValueError("FW kernel: body 1's verts and faces_t must be contiguous, faces_t int64 on its device")
        c1 = self.consts(bd1.shape, dtype, device) if bd1.is_sdf else None
        c2 = self.consts(bd2.shape, dtype, device)
        b_cand, b_iters, n = out_layout(R, F, q1.element_size())
        buf = torch.empty((n,), dtype=dtype, device=device)
        state = torch.empty((NSTATE * R * F,), dtype=dtype, device=device) if F > FACE_CAP else None
        strides = (ctypes.c_longlong * 8)(*(s for t in (q1, pos1, q2, pos2) for s in t.stride()))
        polish = int(cfg.contact_polish_iters) if bd1.is_sdf else 0
        dims = (1 if dtype == torch.float64 else 0, bd1.kind, bd2.kind, R, F, int(cfg.fw_iters), polish)
        ptrs = (verts.data_ptr(), faces.data_ptr(), q1.data_ptr(), pos1.data_ptr(), q2.data_ptr(),
                pos2.data_ptr(), ctypes.addressof(strides), 0 if c1 is None else c1.data_ptr(), c2.data_ptr(),
                buf.data_ptr(), 0 if state is None else state.data_ptr())
        return dict(dims=dims, tols=(float(cfg.eps), float(cfg.tol)), ptrs=ptrs,
                    keep=(strides, q1, pos1, q2, pos2, state),
                    buf=buf, layout=(R, F, b_cand, b_iters), device=device)

    def launch(self, args):
        """One kernel launch on the current stream (the only place that counts)."""
        err = self._lib_fn()(*args["dims"], *args["tols"], *args["ptrs"],
                             torch.cuda.current_stream(args["device"]).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fw_search kernel launch failed: CUDA error {err}")
        self.launches += 1

    def finish(self, args):
        """The nine outputs, as views into the one buffer."""
        from ..physics.contacts import RawPairSearch

        R, F, b_cand, b_iters = args["layout"]
        buf = args["buf"]
        n3 = 3 * R * F
        f3 = lambda i: buf.as_strided((R, F, 3), (3 * F, 1, F), i * n3)  # (R,F,3) of (R,3,F)
        flags = buf.view(torch.bool)
        self._last = (buf, b_iters, R)
        return RawPairSearch(
            abc=f3(0), n_ng=f3(1), p1_ng=f3(2), pen=buf.as_strided((R, F), (F, 1), 4 * n3),
            cand=flags.as_strided((R, F), (F, 1), b_cand), cmask=flags.as_strided((R, F), (F, 1), b_cand + R * F),
            max_pen=buf.as_strided((R,), (1,), 4 * n3 + R * F), x1=f3(3),
        )


fw_search_pair = _FwKernel()
