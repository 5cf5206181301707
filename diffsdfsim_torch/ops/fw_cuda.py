"""K3 wrapper: the Frank-Wolfe contact search as a hand-written CUDA kernel.

Replaces the Pallas kernel ``diffsdfsim_tpu/ops/fw_pallas.py``
``_make_kernel`` (wrapper ``_fw_pallas_flat``, public ``fw_search_pair``).
One launch runs, for one directed pair at R poses (the probe ladder's
rungs), the whole gradient-free search: the candidate gate, min-corner
init, up to ``fw_iters`` FW steps with the per-pair early stop, the surface
push, the contact-point polish, the contact test, the no-grad contact
quantities and max_pen. The source is ``ops/csrc/fw_search.cu``.

``fw_search_pair`` dispatches on the tensors' device alone: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain version,
``physics/contacts.search_pair_raw_plain``. The kernel knows the analytic
shapes only; ``supported_pair`` says, by shape kind, which directed pairs it
takes (the JAX package's ``fw_pallas.supported_pair``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.quaternion import quat_apply, quat_invert, quat_to_matrix

NCONST = 32  # packed per-pose constants: R1(9) R2(9) d21(3) s1 s2 _ prm1(4) prm2(4)
NPARAMS = 4
SUPPORTED_KINDS = (0, 1, 2, 3, 4)  # physics/shapes.py KIND_* tags; -1 is a plain mesh
MAX_FACES = 8192


def _params(shape, like):
    prm = list(shape.kernel_params())
    prm = [torch.as_tensor(v, dtype=like.dtype, device=like.device) for v in prm]
    prm += [torch.zeros((), dtype=like.dtype, device=like.device)] * (NPARAMS - len(prm))
    return torch.stack(prm), shape.scale().to(like.dtype)


def pack_inputs(bd1, q1, pos1, bd2, q2, pos2):
    """Kernel inputs for R poses: pqr (R,9,F) (triangle corners of body 1 in
    body 2's frame, component-major) and consts (R, NCONST)."""
    R = q1.shape[0]
    verts_b2 = quat_apply(
        quat_invert(q2[:, None]), quat_apply(q1[:, None], bd1.verts) + pos1[:, None] - pos2[:, None]
    )
    tri = verts_b2[:, bd1.faces_t]  # (R,F,3,3)
    F = tri.shape[1]
    pqr = tri.permute(0, 2, 3, 1).reshape(R, 9, F).contiguous()
    R1 = quat_to_matrix(q1).reshape(R, 9)
    R2 = quat_to_matrix(q2).reshape(R, 9)
    d21 = pos2 - pos1
    if bd1.is_sdf:
        prm1, s1 = _params(bd1.shape, q1)
    else:
        prm1 = torch.zeros((NPARAMS,), dtype=q1.dtype, device=q1.device)
        s1 = torch.ones((), dtype=q1.dtype, device=q1.device)
    prm2, s2 = _params(bd2.shape, q1)
    per_pose = torch.cat([R1, R2, d21], dim=1)  # (R,21)
    shared = torch.cat([torch.stack([s1, s2, torch.zeros_like(s1)]), prm1, prm2])  # (11,)
    consts = torch.cat([per_pose, shared.expand(R, -1)], dim=1)
    consts = torch.nn.functional.pad(consts, (0, NCONST - consts.shape[1])).contiguous()
    return pqr, consts


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
    if not 0 < F <= MAX_FACES:
        raise ValueError(f"FW kernel takes 1..{MAX_FACES} faces, got {F}")


class _FwKernel:
    """Callable wrapper of the K3 launch; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self.last_iters = None  # (R,) FW iterations of the last launch
        self._fn = None

    def _lib_fn(self):
        if self._fn is None:
            from ._build import load

            fn = load("fw_search").fw_search
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 12
            self._fn = fn
        return self._fn

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
        """Validate, pack the kernel's inputs and allocate its outputs."""
        R = q1.shape[0]
        F = bd1.faces_t.shape[0]
        dtype, device = q1.dtype, q1.device
        check_pair(bd1, bd2, F, dtype)
        for t in (pos1, q2, pos2, bd1.verts):
            if t.dtype != dtype or t.device != device:
                raise TypeError(f"FW kernel: mixed inputs {t.dtype} on {t.device}")
        pqr, consts = pack_inputs(bd1, q1, pos1, bd2, q2, pos2)
        polish = int(cfg.contact_polish_iters) if bd1.is_sdf else 0
        f3 = lambda: torch.empty((R, 3, F), dtype=dtype, device=device)
        outs = [
            f3(), f3(), f3(), f3(),  # abc, normal, p1, x1
            torch.empty((R, F), dtype=dtype, device=device),  # pen
            torch.empty((R, F), dtype=torch.uint8, device=device),  # cand
            torch.empty((R, F), dtype=torch.uint8, device=device),  # cmask
            torch.empty((R,), dtype=dtype, device=device),  # max_pen
            torch.empty((R,), dtype=torch.int32, device=device),  # FW iterations run
        ]
        dims = (1 if dtype == torch.float64 else 0, bd1.kind, bd2.kind, R, F, int(cfg.fw_iters), polish)
        return dict(dims=dims, tols=(float(cfg.eps), float(cfg.tol)), ins=[pqr, consts], outs=outs,
                    device=device)

    def launch(self, args):
        """One kernel launch on the current stream (the only place that counts)."""
        err = self._lib_fn()(
            *args["dims"], *args["tols"], *[t.data_ptr() for t in args["ins"] + args["outs"]],
            torch.cuda.current_stream(args["device"]).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"fw_search kernel launch failed: CUDA error {err}")
        self.launches += 1

    def finish(self, args):
        from ..physics.contacts import RawPairSearch

        abc, nrm, p1w, x1, pen, cand, cmask, max_pen, iters_run = args["outs"]
        self.last_iters = iters_run
        tr = lambda t: t.transpose(1, 2)  # (R,F,3)
        # the kernel marks "no contact" with a -1e30 sentinel (fw_pallas.py:673-675)
        max_pen = torch.where(max_pen <= -1e30, torch.full_like(max_pen, float("-inf")), max_pen)
        return RawPairSearch(
            abc=tr(abc), n_ng=tr(nrm), p1_ng=tr(p1w), pen=pen, cand=cand.bool(),
            cmask=cmask.bool(), max_pen=max_pen, x1=tr(x1),
        )


fw_search_pair = _FwKernel()
