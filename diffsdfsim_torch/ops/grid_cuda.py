"""K5 wrappers: the voxel-grid SDF as hand-written CUDA kernels.

Replaces the Pallas kernel ``diffsdfsim_tpu/ops/pallas_kernels.py``
``grid_interp_pallas``; the source is ``ops/csrc/grid_interp.cu``, whose
query entry ``grid_query_lanes`` serves the first two of three wrappers:

- ``grid_query(pts, grid, scale=None, return_grads=True)``: one grid-SDF
  query in one launch (the query entry at one lane), what the plain version ``ops/sdf.grid_query``
  returns. With a scale, ``query_sdfs`` of a ``GridShape`` (metric points,
  the bounding-scale mask, metric values, the twice normalized gradient);
  without one, ``grid_sdf`` and ``grid_sdf_grad`` of points in the grid's
  normalized frame. The kernel forms the voxel index, the masks and the
  central differences itself: no gradient volume is built and no tensor is
  made from a Python value.
- ``grid_query_lanes(pts, grids, scales=None, return_grads=True)``: the
  queries of a seed sweep's lanes in one launch (the lane entry): grids (L,
  X, Y, Z) or one shared grid, scales (L,) or one, points (R, N, 3) with
  R = L d lane-major (pose r reads lane r // d), what ``torch.func.vmap``
  of ``ops/sdf.grid_query`` returns. ``grid_query`` under
  ``torch.func.vmap`` (a grid lane body's query) reaches it through the
  autograd Function's vmap rule: one launch for the whole batch.
- ``grid_interp(grid, inds)``: trilinear sampling of an (X, Y, Z) grid or a
  (C, X, Y, Z) stack, (N,) or (C, N), what ``ops/sdf.grid_interp`` returns.

All dispatch on the tensors' device alone: CUDA tensors launch the kernel
(or raise), CPU tensors take the plain version.

On CUDA the query sits in an autograd Function. The value's vector-Jacobian
product with respect to the points is ``GridSdf``'s, the kernel's saved
once-normalized gradient times the cotangent (through the scale and the
overlap mask); the gradient output's, and anything with respect to the
scale, are autograd's of the plain composition, recomputed from the saved
inputs (for lanes, the plain composition mapped over them, so a lane's
d scale reaches that lane only). The grid takes no gradient, as in the
reference's ``DiffGridSDF``.
"""

from __future__ import annotations

import ctypes

import torch

from . import sdf as sdf_ops


def _check(grid, pts):
    if grid.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"grid kernel takes float32 or float64, not {grid.dtype}")
    if pts.dtype != grid.dtype or pts.device != grid.device:
        raise TypeError(f"grid kernel: points {pts.dtype} on {pts.device}, grid {grid.dtype} on {grid.device}")


class _GridKernel:
    """The K5 sampler's launch; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _lib_fn(self):
        if self._fn is None:
            from ._build import load

            fn = load("grid_interp").grid_interp
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
            self._fn = fn
        return self._fn

    def __call__(self, grid, inds):
        if not inds.is_cuda:
            return sdf_ops.grid_interp(grid, inds)
        return self.run(grid, inds)

    def run(self, grid, inds):
        """Validate, launch once on the current stream and return (N,) or (C, N)."""
        _check(grid, inds)
        if grid.dim() not in (3, 4) or inds.dim() != 2 or inds.shape[1] != 3:
            raise ValueError(f"grid kernel takes an (X,Y,Z) or (C,X,Y,Z) grid and (N,3) inds, "
                             f"got {tuple(grid.shape)} and {tuple(inds.shape)}")
        g = grid.detach().contiguous()
        g4 = g if g.dim() == 4 else g[None]
        C, X, Y, Z = g4.shape
        n = inds.shape[0]
        ind = inds.detach().contiguous()
        out = torch.empty((C, n), dtype=grid.dtype, device=grid.device)
        err = self._lib_fn()(
            1 if grid.dtype == torch.float64 else 0, C, X, Y, Z, n, g4.data_ptr(), ind.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(grid.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"grid_interp kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out if grid.dim() == 4 else out[0]


_query_fn = None


def _query_lib_fn():
    """``grid_query_lanes`` of grid_interp.cu, the one query entry."""
    global _query_fn
    if _query_fn is None:
        from ._build import load

        fn = load("grid_interp").grid_query_lanes
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _query_fn = fn
    return _query_fn


class _GridQueryKernel:
    """The K5 query's launch (one body's query is the lane entry at one
    lane); ``launches`` counts the launches made through this object, so
    the single and the lane queries count apart."""

    def __init__(self):
        self.launches = 0

    def run(self, pts, grid, scale=None, grad=False, grad_in=False, grad_raw=False):
        """Validate, launch once on the current stream and return (sdf,
        grad, grad_in, grad_raw), each gradient where asked for, else None:
        ``grad`` the query's twice normalized, overlap-masked gradient
        (needs a scale), ``grad_in`` ``grid_sdf_grad`` of the normalized
        points, ``grad_raw`` the interpolated central differences before
        normalize and masks. One query: pts (N, 3), an (X, Y, Z) grid and a
        0-dim scale, returning (N,) and (N, 3). Lanes: pts (L, M, 3), grids
        (L, X, Y, Z) or one (X, Y, Z) every lane shares, scales (L,) or a
        0-dim one, returning (L, M) and (L, M, 3)."""
        _check(grid, pts)
        L = pts.shape[0] if pts.dim() == 3 else 1
        if (pts.dim() not in (2, 3) or pts.shape[-1] != 3 or grid.dim() not in (3, 4)
                or (grid.dim() == 4 and (pts.dim() == 2 or grid.shape[0] != L))):
            raise ValueError(f"grid query: grid {tuple(grid.shape)} and points {tuple(pts.shape)}")
        if scale is not None and (scale.dim() not in (0, 1) or scale.dtype != grid.dtype or scale.device != grid.device
                                  or (scale.dim() == 1 and (pts.dim() == 2 or scale.shape[0] != L))):
            raise TypeError(f"grid query: scale must be a 0-dim (or, for lanes, (L,)) {grid.dtype} tensor on "
                            f"{grid.device}, got {tuple(scale.shape)}")
        if grad and scale is None:
            raise ValueError("grid query: the query's gradient needs a scale")
        g = grid.detach().contiguous()
        p = pts.detach().contiguous()
        s = None if scale is None else scale.detach().contiguous()
        n = p.numel() // 3
        want = (grad, grad_in, grad_raw)
        buf = torch.empty((n * (1 + 3 * sum(want)),), dtype=grid.dtype, device=grid.device)
        lead = p.shape[:-1]
        outs, ptrs, off = [buf[:n].view(lead)], [], n
        for w in want:
            outs.append(buf[off:off + 3 * n].view(lead + (3,)) if w else None)
            ptrs.append(buf.data_ptr() + off * buf.element_size() if w else None)
            off += 3 * n if w else 0
        err = _query_lib_fn()(
            1 if grid.dtype == torch.float64 else 0, L, *g.shape[-3:], n // L, g.data_ptr(),
            g[0].numel() if g.dim() == 4 else 0, p.data_ptr(), None if s is None else s.data_ptr(),
            1 if s is not None and s.dim() == 1 else 0, buf.data_ptr(), *ptrs,
            torch.cuda.current_stream(grid.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"grid_query_lanes kernel launch failed: CUDA error {err}")
        self.launches += 1
        return tuple(outs)


def _lane_view(t, lanes: bool):
    """A per-lane scale as a tensor that broadcasts against one value per
    point ((L, 1) for (L,) on (L, M) points), else as it is."""
    return t[:, None] if lanes and t is not None and t.dim() == 1 else t


def _plain_query(pts, grid, scale):
    """The plain composition of a single or lane query (``torch.func.vmap``
    of ``ops/sdf.grid_query`` over the lanes), differentiable in pts and
    scale."""
    if pts.dim() == 2:
        return sdf_ops.grid_query(pts, grid, scale)
    dims = (0, None if scale is None or scale.dim() == 0 else 0, 0 if grid.dim() == 4 else None)
    return torch.func.vmap(lambda p, s, g: sdf_ops.grid_query(p, g, s), in_dims=dims)(pts, scale, grid)


class _GridQuery(torch.autograd.Function):
    """Forward: one K5 query launch, of one lane for points (N, 3), of L
    lanes for points (L, M, 3) (grids and scales per lane or shared). Outputs (sdf, the gradient output or None, the once-normalized
    gradient kept for the backward or None). Backward, per lane: the
    value's product with the saved once-normalized gradient; the plain
    composition's vector-Jacobian product for the gradient output and for
    the scale. vmap: the mapped axis folded into the lanes (into the points
    where grid and scale are shared): one launch for the whole batch."""

    @staticmethod
    def forward(pts, scale, grid, return_grads, grad_mode):
        scaled = scale is not None
        keep_in = grad_mode and (pts.requires_grad or (scaled and scale.requires_grad))
        kernel = grid_query_lanes_kernel if pts.dim() == 3 else grid_query_kernel
        sdf, grad, grad_in, _ = kernel.run(pts, grid, scale, grad=scaled and return_grads,
                                           grad_in=keep_in or (return_grads and not scaled))
        if not return_grads:
            return sdf, None, grad_in
        return (sdf, grad, grad_in) if scaled else (sdf, grad_in, None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pts, scale, grid, _, _ = inputs
        kept = output[2] if output[2] is not None or scale is not None else output[1]
        ctx.set_materialize_grads(False)
        if output[2] is not None:
            ctx.mark_non_differentiable(output[2])
        ctx.grid, ctx.scaled = grid, scale is not None
        ctx.save_for_backward(pts, scale, kept)

    @staticmethod
    def vmap(info, in_dims, pts, scale, grid, return_grads, grad_mode):
        pd, sd, gd = in_dims[:3]
        B = info.batch_size
        x = pts.movedim(pd, 0) if pd is not None else pts.expand((B,) + pts.shape)
        inner = x.dim() == 4  # the points already carry lanes (a lane call under another vmap)
        if gd is None and grid.dim() == 3 and (scale is None or (sd is None and scale.dim() == 0)):
            # grid and scale shared by every lane: the points of all lanes in one query
            out = _GridQuery.apply(x.reshape(-1, 3), scale, grid, return_grads, grad_mode)
        else:
            L = x.shape[0] * (x.shape[1] if inner else 1)

            def lanes_of(t, d, base):
                """t per lane, (L,) + one lane's shape, or as it is where
                every lane shares it (the kernel's lane stride 0)."""
                if t is None or (d is None and t.dim() == base):
                    return t
                t = t.movedim(d, 0) if d is not None else t.expand((B,) + t.shape)
                if inner and t.dim() == base + 1:  # mapped here, shared by the inner lanes
                    t = t[:, None].expand((B, x.shape[1]) + t.shape[1:])
                return t.reshape((L,) + t.shape[t.dim() - base:])

            out = _GridQuery.apply(x.reshape(L, -1, 3), lanes_of(scale, sd, 0), lanes_of(grid, gd, 3), return_grads,
                                   grad_mode)
        lead = x.shape[:-1]
        res = (out[0].reshape(lead),) + tuple(None if o is None else o.reshape(lead + (3,)) for o in out[1:])
        return res, tuple(None if o is None else 0 for o in res)

    @staticmethod
    def backward(ctx, d_sdf, d_grad, _):
        pts, scale, grad_in = ctx.saved_tensors
        lanes = pts.dim() == 3
        need_pts = ctx.needs_input_grad[0]
        need_scale = ctx.scaled and ctx.needs_input_grad[1]
        d_pts = d_scale = None
        if d_sdf is not None and need_pts and not need_scale:
            if ctx.scaled:
                s = _lane_view(scale, lanes)
                overlap = torch.all(torch.abs(pts) <= s[..., None], dim=-1)
                d_n = torch.where(overlap, d_sdf * s, torch.zeros_like(d_sdf))
                d_pts = grad_in * d_n[..., None] / s[..., None]
            else:
                d_pts = grad_in * d_sdf[..., None]
        if (need_pts or need_scale) and (d_grad is not None or (need_scale and d_sdf is not None)):
            # autograd of the plain composition: the gradient output always,
            # the value too where the scale takes a gradient
            with torch.enable_grad():
                p = pts.detach().requires_grad_(need_pts)
                s = scale.detach().requires_grad_(need_scale) if ctx.scaled else None
                sdf, grad = _plain_query(p, ctx.grid.detach(), s)
                outs, cots = [], []
                if d_grad is not None:
                    outs.append(grad)
                    cots.append(d_grad)
                if need_scale and d_sdf is not None:
                    outs.append(sdf)
                    cots.append(d_sdf)
                wrt = [p] * need_pts + [s] * need_scale
                got = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
            if need_pts and got[0] is not None:
                d_pts = got[0] if d_pts is None else d_pts + got[0]
            if need_scale:
                d_scale = got[-1]
        d_grid = torch.zeros_like(ctx.grid) if ctx.needs_input_grad[2] else None
        return d_pts, d_scale, d_grid, None, None


grid_interp = _GridKernel()
grid_query_kernel = _GridQueryKernel()  # one body's queries
grid_query_lanes_kernel = _GridQueryKernel()  # lane queries


def _query(pts, grid, scale, return_grads):
    """The Function's query of pts (N, 3) or lane points (L, M, 3)."""
    sdf, grad, _ = _GridQuery.apply(pts, scale, grid, return_grads, torch.is_grad_enabled())
    return (sdf, grad) if return_grads else sdf


def grid_query(pts, grid, scale=None, return_grads=True):
    """A grid-SDF query of pts (..., 3): with a scale (a 0-dim tensor), the
    metric query of a GridShape, ``sdfs`` or ``(sdfs, grads)``; without, the
    normalized-frame ``grid_sdf`` value or ``(grid_sdf, grid_sdf_grad)``. CPU
    tensors take the plain version ``ops/sdf.grid_query``; CUDA tensors one
    kernel launch (under ``torch.func.vmap`` over lane grids, one lane-entry
    launch for all lanes)."""
    if not pts.is_cuda:
        return sdf_ops.grid_query(pts, grid, scale, return_grads)
    lead = pts.shape[:-1]
    out = _query(pts.reshape(-1, 3), grid, scale, return_grads)
    if not return_grads:
        return out.reshape(lead)
    return out[0].reshape(lead), out[1].reshape(lead + (3,))


def grid_query_lanes(pts, grids, scales=None, return_grads=True):
    """The grid-SDF queries of L lanes: pts (R, N, 3) with R = L d poses,
    lane-major (pose r reads lane r // d), grids (L, X, Y, Z) or one (X,
    Y, Z) grid every lane shares, scales (L,) or a 0-dim scale, or None (the
    normalized frame, as ``grid_query``). Returns sdfs (R, N) or (sdfs,
    grads (R, N, 3)). CPU tensors take the plain version
    (``torch.func.vmap`` of ``ops/sdf.grid_query``); CUDA tensors one
    lane-entry launch."""
    R = pts.shape[0]
    L = grids.shape[0] if grids.dim() == 4 else (scales.shape[0] if scales is not None and scales.dim() == 1 else R)
    if R % L:
        raise ValueError(f"grid query lanes: {R} poses for {L} lanes")
    x = pts.reshape(L, -1, 3)
    if not pts.is_cuda:
        dims = (0, 0 if grids.dim() == 4 else None, None if scales is None or scales.dim() == 0 else 0)
        out = torch.func.vmap(lambda p, g, s: sdf_ops.grid_query(p, g, s, return_grads), in_dims=dims)(x, grids, scales)
    else:
        out = _query(x, grids, scales, return_grads)
    if not return_grads:
        return out.reshape(pts.shape[:-1])
    return out[0].reshape(pts.shape[:-1]), out[1].reshape(pts.shape)
