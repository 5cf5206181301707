"""K5 wrappers: the voxel-grid SDF as hand-written CUDA kernels.

Replaces the Pallas kernel ``diffsdfsim_tpu/ops/pallas_kernels.py``
``grid_interp_pallas``; the source is ``ops/csrc/grid_interp.cu``, with two
entry points:

- ``grid_query(pts, grid, scale=None, return_grads=True)``: one grid-SDF
  query in one launch, what the plain version ``ops/sdf.grid_query``
  returns. With a scale, ``query_sdfs`` of a ``GridShape`` (metric points,
  the bounding-scale mask, metric values, the twice normalized gradient);
  without one, ``grid_sdf`` and ``grid_sdf_grad`` of points in the grid's
  normalized frame. The kernel forms the voxel index, the masks and the
  central differences itself: no gradient volume is built and no tensor is
  made from a Python value.
- ``grid_interp(grid, inds)``: trilinear sampling of an (X, Y, Z) grid or a
  (C, X, Y, Z) stack, (N,) or (C, N), what ``ops/sdf.grid_interp`` returns.

Both dispatch on the tensors' device alone: CUDA tensors launch the kernel
(or raise), CPU tensors take the plain version.

On CUDA the query sits in an autograd Function. The value's vector-Jacobian
product with respect to the points is ``GridSdf``'s, the kernel's saved
once-normalized gradient times the cotangent (through the scale and the
overlap mask); the gradient output's, and anything with respect to the
scale, are autograd's of the plain composition, recomputed from the saved
inputs. The grid takes no gradient, as in the reference's ``DiffGridSDF``.
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


class _GridQueryKernel:
    """The K5 query's launch; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _lib_fn(self):
        if self._fn is None:
            from ._build import load

            fn = load("grid_interp").grid_query
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8
            self._fn = fn
        return self._fn

    def run(self, pts, grid, scale=None, grad=False, grad_in=False, grad_raw=False):
        """Validate, launch once on the current stream and return (sdf (N,),
        grad, grad_in, grad_raw), each gradient (N, 3) where asked for, else
        None: ``grad`` the query's twice normalized, overlap-masked gradient
        (needs a scale), ``grad_in`` ``grid_sdf_grad`` of the normalized
        points, ``grad_raw`` the interpolated central differences before
        normalize and masks."""
        _check(grid, pts)
        if grid.dim() != 3 or pts.dim() != 2 or pts.shape[1] != 3:
            raise ValueError(f"grid query takes an (X,Y,Z) grid and (N,3) points, "
                             f"got {tuple(grid.shape)} and {tuple(pts.shape)}")
        if scale is not None and (scale.dim() != 0 or scale.dtype != grid.dtype or scale.device != grid.device):
            raise TypeError(f"grid query: scale must be a 0-dim {grid.dtype} tensor on {grid.device}")
        if grad and scale is None:
            raise ValueError("grid query: the query's gradient needs a scale")
        g = grid.detach().contiguous()
        p = pts.detach().contiguous()
        n = p.shape[0]
        want = (grad, grad_in, grad_raw)
        buf = torch.empty((n * (1 + 3 * sum(want)),), dtype=grid.dtype, device=grid.device)
        outs, ptrs, off = [buf[:n]], [], n
        for w in want:
            outs.append(buf[off:off + 3 * n].view(n, 3) if w else None)
            ptrs.append(buf.data_ptr() + off * buf.element_size() if w else None)
            off += 3 * n if w else 0
        err = self._lib_fn()(
            1 if grid.dtype == torch.float64 else 0, *g.shape, n, g.data_ptr(), p.data_ptr(),
            None if scale is None else scale.data_ptr(), buf.data_ptr(), *ptrs,
            torch.cuda.current_stream(grid.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"grid_query kernel launch failed: CUDA error {err}")
        self.launches += 1
        return tuple(outs)


class _GridQuery(torch.autograd.Function):
    """Forward: one K5 query launch. Backward: the value's product with the
    saved once-normalized gradient; the plain composition's vector-Jacobian
    product for the gradient output and for the scale."""

    @staticmethod
    def forward(ctx, pts, scale, grid, return_grads):
        scaled = scale is not None
        keep_in = ctx.needs_input_grad[0] or (scaled and ctx.needs_input_grad[1])
        sdf, grad, grad_in, _ = grid_query_kernel.run(pts, grid, scale, grad=scaled and return_grads,
                                                      grad_in=keep_in or (return_grads and not scaled))
        ctx.set_materialize_grads(False)
        ctx.grid, ctx.scaled = grid, scaled
        ctx.save_for_backward(pts, scale if scaled else None, grad_in)
        if not return_grads:
            return sdf
        return sdf, grad if scaled else grad_in

    @staticmethod
    def backward(ctx, d_sdf, d_grad=None):
        pts, scale, grad_in = ctx.saved_tensors
        need_pts = ctx.needs_input_grad[0]
        need_scale = ctx.scaled and ctx.needs_input_grad[1]
        d_pts = d_scale = None
        if d_sdf is not None and need_pts and not need_scale:
            if ctx.scaled:
                overlap = torch.all(torch.abs(pts) <= scale, dim=-1)
                d_n = torch.where(overlap, d_sdf * scale, torch.zeros_like(d_sdf))
                d_pts = grad_in * d_n[..., None] / scale
            else:
                d_pts = grad_in * d_sdf[..., None]
        if (need_pts or need_scale) and (d_grad is not None or (need_scale and d_sdf is not None)):
            # autograd of the plain composition: the gradient output always,
            # the value too where the scale takes a gradient
            with torch.enable_grad():
                p = pts.detach().requires_grad_(need_pts)
                s = scale.detach().requires_grad_(need_scale) if ctx.scaled else None
                sdf, grad = sdf_ops.grid_query(p, ctx.grid.detach(), s)
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
        return d_pts, d_scale, d_grid, None


grid_interp = _GridKernel()
grid_query_kernel = _GridQueryKernel()


def grid_query(pts, grid, scale=None, return_grads=True):
    """A grid-SDF query of pts (..., 3): with a scale (a 0-dim tensor), the
    metric query of a GridShape, ``sdfs`` or ``(sdfs, grads)``; without, the
    normalized-frame ``grid_sdf`` value or ``(grid_sdf, grid_sdf_grad)``. CPU
    tensors take the plain version ``ops/sdf.grid_query``; CUDA tensors one
    kernel launch."""
    if not pts.is_cuda:
        return sdf_ops.grid_query(pts, grid, scale, return_grads)
    lead = pts.shape[:-1]
    out = _GridQuery.apply(pts.reshape(-1, 3), scale, grid, return_grads)
    if not return_grads:
        return out.reshape(lead)
    return out[0].reshape(lead), out[1].reshape(lead + (3,))
