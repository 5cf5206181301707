"""K5 wrapper: trilinear voxel-grid sampling as a hand-written CUDA kernel.

Replaces the Pallas kernel ``diffsdfsim_tpu/ops/pallas_kernels.py``
``grid_interp_pallas``; the source is ``ops/csrc/grid_interp.cu``.
``grid_interp(grid, inds)`` takes an (X, Y, Z) grid or a (C, X, Y, Z) stack
of grids and returns what the plain version ``ops/sdf.grid_interp`` returns,
(N,) or (C, N). It dispatches on the tensors' device alone: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain version.

On CUDA the launch sits in an autograd Function: its forward is the kernel,
its backward the plain version's vector-Jacobian product with respect to the
coordinates, recomputed from the saved inputs. The grid takes no gradient,
as in the reference's ``DiffGridSDF``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .sdf import grid_interp as grid_interp_plain


class _GridKernel:
    """Callable wrapper of the K5 launch; ``launches`` counts kernel launches."""

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
            return grid_interp_plain(grid, inds)
        return _GridInterp.apply(inds, grid, self)

    def run(self, grid, inds):
        """Validate, launch once on the current stream and return (N,) or (C, N)."""
        if grid.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"grid kernel takes float32 or float64, not {grid.dtype}")
        if inds.dtype != grid.dtype or inds.device != grid.device:
            raise TypeError(f"grid kernel: inds {inds.dtype} on {inds.device}, grid {grid.dtype} on {grid.device}")
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


class _GridInterp(torch.autograd.Function):
    """Forward: kernel K5. Backward: the plain version's vector-Jacobian
    product with respect to the coordinates; none for the grid."""

    @staticmethod
    def forward(ctx, inds, grid, kernel):
        ctx.save_for_backward(inds, grid)
        return kernel.run(grid, inds)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        inds, grid = ctx.saved_tensors
        with torch.enable_grad():
            xd = inds.detach().requires_grad_(True)
            (gi,) = torch.autograd.grad(grid_interp_plain(grid.detach(), xd), xd, grad)
        return gi, None, None


grid_interp = _GridKernel()
