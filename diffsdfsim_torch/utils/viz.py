"""Debug visualization: SDF slice plots.

PyTorch counterpart of ``diffsdfsim_tpu/utils/viz.py`` (reference
``plot_sdf_slices``, ``sdf_physics/physics3d/utils.py:353-391``): sample an
SDF on a res^3 grid over [-1, 1]^3 and plot axis-aligned slices with
optional contour lines. matplotlib is imported only by the plot: it is a
debug tool, not a dependency of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


def sample_sdf_volume(sdf_func, sdf_params, res=64, dtype=torch.float64, device=None):
    """``sdf_func(pts (res^3, 3), *sdf_params)`` on the res^3 lattice on
    ``device`` (default: the card), as a (res, res, res) numpy array."""
    lin = torch.linspace(-1.0, 1.0, res, dtype=dtype, device=resolve_device(device))
    pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1)
    with torch.no_grad():
        vals = sdf_func(pts.reshape(-1, 3), *sdf_params)
    return vals.detach().cpu().numpy().reshape(res, res, res)


def plot_sdf_slices(res, n_slices, sdf_func, sdf_params, slice_dims=(0, 1, 2), plot_contours=(), **sample_kw):
    """A matplotlib figure of ``n_slices`` slices along each of
    ``slice_dims`` of the sampled SDF volume."""
    import matplotlib.pyplot as plt

    sdfs = sample_sdf_volume(sdf_func, sdf_params, res=res, **sample_kw)
    fig, axs = plt.subplots(nrows=n_slices, ncols=len(slice_dims), squeeze=False)
    for i in range(n_slices):
        for col, j in enumerate(slice_dims):
            idx = int(i / max(n_slices - 1, 1) * (sdfs.shape[j] - 1)) if n_slices > 1 else sdfs.shape[j] // 2
            sl = np.take(sdfs, idx, axis=j)
            if j > 0:
                sl = sl.T
            sl = sl[::-1]
            ax = axs[i][col]
            pos = ax.imshow(sl, cmap="seismic", vmin=-1, vmax=1)
            if plot_contours:
                cs = ax.contour(sl, levels=list(plot_contours), colors="black")
                ax.clabel(cs, inline=1, fontsize=10)
            ax.set_xticks([])
            ax.set_yticks([])
            fig.colorbar(pos, ax=ax, fraction=0.046)
    return fig
