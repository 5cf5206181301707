"""Frank-Wolfe contact-point search over SDF surfaces (plain version).

PyTorch counterpart of ``diffsdfsim_tpu/ops/frank_wolfe.py`` (reference
``sdf_physics/physics3d/contacts.py:39-94``). For every triangle of body 1's
surface mesh, expressed in body 2's local frame, minimize body 2's SDF over
the triangle by up to ``iters`` Frank-Wolfe steps, tracking barycentric
coordinates. All faces run in lockstep under a candidate mask; the
reference's per-pair early stops ("all improvements below tol" / "found
sdf < -tol") freeze a whole search.

The leading axis R is a batch of independent searches (the probe ladder's
rungs); each one stops on its own, as the vmapped JAX while_loop does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as tnf


class FWResult(NamedTuple):
    abc: torch.Tensor  # (R,F,3) barycentric coords of the per-face minimizer
    x: torch.Tensor  # (R,F,3) minimizer in body 2's local metric frame
    cand: torch.Tensor  # (R,F) candidate mask (centroid ball test)
    contact_mask: torch.Tensor  # (R,F) cand & (sdf <= eps) after finalize_fw


def _take(pqr, ind):
    """pqr (R,F,3,3), ind (R,F) -> the selected corners (R,F,3)."""
    return torch.gather(pqr, 2, ind[..., None, None].expand(ind.shape + (1, 3)))[..., 0, :]


def frank_wolfe(pqr, query_fn: Callable, eps: float, tol: float, iters: int = 32) -> FWResult:
    """FW over all faces of R independent searches. ``pqr`` (R,F,3,3) are
    triangles in body 2's local metric frame; ``query_fn(pts) -> (sdfs,
    grads)`` is body 2's metric local SDF (grads normalized)."""
    dtype = pqr.dtype
    # candidate test: centroid sdf < face circumradius + eps (contacts.py:44-52)
    x0 = torch.mean(pqr, dim=2)
    centr_sdfs, centr_grads = query_fn(x0)
    rads = torch.amax(torch.linalg.norm(x0[:, :, None, :] - pqr, dim=-1), dim=2)
    cand = (centr_sdfs < rads + eps) & (torch.linalg.norm(centr_grads, dim=-1) > 1e-12)

    # init at the corner with the smallest sdf (contacts.py:57-61)
    R, F = pqr.shape[:2]
    corner_sdfs = query_fn(pqr.reshape(R, F * 3, 3))[0].reshape(R, F, 3)
    init_ind = torch.argmin(corner_sdfs, dim=-1)
    x = _take(pqr, init_ind)
    abc = tnf.one_hot(init_ind, 3).to(dtype)

    active = torch.any(cand, dim=-1)
    it = 0
    while it < iters and bool(torch.any(active)):
        sdfs, grads = query_fn(x)
        # linear minimization oracle: corner minimizing grad . corner
        dpqr = torch.einsum("rfvc,rfc->rfv", pqr, grads)
        ind = torch.argmin(dpqr, dim=-1)
        s = _take(pqr, ind)

        gamma = 2.0 / (it + 2.0)
        impr = torch.sum((x - s) * grads, dim=-1)
        gamma = gamma * (torch.abs(impr) > tol).to(dtype)
        gamma = torch.where(cand, gamma, torch.zeros_like(gamma))

        # per-search early stops (contacts.py:75-78)
        stop = torch.all(gamma == 0.0, dim=-1) | torch.any(
            torch.where(cand, sdfs, torch.zeros_like(sdfs)) < -tol, dim=-1
        )
        active = active & ~stop

        g = torch.where(active[:, None], gamma, torch.zeros_like(gamma))[..., None]
        x = (1.0 - g) * x + g * s
        abc = abc * (1.0 - g) + g * tnf.one_hot(ind, 3).to(dtype)
        it += 1
    return FWResult(abc=abc, x=x, cand=cand, contact_mask=cand)


def finalize_fw(res: FWResult, query_fn: Callable, eps: float, push_fn: Callable | None = None) -> FWResult:
    """Surface push + final contact test (contacts.py:84-94). ``push_fn(abc)
    -> delta_x`` projects onto body 1's surface when body 1 is an SDF body."""
    x = res.x
    if push_fn is not None:
        x = x + push_fn(res.abc)
    sdfs = query_fn(x)[0]
    return FWResult(abc=res.abc, x=x, cand=res.cand, contact_mask=res.cand & (sdfs <= eps))
