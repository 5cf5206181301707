"""Time-of-contact (TOC) differential.

PyTorch counterpart of ``diffsdfsim_tpu/ops/toc.py`` (reference
``lcp_physics/physics/world.py:141-237``, class ``World.H``). After a step
that creates new contacts, dt is re-emitted through ``toc_dt``, an identity
whose backward applies the implicit function theorem to the contact gap
function

    D(h, .) = n2' (c2 - R2h' (R1h c1 + x1h - x2h))

with x_ih = x_i + h v_i + 1/2 a_i h^2 and R_ih = exp(h w_i) R_i:

    dL/dtheta = -dL/dh * sum_k w_k dD_k/dtheta,   w = dD/dh / sum_k (dD_k/dh)^2,

with dD_k/dh < TOL/h zeroed ("only motion into collision", world.py:204),
padded slots masked, and w = 0 when sum (dD/dh)^2 <= 1e-5
(world.py:206-210). The backward is one forward-mode derivative for dD/dh
and one vector-Jacobian product with cotangent -w dL/dh for all eleven
inputs at once, as in the JAX package.

A seed sweep's B worlds (``physics/batched.py``) re-emit their dts in one
call: h (B,), the arguments and the mask (B, K, ...), every sum over a
lane's own contacts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.quaternion import so3_exp_map

TOC_TOL = 1e-6  # reference uses the 2D Defaults.TOL here (world.py:204)


class TocArgs(NamedTuple):
    """Per-contact state entering the gap function, all (K, ...) padded."""

    cs1: torch.Tensor  # (K,3) contact point in body 1's frame before the step
    cs2: torch.Tensor  # (K,3)
    vs1: torch.Tensor  # (K,6) body velocities [omega, v]
    vs2: torch.Tensor  # (K,6)
    poss1: torch.Tensor  # (K,3) body positions before the step
    poss2: torch.Tensor  # (K,3)
    rots1: torch.Tensor  # (K,3,3) world rotations before the step
    rots2: torch.Tensor  # (K,3,3)
    ns2: torch.Tensor  # (K,3) contact normal in body 2's frame
    as1: torch.Tensor  # (K,6) accelerations (applied force / mass)
    as2: torch.Tensor  # (K,6)


def gap_function(h, a: TocArgs):
    """D(h, .): (K,) signed gap at time offset h (reference world.py:150-171);
    (B, K) for h (B,) and arguments (B, K, ...)."""
    if h.dim():
        h = h[:, None, None]
    Rih = so3_exp_map(h * a.vs1[..., :3]) @ a.rots1
    Rjh = so3_exp_map(h * a.vs2[..., :3]) @ a.rots2
    posih = a.poss1 + h * a.vs1[..., 3:] + 0.5 * a.as1[..., 3:] * h * h
    posjh = a.poss2 + h * a.vs2[..., 3:] + 0.5 * a.as2[..., 3:] * h * h
    cih_w = (Rih @ a.cs1[..., None])[..., 0] + posih
    cih_j = (Rjh.transpose(-1, -2) @ (cih_w - posjh)[..., None])[..., 0]
    return torch.sum(a.ns2 * (a.cs2 - cih_j), dim=-1)


class TocDt(torch.autograd.Function):
    """Identity on h whose backward routes dL/dh into the contact state by
    the implicit function theorem on the gap function (JAX ops/toc.py:73-106)."""

    @staticmethod
    def forward(ctx, h, mask, *args):
        ctx.save_for_backward(h, mask, *args)
        return h.clone()

    @staticmethod
    def backward(ctx, dL_dh):
        h, mask, *flat = ctx.saved_tensors
        a = TocArgs(*flat)
        # dD/dh by one forward-mode derivative
        _, dD_dh = torch.func.jvp(lambda hh: gap_function(hh, a), (h,), (torch.ones_like(h),))
        zero = torch.zeros_like(dD_dh)
        lanes = h.dim() > 0
        hc, dL_dhc = (h[:, None], dL_dh[:, None]) if lanes else (h, dL_dh)
        dD_dh = torch.where(dD_dh < TOC_TOL / hc, zero, dD_dh)  # only motion into collision
        dD_dh = torch.where(mask, dD_dh, zero)
        denom = torch.sum(dD_dh**2, dim=-1, keepdim=True) if lanes else torch.sum(dD_dh**2)
        ok = denom > 1e-5
        w = torch.where(ok, dD_dh / torch.where(ok, denom, torch.ones_like(denom)), zero)
        # every other gradient by one vjp with cotangent -w dL/dh
        _, vjp_fn = torch.func.vjp(lambda *aa: gap_function(h, TocArgs(*aa)), *a)
        d_args = vjp_fn(-w * dL_dhc)
        return (dL_dh, None) + tuple(d_args)


def toc_dt(h, args: TocArgs, mask):
    """Identity on h; its backward applies the TOC differential. ``mask``
    (K,) bool marks the contacts new in this step ((B, K) for h (B,))."""
    return TocDt.apply(h, mask, *args)
