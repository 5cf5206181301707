"""Contact-point polish after the Frank-Wolfe search (plain version).

PyTorch counterpart of ``diffsdfsim_tpu/ops/polish.py``: starting from each
candidate face's FW point, run a fixed number of projected tangential
descent steps of body 2's SDF along body 1's analytic surface (project onto
sdf1 = 0, step along the part of grad sdf2 tangent to it, halve the step
each iteration, keep the best iterate). It recovers the exact contact point
and penetration from coarse template meshes.

Poses carry a leading batch axis R (the probe ladder's rungs); per-face
arrays are (R, F, ...).
"""

from __future__ import annotations

import torch

from ..utils.quaternion import quat_apply, quat_invert, quat_multiply
from .sdf import _safe_norm


def polish_pair(x0_b2, active, step0, bd1, q1, p1, bd2, q2, p2, iters: int):
    """Polish per-face contact points of one directed pair.

    x0_b2 (R,F,3) FW points in body 2's frame (already surface-pushed),
    active (R,F) faces worth polishing, step0 (R,F) initial step (the face
    circumradius), q*/p* (R,4)/(R,3) world poses. Returns (x1_best (R,F,3)
    body-1-frame anchors on body 1's surface, s2_best (R,F) body-2 SDF at
    the anchors)."""
    q1, p1, q2, p2 = q1[:, None], p1[:, None], q2[:, None], p2[:, None]
    q12 = quat_multiply(quat_invert(q1), q2)
    q21 = quat_multiply(quat_invert(q2), q1)
    t12 = quat_apply(quat_invert(q1), p2 - p1)
    t21 = quat_apply(quat_invert(q2), p1 - p2)

    def to_b1(x):
        return quat_apply(q12, x) + t12

    def to_b2(x1):
        return quat_apply(q21, x1) + t21

    # baseline: project the FW point once and measure
    x1_0 = to_b1(x0_b2)
    s1_0, n1_0 = bd1.query_sdfs(x1_0)
    x1_best = x1_0 - s1_0[..., None] * n1_0
    s2_best = bd2.query_sdfs(to_b2(x1_best), return_grads=False)

    x = x0_b2
    act3 = active[..., None]
    for k in range(iters):
        x1 = to_b1(x)
        s1, n1b = bd1.query_sdfs(x1)
        x1p = x1 - s1[..., None] * n1b
        xp = to_b2(x1p)
        s2, g2 = bd2.query_sdfs(xp)
        better = active & (s2 < s2_best)
        x1_best = torch.where(better[..., None], x1p, x1_best)
        s2_best = torch.where(better, s2, s2_best)
        n1 = quat_apply(q21, n1b)
        t = g2 - torch.sum(g2 * n1, dim=-1, keepdim=True) * n1
        tn = t / _safe_norm(t)[..., None]
        eta = step0 * (0.5**k)
        x = torch.where(act3, xp - eta[..., None] * tn, x)
    return x1_best, s2_best
