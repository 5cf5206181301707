#!/usr/bin/env python3
"""Which order does torch's CUDA sum of three squares take inside
``utils/spherical.normalize``, as the grid query calls it?

    python3 tools/normalize_rounding_check.py

On the card: builds the plain grid query's two normalize inputs (the
interpolated central differences, an (N, 3) transposed view, and the once
normalized, masked gradient), computes ``torch.sum(v * v, dim=-1)`` as
normalize does, and compares it bitwise with the three orders of adding the
squares, each square and sum its own tensor op (so nothing is fused): (a +
b) + c, (a + c) + b and a + (b + c). Kernel K5's query
(``ops/csrc/grid_interp.cu`` ``normalize3``) must take the order that
matches every entry for its normalized gradients to be bitwise the plain
version's. Prints one line per dtype and input.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    if not torch.cuda.is_available():
        print("normalize_rounding_check: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from diffsdfsim_torch.ops import sdf
    from diffsdfsim_torch.utils.spherical import normalize

    for dtype in (torch.float64, torch.float32):
        grid = torch.tensor(chip_smoke.sphere_grid(64), dtype=dtype, device="cuda")
        pts = torch.tensor(chip_smoke.k5_query_points(64, 0.75, 100000, seed=1), dtype=dtype, device="cuda") / 0.75
        inds, valid = sdf._grid_inds(pts, grid.shape)
        safe = torch.where(valid[:, None], inds, torch.zeros_like(inds))
        raw = sdf.grid_interp(sdf.grid_grad_volume(grid), safe).T
        once = normalize(raw)
        once = torch.where(valid[..., None], once, torch.zeros_like(once))
        for name, v in (("interpolated differences (transposed view)", raw), ("once normalized", once)):
            got = torch.sum(v * v, dim=-1)
            sq = [v[:, i].contiguous() * v[:, i].contiguous() for i in range(3)]
            orders = {"(a+b)+c": (sq[0] + sq[1]) + sq[2], "(a+c)+b": (sq[0] + sq[2]) + sq[1],
                      "a+(b+c)": sq[0] + (sq[1] + sq[2])}
            res = ", ".join(f"{k} {int((o == got).sum())}" for k, o in orders.items())
            print(f"{str(dtype)[6:]} {name}, strides {tuple(v.stride())}: entries equal to torch.sum "
                  f"of {got.numel()}: {res}; differ in every order: "
                  f"{int(np.prod([(o != got).cpu().numpy() for o in orders.values()], axis=0).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
