"""The port's inertia-fitting experiments (``optim_primitives``,
``optim_shapespace_inertia``) against the JAX package, float64 on the CPU.

The JAX side is read from ``tests/golden/inertia_<case>_f64.npz``
(``tests/golden/gen_torch_inertia_golden.py``): JAX's draws, the loss and
its gradient at the start point and ``run_one``'s histories, which the
port's explicit-draw ``fit`` reproduces; a sweep's lanes are held against
the single path.
"""

import os

import numpy as np
import pytest
import torch

from torch_jax_bridge import one_torch_thread  # noqa: F401

from diffsdfsim_torch.experiments import optim_primitives as op
from diffsdfsim_torch.experiments import optim_shapespace_inertia as ssi
from diffsdfsim_torch.models.igr import ImplicitNet

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PRIM = [f"{s}{v}" for s in ("box", "sphere", "cylinder") for v in ("", "_ci", "_cm")]


def _gold(case):
    return {k: torch.tensor(v) for k, v in np.load(os.path.join(GOLDEN, f"inertia_{case}_f64.npz")).items()}


def _prim_config(name, **kw):
    shape, _, variant = name.partition("_")
    return dict(op.DEFAULTS, shape=shape, custom_inertia=variant == "ci", custom_mesh=variant == "cm", **kw)


def _close(a, b, rtol):
    return float((a - b).abs().max()) <= rtol * max(float(b.abs().max()), 1e-300)


@pytest.mark.parametrize("name", PRIM)
def test_primitives_step_matches_jax(name):
    """``optim_primitives`` at its defaults (27 frames) from JAX's draws:
    the loss and d loss / d params at the start point within 1e-8 relative
    of JAX's, and the parameters after one Adam step (clipped) within
    1e-8."""
    g = _gold(f"prim_{name}")
    c = _prim_config(name)
    out = op.fit(g["target"], g["start"], g["axis"], c, op.build_cfg(c), "cpu", max_iter=1)
    assert _close(out["loss_hist"][0], g["loss0"], 1e-8)
    assert _close(out["grad_hist"][0], g["grad0"], 1e-8)
    assert _close(out["param_hist"][0], g["param_hist"][0], 1e-8)


def test_primitives_sweep_lanes_match_single():
    """A 2-lane box sweep (lane 0 JAX's draws, lane 1 another seed's) through
    the batched-native rollout: each lane's loss, gradient and step within
    1e-9 of the single path."""
    g = _gold("prim_box")
    c = _prim_config("box")
    cfg = op.build_cfg(c)
    t1, s1, a1 = op.draw_problem(c, torch.Generator().manual_seed(1))
    targets, starts, axes = (torch.stack(x) for x in ((g["target"], t1), (g["start"], s1), (g["axis"], a1)))
    sweep = op.fit_batched(targets, starts, axes, c, cfg, "cpu", max_iter=1)
    for i in range(2):
        single = op.fit(targets[i], starts[i], axes[i], c, cfg, "cpu", max_iter=1)
        for k in ("loss_hist", "grad_hist", "param_hist"):
            assert _close(sweep[k][:, i], single[k], 1e-9), (i, k)


def _ssi(case):
    g = _gold(case)
    n = sum(1 for k in g if k[0] == "w" and k[1:].isdigit())
    net = ImplicitNet.from_arrays([g[f"w{i}"] for i in range(n)], [g[f"b{i}"] for i in range(n)],
                                  skip_in=tuple(int(i) for i in g["skip_in"]), device="cpu")
    c = dict(ssi.DEFAULTS, run_time=0.4, mesh_subdiv=1)
    return g, net, c, ssi.build_cfg(c)


def test_shapespace_inertia_fit_matches_jax():
    """``optim_shapespace_inertia`` at test_shapespace_inertia.py's tiny
    config ((32,)*4 decoder, 12 frames, ``mesh_subdiv`` 1) from JAX's draws:
    the loss and d loss / d latent (through the Mirtich inertia of the
    projection mesh) at the start within 1e-6 relative, and two Adam steps'
    losses, chamfer distances, latent errors and final chamfer within
    1e-6."""
    g, net, c, cfg = _ssi("ssi_tiny")
    out = ssi.fit(net, g["target"], g["start"], g["axis"], c, cfg, "cpu", max_iter=2)
    assert _close(out["loss_hist"][0], g["loss0"], 1e-6) and _close(out["grad_hist"][0], g["grad0"], 1e-6)
    assert float(out["grad_hist"][0].abs().max()) > 0.0
    for k in ("loss_hist", "dist_hist", "latent_err_hist", "final_chamfer", "final_latent"):
        assert _close(out[k], g[k], 1e-6), k


def test_shapespace_inertia_sweep_lane0_matches_single():
    """A 2-lane sweep (lane 0 JAX's draws, lane 1 drawn from seed 1) built by
    ``make_body_lanes``: lane 0's loss, gradient, chamfer distance and step
    within 1e-9 of the single path."""
    g, net, c, cfg = _ssi("ssi_tiny")
    t1, s1, a1 = ssi.draw_problem(g["codes"], torch.Generator().manual_seed(1))
    targets, starts, axes = (torch.stack(x) for x in ((g["target"], t1), (g["start"], s1), (g["axis"], a1)))
    sweep = ssi.fit_batched(net, targets, starts, axes, c, cfg, "cpu", max_iter=1)
    single = ssi.fit(net, targets[0], starts[0], axes[0], c, cfg, "cpu", max_iter=1)
    for k in ("loss_hist", "grad_hist", "dist_hist", "latent_err_hist"):
        assert _close(sweep[k][:, 0], single[k], 1e-9), k
    for k in ("final_latent", "final_chamfer"):
        assert _close(sweep[k][0], single[k], 1e-9), k
