"""Port parity, the 2D grid-SDF layer (``diffsdfsim_torch/ops/marching2d.py``
and the facade's ``GridShape2D`` / ``GridSDF2D``) against the JAX package,
float64 on the CPU.

- ``bilinear_interp`` (inside, on nodes, out of range) and its gradients
  with respect to the grid values and the points: within 1e-12.
- ``marching_squares``: the same fixed-size masked segments in the same
  order (within 1e-12) on a circle grid and a seeded random grid;
  ``grid_from_sdf_fn`` and ``contour_2d`` likewise.
- The grid body's SDF and gradient within 1e-12.
- The JAX package's grid drop (``tests/scenes2d.py``) against
  ``tests/golden/scenes2d_f64.npz``: tier-1 holds it started 0.05 m above
  the floor for 8 frames, poses within 1e-8, and d(final height) / d(grid
  values) within 1e-6 relative; ``-m slow`` runs the 25-frame drop from
  1 m (11 s on one CPU thread, the plain search over the grid SDF) and its
  gradient. The grid body rests on a line along the extrusion, so each run
  is held up to its first contact parting, where a tie must be witnessed
  (``scenes2d.hold_to_parting``); a gradient past a witnessed tie is
  reported.

The JAX side of the leaf tests is read from
``tests/golden/marching2d_jax.pkl`` (``gen_torch_marching2d_golden.py``
runs these tests with the JAX calls live, ``torch_jax_bridge.JaxGolden``;
JAX's eager calls take seconds here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes2d
from diffsdfsim_torch.ops import marching2d as tm2
from diffsdfsim_torch.physics2d import facade as tfac
from diffsdfsim_tpu.ops import marching2d as jm2
from diffsdfsim_tpu.physics2d import facade as jfac
from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
_from_jax = JaxGolden(os.path.join(HERE, "golden", "marching2d_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()
ATOL = 1e-12
ATOL_POSE = 1e-8
RTOL_GRAD = 1e-6


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64, requires_grad=grad)


def _circle_grid(res, rad=0.3):
    xs = np.linspace(-0.5, 0.5, res)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    return np.sqrt(px**2 + py**2) - rad


def test_bilinear_and_gradients_match_jax():
    rng = np.random.default_rng(0)
    g = _circle_grid(17) + 0.01 * rng.standard_normal((17, 17))
    xs = np.linspace(-0.5, 0.5, 17)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (64, 2)), [[xs[3], xs[12]], [0.5, 0.0], [-0.5, -0.5],
                                                             [0.9, 0.0], [0.0, -1.2]]])
    w = rng.standard_normal(pts.shape[0])

    def jf(grid, p):
        return jnp.sum(jm2.bilinear_interp(grid, p) * w)

    jv, jgg, jgp = _from_jax(lambda: (jm2.bilinear_interp(jnp.asarray(g), jnp.asarray(pts)),
                                      *jax.grad(jf, argnums=(0, 1))(jnp.asarray(g), jnp.asarray(pts))))
    tg, tp = _t(g, True), _t(pts, True)
    tv = tm2.bilinear_interp(tg, tp)
    tgg, tgp = torch.autograd.grad(torch.sum(tv * _t(w)), (tg, tp))
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tgg.numpy(), jgg, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tgp.numpy(), jgp, rtol=0, atol=ATOL)
    # the JAX package's own checks (test_marching2d.py:21-47): exact at a
    # node, growing out of range
    np.testing.assert_allclose(float(tv[64]), g[3, 12], atol=1e-12)
    assert float(tv[67]) > float(tv[65])


@pytest.mark.parametrize("which", ["circle", "random"])
def test_marching_squares_matches_jax(which):
    rng = np.random.default_rng(1)
    g = _circle_grid(65) if which == "circle" else rng.standard_normal((9, 13))
    jsegs, jvalid = _from_jax(lambda: jm2.marching_squares(jnp.asarray(g)))
    tsegs, tvalid = tm2.marching_squares(_t(g))
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    np.testing.assert_allclose(tsegs.numpy(), jsegs, rtol=0, atol=ATOL)
    if which == "circle":  # contour on r = 0.3 (test_marching2d.py:50)
        pts = tsegs[tvalid].reshape(-1, 2).numpy()
        assert pts.shape[0] > 50
        np.testing.assert_allclose(np.linalg.norm(pts, axis=-1), 0.3, atol=2e-3)
    for full in (np.ones((9, 9)), -np.ones((9, 9))):
        assert not bool(tm2.marching_squares(_t(full))[1].any())


def test_grid_from_sdf_fn_and_contour_match_jax():
    jg = _from_jax(lambda: jm2.grid_from_sdf_fn(lambda p: jnp.sqrt(jnp.sum(p**2, axis=-1)) - 0.3, 33))
    tg = tm2.grid_from_sdf_fn(lambda p: torch.sqrt(torch.sum(p**2, dim=-1)) - 0.3, 33, device="cpu")
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=ATOL)
    grid = scenes2d.circle_grid(res=33)
    jsegs, jvalid = _from_jax(lambda: jfac.contour_2d(jnp.asarray(grid), 2.0))
    tsegs, tvalid = tfac.contour_2d(grid, 2.0, device="cpu")
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    np.testing.assert_allclose(tsegs.numpy(), jsegs, rtol=0, atol=ATOL)


def test_grid_shape_sdf_and_grad_match_jax():
    rng = np.random.default_rng(2)
    g = _circle_grid(17)
    pts = np.concatenate([rng.uniform(-0.9, 0.9, (64, 3)), [[0.21, 0.07, 0.0], [0.0, 0.33, 0.1]]])
    # the grid values take the gradient of the values and of the normals
    w = rng.standard_normal((pts.shape[0], 3))

    def jax_side():
        def shape(grid):
            return jfac.GridShape2D(grid=grid, scale_=jnp.asarray(1.3), coord_scale=jnp.asarray(1.1))

        def jloss(grid):
            s = shape(grid)
            return jnp.sum(s.sdf(jnp.asarray(pts))) + jnp.sum(s.sdf_grad(jnp.asarray(pts)) * w)

        js = shape(jnp.asarray(g))
        return js.sdf(jnp.asarray(pts)), js.sdf_grad(jnp.asarray(pts)), jax.grad(jloss)(jnp.asarray(g))

    jd, jn, jgg = _from_jax(jax_side)
    tgrid = _t(g, True)
    ts = tfac.GridShape2D(grid=tgrid, scale_=_t(1.3), coord_scale=_t(1.1))
    np.testing.assert_allclose(ts.sdf(_t(pts)).detach().numpy(), jd, rtol=0, atol=ATOL)
    tn = ts.sdf_grad(_t(pts))
    np.testing.assert_allclose(tn.detach().numpy(), jn, rtol=0, atol=ATOL)
    (tgg,) = torch.autograd.grad(torch.sum(ts.sdf(_t(pts))) + torch.sum(tn * _t(w)), tgrid)
    np.testing.assert_allclose(tgg.numpy(), jgg, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def golden():
    with np.load(os.path.join(HERE, "golden", "scenes2d_f64.npz")) as g:
        return dict(g)


@pytest.mark.parametrize("case", ["grid_low", "grid"])
def test_grid_golden_projection_differs_from_jax_only_at_ties(golden, case):
    """The golden's grid body is projected op by op
    (``gen_torch_2d_golden.eager_grid_projection``). The JAX package's
    compiled projection of it (``verts1_xla``) differs only at the template
    vertices whose compiled Newton step a tie loses (``tie1``; ROADMAP
    queue 3, item 25), by at most 2e-4 m, and elsewhere by at most the
    SDF's floor, 1e-12 of the normalized frame times the body's scale."""
    moved = np.abs(golden[f"{case}/verts1"] - golden[f"{case}/verts1_xla"]).max(axis=1)
    tie = golden[f"{case}/tie1"]
    assert 0 < int(tie.sum()) < len(tie)
    assert np.all(moved[~tie] <= (1e-12 + 1e-15) * float(golden[f"{case}/scale1"]))
    assert moved.max() <= 2e-4


@pytest.mark.parametrize("case", ["grid_low", pytest.param("grid", marks=pytest.mark.slow)])
def test_grid_drop_matches_jax(golden, case):
    P = scenes2d.namespace("torch", "cpu")
    (spec, state), n = scenes2d.build(P, case)
    for i, bd in enumerate(spec.bodies):
        np.testing.assert_allclose(bd.verts.numpy(), golden[f"{case}/verts{i}"], rtol=0, atol=1e-10)
    _, traj = P.rollout(spec, state, n)
    ok, _, line = scenes2d.hold_run(spec, scenes2d.traj_numpy(traj), golden, case, ATOL_POSE)
    print(line)
    assert ok, line
    if case == "grid":  # rests at the circle's radius (test_marching2d.py:66)
        assert abs(float(traj.pos[-1, -1, 1, 1]) - 0.4) < 0.05


@pytest.mark.parametrize("name", ["grad_grid_low", pytest.param("grad_grid", marks=pytest.mark.slow)])
def test_grid_values_gradient_matches_jax(golden, name):
    P = scenes2d.namespace("torch", "cpu")
    grid = _t(scenes2d.grad_param(name), True)
    spec, state = scenes2d.grad_world(P, name, grid)
    final, traj = P.rollout(spec, state, scenes2d.GRADS[name][2])
    (g,) = torch.autograd.grad(final.pos[1, 1], grid)
    ref = golden[f"{name}/grad"]
    err = float(np.abs(g.numpy() - ref).max() / np.abs(ref).max())
    assert np.count_nonzero(ref) > 0
    # the same rollout as the drop case: held up to a witnessed tie, after
    # which the gradient is reported
    ok, held, line = scenes2d.hold_run(spec, scenes2d.traj_numpy(traj), golden, name[5:], ATOL_POSE)
    print(line, f"; d height / d grid {err:.3e} (relative) from JAX's")
    assert ok, line
    if held:
        np.testing.assert_allclose(float(final.pos[1, 1]), golden[f"{name}/value"], rtol=0, atol=ATOL_POSE)
        assert err < RTOL_GRAD, f"{name}: d height / d grid {err:.3e} (relative to its largest entry) from JAX's"
