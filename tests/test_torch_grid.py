"""Port parity, voxel-grid SDF bodies (diffsdfsim_torch vs diffsdfsim_tpu,
float64 on the CPU): trilinear sampling with its clamp and out-of-bounds
rule, the gradient volume, ``grid_sdf``'s vector-Jacobian product,
``GridShape.query_sdfs`` and the plain version of kernel K5's fused query
(``ops/sdf.grid_query``: values, both gradients and the vector-Jacobian
products of the value and of the gradient output), and the 33^3
voxelized-sphere drop of
``tests/test_world_extra.py:53-67`` against the JAX golden file
``tests/golden/grid33_f64.npz`` (``tests/golden/gen_torch_shape_golden.py``).

Tolerances: leaf functions and the query 1e-12 absolute (the same products
in the same order); body verts and inertia 1e-12; the 16-frame drop:
identical discrete decisions, poses and velocities within 1e-9.

The JAX side's results (its compiled references take seconds to build) are
read from ``tests/golden/grid_jax.pkl``, which
``tests/golden/gen_torch_grid_golden.py`` writes by running these tests with
the JAX calls live (``torch_jax_bridge.JaxGolden``); regenerate it when a
test's inputs change.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.ops import grid_cuda
from diffsdfsim_torch.ops import sdf as tsdf
from diffsdfsim_torch.physics import shapes as tshapes
from diffsdfsim_tpu.ops import sdf as jsdf
from diffsdfsim_tpu.physics import shapes as jshapes
from torch_jax_bridge import JaxGolden, one_torch_thread, sphere_grid  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "grid33_f64.npz")
ATOL = 1e-12
_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "grid_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


@pytest.fixture(scope="module")
def data():
    """Inputs, and the JAX package's values on them from one compiled call."""
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(9, 7, 8))
    pts = rng.uniform(-1.2, 1.2, (200, 3))
    # the upper and lower faces, a corner, exact lattice points
    pts[:6] = [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, 0.0, -1.0], [0.0, 0.0, 0.0], [1.0 + 1e-12, 0, 0], [0.5, 0.5, 0.5]]
    inds = (pts + 1.0) * 0.5 * (np.array(grid.shape) - 1.0)  # some out of bounds: extrapolated
    stack = np.stack([grid, 2 * grid, -grid])
    cot = rng.normal(size=len(pts))
    sphere = sphere_grid(17)

    def jax_side():
        jshape = jshapes.GridShape(grid=jnp.asarray(sphere), scale_=jnp.asarray(0.75))

        @jax.jit
        def ref(grid, stack, inds, pts, cot):
            return dict(
                interp=jsdf.grid_interp(grid, inds), interp_stack=jsdf.grid_interp(stack, inds),
                grid_sdf_raw=jsdf.grid_sdf_raw(pts, grid), grid_sdf_grad=jsdf.grid_sdf_grad(pts, grid),
                volume=jsdf.grid_grad_volume(grid), vjp=jax.vjp(jsdf.grid_sdf, pts, grid)[1](cot),
                query=jshapes.query_sdfs(jshape, pts),
            )

        return ref(grid, stack, inds, pts, cot)

    return dict(grid=grid, pts=pts, inds=inds, stack=stack, cot=cot, sphere=sphere,
                ref=_from_jax.keyed("fixture data", jax_side))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def test_grid_interp_matches_jax(data):
    ref = data["ref"]
    _close(tsdf.grid_interp(torch.tensor(data["grid"]), torch.tensor(data["inds"])), ref["interp"])
    _close(tsdf.grid_interp(torch.tensor(data["stack"]), torch.tensor(data["inds"])), ref["interp_stack"])


def test_kernel_wrapper_takes_the_plain_version_on_cpu(data):
    grid, inds = torch.tensor(data["grid"]), torch.tensor(data["inds"])
    before = grid_cuda.grid_interp.launches
    assert torch.equal(grid_cuda.grid_interp(grid, inds), tsdf.grid_interp(grid, inds))
    assert grid_cuda.grid_interp.launches == before


@pytest.mark.parametrize("fn", ["grid_sdf_raw", "grid_sdf_grad"])
def test_grid_sdf_and_gradient_match_jax(data, fn):
    _close(getattr(tsdf, fn)(torch.tensor(data["pts"]), torch.tensor(data["grid"])), data["ref"][fn])


def test_grad_volume_matches_jax(data):
    _close(tsdf.grid_grad_volume(torch.tensor(data["grid"])), data["ref"]["volume"])


def test_grid_sdf_vjp_matches_custom_vjp(data):
    """Points get grid_sdf_grad times the cotangent; the grid gets zero."""
    tp = torch.tensor(data["pts"], requires_grad=True)
    tg = torch.tensor(data["grid"], requires_grad=True)
    torch.sum(tsdf.grid_sdf(tp, tg) * torch.tensor(data["cot"])).backward()
    jp, jg = data["ref"]["vjp"]
    _close(tp.grad, jp)
    assert float(tg.grad.abs().max()) == 0.0 and float(np.abs(jg).max()) == 0.0


def test_grid_shape_query_sdfs_matches_jax(data):
    tshape = tshapes.GridShape(grid=torch.tensor(data["sphere"]), scale_=torch.tensor(0.75, dtype=torch.float64))
    for a, b in zip(tshapes.query_sdfs(tshape, torch.tensor(data["pts"])), data["ref"]["query"]):
        _close(a, b)


@pytest.fixture(scope="module")
def query_data():
    """A 33^3 sphere grid at scale 0.75 and seeded metric points inside the
    grid, on its faces, just outside them and outside the scale box (none
    within 0.05 of the centre, where the interpolated gradient vanishes and
    its normalization divides by ~1e-12); the JAX package's query_sdfs on a
    GridShape, its value-only form, grid_sdf / grid_sdf_grad of the
    normalized points, and jax.vjp of the query's value and of its gradient
    output, from one compiled call."""
    rng = np.random.default_rng(33)
    sphere, scale = sphere_grid(33), 0.75
    d = rng.normal(size=(400, 3))
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0.05, 1.5, (400, 1))
    pts[:80] = rng.uniform(-1.1 * scale, 1.1 * scale, (80, 3))
    pts[:80][np.linalg.norm(pts[:80], axis=1) < 0.05] = 0.3
    for i in range(80, 120):  # on a face of the grid, on one axis or several
        axes = rng.choice(3, size=1 + i % 3, replace=False)
        pts[i, axes] = scale * rng.choice([-1.0, 1.0], size=len(axes))
    pts[120:130] = scale * (1.0 + 1e-15 * rng.uniform(1, 8, (10, 3)))  # just outside
    cot_s, cot_g = rng.normal(size=len(pts)), rng.normal(size=(len(pts), 3))

    def jax_side():
        jshape = jshapes.GridShape(grid=jnp.asarray(sphere), scale_=jnp.asarray(scale))

        @jax.jit
        def ref(pts):
            query = lambda p: jshapes.query_sdfs(jshape, p)  # noqa: E731
            (s, g), vjp = jax.vjp(query, pts)
            pts_in = pts / scale
            return dict(
                value=s, grads=g, value_only=jshapes.query_sdfs(jshape, pts, return_grads=False),
                vjp_value=vjp((jnp.asarray(cot_s), jnp.zeros_like(g)))[0],
                vjp_grads=vjp((jnp.zeros_like(s), jnp.asarray(cot_g)))[0],
                normalized_frame=(jsdf.grid_sdf(pts_in, jnp.asarray(sphere)),
                                  jsdf.grid_sdf_grad(pts_in, jnp.asarray(sphere))),
            )

        return ref(pts)

    return dict(sphere=sphere, scale=scale, pts=pts, cot_s=cot_s, cot_g=cot_g,
                ref=_from_jax.keyed("fixture query_data", jax_side))


QUERY_CASES = ["value", "grads", "value_only", "vjp_value", "vjp_grads", "normalized_frame"]


@pytest.mark.parametrize("case", QUERY_CASES)
def test_grid_query_matches_jax(query_data, case):
    """The plain fused query (the CPU path of every GridShape query, and what
    kernel K5 is held against on the card) against the JAX package's XLA
    path, 1e-12 absolute in float64."""
    d = query_data
    grid = torch.tensor(d["sphere"])
    scale = torch.tensor(d["scale"], dtype=torch.float64)
    pts = torch.tensor(d["pts"], requires_grad=case.startswith("vjp"))
    ref = d["ref"][case]
    if case == "normalized_frame":
        got = tsdf.grid_query(pts / scale, grid)
    elif case == "value_only":
        got = tsdf.grid_query(pts, grid, scale, return_grads=False)
    else:
        sdfs, grads = tsdf.grid_query(pts, grid, scale)
        got = dict(value=sdfs, grads=grads).get(case)
        if case == "vjp_value":
            (got,) = torch.autograd.grad(sdfs, pts, torch.tensor(d["cot_s"]))
        elif case == "vjp_grads":
            (got,) = torch.autograd.grad(grads, pts, torch.tensor(d["cot_g"]))
    for a, b in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        _close(a, b)


def test_cpu_grid_queries_take_the_plain_version(query_data, monkeypatch):
    """On CPU tensors every GridShape query (query_sdfs, sdf, sdf_grad) is
    the plain ops/sdf.grid_query, and nothing reaches a kernel launch."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU query reached the kernel wrapper's launch")

    monkeypatch.setattr(grid_cuda.grid_query_kernel, "run", no_launch)
    monkeypatch.setattr(grid_cuda.grid_interp, "run", no_launch)
    calls = []
    plain = tsdf.grid_query
    monkeypatch.setattr(tsdf, "grid_query", lambda *a, **k: calls.append(1) or plain(*a, **k))
    grid = torch.tensor(query_data["sphere"])
    scale = torch.tensor(query_data["scale"], dtype=torch.float64)
    shape = tshapes.GridShape(grid=grid, scale_=scale)
    pts = torch.tensor(query_data["pts"])
    for a, b in zip(tshapes.query_sdfs(shape, pts), plain(pts, grid, scale)):
        assert torch.equal(a, b)
    assert torch.equal(tshapes.query_sdfs(shape, pts, return_grads=False), plain(pts, grid, scale, False))
    assert torch.equal(shape.sdf(pts / scale), plain(pts / scale, grid, return_grads=False))
    assert torch.equal(shape.sdf_grad(pts / scale), plain(pts / scale, grid)[1])
    assert len(calls) == 4 and grid_cuda.grid_query_kernel.launches == 0


@pytest.mark.parametrize("output", ["value", "gradient", "both", "scale", "normalized_frame"])
def test_query_function_backward_matches_plain(query_data, monkeypatch, output):
    """The CUDA path's autograd Function (grid_cuda._GridQuery, applied by
    grid_cuda._query), with its launch replaced by the plain version's
    outputs, gives the plain composition's vector-Jacobian products with
    respect to the points and the scale: its own product for the value,
    the plain recompute for the gradient output and the scale. 1e-12
    absolute, float64."""
    def plain_run(pts, grid, scale=None, grad=False, grad_in=False, grad_raw=False):
        sdfs = tsdf.grid_query(pts, grid, scale, return_grads=False) if scale is not None else tsdf.grid_sdf_raw(pts, grid)
        pts_in = pts if scale is None else pts / scale
        return (sdfs, tsdf.grid_query(pts, grid, scale)[1] if grad else None,
                tsdf.grid_sdf_grad(pts_in, grid) if grad_in else None, None)

    monkeypatch.setattr(grid_cuda.grid_query_kernel, "run", plain_run)
    grid = torch.tensor(query_data["sphere"])
    pts0 = torch.tensor(query_data["pts"])
    cot_s, cot_g = torch.tensor(query_data["cot_s"]), torch.tensor(query_data["cot_g"])
    scaled = output != "normalized_frame"
    if not scaled:
        pts0 = pts0 / query_data["scale"]
    got = []
    for fn in (lambda p, s: grid_cuda._query(p, grid, s, True), lambda p, s: tsdf.grid_query(p, grid, s)):
        p = pts0.clone().requires_grad_(True)
        s = torch.tensor(query_data["scale"], dtype=torch.float64, requires_grad=output == "scale") if scaled else None
        sdfs, grads = fn(p, s)
        loss = (sdfs * cot_s).sum() * (output != "gradient") + (grads * cot_g).sum() * (output != "value")
        got.append(torch.autograd.grad(loss, [p, s] if output == "scale" else [p]))
    for a, b in zip(*got):
        _close(a, b.numpy())


def test_grid_drop_matches_golden():
    """The voxelized-sphere drop on a 33^3 grid: make_body's verts and
    inertia, then 16 frames, against the JAX golden file."""
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import BoxShape, Gravity3D, GridShape, TotalConstraint3D, make_body, make_world, rollout

    g = np.load(GOLDEN)
    cfg = SimConfig(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                    max_bisect=6)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3, device="cpu")
    ball = make_body(GridShape(grid=torch.tensor(sphere_grid(int(g["res"]))), scale_=torch.tensor(0.75)),
                     fric_coeff=0.25, template="ico", subdiv=2, project_iters=16, device="cpu")
    np.testing.assert_allclose(ball.verts.numpy(), g["verts"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(ball.ang_inertia.numpy(), g["ang_inertia"], rtol=0, atol=ATOL)
    spec, state = make_world([floor, ball], [[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, 1.0, 0]], np.zeros((2, 6)),
                             joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)), cfg=cfg, device="cpu")
    _, traj = rollout(spec, state, int(g["frames"]))
    for key in ("valid", "n_halvings", "bisect_failed", "truncated"):
        np.testing.assert_array_equal(getattr(traj, key).numpy(), g[f"traj_{key}"])
    for key in ("pos", "quat", "v", "t"):
        np.testing.assert_allclose(getattr(traj, key).numpy(), g[f"traj_{key}"], rtol=0, atol=1e-9)
    assert float(traj.v[..., 1, 4].max()) > 0.3  # it bounced
