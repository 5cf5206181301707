"""Port parity, voxel-grid SDF bodies (diffsdfsim_torch vs diffsdfsim_tpu,
float64 on the CPU): trilinear sampling with its clamp and out-of-bounds
rule, the gradient volume, ``grid_sdf``'s vector-Jacobian product,
``GridShape.query_sdfs``, and the 33^3 voxelized-sphere drop of
``tests/test_world_extra.py:53-67`` against the JAX golden file
``tests/golden/grid33_f64.npz`` (``tests/golden/gen_torch_shape_golden.py``).

Tolerances: leaf functions 1e-12 absolute (the same products in the same
order); body verts and inertia 1e-12; the 16-frame drop: identical discrete
decisions, poses and velocities within 1e-9.
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
from torch_jax_bridge import one_torch_thread, sphere_grid  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "grid33_f64.npz")
ATOL = 1e-12


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
    jshape = jshapes.GridShape(grid=jnp.asarray(sphere), scale_=jnp.asarray(0.75))

    @jax.jit
    def ref(grid, stack, inds, pts, cot):
        return dict(
            interp=jsdf.grid_interp(grid, inds), interp_stack=jsdf.grid_interp(stack, inds),
            grid_sdf_raw=jsdf.grid_sdf_raw(pts, grid), grid_sdf_grad=jsdf.grid_sdf_grad(pts, grid),
            volume=jsdf.grid_grad_volume(grid), vjp=jax.vjp(jsdf.grid_sdf, pts, grid)[1](cot),
            query=jshapes.query_sdfs(jshape, pts),
        )

    return dict(grid=grid, pts=pts, inds=inds, stack=stack, cot=cot, sphere=sphere,
                ref=ref(grid, stack, inds, pts, cot))


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
    assert float(tg.grad.abs().max()) == 0.0 and float(jnp.abs(jg).max()) == 0.0


def test_grid_shape_query_sdfs_matches_jax(data):
    tshape = tshapes.GridShape(grid=torch.tensor(data["sphere"]), scale_=torch.tensor(0.75, dtype=torch.float64))
    for a, b in zip(tshapes.query_sdfs(tshape, torch.tensor(data["pts"])), data["ref"]["query"]):
        _close(a, b)


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
