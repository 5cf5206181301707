"""The port's body builders against the JAX package, float64 on the CPU: the
bowl (``ops/sdf.bowl_sdf``, ``bowl_sdf_grad``, ``BowlShape``), the analytic
meshes (``physics/analytic_meshes.py``) and ``make_body``'s
``custom_mesh`` branch, the marching mesher (``ops/marching.py``) and its
``make_body`` branch, and the worlds built from them: the marble in the
bowl and the 14^3 torus dropped on the floor, with d loss / d scale.

The JAX side is read from ``tests/golden/meshes_{shapes,torus,bowl}_f64.npz``
(``tests/golden/gen_torch_meshes_golden.py``). The JAX package pads a
marching body with invalid triangles and masks them; the port holds only
the valid ones, which must equal JAX's valid ones in order.
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_jax_bridge import one_torch_thread  # noqa: F401

from diffsdfsim_torch.config import SimConfig
from diffsdfsim_torch.ops import sdf
from diffsdfsim_torch.ops.marching import marching_tets
from diffsdfsim_torch.physics import (
    BowlShape,
    BoxShape,
    CylinderShape,
    GridShape,
    Gravity3D,
    SphereShape,
    TotalConstraint3D,
    make_body,
    make_world,
    rollout,
)
from diffsdfsim_torch.physics import analytic_meshes as am

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
DISCRETE = ("valid", "bisect_failed", "truncated", "n_halvings")


def _gold(case):
    return dict(np.load(os.path.join(GOLDEN, f"meshes_{case}_f64.npz")))


@pytest.fixture(scope="module")
def shapes_gold():
    return _gold("shapes")


sys.path.insert(0, GOLDEN)
import gen_torch_meshes_golden as GEN  # noqa: E402  (its inputs: grids, sizes, configurations)


def test_bowl_sdf_and_grad_match_jax(shapes_gold):
    """Bowl SDF and its analytic gradient (the reference's safe-norm and
    nonzero-sign formula, ties on the z axis and the mid-radius included)
    within 1e-14; BowlShape's scale is (r + d) 1.3333."""
    p = torch.tensor(shapes_gold["bowl_pts"])
    r, d = torch.tensor(0.6, dtype=torch.float64), torch.tensor(0.075, dtype=torch.float64)
    assert float((sdf.bowl_sdf(p, r, d) - torch.tensor(shapes_gold["bowl_sdf"])).abs().max()) <= 1e-14
    assert float((sdf.bowl_sdf_grad(p, r, d) - torch.tensor(shapes_gold["bowl_grad"])).abs().max()) <= 1e-14
    shape = BowlShape(torch.tensor(1.0, dtype=torch.float64), torch.tensor(0.1, dtype=torch.float64))
    assert float(shape.scale()) == (1.0 + 0.1) * 1.3333


MESHES = {
    "box": (lambda q: BoxShape(q), GEN.BOX, lambda q: am.box_mesh(q)),
    "sphere": (lambda q: SphereShape(q[0]), [GEN.SPHERE], lambda q: am.sphere_mesh(q[0], 3)),
    "cylinder": (lambda q: CylinderShape(q[0], q[1]), list(GEN.CYL), lambda q: am.cylinder_mesh(q[0], q[1])),
    "bowl": (lambda q: BowlShape(q[0], q[1]), list(GEN.BOWL), lambda q: am.bowl_mesh(q[0], q[1])),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_analytic_mesh_and_inertia_match_jax(shapes_gold, name):
    """The analytic mesh: faces equal (int32, same order), verts within
    1e-15; ``make_body(custom_mesh=True)``: verts within 1e-15, Mirtich
    inertia within 1e-13, and d trace(inertia) / d params (autograd through
    the verts) within 1e-12 of JAX's."""
    mk, params, mesh = MESHES[name]
    q = torch.tensor(params, dtype=torch.float64)
    v, f = mesh(q)
    assert f.dtype == np.int32 and np.array_equal(f, shapes_gold[f"mesh_{name}_faces"])
    assert float((v - torch.tensor(shapes_gold[f"mesh_{name}_verts"])).abs().max()) <= 1e-15
    q = q.clone().requires_grad_(True)
    bd = make_body(mk(q), custom_mesh=True, subdiv=2, mass=1.3, device="cpu")
    assert float((bd.verts.detach() - torch.tensor(shapes_gold[f"body_{name}_verts"])).abs().max()) <= 1e-15
    assert float((bd.ang_inertia - torch.tensor(shapes_gold[f"body_{name}_inertia"])).abs().max()) <= 1e-13
    (g,) = torch.autograd.grad(torch.trace(bd.ang_inertia), q)
    assert float((g - torch.tensor(shapes_gold[f"body_{name}_dtrace"])).abs().max()) <= 1e-12


@pytest.mark.parametrize("max_tris", [None, 500], ids=["all", "first500"])
def test_marching_tets_matches_jax(shapes_gold, max_tris):
    """test_marching.py's sphere (radius 0.5, 16^3): the port's triangles are
    JAX's valid ones, in order (all of them, and truncated at 500), within
    1e-12."""
    tri = marching_tets(torch.tensor(GEN.marching_sphere_grid()), max_tris=max_tris)
    want = shapes_gold[f"march_{max_tris or 'all'}"]
    assert tri.shape == want.shape
    assert float((tri - torch.tensor(want)).abs().max()) <= 1e-12


def _torus(scale):
    return make_body(GridShape(torch.tensor(GEN.torus_grid()), scale), mesher="marching", device="cpu")


def _assert_traj(traj, gold, prefix, tol):
    for k in DISCRETE:
        np.testing.assert_array_equal(getattr(traj, k).numpy(), gold[f"{prefix}_{k}"], err_msg=k)
    valid = gold[f"{prefix}_valid"]
    for k in ("pos", "quat"):
        err = np.abs(getattr(traj, k).detach().numpy() - gold[f"{prefix}_{k}"])[valid].max()
        assert err <= tol, (k, err)


def test_torus_body_drop_and_dscale_match_jax():
    """The 14^3 torus grid body by marching tetrahedra: its triangles equal
    JAX's valid ones in order (1e-12) and its inertia (1e-12); dropped on
    the floor for 16 frames: the same discrete decisions (valid substeps,
    bisection failures, truncations, halvings), poses within 1e-7, and
    d |final pos|^2 / d scale within 1e-6 relative."""
    g = _gold("torus")
    tor = _torus(torch.tensor(1.0, dtype=torch.float64))
    tris = tor.verts.reshape(-1, 3, 3)
    assert tris.shape == g["torus_tris"].shape and float((tris - torch.tensor(g["torus_tris"])).abs().max()) <= 1e-12
    assert float((tor.ang_inertia - torch.tensor(g["torus_inertia"])).abs().max()) <= 1e-12

    scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device="cpu")
    spec, state = make_world([floor, _torus(scale)], [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]],
                             np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)),
                             cfg=SimConfig(**GEN.TORUS_CFG), device="cpu")
    final, traj = rollout(spec, state, 16)
    loss = torch.sum(final.pos[1] ** 2)
    (dscale,) = torch.autograd.grad(loss, scale)
    _assert_traj(traj, g, "torus", 1e-7)
    assert abs(float(loss) - float(g["torus_loss"])) <= 1e-7
    assert abs(float(dscale) - float(g["torus_dscale"])) <= 1e-6 * abs(float(g["torus_dscale"]))


def test_marble_in_bowl_matches_jax():
    """test_bowl.py's marble dropped into the fixed bowl (analytic shell
    mesh; both directed pairs take the plain Frank-Wolfe search): the same
    discrete decisions over 30 frames and poses within 1e-7."""
    g = _gold("bowl")
    bowl = make_body(BowlShape(torch.tensor(1.0), torch.tensor(0.1)), custom_mesh=True, device="cpu")
    marble = make_body(SphereShape(torch.tensor(0.2)), subdiv=1, fric_coeff=0.3, device="cpu")
    s = np.sqrt(0.5)
    spec, state = make_world([bowl, marble], [[s, -s, 0, 0, 0.0, 0.0, 0.0], [1.0, 0, 0, 0, 0.15, 1.2, 0.0]],
                             np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)),
                             cfg=SimConfig(**GEN.BOWL_CFG), device="cpu")
    with torch.no_grad():
        _, traj = rollout(spec, state, 30)
    _assert_traj(traj, g, "bowl", 1e-7)
