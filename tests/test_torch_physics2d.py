"""Port parity, the 2D facade (``diffsdfsim_torch/physics2d/facade.py``)
against the JAX package, float64 on the CPU.

- Leaf functions: ``polygon_sdf_2d`` and its gradient, the extruded hull
  SDF and its gradient, ``to_2d_state``, the planar joints' rows: within
  1e-12 of JAX's, read from ``tests/golden/physics2d_jax.pkl``
  (``gen_torch_physics2d_golden.py`` runs these tests with the JAX calls
  live, ``torch_jax_bridge.JaxGolden``; JAX's eager calls take seconds).
- The JAX package's 2D scenes (``tests/scenes2d.py``) against the goldens
  of ``tests/golden/scenes2d_f64.npz`` (``gen_torch_2d_golden.py``): the
  bodies' meshes and inertias within 1e-10 (as test_torch_bodies.py: 12
  projection steps repeat the same formulas); each rollout's discrete
  decisions identical and its poses and velocities within ATOL_POSE, a
  Frank-Wolfe scene's up to its first contact parting, where a tie must be
  witnessed (``scenes2d.hold_to_parting``); the
  circle drop's d(final height) / d(radius) under the analytic narrowphase
  within 1e-6 relative. The hull-on-hull stack under the Frank-Wolfe
  search (88 s on one CPU thread: a plain search over hull SDFs) runs under
  ``-m slow``; tier-1 holds it under the analytic narrowphase.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes2d
from diffsdfsim_torch.physics import engine as teng
from diffsdfsim_torch.physics2d import facade as tfac
from diffsdfsim_tpu.physics2d import facade as jfac
from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "scenes2d_f64.npz")
_from_jax = JaxGolden(os.path.join(HERE, "golden", "physics2d_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()
ATOL_LEAF = 1e-12
ATOL_BODY = 1e-10
# poses and velocities against the JAX golden: the port and JAX round
# differently (template projection, K1's plain version); read within
# 1e-13..1e-15 on these scenes
ATOL_POSE = 1e-8
RTOL_GRAD = 1e-6


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


@pytest.fixture(scope="module")
def P():
    return scenes2d.namespace("torch", "cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def test_polygon_sdf_and_grad_match_jax():
    rng = np.random.default_rng(0)
    verts = np.asarray(scenes2d.BASE_HULL)
    pts = np.concatenate([rng.uniform(-1.6, 1.6, (64, 2)), verts, [[0.0, 0.0], [2.0, 0.1]]])
    jd, jg = _from_jax(lambda: (jfac.polygon_sdf_2d(jnp.asarray(pts), jnp.asarray(verts)), jax.grad(
        lambda p: jnp.sum(jfac.polygon_sdf_2d(p, jnp.asarray(verts))))(jnp.asarray(pts))))
    tp = _t(pts).requires_grad_(True)
    td = tfac.polygon_sdf_2d(tp, _t(verts))
    (tg,) = torch.autograd.grad(td.sum(), tp)
    np.testing.assert_allclose(td.detach().numpy(), jd, rtol=0, atol=ATOL_LEAF)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=ATOL_LEAF)
    # the JAX package's own closed forms (test_physics2d_extra.py:19)
    sq = _t([[-1.0, -1], [1, -1], [1, 1], [-1, 1]])
    d = tfac.polygon_sdf_2d(_t([[0.0, 0.0], [2.0, 0.0], [0.0, 1.5], [1.5, 1.5]]), sq)
    np.testing.assert_allclose(d.numpy(), [-1.0, 1.0, 0.5, np.sqrt(0.5)], atol=1e-12)


def test_hull_shape_sdf_and_grad_match_jax():
    rng = np.random.default_rng(1)
    verts = np.asarray(scenes2d.BASE_HULL) / 2.0
    pts = np.concatenate([rng.uniform(-0.9, 0.9, (64, 3)), [[0.1, 0.2, 0.5 / 1.8], [0.0, 0.0, 0.0]]])
    def jax_side():
        js = jfac.HullShape(verts2d=jnp.asarray(verts), scale_=jnp.asarray(1.8))
        return js.sdf(jnp.asarray(pts)), js.sdf_grad(jnp.asarray(pts))

    jd, jg = _from_jax(jax_side)
    ts = tfac.HullShape(verts2d=_t(verts), scale_=_t(1.8))
    np.testing.assert_allclose(ts.sdf(_t(pts)).numpy(), jd, rtol=0, atol=ATOL_LEAF)
    np.testing.assert_allclose(ts.sdf_grad(_t(pts)).numpy(), jg, rtol=0, atol=ATOL_LEAF)


def test_to_2d_state_and_rows_match_jax(P):
    poses = np.array([[0.3, 1.0, 2.0], [-2.0, -0.5, 0.25]])
    vels = np.array([[0.1, 0.5, -0.2], [1.5, 0.0, 3.0]])
    bodies = [P.m.Rect([4.0, 1.0], device="cpu"), P.m.Circle(0.3, device="cpu")]
    hinge = tfac.RevoluteJoint2D(body1=0, body2=1, r1_local=(0.2, 0.1), r2_local=(-0.3, 0.0))
    weld = tfac.FixedJoint2D(body1=0, body2=1, r1_local=(0.2, 0.1), r2_local=(-0.3, 0.0))
    spec, state = P.m.make_world_2d(bodies, poses, vels, joints=(hinge, weld), no_contact=[(0, 1)],
                                    cfg=P.SimConfig(**scenes2d.CFG2D), device="cpu")
    p2, v2 = P.m.to_2d_state(state)
    np.testing.assert_allclose(p2.numpy(), poses, atol=1e-12)
    np.testing.assert_allclose(v2.numpy(), vels, atol=1e-12)
    # the joint rows, and the planar rows for both bodies (none is fixed)
    Je = teng.joint_jacobian(spec.joints, 2, state)

    def jax_side():
        from diffsdfsim_tpu.physics.engine import joint_jacobian

        jq, jpos = jnp.asarray(state.quat.numpy()), jnp.asarray(state.pos.numpy())
        jst = type("S", (), dict(quat=jq, pos=jpos, v=jnp.asarray(state.v.numpy())))
        jj = (jfac.RevoluteJoint2D(body1=0, body2=1, r1_local=(0.2, 0.1), r2_local=(-0.3, 0.0)),
              jfac.FixedJoint2D(body1=0, body2=1, r1_local=(0.2, 0.1), r2_local=(-0.3, 0.0)),
              jfac.PlanarConstraint(body1=0), jfac.PlanarConstraint(body1=1))
        return (*jfac.to_2d_state(jst), joint_jacobian(jj, 2, jst))

    jp2, jv2, jJe = _from_jax(jax_side)
    np.testing.assert_allclose(p2.numpy(), jp2, rtol=0, atol=ATOL_LEAF)
    np.testing.assert_allclose(v2.numpy(), jv2, rtol=0, atol=ATOL_LEAF)
    np.testing.assert_allclose(Je.numpy(), jJe, rtol=0, atol=ATOL_LEAF)


def test_make_world_2d_skips_fixed_bodies(P):
    (spec, _), _ = scenes2d.build(P, "circle_fw")
    planar = [j.body1 for j in spec.joints if isinstance(j, tfac.PlanarConstraint)]
    assert planar == [1]
    assert spec.cfg.narrowphase2d is False
    (spec, _), _ = scenes2d.build(P, "circle_analytic")
    assert spec.cfg.narrowphase2d is True


def _hold(P, golden, case):
    (spec, state), n = scenes2d.build(P, case)
    for i, bd in enumerate(spec.bodies):
        np.testing.assert_allclose(bd.verts.numpy(), golden[f"{case}/verts{i}"], rtol=0, atol=ATOL_BODY)
        np.testing.assert_allclose(bd.ang_inertia.numpy(), golden[f"{case}/inertia{i}"], rtol=0, atol=ATOL_BODY)
    _, traj = P.rollout(spec, state, n)
    ok, _, line = scenes2d.hold_run(spec, scenes2d.traj_numpy(traj), golden, case, ATOL_POSE)
    print(line)
    assert ok, line
    return traj


@pytest.mark.parametrize("case", ["circle_fw", "circle_analytic", "hull_stack_analytic", "pendulum", "fixed"])
def test_scene_matches_jax(P, golden, case):
    traj = _hold(P, golden, case)
    if case == "pendulum":  # the rod keeps its length (test_physics2d_extra.py:40)
        pos = traj.pos[traj.valid].numpy()
        np.testing.assert_allclose(np.linalg.norm(pos[:, 1, :2] - pos[:, 0, :2], axis=-1), 1.0, atol=0.08)
    if case == "fixed":
        np.testing.assert_allclose(float(traj.v[-1, 0, 0, 2]), float(traj.v[-1, 0, 1, 2]), atol=1e-6)


@pytest.mark.slow
def test_hull_stack_fw_matches_jax(P, golden):
    _hold(P, golden, "hull_stack_fw")


def test_circle_radius_gradient_matches_jax(P, golden):
    name = "grad_circle"
    rad = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    spec, state = scenes2d.grad_world(P, name, rad)
    final, _ = P.rollout(spec, state, scenes2d.GRADS[name][2])
    (g,) = torch.autograd.grad(final.pos[1, 1], rad)
    np.testing.assert_allclose(float(final.pos[1, 1]), golden[f"{name}/value"], rtol=0, atol=ATOL_POSE)
    np.testing.assert_allclose(float(g), golden[f"{name}/grad"], rtol=RTOL_GRAD)
