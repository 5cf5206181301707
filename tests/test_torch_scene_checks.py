"""Port parity for the JAX package's scene tests, in cases the port's other
test files do not run.

The JAX package checks whole-scene properties of its rollouts: the
time-of-contact gradient of a bounce and a fit that recovers a radius
(``tests/test_world.py``), the gradient valves and the rolling
sphere's friction gradient (``tests/test_world_extra.py``), the contact
search kernel's rollout and its gradient (``tests/test_fw_pallas.py``), the
marching-tets torus (``tests/test_marching_body.py``), the 2D narrowphase
backends and the hull stack (``tests/test_narrowphase2d.py``,
``tests/test_physics2d.py``), the 2D grid body (``tests/test_marching2d.py``)
and the real-recording fit (``tests/test_pointcloud_real.py``). Each test
here holds one of those properties on the port (CPU, float64), and the
port's numbers against the JAX package's: recorded by
``tests/golden/gen_torch_scene_checks_golden.py`` in
``tests/golden/scene_checks_jax.pkl`` (``torch_jax_bridge.JaxGolden``), or
the 2D scenes' goldens of ``tests/golden/scenes2d_f64.npz``.

Tolerances: a loss within rtol 1e-6 of JAX's and a gradient within rtol
1e-5 (``tests/test_torch_batched.py``'s), or 1e-4 past a touchdown whose
contact point rounding decides (``tests/test_torch_grad_world.py``'s);
poses within the JAX test's own bound between two search backends.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes2d
from diffsdfsim_torch.config import SimConfig
from diffsdfsim_torch.physics import (
    BoxShape,
    GridShape,
    Gravity3D,
    SphereShape,
    TotalConstraint3D,
    make_body,
    make_world,
    rollout,
)
from torch_jax_bridge import JaxGolden, jax_bench_world, one_torch_thread, torch_bench_world  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
_from_jax = JaxGolden(os.path.join(HERE, "golden", "scene_checks_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()
sys.path.insert(0, os.path.join(HERE, "golden"))
import gen_torch_meshes_golden as GEN  # noqa: E402  (the torus grid and configuration)

DECISIONS = ("valid", "n_halvings", "bisect_failed")

# the JAX tests' scenes, the bridge's bench world (a sphere dropped on the
# 20 x 1 x 20 floor box): (configuration, floor and sphere subdivisions)
WORLD_KW = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=6)
EXTRA_KW = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                max_bisect=6)
NOTOC_KW = dict(fric_dirs=4, max_contacts_per_pair=2, max_contacts_total=2, mesh_subdiv=2, max_substeps=3,
                max_bisect=6, tol=1e-8, time_of_contact_diff=False)
FW_KW = dict(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, tol=1e-8, max_substeps=3,
             max_bisect=6)
SCENES = {
    "world": (WORLD_KW, (3, 2)),  # test_world.py
    "extra": (EXTRA_KW, (3, 2)),  # test_world_extra.py's drop_world
    "notoc": (NOTOC_KW, (3, 2)),  # test_world_extra.py's rolling sphere
    "fw": (FW_KW, (3, 2)),  # test_fw_pallas.py's rollout
    "fw_grad": (FW_KW, (2, 1)),  # test_fw_pallas.py's gradient
}


def _sphere_world(scene, rad, height, v_sphere=(0.0, 0.0, 0.0), **cfg_kw):
    """The port's (spec, state): the scene's sphere of radius ``rad`` at
    ``height`` with linear velocity ``v_sphere``."""
    kw, subdiv = SCENES[scene]
    return torch_bench_world(drop=height, rad=rad, cfg_kw={**kw, **cfg_kw}, v_sphere=[0, 0, 0, *v_sphere],
                             subdiv=subdiv)


def _jax_sphere_world(scene, rad, height, v_sphere=(0.0, 0.0, 0.0), **cfg_kw):
    kw, subdiv = SCENES[scene]
    return jax_bench_world(drop=height, rad=rad, cfg_kw={**kw, **cfg_kw}, v_sphere=[0, 0, 0, *v_sphere],
                           subdiv=subdiv)


def _port_value_and_grad(fn, rad):
    r = torch.tensor(rad, dtype=torch.float64, requires_grad=True)
    value = fn(r)
    (g,) = torch.autograd.grad(value, r)
    return float(value.detach()), float(g)


def _jax_value_and_grad(fn, rad):
    return jax.jit(jax.value_and_grad(fn))(jnp.asarray(rad))


def _final_height(world, rollout_fn, scene, height, n_frames, **cfg_kw):
    """d(final sphere height) / d rad's function in either package."""

    def final_y(rad):
        final, _ = rollout_fn(*world(scene, rad, height, **cfg_kw), n_frames)
        return final.pos[1, 1]

    return final_y


def _jax_rollout(spec, state, n_frames):
    from diffsdfsim_tpu.physics import rollout as jrollout

    return jrollout(spec, state, n_frames=n_frames)


# ---------------------------------------------------------------- test_world.py


def test_bounce_height_gradient_with_and_without_toc():
    """test_world.py's TOC gradient: d(final height) / d rad after one
    bounce (rad 0.55 dropped from 1 m, 15 frames) lies in (0.7, 2.2) with
    the time-of-contact differential and below 0.3 without it; each value
    and gradient equal to JAX's."""
    out = {}
    for toc in (True, False):
        y, g = _port_value_and_grad(_final_height(_sphere_world, rollout, "world", 1.0, 15,
                                                  time_of_contact_diff=toc), 0.55)
        j_y, j_g = _from_jax(lambda: _jax_value_and_grad(
            _final_height(_jax_sphere_world, _jax_rollout, "world", 1.0, 15, time_of_contact_diff=toc), 0.55))
        np.testing.assert_allclose(y, j_y, rtol=1e-6)
        np.testing.assert_allclose(g, j_g, rtol=1e-4, atol=1e-8)
        out[toc] = g
    assert 0.7 < out[True] < 2.2, out[True]
    assert abs(out[False]) < 0.3, out[False]


def _traj_loss(pos, valid, t_pos, t_valid):
    m = (valid & t_valid)[..., None]
    return ((pos[:, :, 1, :] - t_pos) ** 2 * m).sum() / m.sum()


def test_radius_fit_recovers_target():
    """test_world.py's radius recovery: 12 clipped gradient steps (lr 0.2)
    on the trajectory MSE from rad 0.45 toward the 0.6 sphere's trajectory
    (20 frames) halve the radius error; the losses and the final radius
    equal JAX's run of the same steps."""

    def traj(rad):
        return rollout(*_sphere_world("world", rad, 1.0), 20)[1]

    with torch.no_grad():
        target = traj(torch.tensor(0.6, dtype=torch.float64))
    rad, losses = 0.45, []
    for _ in range(12):
        val, g = _port_value_and_grad(lambda r: _traj_loss((t := traj(r)).pos, t.valid, target.pos[:, :, 1, :],
                                                           target.valid), rad)
        losses.append(val)
        rad = min(max(rad - 0.2 * g, 0.3), 0.9)

    def jax_fit():
        from diffsdfsim_tpu.physics import rollout as jrollout

        def jtraj(r):
            return jrollout(*_jax_sphere_world("world", r, 1.0), n_frames=20)[1]

        tgt = jax.jit(jtraj)(jnp.asarray(0.6))
        step = jax.jit(jax.value_and_grad(
            lambda r: _traj_loss((t := jtraj(r)).pos, t.valid, tgt.pos[:, :, 1, :], tgt.valid)))
        r, hist = jnp.asarray(0.45), []
        for _ in range(12):
            v, gr = step(r)
            hist.append(v)
            r = jnp.clip(r - 0.2 * gr, 0.3, 0.9)
        return jnp.stack(hist), r

    j_losses, j_rad = _from_jax(jax_fit)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(rad, j_rad, rtol=1e-4)
    assert abs(rad - 0.6) < 0.5 * abs(0.45 - 0.6), (rad, losses)


# ---------------------------------------------------------------- test_world_extra.py


def test_stop_contact_grad_valve_closes_the_radius_gradient():
    """test_world_extra.py's valve test: with stop_contact_grad,
    stop_friction_grad and the TOC differential off, d(final height) / d rad
    (rad 0.55 dropped from 1 m, 14 frames) vanishes; the final height equals
    JAX's."""
    kw = dict(stop_contact_grad=True, stop_friction_grad=True, time_of_contact_diff=False)
    y, g = _port_value_and_grad(_final_height(_sphere_world, rollout, "extra", 1.0, 14, **kw), 0.55)
    j_y, j_g = _from_jax(lambda: _jax_value_and_grad(
        _final_height(_jax_sphere_world, _jax_rollout, "extra", 1.0, 14, **kw), 0.55))
    np.testing.assert_allclose(y, j_y, rtol=1e-6)
    assert abs(g) < 1e-6 and abs(float(j_g)) < 1e-6, (g, j_g)


def test_rolling_sphere_friction_gradient_without_toc():
    """test_world_extra.py's friction-gradient test: a sphere thrown along
    the floor (rad 0.5 at 0.52 m, velocity (3, -0.5, 0), 10 frames) without
    the TOC differential has a finite, nonzero d loss / d rad of its x
    progress, equal to JAX's."""

    def loss_fn(world, rollout_fn):
        def loss(rad):
            _, traj = rollout_fn(*world("notoc", rad, 0.52, (3.0, -0.5, 0.0)), 10)
            return (traj.pos[:, :, 1, 0] ** 2 * traj.valid).sum()

        return loss

    val, g = _port_value_and_grad(loss_fn(_sphere_world, rollout), 0.5)
    j_val, j_g = _from_jax(lambda: _jax_value_and_grad(loss_fn(_jax_sphere_world, _jax_rollout), 0.5))
    np.testing.assert_allclose(val, j_val, rtol=1e-6)
    np.testing.assert_allclose(g, j_g, rtol=1e-5, atol=1e-8)
    assert np.isfinite(g) and abs(g) > 1e-8


def test_grid_sphere_from_another_height_bounces_above_the_floor():
    """test_world_extra.py's grid body (a voxelized sphere on a 33^3 grid,
    ico template) dropped from 1.3 m, a height the port's
    test_torch_grid.py does not run (16 frames): it bounces and never sinks
    through the floor; its decisions and heights equal JAX's."""
    from torch_jax_bridge import sphere_grid

    grid = sphere_grid(33)

    def world(pkg):
        if pkg == "jax":
            from diffsdfsim_tpu.physics import BoxShape as Box
            from diffsdfsim_tpu.physics import GridShape as Grid
            from diffsdfsim_tpu.physics import make_body as mk

            floor = mk(Box(jnp.array([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3)
            ball = mk(Grid(grid=jnp.asarray(grid), scale_=jnp.asarray(0.75)), fric_coeff=0.25, template="ico",
                      subdiv=2, project_iters=16)
            return jax_bench_world(drop=1.3, cfg_kw=EXTRA_KW, bodies=[floor, ball])
        floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3, device="cpu")
        ball = make_body(GridShape(grid=torch.tensor(grid), scale_=torch.tensor(0.75)), fric_coeff=0.25,
                         template="ico", subdiv=2, project_iters=16, device="cpu")
        return torch_bench_world(drop=1.3, cfg_kw=EXTRA_KW, bodies=[floor, ball])

    def jax_side():
        _, jtraj = jax.jit(lambda: _jax_rollout(*world("jax"), 16))()
        return jtraj.pos[:, :, 1, 1], tuple(getattr(jtraj, k) for k in DECISIONS)

    j_y, j_dec = _from_jax(jax_side)
    with torch.no_grad():
        _, traj = rollout(*world("torch"), 16)
    for key, want in zip(DECISIONS, j_dec):
        np.testing.assert_array_equal(getattr(traj, key).numpy(), want, err_msg=key)
    valid = traj.valid
    np.testing.assert_allclose(traj.pos[:, :, 1, 1][valid].numpy(), j_y[valid.numpy()], rtol=0, atol=1e-7)
    assert float(traj.v[:, :, 1, 4][valid].max()) > 0.3  # bounced
    assert float(traj.pos[:, :, 1, 1][valid].min()) > 0.42  # never sank through


# ---------------------------------------------------------------- test_strict_flags.py


def _overflow_world():
    """test_strict_flags.py's overflow scene on the port: two spheres falling
    onto the floor with one global contact slot."""
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device="cpu")
    s1 = make_body(SphereShape(torch.tensor(0.5, dtype=torch.float64)), subdiv=2, device="cpu")
    s2 = make_body(SphereShape(torch.tensor(0.5, dtype=torch.float64)), subdiv=2, device="cpu")
    vels = np.zeros((3, 6))
    vels[1:, 4] = -1.0
    return make_world([floor, s1, s2], [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, -2.0, 0.45, 0.0],
                                        [1.0, 0, 0, 0, 2.0, 0.45, 0.0]], vels,
                      joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),), (Gravity3D(10.0),)),
                      cfg=SimConfig(fric_dirs=4, max_contacts_per_pair=1, max_contacts_total=1, mesh_subdiv=2,
                                    max_substeps=4, max_bisect=6, tol=1e-6, strict_no_penetration=False),
                      no_contact=((1, 2),), device="cpu")


def _jax_overflow_decisions():
    """JAX's decisions over the overflow scene's first 3 frames."""

    def jax_side():
        import test_strict_flags as jtest

        _, jtraj = jax.jit(lambda: _jax_rollout(*jtest._overflow_world(), 3))()
        return tuple(getattr(jtraj, k) for k in DECISIONS)

    return _from_jax.keyed("overflow_decisions", jax_side)


def test_bisect_failed_flag_when_a_contact_slot_is_missing():
    """test_strict_flags.py's bisection-failure flag: in the overflow scene
    (3 frames) the sphere left without a contact sinks at every dt, so the
    per-substep bisect_failed flag is raised on valid substeps, where JAX
    raises it."""
    j_dec = _jax_overflow_decisions()
    with torch.no_grad():
        _, traj = rollout(*_overflow_world(), 3)
    for key, want in zip(DECISIONS, j_dec):
        np.testing.assert_array_equal(getattr(traj, key).numpy(), want, err_msg=key)
    assert bool(traj.bisect_failed[traj.valid].any())


def test_run_world_strict_raises_where_jax_raises():
    """test_strict_flags.py's strict run: run_world over the overflow scene,
    made strict after construction, raises when a frame's bisection hits
    its floor, with JAX's message (the same simulated time)."""
    from diffsdfsim_torch.physics.world import run_world

    def jax_side():
        import test_strict_flags as jtest

        jspec, jstate = jtest._overflow_world()
        jspec.cfg = jspec.cfg.replace(strict_no_penetration=True)
        try:
            jtest.run_world(jspec, jstate, run_time=4 * jtest.CFG.dt)
        except AssertionError as e:
            return str(e)
        return "no raise"

    j_msg = str(_from_jax(jax_side))
    spec, state = _overflow_world()
    spec.cfg = spec.cfg.replace(strict_no_penetration=True)
    with torch.no_grad(), pytest.raises(AssertionError, match="strict_no_penetration") as err:
        run_world(spec, state, run_time=4 * spec.cfg.dt)
    assert str(err.value) == j_msg


# ---------------------------------------------------------------- test_multicontact.py


def test_two_box_tower_stands():
    """test_multicontact.py's block tower (a 0.8 box on a 1 m box on the
    floor, detach_contact_b2, 25 frames) on the port: both boxes stay near
    their stack positions and the top one does not slide off; the final
    poses equal JAX's."""
    kw = dict(fric_dirs=4, max_contacts_per_pair=6, max_contacts_total=12, mesh_subdiv=2, max_substeps=4,
              max_bisect=6, time_of_contact_diff=False, detach_contact_b2=True)
    poses = [[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, 0.5, 0], [1.0, 0, 0, 0, 0.05, 1.4, 0]]
    sizes = ([20.0, 1.0, 20.0], [1.0, 1.0, 1.0], [0.8, 0.8, 0.8])

    def jax_side():
        from diffsdfsim_tpu.config import SimConfig as JaxSimConfig
        from diffsdfsim_tpu.physics import BoxShape as JBox
        from diffsdfsim_tpu.physics import Gravity3D as JGravity
        from diffsdfsim_tpu.physics import TotalConstraint3D as JTotal
        from diffsdfsim_tpu.physics import make_body as jmake_body
        from diffsdfsim_tpu.physics import make_world as jmake_world

        def run():
            bodies = [jmake_body(JBox(jnp.array(sz)), fric_coeff=0.6, subdiv=3 if i == 0 else 2)
                      for i, sz in enumerate(sizes)]
            spec, state = jmake_world(bodies, jnp.array(poses), jnp.zeros((3, 6)), joints=(JTotal(body1=0),),
                                      forces=((), (JGravity(10.0),), (JGravity(10.0),)), cfg=JaxSimConfig(**kw))
            return _jax_rollout(spec, state, 25)[0].pos

        return jax.jit(run)()

    j_pos = _from_jax(jax_side)
    bodies = [make_body(BoxShape(torch.tensor(sz)), fric_coeff=0.6, subdiv=3 if i == 0 else 2, device="cpu")
              for i, sz in enumerate(sizes)]
    spec, state = make_world(bodies, poses, np.zeros((3, 6)), joints=(TotalConstraint3D(body1=0),),
                             forces=((), (Gravity3D(10.0),), (Gravity3D(10.0),)), cfg=SimConfig(**kw), device="cpu")
    with torch.no_grad():
        final, _ = rollout(spec, state, 25)
    np.testing.assert_allclose(final.pos.numpy(), j_pos, rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(final.pos[1, 1]), 0.5, atol=0.05)
    np.testing.assert_allclose(float(final.pos[2, 1]), 1.4, atol=0.12)
    assert abs(float(final.pos[2, 0])) < 0.3


# ---------------------------------------------------------------- test_qp_crosscheck.py


def _jax_engine_lcps():
    """test_qp_crosscheck.py's LCPs: the first 8 in-contact frames' mixed
    LCPs of the JAX package's bounce-and-slide rollout (25 frames), as
    (args, k, fric_dirs)."""

    def jax_side():
        import test_qp_crosscheck as jtest

        return tuple((args, structure[1], structure[2]) for args, structure in jtest._collect_lcps()[:8])

    return _from_jax.keyed("engine_lcps", jax_side)


def test_plain_pdipm_matches_lemke_on_jax_engine_lcps():
    """test_qp_crosscheck.py's independent check on the port: the port's
    LCP solve (its plain version on the CPU) of each of the JAX package's
    engine LCPs matches the JAX test's numpy Lemke solve."""
    from diffsdfsim_torch.ops.qp import lcp_solve as port_lcp_solve

    import test_qp_crosscheck as jtest

    lcps = _jax_engine_lcps()
    assert len(lcps) >= 3
    for args, k, fd in lcps:
        x = port_lcp_solve(*[torch.as_tensor(np.asarray(a)) for a in args], 30, 1e-12, 3, ("fric", int(k), int(fd)))
        Q, p, G, h, A, b, F = [np.asarray(a[0], dtype=np.float64) for a in args]
        z_ref, _ = jtest.solve_mixed_lcp_lemke(Q, p, G, h, A, b, F)
        assert z_ref is not None, "Lemke ray termination on an engine LCP"
        scale = max(1.0, float(np.max(np.abs(z_ref))))
        np.testing.assert_allclose(x[0].numpy(), z_ref, atol=2e-5 * scale, rtol=2e-4)


def test_plain_pdipm_duals_satisfy_complementarity():
    """test_qp_crosscheck.py's residual audit on the port: the full
    primal-dual solution of the port's plain solve of the first four JAX
    engine LCPs satisfies the mixed LCP's KKT system to the JAX test's
    bounds."""
    from diffsdfsim_torch.ops.qp import pdipm_solve_raw as port_pdipm_solve_raw

    for args, k, fd in _jax_engine_lcps()[:4]:
        sol = port_pdipm_solve_raw(*[torch.as_tensor(np.asarray(a)) for a in args], 30, 1e-12, 3,
                                   ("fric", int(k), int(fd)))
        x, y, lam, s = [t[0].numpy() for t in sol]
        Q, p, G, h, A, b, F = [np.asarray(a[0], dtype=np.float64) for a in args]
        r1 = Q @ x + p + G.T @ lam + (A.T @ y if A.size else 0.0)  # stationarity
        r2 = G @ x + s - h - F @ lam  # primal feasibility with the coupling
        r3 = A @ x - b if A.size else np.zeros(0)
        assert np.max(np.abs(r1)) < 1e-5
        assert np.max(np.abs(r2)) < 1e-5
        if r3.size:
            assert np.max(np.abs(r3)) < 1e-5
        assert np.min(s) > -1e-6 and np.min(lam) > -1e-6
        assert abs(np.dot(s, lam)) < 1e-5


# ---------------------------------------------------------------- test_physics2d_extra.py


def test_triangle_hull_rests_on_its_base(P):
    """test_physics2d_extra.py's hull drop through the port's Frank-Wolfe
    search: a triangle dropped from 1.5 m (20 frames) rests on its base
    without tunnelling and stays in the plane; its heights equal JAX's."""
    cfg = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
               max_bisect=6, time_of_contact_diff=False)
    tri = [[-0.5, -0.3], [0.5, -0.3], [0.0, 0.5]]

    def world(Q):
        return scenes2d._grounded(Q, [Q.m.Rect([20.0, 1.0], **Q.kw), Q.m.Hull(tri, **Q.kw)],
                                  [[0.0, 0.0, -0.5], [0.0, 0.0, 1.5]], np.zeros((2, 3)), Q.SimConfig(**cfg))

    def jax_side():
        J = scenes2d.namespace("jax")
        _, jtraj = jax.jit(lambda: J.rollout(*world(J), 20))()
        return jtraj.pos[:, :, 1, 1], tuple(getattr(jtraj, k) for k in DECISIONS)

    j_y, j_dec = _from_jax(jax_side)
    with torch.no_grad():
        final, traj = P.rollout(*world(P), 20)
    for key, want in zip(DECISIONS, j_dec):
        np.testing.assert_array_equal(getattr(traj, key).numpy(), want, err_msg=key)
    ys = traj.pos[:, :, 1, 1][traj.valid]
    np.testing.assert_allclose(ys.numpy(), j_y[traj.valid.numpy()], rtol=0, atol=1e-7)
    assert float(ys.min()) > 0.2  # rests on its base, no tunnelling
    assert abs(float(final.pos[1, 2])) < 1e-6  # stays planar


# ---------------------------------------------------------------- test_fw_pallas.py


def test_search_rollout_matches_jax_xla_search():
    """test_fw_pallas.py's rollout parity (rad 0.55 dropped from 1.1 m,
    20 frames): the port's search (the plain version on the CPU; its
    kernel is held against it on the card) against the JAX package's XLA
    search, to the JAX test's bound between its two search backends."""
    with torch.no_grad():
        _, traj = rollout(*_sphere_world("fw", torch.tensor(0.55, dtype=torch.float64), 1.1), 20)

    def jax_side():
        _, jtraj = jax.jit(lambda: _jax_rollout(*_jax_sphere_world("fw", 0.55, 1.1, fw_backend="xla"), 20))()
        return jtraj.pos[:, :, 1, :], tuple(getattr(jtraj, k) for k in DECISIONS)

    j_pos, j_dec = _from_jax(jax_side)
    for key, want in zip(DECISIONS, j_dec):
        np.testing.assert_array_equal(getattr(traj, key).numpy(), want, err_msg=key)
    np.testing.assert_allclose(traj.pos[:, :, 1, :].numpy(), j_pos, atol=1e-5)


def test_radius_gradient_flows_through_the_search():
    """test_fw_pallas.py's gradient test (rad 0.55 from 1.1 m, coarse
    meshes, 15 frames): d loss / d rad flows through the differentiable
    contact recompute after the gradient-free search, finite and nonzero,
    equal to JAX's."""

    def loss_fn(world, rollout_fn):
        def loss(rad):
            _, traj = rollout_fn(*world("fw_grad", rad, 1.1), 15)
            return (traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None]).sum()

        return loss

    val, g = _port_value_and_grad(loss_fn(_sphere_world, rollout), 0.55)
    j_val, j_g = _from_jax(lambda: _jax_value_and_grad(loss_fn(_jax_sphere_world, _jax_rollout), 0.55))
    np.testing.assert_allclose(val, j_val, rtol=1e-6)
    np.testing.assert_allclose(g, j_g, rtol=1e-5, atol=1e-8)
    assert np.isfinite(g) and abs(g) > 1e-8


# ---------------------------------------------------------------- test_marching_body.py


def test_marching_torus_from_another_height_rests_with_a_gradient():
    """test_marching_body.py's torus (the 14^3 grid by marching tetrahedra,
    16 frames) dropped from 1.0 m, a height the port's test_torch_meshes.py
    does not run (it drops from 1.2 m): it rests on its tube, and
    |final pos|^2 and its d / d scale are finite, nonzero and equal to
    JAX's."""
    grid = GEN.torus_grid()

    def loss(scale):
        floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device="cpu")
        torus = make_body(GridShape(grid=torch.tensor(grid), scale_=scale), mesher="marching", device="cpu")
        final, traj = rollout(*make_world([floor, torus], [[1.0, 0, 0, 0, 0.0, -0.5, 0.0],
                                                           [1.0, 0, 0, 0, 0.0, 1.0, 0.0]],
                                          np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                                          forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**GEN.TORUS_CFG),
                                          device="cpu"), 16)
        return torch.sum(final.pos[1] ** 2), torch.where(traj.valid, traj.pos[:, :, 1, 1], np.inf).min()

    scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    val, min_y = loss(scale)
    (g,) = torch.autograd.grad(val, scale)

    def jax_side():
        from diffsdfsim_tpu.config import SimConfig as JaxSimConfig
        from diffsdfsim_tpu.physics import BoxShape as JBox
        from diffsdfsim_tpu.physics import Gravity3D as JGravity
        from diffsdfsim_tpu.physics import TotalConstraint3D as JTotal
        from diffsdfsim_tpu.physics import make_body as jmake_body
        from diffsdfsim_tpu.physics import make_world as jmake_world
        from diffsdfsim_tpu.physics.shapes import GridShape as JGrid

        def jloss(s):
            floor = jmake_body(JBox(jnp.array([20.0, 1.0, 20.0])), subdiv=3)
            torus = jmake_body(JGrid(grid=jnp.asarray(grid), scale_=s), mesher="marching")
            poses = jnp.array([[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.0, 0.0]])
            spec, state = jmake_world([floor, torus], poses, jnp.zeros((2, 6)), joints=(JTotal(body1=0),),
                                      forces=((), (JGravity(10.0),)), cfg=JaxSimConfig(**GEN.TORUS_CFG))
            final, traj = _jax_rollout(spec, state, 16)
            return jnp.sum(final.pos[1] ** 2), jnp.min(jnp.where(traj.valid, traj.pos[:, :, 1, 1], jnp.inf))

        return jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(1.0))

    (j_val, j_min_y), j_g = _from_jax(jax_side)
    np.testing.assert_allclose(float(val), j_val, rtol=1e-6)
    np.testing.assert_allclose(float(min_y), j_min_y, rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(g), j_g, rtol=1e-4)  # past its touchdown
    # resting on the tube: y ~ R_MIN = 0.25
    assert 0.2 < float(min_y) < 0.35, float(min_y)
    assert np.isfinite(float(g)) and abs(float(g)) > 0.0


# ---------------------------------------------------------------- 2D scenes


@pytest.fixture(scope="module")
def golden2d():
    with np.load(os.path.join(HERE, "golden", "scenes2d_f64.npz")) as g:
        return dict(g)


@pytest.fixture(scope="module")
def P():
    return scenes2d.namespace("torch", "cpu")


@pytest.mark.parametrize("scene", ["stack", "hulls"])
def test_analytic_narrowphase_agrees_with_jax_frank_wolfe(P, golden2d, scene):
    """test_narrowphase2d.py's rollout parity (a tilted box resting on a
    box, and a hull and a circle thrown at each other over the floor; 10
    frames): the port's analytic narrowphase ends within the JAX test's
    5e-2 of the JAX package's Frank-Wolfe run, across packages and
    backends at once."""
    (spec, state), n = scenes2d.build(P, f"{scene}_analytic")
    with torch.no_grad():
        final, _ = P.rollout(spec, state, n)
    assert bool(torch.isfinite(final.pos).all())
    p_an, _ = P.m.to_2d_state(final)
    np.testing.assert_allclose(p_an.numpy(), _golden_final_2d(golden2d, f"{scene}_fw"), atol=5e-2)


def _golden_final_2d(golden, case):
    """Each body's (theta, x, y) at the end of the JAX package's rollout
    ``case``: its last frame's last valid substep."""
    s = np.flatnonzero(golden[f"{case}/valid"][-1])[-1]
    q, p = golden[f"{case}/quat"][-1, s], golden[f"{case}/pos"][-1, s]
    return np.stack([2.0 * np.arctan2(q[:, 3], q[:, 0]), p[:, 0], p[:, 1]], axis=-1)


def test_hull_stack_stands_under_the_analytic_narrowphase(P, golden2d):
    """test_physics2d.py's hull-on-hull stack (30 frames) through the port's
    analytic narrowphase: the stack stands, in-plane, with the JAX test's
    bounds, and ends within 5e-2 of the JAX package's Frank-Wolfe run."""
    (spec, state), n = scenes2d.build(P, "hull_stack_analytic")
    with torch.no_grad():
        final, traj = P.rollout(spec, state, n)
    p2, _ = P.m.to_2d_state(final)
    assert abs(float(final.pos[1, 2])) < 1e-5 and abs(float(final.pos[2, 2])) < 1e-5
    assert 0.40 < float(p2[1, 2]) < 0.60, f"base y {float(p2[1, 2])}"
    assert 1.35 < float(p2[2, 2]) < 1.75, f"top y {float(p2[2, 2])}"
    assert abs(float(p2[1, 0])) < 0.1 and abs(float(p2[2, 0])) < 0.1
    ys_top = traj.pos[:, :, 2, 1][traj.valid]
    assert float(ys_top.min()) > 1.2
    np.testing.assert_allclose(p2.numpy(), _golden_final_2d(golden2d, "hull_stack_fw"), atol=5e-2)


def test_circle_rests_where_jax_grid_body_rests(P, golden2d):
    """test_marching2d.py's grid-against-circle test, its circle half on the
    port: the analytic-SDF circle (rad 0.4, no restitution, dropped from
    1 m, 25 frames, the grid scene's configuration) rests within 0.05 of
    its radius, within the JAX test's 0.03 of where the JAX package's
    65 x 65 grid body rests, and within 1e-3 of JAX's own circle: the
    Frank-Wolfe search's tied candidate points on the circle decide the
    last bits of its resting height in either package (ROADMAP queue 3,
    item 26), 2.2e-4 m apart here."""
    bodies = [P.m.Rect([20.0, 1.0], fric_coeff=0.3, restitution=0.0, **P.kw),
              P.m.Circle(0.4, fric_coeff=0.3, restitution=0.0, **P.kw)]
    spec, state = scenes2d._grounded(P, bodies, [[0.0, 0.0, -0.5], [0.0, 0.0, 1.0]], np.zeros((2, 3)),
                                     P.SimConfig(**scenes2d.GRID_CFG))
    with torch.no_grad():
        final, _ = P.rollout(spec, state, 25)
    y_circ = float(final.pos[1, 1])

    def jax_side():
        J = scenes2d.namespace("jax")
        jbodies = [J.m.Rect([20.0, 1.0], fric_coeff=0.3, restitution=0.0),
                   J.m.Circle(0.4, fric_coeff=0.3, restitution=0.0)]

        def run():
            jspec, jstate = scenes2d._grounded(J, jbodies, [[0.0, 0.0, -0.5], [0.0, 0.0, 1.0]], np.zeros((2, 3)),
                                               J.SimConfig(**scenes2d.GRID_CFG))
            return J.rollout(jspec, jstate, 25)[0].pos[1, 1]

        return jax.jit(run)()

    np.testing.assert_allclose(y_circ, _from_jax(jax_side), rtol=0, atol=1e-3)
    y_grid = float(golden2d["grid/pos"][-1, -1, 1, 1])
    assert abs(y_circ - 0.4) < 0.05, y_circ
    assert abs(y_grid - y_circ) < 0.03, (y_grid, y_circ)


# ---------------------------------------------------------------- test_pointcloud_real.py


def test_real_recording_fit_toward_another_size(tmp_path):
    """test_pointcloud_real.py's pipeline on a synthetic recording of a
    0.56 sphere (the port's test_torch_pointcloud.py runs 0.62): 30 Adam
    steps from size 0.5 move decisively toward it, to JAX's fitted size."""
    import test_pointcloud_real as jtest
    from diffsdfsim_torch.experiments import optim_pointcloud_real as topr

    path = tmp_path / "rec.pkl"
    r_target = jtest._make_fixture(path, r_target=0.56)
    argv = ["with", f"data_path={path}", "max_iter=30", "mesh_subdiv=1"]
    out = topr.main(argv + [f"base_dir={tmp_path / 'out'}"], device="cpu")

    def jax_side():
        from diffsdfsim_tpu.experiments.optim_pointcloud_real import main

        return main(argv + [f"base_dir={tmp_path / 'jax'}"])["size"]

    fitted = float(out["size"])
    np.testing.assert_allclose(fitted, float(_from_jax(jax_side)), rtol=1e-6)
    assert abs(fitted - r_target) < 0.06, f"fitted {fitted} vs {r_target}"
