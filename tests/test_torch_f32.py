"""Port parity in float32, the dtype the JAX package runs on its
accelerator: the port's plain float32 path on the CPU, through its entry
points (``make_body`` / ``make_world`` / ``rollout`` with
``dtype=torch.float32`` and bench.py's float32 ``tol=1e-5``,
``rollout_batched``, ``optim_shapespace``), against the JAX package's own
float32 runs, recorded by ``tests/golden/gen_torch_f32_golden.py`` (x64 is
on in this test process, so the float32 side runs in a process of its
own).

Two references: ``*_xla_f32.npz``, the JAX package's plain path off its
accelerator, which the port's plain path copies op for op (the float32
d-clip to [1e-5, 1e5] and 1e-6 ridge of its LCP factorization, the 1e5 cap
of its backward), and ``*_pallas_f32.npz``, its PDIPM, KKT and Frank-Wolfe
kernels in interpret mode, what it computes on its accelerator, which the
card's kernels are held to (``chip_smoke.phase_float32``).

Tolerances, from float32's epsilon (1.19e-7) and what the runs show:

- discrete decisions (valid substeps, accepted rungs, bisection failures,
  truncated frames) identical;
- the bench: before the first touchdown (frame 10) every component within
  1e-6 (~8 ulps of 1 m; read 2.4e-7); then the sphere's height within 2e-5
  (~170 ulps of 1 m; read 5.4e-7) and its vertical velocity within 1e-4
  (~210 ulps of 4 m/s; read 4.4e-6), every component within 5e-2 as in
  float64, because the touchdown tie (ROADMAP queue 3, item 1) decides the
  tangential state: in float32 the JAX package's two paths part by 1e-3
  there (``test_references_part_where_float32_decides``);
- d loss / d rad at 12 frames within 1e-5 relative (read 3.5e-7);
- the 17^3 grid drop and the narrow decoder's latent drop: every pose and
  velocity within 2e-5 (read 8.2e-7 and 2.7e-6);
- the slow cases: the sweep's losses within 1e-5 and gradients within 1e-4
  relative, the latent fit's first loss within 1e-5 and gradient within
  1e-4 relative.
"""

import os

import numpy as np
import pytest
import torch

from diffsdfsim_torch import interop
from diffsdfsim_torch.config import SimConfig
from diffsdfsim_torch.physics import (
    BoxShape,
    Gravity3D,
    GridShape,
    SphereShape,
    TotalConstraint3D,
    make_body,
    make_world,
    make_world_batched,
    rollout,
    rollout_batched,
)
from torch_jax_bridge import one_torch_thread, sphere_grid  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
F32 = torch.float32
# bench.py:47-63 at float32
BENCH_CFG = dict(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=2, max_substeps=4,
                 max_bisect=8, tol=1e-5)
GRID_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                max_bisect=6, tol=1e-5)
DECISIONS = ("valid", "n_halvings", "bisect_failed", "truncated")
FIRST_TOUCHDOWN = 10
ATOL_PRE, ATOL_Y, ATOL_VY, ATOL_ALL = 1e-6, 2e-5, 1e-4, 5e-2
RTOL_GRAD = 1e-5
ATOL_SHAPE = 2e-5


def golden(case, mode="xla"):
    return dict(np.load(os.path.join(HERE, "golden", f"{case}_{mode}_f32.npz")))


def bench_world(rad=0.5):
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25, device="cpu", dtype=F32)
    sphere = make_body(SphereShape(torch.as_tensor(rad, dtype=F32)), subdiv=2, fric_coeff=0.25, device="cpu",
                       dtype=F32)
    poses = [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]]
    return make_world([floor, sphere], poses, np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**BENCH_CFG), device="cpu")


def first_decision_parting(a, b, n):
    bad = np.zeros(n, dtype=bool)
    for key in DECISIONS:
        bad |= (np.asarray(a[key])[:n] != np.asarray(b[key])[:n]).reshape(n, -1).any(axis=1)
    over = np.nonzero(bad)[0]
    return int(over[0]) if len(over) else n


def hold_decisions(traj, ref, prefix=""):
    for key in DECISIONS:
        np.testing.assert_array_equal(getattr(traj, key).numpy(), ref[prefix + key], err_msg=key)


def test_bench_rollout_matches_xla_golden():
    """30 frames of the bench (the first bounce, frame 10, and the second
    touchdown, frame 21) in float32 end to end: every floating tensor of
    the world and the trajectory is float32."""
    n = 30
    ref = golden("bench")
    spec, state = bench_world()
    final, traj = rollout(spec, state, n)
    for name, t in list(traj._asdict().items()) + list(final._asdict().items()):
        if torch.is_tensor(t) and t.is_floating_point():
            assert t.dtype == F32, name
    for bd in spec.bodies:
        assert bd.verts.dtype == bd.mass.dtype == bd.ang_inertia.dtype == F32
    hold_decisions(traj, {k: v[:n] for k, v in ref.items()})
    for key in ("pos", "quat", "v"):
        a, b = getattr(traj, key).numpy().astype(np.float64), ref[key][:n]
        np.testing.assert_allclose(a[:FIRST_TOUCHDOWN], b[:FIRST_TOUCHDOWN], rtol=0, atol=ATOL_PRE, err_msg=key)
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_ALL, err_msg=key)
    np.testing.assert_allclose(traj.pos.numpy()[..., 1, 1], ref["pos"][:n, :, 1, 1], rtol=0, atol=ATOL_Y)
    np.testing.assert_allclose(traj.v.numpy()[..., 1, 4], ref["v"][:n, :, 1, 4], rtol=0, atol=ATOL_VY)


def test_bench_gradient_matches_xla_golden():
    """d loss / d rad of bench.py's loss over 12 frames (the first bounce
    with the time-of-contact differential) in float32."""
    ref = golden("grad_12")
    rad = torch.tensor(0.5, dtype=F32, requires_grad=True)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25, device="cpu", dtype=F32)
    sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25, device="cpu", dtype=F32)
    poses = [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]]
    spec, state = make_world([floor, sphere], poses, np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                             forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**BENCH_CFG), device="cpu")
    _, traj = rollout(spec, state, int(ref["frames"]))
    loss = torch.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None])
    loss.backward()
    assert rad.grad.dtype == F32
    np.testing.assert_allclose(float(loss.detach()), float(ref["loss"]), rtol=RTOL_GRAD)
    np.testing.assert_allclose(float(rad.grad), float(ref["grad"]), rtol=RTOL_GRAD)


def test_references_part_where_float32_decides():
    """The JAX package's own float32 runs, the witnesses of where float32
    decides: its plain (xla) and kernel (pallas) paths part at the first
    touchdown's tangential velocity by ~1e-3 (the touchdown tie), their
    decisions part at frame 36 of the resting sphere, and the plain path's
    LCP backward (d-clip and ridge) moves d loss / d rad by 4.5 % at 20
    frames (ROADMAP queue 3, item 7), while the kernels' stays within 1e-5
    of the float64 gradient."""
    xla, pallas = golden("bench"), golden("bench", "pallas")
    f64 = dict(np.load(os.path.join(HERE, "golden", "bench_rollout_f64.npz")))
    assert first_decision_parting(xla, pallas, 100) == 36
    assert first_decision_parting(pallas, f64, 100) == 100
    vt = np.abs(xla["v"][FIRST_TOUCHDOWN:, :, 1, [3, 5]] - pallas["v"][FIRST_TOUCHDOWN:, :, 1, [3, 5]])
    assert 5e-4 < float(vt[0].max()) < 5e-2
    g = {m: float(golden("grad_20", m)["grad"]) for m in ("xla", "pallas")}
    g64 = float(np.load(os.path.join(HERE, "golden", "bench_grad_f64.npz"))["toc_20_grad"])
    assert abs(g["xla"] / g64 - 1) > 4e-2
    assert abs(g["pallas"] / g64 - 1) < 1e-5


def grid_drop(res):
    cfg = SimConfig(**GRID_CFG)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3, device="cpu", dtype=F32)
    ball = make_body(GridShape(grid=torch.tensor(sphere_grid(res)), scale_=torch.tensor(0.75)), fric_coeff=0.25,
                     template="ico", subdiv=2, project_iters=16, device="cpu", dtype=F32)
    spec, state = make_world([floor, ball], [[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, 1.0, 0]], np.zeros((2, 6)),
                             joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)), cfg=cfg,
                             device="cpu")
    return ball, rollout(spec, state, 16)[1]


def test_grid_drop_matches_xla_golden():
    """The voxelized ball on a 17^3 float32 grid: make_body's template
    projection and Mirtich inertia, then 16 frames through the bounce."""
    ref = golden("grid17")
    ball, traj = grid_drop(int(ref["res"]))
    assert ball.shape.grid.dtype == F32
    np.testing.assert_allclose(ball.verts.numpy(), ref["verts"], rtol=0, atol=ATOL_SHAPE)
    np.testing.assert_allclose(ball.ang_inertia.numpy(), ref["ang_inertia"], rtol=0, atol=ATOL_SHAPE)
    hold_decisions(traj, ref)
    for key in ("pos", "quat", "v"):
        np.testing.assert_allclose(getattr(traj, key).numpy(), ref[key], rtol=0, atol=ATOL_SHAPE, err_msg=key)
    assert float(traj.v[..., 1, 4].max()) > 1.0  # it bounced


def latent_scene(ref):
    """optim_shapespace at the golden's narrow decoder (the float64 seeded
    weights rounded to float32, as the golden's) with the JAX package's
    float32 draws."""
    from diffsdfsim_torch.experiments import optim_shapespace as oss
    from diffsdfsim_torch.models.igr import init_implicit_net

    net = init_implicit_net(5, tuple(ref["dims"].tolist()), tuple(ref["skip_in"].tolist()),
                            radius_init=float(ref["radius"]), generator=np.random.default_rng(1234)).to(F32)
    c = dict(oss.DEFAULTS, run_time=int(ref["frames"]) / 30.0)
    cfg = oss.build_cfg(c, F32)
    assert cfg.tol == 1e-5
    return oss, net, c, cfg, [torch.tensor(ref[k]) for k in ("target_latent", "start_latent", "quat0")]


def test_latent_drop_matches_xla_golden():
    """The narrow decoder's 20-frame drop at the fit's start latent."""
    ref = golden("latent32")
    oss, net, c, cfg, (_, start, quat0) = latent_scene(ref)
    _, traj = oss.simulate(start, quat0, net, c, cfg, device="cpu")
    hold_decisions(traj, ref, "start_traj_")
    for key in ("pos", "quat", "v"):
        np.testing.assert_allclose(getattr(traj, key).numpy(), ref[f"start_traj_{key}"], rtol=0, atol=ATOL_SHAPE,
                                   err_msg=key)


@pytest.mark.slow
def test_latent_fit_first_step_matches_xla_golden():
    """The fit's first Adam step (the taped drop at the start latent, the
    trajectory loss against JAX's drop at the target, optax's rule)."""
    ref = golden("latent32")
    oss, net, c, cfg, (target, start, quat0) = latent_scene(ref)
    out = oss.fit(net, target, start, quat0, c, cfg, device="cpu", max_iter=1)
    np.testing.assert_allclose(float(out["loss_hist"][0]), float(ref["loss_0"]), rtol=1e-5)
    np.testing.assert_allclose(out["grad_hist"][0].numpy(), ref["grad_0"], rtol=1e-4)
    np.testing.assert_allclose(out["final_latent"].numpy(), ref["latent_1"], rtol=0, atol=1e-7)


@pytest.mark.slow
def test_seed_sweep_matches_xla_golden():
    """``rollout_batched`` of the bench world at 4 radii, 30 frames fwd+bwd,
    against the JAX package's float32 sweep, and its first and last lanes
    against the single float32 path."""
    ref = golden("batched_4")
    r = torch.tensor(ref["rads"], requires_grad=True)
    spec, bodies_b, state_b = make_world_batched(bench_world, r)
    _, traj = rollout_batched(spec, bodies_b, state_b, int(ref["frames"]))
    losses = torch.sum(traj.pos[:, :, :, 1, :] ** 2 * traj.valid[:, :, :, None], dim=(0, 1, 3))
    (grad,) = torch.autograd.grad(losses.sum(), r)
    assert grad.dtype == F32
    hold_decisions(traj, ref)
    np.testing.assert_allclose(losses.detach().numpy(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref["grad"], rtol=1e-4)
    for i in (0, len(ref["rads"]) - 1):
        _, one = rollout(*bench_world(float(ref["rads"][i])), int(ref["frames"]))
        for key in DECISIONS:
            a = getattr(traj, key)[:, i] if key == "truncated" else getattr(traj, key)[:, :, i]
            np.testing.assert_array_equal(a.numpy(), getattr(one, key).numpy(), err_msg=f"lane {i} {key}")
        np.testing.assert_allclose(traj.pos[:, :, i].detach().numpy(), one.pos.numpy(), rtol=0, atol=1e-6)


def test_interop_keeps_float32():
    """A JAX body, contact buffer or world state in float32 (the JAX
    package's accelerator dtype) comes across in float32; float64 stays
    float64; a named dtype wins."""
    spec, state = bench_world()
    bd = interop.body_from_numpy(interop.body_to_numpy(spec.bodies[1]), device="cpu")
    st = interop.state_from_numpy(interop.state_to_numpy(state), device="cpu")
    assert bd.verts.dtype == bd.shape.rad.dtype == bd.mass.dtype == F32
    assert st.pos.dtype == st.contacts.pen.dtype == st.t.dtype == F32
    d64 = interop.state_to_numpy(interop.state_from_numpy(interop.state_to_numpy(state), device="cpu",
                                                          dtype=torch.float64))
    assert interop.state_from_numpy(d64, device="cpu").pos.dtype == torch.float64
    assert interop.body_from_numpy(interop.body_to_numpy(spec.bodies[1]), device="cpu",
                                   dtype=torch.float64).verts.dtype == torch.float64
