"""Port parity, the seed sweep (``diffsdfsim_torch.physics.batched``): the
batched-native rollout of ``tests/test_batched.py``'s scene on the CPU
against the JAX package's ``rollout_batched`` (committed golden file
tests/golden/batched_f64.npz, written by
tests/golden/gen_torch_batched_golden.py) and against the port's own
single rollout of each lane, float64; the lane-axis search and world
construction against their per-lane single calls.

Tolerances (the reference's own ``tests/test_batched.py``): the discrete
decisions (valid substeps, accepted rungs, bisection failures, truncated
frames) identical; each lane's loss within rtol 1e-6, its d loss / d rad
within rtol 1e-5, atol 1e-8; the lane-axis search and construction equal to
the single calls.
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
    SphereShape,
    TotalConstraint3D,
    make_body,
    make_world,
    make_world_batched,
    rollout,
    rollout_batched,
    trajectory_lanes_first,
)
from diffsdfsim_torch.physics.contacts import search_contacts_raw
from torch_jax_bridge import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "batched_f64.npz")
CFG = SimConfig(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=1, max_substeps=4,
                max_bisect=4)
CASES = {"plain": ([0.45, 0.6, 0.8], 10, False), "detach": ([0.55, 0.7], 14, True)}
DECISIONS = ("valid", "n_halvings", "bisect_failed", "truncated")


def _build(rad, device="cpu", g=10.0):
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), mass=1.0, fric_coeff=0.25, subdiv=2, device=device)
    sphere = make_body(SphereShape(rad), mass=1.0, fric_coeff=0.25, subdiv=1, device=device)
    poses = [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]]
    vels = np.zeros((2, 6))
    vels[1, 3] = 2.0
    return make_world([floor, sphere], poses, vels, joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(g),)), cfg=CFG, device=device)


def _loss(traj):
    """Each lane's loss: sum(pos[..., 1, :]**2 * valid) over frames and substeps."""
    return torch.sum(traj.pos[:, :, :, 1, :] ** 2 * traj.valid[:, :, :, None], dim=(0, 1, 3))


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def runs():
    """Each case's batched rollout, its per-lane losses and gradients."""
    out = {}
    for name, (rads, n_frames, detach) in CASES.items():
        r = torch.tensor(rads, dtype=torch.float64, requires_grad=True)
        spec, bodies_b, state_b = make_world_batched(_build, r)
        _, traj = rollout_batched(spec, bodies_b, state_b, n_frames, detach_2nd_bounce=detach)
        losses = _loss(traj)
        losses.sum().backward()
        out[name] = (losses.detach(), r.grad.clone(), traj, spec)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_batched_matches_jax_golden(runs, golden, case):
    losses, grads, traj, spec = runs[case]
    for key in DECISIONS:
        np.testing.assert_array_equal(getattr(traj, key).numpy(), golden[f"{case}_{key}"], err_msg=key)
    np.testing.assert_allclose(losses.numpy(), golden[f"{case}_loss"], rtol=1e-6)
    np.testing.assert_allclose(grads.numpy(), golden[f"{case}_grad"], rtol=1e-5, atol=1e-8)
    # one host read per whole-batch decision: per probe stage the start
    # contact and the deep-stage gate, per substep the recompute gate
    reads, stages = spec.host_reads, spec.stages
    assert reads["contact"] == reads["deep"] == stages["shallow"] == stages["substep"] == reads["recompute"]
    assert stages["deep"] <= stages["shallow"] and reads["toc"] > 0
    assert sum(reads.values()) == spec.host_syncs
    assert (reads["redo"] > 0) == CASES[case][2]


@pytest.mark.parametrize("case,lane", [("plain", 0), ("plain", 1), ("plain", 2), ("detach", 0), ("detach", 1)])
def test_batched_lane_matches_single_rollout(runs, case, lane):
    """Lane i of the sweep against the port's single rollout at its radius."""
    losses, grads, traj, _ = runs[case]
    rads, n_frames, detach = CASES[case]
    rad = torch.tensor(rads[lane], dtype=torch.float64, requires_grad=True)
    spec, state = _build(rad)
    _, single = rollout(spec, state, n_frames, detach_2nd_bounce=detach)
    loss = torch.sum(single.pos[:, :, 1, :] ** 2 * single.valid[:, :, None])
    loss.backward()
    lanes = trajectory_lanes_first(traj)
    for key in DECISIONS:
        np.testing.assert_array_equal(getattr(lanes, key)[lane].numpy(), getattr(single, key).numpy(), err_msg=key)
    np.testing.assert_allclose(lanes.pos[lane].detach().numpy(), single.pos.detach().numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(losses[lane]), float(loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(float(grads[lane]), float(rad.grad), rtol=1e-5, atol=1e-8)


def test_per_lane_forces_match_single_rollout():
    """Per-lane force parameters (``forces_b``): a gravity of its own in each
    of two lanes whose bodies are all shared, each lane against the single
    rollout under its gravity, d loss / d g included."""
    gs, rad, n_frames = torch.tensor([11.0, 14.0], dtype=torch.float64, requires_grad=True), 0.8, 9
    spec, bodies_b, forces_b, state_b = make_world_batched(
        lambda g: _build(torch.tensor(rad, dtype=torch.float64), g=g), gs, return_forces=True)
    assert all(bd.lanes == 0 for bd in bodies_b) and forces_b[1][0].g.shape == (2,)
    _, traj = rollout_batched(spec, bodies_b, state_b, n_frames, forces_b=forces_b)
    losses = _loss(traj)
    (grads,) = torch.autograd.grad(losses.sum(), gs)
    lanes = trajectory_lanes_first(traj)
    assert bool((lanes.v[:, :, 0, 1, 4] > 0).any(dim=1).all())  # every lane's sphere bounces
    for i in range(2):
        g = torch.tensor(float(gs[i]), dtype=torch.float64, requires_grad=True)
        s, st = _build(torch.tensor(rad, dtype=torch.float64), g=g)
        _, single = rollout(s, st, n_frames)
        loss = torch.sum(single.pos[:, :, 1, :] ** 2 * single.valid[:, :, None])
        (g_single,) = torch.autograd.grad(loss, g)
        for key in DECISIONS:
            np.testing.assert_array_equal(getattr(lanes, key)[i].numpy(), getattr(single, key).numpy(), err_msg=key)
        np.testing.assert_allclose(lanes.pos[i].detach().numpy(), single.pos.detach().numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(losses[i]), float(loss), rtol=1e-6)
        np.testing.assert_allclose(float(grads[i]), float(g_single), rtol=1e-5, atol=1e-8)


def test_search_contacts_raw_lanes_match_single():
    """The probe stage's search of B D poses with a sphere of another radius
    in each lane equals each lane's single search of its D poses."""
    rads, D = [0.45, 0.6, 0.8], 3
    worlds = [_build(torch.tensor(r, dtype=torch.float64)) for r in rads]
    spec, bodies_b, _ = make_world_batched(_build, torch.tensor(rads, dtype=torch.float64))
    assert bodies_b[0].lanes == 0 and bodies_b[1].lanes == len(rads)
    quat = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64).expand(len(rads) * D, 2, 4)
    ys = np.repeat(rads, D) - 1e-3 * np.tile(np.arange(D), len(rads))
    pos = torch.zeros((len(rads) * D, 2, 3), dtype=torch.float64)
    pos[:, 0, 1] = -0.5
    pos[:, 1, 1] = torch.tensor(ys)
    pos[:, 1, 0] = 0.01
    got = search_contacts_raw(bodies_b, quat, pos, spec.directed_pairs, CFG)
    assert bool(torch.isfinite(got.max_pen_all).all())
    for i, (s, _) in enumerate(worlds):
        rows = slice(i * D, (i + 1) * D)
        want = search_contacts_raw(s.bodies, quat[rows], pos[rows], s.directed_pairs, CFG)
        torch.testing.assert_close(got.max_pen_all[rows], want.max_pen_all, rtol=0, atol=0)
        for g, w in zip(got.gates, want.gates):
            assert torch.equal(g[rows], w)
        for g, w in zip(got.raws, want.raws):
            for name, a, b in zip(g._fields, g, w):
                torch.testing.assert_close(a[rows], b, rtol=0, atol=0, msg=name)


def test_make_world_batched_leaves_match_make_world():
    """Each lane's bodies and state equal its own make_world; a body equal
    in every lane stays one body, a lane's radius reaches its own tape, a
    lane body and the sweep's state round-trip through numpy (``interop``),
    and the sweep is built on CUDA unless the CPU is asked for."""
    rads = torch.tensor([0.45, 0.6], dtype=torch.float64, requires_grad=True)
    spec, bodies_b, state_b = make_world_batched(_build, rads)
    floor, sphere = bodies_b
    assert floor.lanes == 0 and sphere.lanes == 2 and sphere.verts.shape[0] == 2
    for i in range(2):
        s, st = _build(rads[i].detach().clone())
        for name, t in s.bodies[1].tensors().items():
            torch.testing.assert_close(sphere.tensors()[name][i].detach(), t, rtol=0, atol=0, msg=name)
        for name in ("quat", "pos", "v", "t", "last_dt", "had_toc"):
            assert torch.equal(getattr(state_b, name)[i], getattr(st, name)), name
        assert torch.equal(state_b.contacts.valid[i], st.contacts.valid)
    back = interop.body_from_numpy(interop.body_to_numpy(sphere), device="cpu")  # the lane axis round-trips
    assert back.lanes == 2 and all(torch.equal(t, sphere.tensors()[k].detach()) for k, t in back.tensors().items())
    st_back = interop.state_from_numpy(interop.state_to_numpy(state_b), device="cpu")
    assert all(torch.equal(getattr(st_back, n), getattr(state_b, n).detach())
               for n in ("quat", "pos", "v", "t", "last_dt", "had_toc"))
    assert torch.equal(st_back.contacts.valid, state_b.contacts.valid) and st_back.pos.shape[0] == 2
    (g,) = torch.autograd.grad(sphere.ang_inertia[1].sum(), rads)
    assert float(g[0]) == 0.0 and float(g[1]) != 0.0  # lane 1's inertia depends on its radius alone
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_world_batched(lambda r: _build(r, device=None), rads)
