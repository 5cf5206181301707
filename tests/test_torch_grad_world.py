"""Port parity, the whole gradient slice: d loss / d rad of bench.py's loss,
sum(traj.pos[:, :, 1, :]**2 * valid), over the bench world (sphere rad 0.5
dropped from 1.2 m onto the floor box, bench.py's config, float64, CPU)
through the port's public entry points (make_body with a radius that
requires grad, make_world, rollout, backward), against the JAX package's
committed golden values (tests/golden/bench_grad_f64.npz, written by
tests/golden/gen_torch_grad_golden.py).

Tolerances: the loss within 1e-12 relative and its gradient within 1e-4
relative through the first bounce (20 frames, with and without the
time-of-contact differential; without it the gradient is zero to rounding,
~1e-20, and is held at 1e-4 absolute) and with detach_2nd_bounce through
frame 26 (27 frames, the truncation firing at the touchdowns of frames 21
and 26; there the loss within 1e-7 relative: the forward state after a
touchdown carries rounding-level differences, see test_torch_world.py).

The 100-frame case (marked slow) is held prefix by prefix, at 1e-2
relative for the whole run: from the touchdown in frame 26 the reference's
own contact point is decided by rounding (ROADMAP.md queue 3); the golden
values at 27 .. 80 frames show the difference begin there and grow.
"""

import os

import numpy as np
import pytest
import torch

from diffsdfsim_torch.physics import BoxShape, SphereShape, make_body, rollout
from torch_jax_bridge import BENCH_CFG, one_torch_thread, torch_bench_world  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "bench_grad_f64.npz")
ROLLOUT_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "bench_rollout_f64.npz")


@pytest.fixture(scope="module")
def golden():
    return {k: float(v) for k, v in np.load(GOLDEN).items()}


def bench_loss(n_frames, cfg_kw=None, detach_2nd_bounce=False):
    """(loss, d loss / d rad, trajectory, spec) of the bench rollout."""
    rad = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25, device="cpu")
    sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25, device="cpu")
    spec, state = torch_bench_world(cfg_kw={**BENCH_CFG, **(cfg_kw or {})}, bodies=[floor, sphere])
    _, traj = rollout(spec, state, n_frames, detach_2nd_bounce=detach_2nd_bounce)
    loss = torch.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None])
    loss.backward()
    return float(loss.detach()), float(rad.grad), traj, spec


def test_first_bounce_gradient(golden):
    """20 frames: the first bounce (frame 10) with the TOC differential. The
    trajectory of the differentiable rollout is the forward rollout's, held
    against the forward golden file as test_torch_world.py holds it."""
    loss, grad, traj, _ = bench_loss(20)
    np.testing.assert_allclose(loss, golden["toc_20_loss"], rtol=1e-12)
    np.testing.assert_allclose(grad, golden["toc_20_grad"], rtol=1e-4)
    ref = np.load(ROLLOUT_GOLDEN)
    np.testing.assert_allclose(traj.pos.detach().numpy(), ref["pos"][:20], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(traj.n_halvings.numpy(), ref["n_halvings"][:20])


def test_first_bounce_gradient_without_toc(golden):
    loss, grad, _, _ = bench_loss(20, {"time_of_contact_diff": False})
    np.testing.assert_allclose(loss, golden["notoc_20_loss"], rtol=1e-12)
    np.testing.assert_allclose(grad, golden["notoc_20_grad"], rtol=0, atol=1e-4)
    assert abs(golden["toc_20_grad"]) > 1.0  # the TOC differential is what carries the gradient


def test_detach_2nd_bounce_gradient(golden):
    """27 frames with detach_2nd_bounce: the truncation fires at frames 21
    and 26, re-running each from its detached start state (two more frame
    runs, so more host reads than frames)."""
    loss, grad, _, spec = bench_loss(27, detach_2nd_bounce=True)
    np.testing.assert_allclose(loss, golden["detach_27_loss"], rtol=1e-7)
    np.testing.assert_allclose(grad, golden["detach_27_grad"], rtol=1e-4)
    assert abs(grad - golden["toc_27_grad"]) > 1e-2 * abs(grad)  # the truncation changed the gradient


def test_no_grad_rollout_is_the_same_forward(monkeypatch):
    """Without a tape to record the rollout re-emits the probe's values
    only: under torch.no_grad(), and in grad mode when nothing requires
    grad (no replay solve, no TOC block, the same host reads). With a
    radius that requires grad the differentiable replay produces the same
    numbers bit for bit."""
    from diffsdfsim_torch.physics import world

    spec, state = torch_bench_world()
    with torch.no_grad():
        _, traj_ng = rollout(spec, state, 12)
    replays = []
    monkeypatch.setattr(world, "solve_dynamics", lambda *a, **kw: replays.append(1))
    spec_u, state_u = torch_bench_world()
    _, traj_u = rollout(spec_u, state_u, 12)
    monkeypatch.undo()
    assert torch.is_grad_enabled() and not replays and spec_u.host_syncs == spec.host_syncs
    assert traj_u.pos.grad_fn is None and torch.equal(traj_u.pos, traj_ng.pos)
    rad = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25, device="cpu")
    sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25, device="cpu")
    spec_g, state_g = torch_bench_world(bodies=[floor, sphere])
    _, traj_g = rollout(spec_g, state_g, 12)
    assert traj_g.pos.requires_grad and not traj_ng.pos.requires_grad
    for key in ("pos", "quat", "v"):
        assert torch.equal(getattr(traj_g, key).detach(), getattr(traj_ng, key)), key


def test_run_world_matches_rollout():
    from diffsdfsim_torch.physics.world import run_world

    spec, state = torch_bench_world()
    with torch.no_grad():
        final, traj = run_world(spec, state, run_time=6.5 / 30)
        _, ref = rollout(*torch_bench_world(), 7)
    assert traj.pos.shape[0] == 7
    assert torch.equal(traj.pos, ref.pos)
    with pytest.raises(NotImplementedError):
        run_world(spec, state, recorder=object())


@pytest.mark.slow
def test_whole_bench_gradient(golden):
    """100 frames (the bench workload), compared prefix by prefix: the loss
    over the first n frames for n in 20 .. 100, each one backward through
    the same taped rollout, against the golden value for n frames. The
    forward state equals the reference's to 1e-15 through frame 26 and
    leaves it by > 1e-4 at frame 27, after the touchdown in frame 26 whose
    contact point rounding decides (ROADMAP.md queue 3); from frame 30 the
    sphere is in contact every frame and the gradient parts with the
    reference by a relative 1e-7 (27 frames), 2e-7 (30), 2e-6 (40), 9e-6
    (50), 3e-5 (60), 3e-4 (80) and 2e-3 (100) on the CPU. Held: 1e-4
    through 30 frames, 1e-3 through 80, 1e-2 at 100."""
    rad = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25, device="cpu")
    sphere = make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25, device="cpu")
    spec, state = torch_bench_world(bodies=[floor, sphere])
    _, traj = rollout(spec, state, 100)
    per_frame = torch.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None], dim=(1, 2))
    np.testing.assert_allclose(float(per_frame.sum().detach()), golden["toc_100_loss"], rtol=1e-5)
    for n, rtol in ((20, 1e-4), (27, 1e-4), (30, 1e-4), (40, 1e-3), (50, 1e-3), (60, 1e-3), (80, 1e-3),
                    (100, 1e-2)):
        (grad,) = torch.autograd.grad(per_frame[:n].sum(), rad, retain_graph=n < 100)
        np.testing.assert_allclose(float(grad), golden[f"toc_{n}_grad"], rtol=rtol, err_msg=f"{n} frames")
