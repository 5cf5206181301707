"""Port parity for the JAX package's seed-sweep machinery, in cases the
port's other test files do not run.

The JAX package checks that its sweep machinery is a pure optimization:
the batched-native sweep (``tests/test_batched.py``), the whole-batch probe
gate (``tests/test_ladder_gate.py``), the replay emission mode
(``tests/test_replay_emit.py``), the scan-unroll and remat knobs
(``tests/test_unroll.py``), the sharded sweep (``tests/test_sharding.py``)
and the batched system-identification sweep
(``tests/test_sysid_batched.py``). The port keeps the batched sweep and the
sharded sweep and accepts the other knobs as no-ops (``SimConfig``). Each
test here holds the port's sweep against its single rollouts (CPU,
float64), and against the JAX package's lanes in the same scene with the
same knobs, recorded by ``tests/golden/gen_torch_sweep_knobs_golden.py`` in
``tests/golden/sweep_knobs_jax.pkl`` (``torch_jax_bridge.JaxGolden``).

Tolerances, as ``tests/test_torch_batched.py``'s: the discrete decisions
identical; each lane's loss within rtol 1e-6 and its gradient within rtol
1e-5, atol 1e-8, of the port's single rollout and of JAX's lanes.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes_sharding as ss
from diffsdfsim_torch.parallel import batched_rollout, make_mesh, shard_batch
from diffsdfsim_torch.physics import make_world_batched, rollout, rollout_batched, trajectory_lanes_first
from torch_jax_bridge import JaxGolden, jax_bench_world, one_torch_thread, torch_bench_world  # noqa: F401

_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "sweep_knobs_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()

DECISIONS = ("valid", "n_halvings", "bisect_failed")
RTOL_LOSS, RTOL_GRAD, ATOL_GRAD = 1e-6, 1e-5, 1e-8

# the JAX tests' configurations: test_batched.py and test_ladder_gate.py;
# test_replay_emit.py; test_unroll.py
SWEEP_KW = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=1, max_substeps=4,
                max_bisect=4)
EMIT_KW = dict(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=1, max_substeps=4,
               max_bisect=6, tol=1e-8, strict_no_penetration=False, replay_mode="emit")
UNROLL_KW = dict(fric_dirs=4, max_contacts_per_pair=2, max_contacts_total=2, mesh_subdiv=1, max_substeps=3,
                 max_bisect=4)
GATE_KW = dict(ladder_fast_path=False, ladder_batch_gate=True)
# scene: (configuration, the sphere's x and height, its x velocity); the
# bridge's bench world with a sphere of subdivision 1 over a floor box of
# subdivision 2
SCENES = {
    "sweep": (SWEEP_KW, 0.0, 1.2, 2.0),
    "resting": (SWEEP_KW, 0.0, 0.8, 2.0),  # test_ladder_gate.py's detach scene
    "emit": (EMIT_KW, 0.3, 0.9, 1.0),
    "unroll": (UNROLL_KW, 0.0, 1.1, 0.0),
}


# ---------------------------------------------------------------- the port


def _world(scene, rad, **cfg_kw):
    kw, x, height, vx = SCENES[scene]
    return torch_bench_world(drop=height, rad=rad, cfg_kw={**kw, **cfg_kw}, v_sphere=[0, 0, 0, vx, 0, 0], x=x,
                             subdiv=(2, 1))


def _single(scene, rad, n_frames, detach=False, **cfg_kw):
    """(loss, d loss / d rad, trajectory) of the port's single rollout; the
    loss is the JAX tests' sum(pos[:, :, 1, :]**2 * valid)."""
    r = torch.tensor(rad, dtype=torch.float64, requires_grad=True)
    spec, state = _world(scene, r, **cfg_kw)
    _, traj = rollout(spec, state, n_frames, detach_2nd_bounce=detach)
    loss = torch.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None])
    (g,) = torch.autograd.grad(loss, r)
    return float(loss.detach()), float(g), traj


def _sweep(scene, rads, n_frames, detach=False, **cfg_kw):
    """(losses, gradients, trajectory lanes first) of the port's
    batched-native sweep, one lane a radius."""
    r = torch.tensor(rads, dtype=torch.float64, requires_grad=True)
    spec, bodies_b, state_b = make_world_batched(lambda x: _world(scene, x, **cfg_kw), r)
    _, traj = rollout_batched(spec, bodies_b, state_b, n_frames, detach_2nd_bounce=detach)
    losses = torch.sum(traj.pos[:, :, :, 1, :] ** 2 * traj.valid[:, :, :, None], dim=(0, 1, 3))
    (g,) = torch.autograd.grad(losses.sum(), r)
    return losses.detach().numpy(), g.numpy(), trajectory_lanes_first(traj)


def _assert_lanes_match_single(scene, rads, n_frames, losses, grads, lanes, detach=False, **cfg_kw):
    for i, rad in enumerate(rads):
        loss, g, single = _single(scene, rad, n_frames, detach, **cfg_kw)
        for key in DECISIONS:
            np.testing.assert_array_equal(getattr(lanes, key)[i].numpy(), getattr(single, key).numpy(), err_msg=key)
        np.testing.assert_allclose(lanes.pos[i].detach().numpy(), single.pos.detach().numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(losses[i], loss, rtol=RTOL_LOSS)
        np.testing.assert_allclose(grads[i], g, rtol=RTOL_GRAD, atol=ATOL_GRAD)


def _assert_matches_jax(losses, grads, jax_out, decisions=None):
    j_losses, j_grads = jax_out[:2]
    np.testing.assert_allclose(losses, j_losses, rtol=RTOL_LOSS)
    np.testing.assert_allclose(grads, j_grads, rtol=RTOL_GRAD, atol=ATOL_GRAD)
    if decisions is not None:
        for key, want in zip(DECISIONS, jax_out[2]):
            np.testing.assert_array_equal(getattr(decisions, key).numpy(), want, err_msg=key)


# ---------------------------------------------------------------- JAX


def _jax_world(scene, rad, **cfg_kw):
    kw, x, height, vx = SCENES[scene]
    return jax_bench_world(drop=height, rad=rad, cfg_kw={**kw, **cfg_kw}, v_sphere=[0, 0, 0, vx, 0, 0], x=x,
                           subdiv=(2, 1))


def _jax_loss(scene, n_frames, detach=False, **cfg_kw):
    from diffsdfsim_tpu.physics import rollout as jrollout

    def loss(rad):
        _, traj = jrollout(*_jax_world(scene, rad, **cfg_kw), n_frames=n_frames, detach_2nd_bounce=detach)
        return jnp.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None]), traj

    return loss


def _jax_single(scene, rad, n_frames, detach=False, **cfg_kw):
    """JAX's (loss, d loss / d rad, decisions, positions) of one rollout."""
    (loss, traj), g = jax.jit(jax.value_and_grad(_jax_loss(scene, n_frames, detach, **cfg_kw), has_aux=True))(
        jnp.asarray(rad))
    return loss, g, tuple(getattr(traj, k) for k in DECISIONS), traj.pos


def _jax_sweep(scene, rads, n_frames, detach=False, **cfg_kw):
    """JAX's batched-native sweep (make_world_batched + rollout_batched):
    (losses, gradients, decisions lanes first)."""
    from diffsdfsim_tpu.physics import make_world_batched as jmake_world_batched
    from diffsdfsim_tpu.physics import rollout_batched as jrollout_batched

    def total(rs):
        spec, bodies_b, state_b = jmake_world_batched(lambda r: _jax_world(scene, r, **cfg_kw), rs)
        _, traj = jrollout_batched(spec, bodies_b, state_b, n_frames, detach_2nd_bounce=detach)
        losses = jnp.sum(traj.pos[:, :, :, 1, :] ** 2 * traj.valid[:, :, :, None], axis=(0, 1, 3))
        return jnp.sum(losses), (losses, traj)

    (_, (losses, traj)), g = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(rads))
    return losses, g, tuple(jnp.moveaxis(getattr(traj, k), 2, 0) for k in DECISIONS)


def _jax_lanes(scene, rads, n_frames, detach=False, **cfg_kw):
    """JAX's jit(vmap(value_and_grad)) of the single path: (losses,
    gradients, decisions lanes first)."""
    loss = _jax_loss(scene, n_frames, detach, **cfg_kw)
    (losses, traj), g = jax.jit(jax.vmap(jax.value_and_grad(loss, has_aux=True)))(jnp.asarray(rads))
    return losses, g, tuple(getattr(traj, k) for k in DECISIONS)


# ---------------------------------------------------------------- batched sweep (test_batched.py)


@pytest.mark.parametrize("rads,n_frames,detach", [([0.5, 0.65, 0.75], 12, False), ([0.45, 0.6, 0.8], 14, True)],
                         ids=["plain", "detach"])
def test_sweep_lanes_match_single_and_jax(rads, n_frames, detach):
    """test_batched.py's two tests (lanes of the batched-native sweep equal
    each lane's single rollout, with and without detach_2nd_bounce) at
    lane sets and frame counts the port's test_torch_batched.py does not
    run, each lane also against JAX's sweep."""
    jax_out = _from_jax(lambda: _jax_sweep("sweep", rads, n_frames, detach))
    losses, grads, lanes = _sweep("sweep", rads, n_frames, detach)
    _assert_lanes_match_single("sweep", rads, n_frames, losses, grads, lanes, detach)
    _assert_matches_jax(losses, grads, jax_out, lanes)


# ---------------------------------------------------------------- knobs the port ignores


# the knobs the JAX package's own tests turn (test_ladder_gate.py,
# test_replay_emit.py, test_unroll.py), which the port's SimConfig accepts
# and ignores: (scene, radii, frames, detach_2nd_bounce, knobs, JAX's lanes:
# its vmap of the single path or its batched-native sweep)
KNOB_CASES = {
    "gate": ("sweep", [0.5, 0.7], 12, False, GATE_KW, "vmap"),  # test_ladder_gate.py
    "gate_one_lane": ("sweep", [0.55], 12, False, GATE_KW, "vmap"),
    "emit": ("emit", [0.53, 0.6], 12, False, {}, "vmap"),  # test_replay_emit.py
    "emit_detach": ("emit", [0.6], 12, True, {}, "vmap"),
    "emit_gate": ("emit", [0.57, 0.65], 12, False, GATE_KW, "vmap"),
    "emit_sweep": ("emit", [0.52, 0.57, 0.62], 12, False, dict(ladder_fast_path=False), "sweep"),
    "unroll_remat": ("unroll", [0.5, 0.6], 6, False, dict(substep_unroll=3, frame_unroll=2, remat_policy="dots"),
                     "vmap"),  # test_unroll.py
}


@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_sweep_matches_single_and_jax_under_knobs(case):
    """The JAX tests' knobs, each at lanes of its own: the port's sweep with
    the knob equals its lanes' single rollouts, and JAX's lanes with the
    knob."""
    scene, rads, n_frames, detach, knobs, jax_path = KNOB_CASES[case]
    jax_lanes = {"vmap": _jax_lanes, "sweep": _jax_sweep}[jax_path]
    jax_out = _from_jax(lambda: jax_lanes(scene, rads, n_frames, detach, **knobs))
    losses, grads, lanes = _sweep(scene, rads, n_frames, detach, **knobs)
    _assert_lanes_match_single(scene, rads, n_frames, losses, grads, lanes, detach, **knobs)
    _assert_matches_jax(losses, grads, jax_out, lanes)


# ---------------------------------------------------------------- detach at resting contact (test_ladder_gate.py)


@pytest.fixture(scope="module")
def resting_runs():
    """test_ladder_gate.py's detach scene (sphere 0.6 dropped from 0.8 m,
    24 frames, settling into resting contact) with and without
    detach_2nd_bounce: the port's (loss, gradient, trajectory)."""
    return {detach: _single("resting", 0.6, 24, detach) for detach in (False, True)}


def _jax_resting(detach):
    return _from_jax.keyed(f"resting/{detach}", lambda: _jax_single("resting", 0.6, 24, detach))


def test_detach_severs_gradient_at_resting_contact(resting_runs):
    """test_ladder_gate.py's severs-gradient test on the port: the detached
    gradient differs from the full tape's, each equal to JAX's."""
    jax_out = {detach: _jax_resting(detach) for detach in (False, True)}
    g = {}
    for detach, (loss, grad, _) in resting_runs.items():
        j_loss, j_g, _, _ = jax_out[detach]
        _assert_matches_jax(np.array([loss]), np.array([grad]), (np.array([j_loss]), np.array([j_g])))
        assert np.isfinite(grad)
        g[detach] = grad
    assert abs(g[False] - g[True]) > 1e-12


def test_detach_keeps_trajectory_values(resting_runs):
    """test_ladder_gate.py's preserves-values test on the port: detaching
    changes no recorded value, validity or simulated time; the detached
    trajectory's decisions and positions equal JAX's."""
    traj_p, traj_d = resting_runs[False][2], resting_runs[True][2]
    assert torch.equal(traj_d.valid, traj_p.valid)
    m = traj_p.valid
    np.testing.assert_allclose(traj_d.pos[m].detach().numpy(), traj_p.pos[m].detach().numpy(), rtol=1e-7, atol=1e-9)
    assert abs(float(traj_d.t[traj_d.valid].max()) - float(traj_p.t[m].max())) <= 1e-9
    _, _, j_dec, j_pos = _jax_resting(True)
    for key, want in zip(DECISIONS, j_dec):
        np.testing.assert_array_equal(getattr(traj_d, key).numpy(), want, err_msg=key)
    np.testing.assert_allclose(traj_d.pos[m].detach().numpy(), j_pos[m.numpy()], rtol=0, atol=1e-7)


# ---------------------------------------------------------------- sharded sweep (test_sharding.py)


@pytest.fixture(scope="module")
def four_worker_runs():
    """test_sharding.py's sweeps, the small and the bench configuration at
    its 8 seeds and 2 frames, unsharded and over a mesh of four CPU workers
    (two lanes a worker)."""
    out = {}
    mesh = make_mesh(devices=["cpu"] * 4)
    with mesh:
        for size in ("jax_test", "bench_2"):
            batch = tuple(torch.tensor(x) for x in ss.seeds(size))
            step = functools.partial(ss.seed_step, size)
            out[size] = (batched_rollout(step, device="cpu", has_aux=True)(batch)[0],
                         batched_rollout(step, mesh, device="cpu", has_aux=True)(shard_batch(batch, mesh))[0])
    return out


def _jax_unsharded(size):
    from diffsdfsim_tpu.parallel.sharding import batched_rollout as jax_batched_rollout

    rads, drops = ss.seeds(size)
    return jax_batched_rollout(jax.value_and_grad(ss.jax_loss(size)))((jnp.asarray(rads), jnp.asarray(drops)))


def test_four_worker_sweep_matches_unsharded_and_jax(four_worker_runs):
    """test_sharding.py's sharded value_and_grad at its own 2 frames: over
    four workers every lane equals the unsharded sweep, and JAX's lanes."""
    vals, (g_rad, g_drop) = _from_jax(lambda: _jax_unsharded("jax_test"))
    ref, out = four_worker_runs["jax_test"]
    for key in ref:
        assert torch.equal(out[key], ref[key]), key
    np.testing.assert_allclose(ref["loss"].numpy(), vals, rtol=1e-8, atol=0)
    np.testing.assert_allclose(ref["d_rad"].numpy(), g_rad, rtol=1e-8, atol=0)
    np.testing.assert_allclose(ref["d_drop"].numpy(), g_drop, rtol=1e-8, atol=0)


def test_four_worker_loss_sum_matches_jax_reduction(four_worker_runs):
    """test_sharding.py's reduced loss: the sum of the four workers' lanes
    in lane order equals the unsharded sum, and JAX's reduction."""

    def jax_total():
        rads, drops = ss.seeds("jax_test")
        loss = ss.jax_loss("jax_test")
        return jax.jit(lambda a: jnp.sum(jax.vmap(loss)(a)))((jnp.asarray(rads), jnp.asarray(drops)))

    j_total = _from_jax(jax_total)
    ref, out = four_worker_runs["jax_test"]
    assert float(torch.sum(out["loss"])) == float(torch.sum(ref["loss"]))
    np.testing.assert_allclose(float(torch.sum(out["loss"])), float(j_total), rtol=1e-10)


def test_bench_scale_sharded_sweep_matches_jax(four_worker_runs):
    """test_sharding.py's bench-scale step: the bench configuration's sweep
    of 8 seeds over four workers is finite, equals the unsharded sweep and
    JAX's batched-native lanes."""
    rads, drops = ss.seeds("bench_2")
    j = _from_jax(lambda: jax.jit(functools.partial(ss.jax_seed_step, "bench_2"))(jnp.asarray(rads),
                                                                                   jnp.asarray(drops)))
    ref, out = four_worker_runs["bench_2"]
    for key in ref:
        assert torch.equal(out[key], ref[key]), key
    assert bool(torch.isfinite(out["loss"]).all()) and bool(torch.isfinite(out["d_rad"]).all())
    np.testing.assert_allclose(out["loss"].numpy(), j["loss"], rtol=1e-8, atol=0)
    np.testing.assert_allclose(out["d_rad"].numpy(), j["d_rad"], rtol=1e-8, atol=0)


# ---------------------------------------------------------------- system identification (test_sysid_batched.py)


@pytest.mark.parametrize("param", ["force", "friction"])
def test_sysid_sweep_matches_single_fits_and_jax(param):
    """test_sysid_batched.py's backend parity (its configuration, three
    steps at lr 0.1) at JAX's seed-0 draws: the port's batched-native sweep
    against its single fits, and against JAX's run_sweep_batched."""
    from diffsdfsim_torch.experiments import optim_sysid as osy

    c_jax = dict(seed=0, param=param, run_time=0.3, max_iter=3, lr=1e-1, min_val=0.0, max_val=0.0, mesh_subdiv=1,
                 n_par=2)
    c = dict(osy.DEFAULTS, **c_jax)

    def jax_side():
        from diffsdfsim_tpu.experiments import optim_sysid as josy

        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        return jax.jit(lambda ks: josy.run_sweep_batched(ks, c_jax, josy.build_cfg(c_jax)))(keys)

    j = _from_jax(jax_side)
    cfg = osy.build_cfg(c)
    targets, starts = torch.tensor(j["target_theta"]), torch.tensor(j["start_theta"])
    res = osy.fit_batched(targets, starts, c, cfg, "cpu")
    # test_sysid_batched.py's tolerances, lanes against single fits and against JAX
    for i in range(2):
        one = osy.fit(targets[i], starts[i], c, cfg, "cpu")
        np.testing.assert_allclose(res["loss_hist"][:, i].numpy(), one["loss_hist"].numpy(), rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(float(res["final_theta"][i]), float(one["final_theta"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res["loss_hist"].numpy(), j["loss_hist"], rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(res["final_theta"].numpy(), j["final_theta"], rtol=1e-4, atol=1e-6)
