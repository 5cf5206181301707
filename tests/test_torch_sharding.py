"""Port parity, the sharded seed sweep (``diffsdfsim_torch.parallel``): the
counterpart of ``tests/test_sharding.py``.

The sweep is ``tests/scenes_sharding.py``'s ``cpu`` size: the JAX tests'
small configuration at 8 seeds (rads ``linspace(0.4, 0.7, 8)``, drops
``linspace(1.0, 1.5, 8)``) and 14 frames, past every lane's touchdown,
fwd+bwd (``scenes_sharding.seed_step``). It runs unsharded in this process
and over a mesh of two CPU workers, started once for the module (4 lanes a
worker), float64.

Tolerances: the sharded run equals the unsharded one bitwise (on the CPU a
lane's result does not depend on the batch it runs in), and so does the sum
of the lanes' losses in lane order; against JAX's unsharded
``batched_rollout(jax.value_and_grad(loss))`` (recorded by
``tests/golden/gen_torch_sharding_golden.py`` in
``tests/golden/sharding_jax.pkl``) each lane's loss and its gradient with
respect to (rad, drop) within RTOL_JAX relative.
"""

import concurrent.futures
import functools
import operator
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes_sharding as ss
from diffsdfsim_torch.parallel import WorkerError, batched_rollout, make_mesh, shard_batch
from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

RTOL_JAX = 1e-8
STEP = functools.partial(ss.seed_step, "cpu")

_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "sharding_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


@pytest.fixture(scope="module")
def seed_batch():
    return tuple(torch.tensor(x) for x in ss.seeds("cpu"))


@pytest.fixture(scope="module")
def runs(seed_batch):
    """(mesh, unsharded (outputs, aux), sharded (outputs, aux, stats)). The
    workers start and run their chunks from a thread, which only waits on
    them, while the unsharded sweep runs here."""

    def sharded():
        mesh = make_mesh(devices=["cpu", "cpu"])
        step = batched_rollout(STEP, mesh, device="cpu", has_aux=True)
        return mesh, (*step(shard_batch(seed_batch, mesh)), step.stats)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(sharded)
        unsharded = batched_rollout(STEP, device="cpu", has_aux=True)(seed_batch)
        mesh, shard = fut.result()
    with mesh:
        yield mesh, unsharded, shard


def test_mesh_has_two_workers(runs):
    mesh = runs[0]
    assert len(mesh) == 2 and mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.start_seconds > 0


def test_shard_batch_places_on_mesh(runs, seed_batch):
    mesh = runs[0]
    sharded = shard_batch(seed_batch, mesh)
    assert sharded.lanes == [range(0, 4), range(4, 8)] and sharded.mesh is mesh
    for chunk, lanes in zip(sharded.chunks, sharded.lanes):
        for x, full in zip(chunk, seed_batch):
            assert x.shape == (4,) and x.device.type == "cpu"
            assert torch.equal(x, full[lanes.start:lanes.stop])
    with pytest.raises(ValueError, match="7 lanes do not split evenly"):
        shard_batch(tuple(x[:7] for x in seed_batch), mesh)


def test_sharded_value_and_grad_matches_unsharded(runs):
    _, (ref, ref_aux), (out, aux, stats) = runs
    assert set(out) == set(ref)
    for key in ref:
        assert out[key].shape[0] == 8 and out[key].device.type == "cpu" and not out[key].requires_grad, key
        assert torch.equal(out[key], ref[key]), key
    assert bool(ref["bounced"].all())  # every lane has touched the floor
    # each worker reports its chunk: lanes, its own host reads, no kernel launch on the CPU
    assert [s["lanes"] for s in stats] == [range(0, 4), range(4, 8)]
    assert all(s["device"] == "cpu" and s["seconds"] > 0 and not any(s["launches"].values()) for s in stats)
    assert len(aux) == 2 and len(ref_aux) == 1
    for a in (*aux, *ref_aux):
        assert a.host_reads["substep"] > 0 and a.stages["replay_lcp"] > 0
        assert a.host_syncs == sum(a.host_reads.values())


def test_sharded_loss_reduction_sum(runs):
    """The counterpart of JAX's psum-reduced loss: the sum of the gathered
    lanes in lane order equals the unsharded sum exactly."""
    _, (ref, _), (out, _, _) = runs
    assert float(torch.sum(out["loss"])) == float(torch.sum(ref["loss"]))


def _jax_unsharded():
    from diffsdfsim_tpu.parallel.sharding import batched_rollout as jax_batched_rollout

    rads, drops = ss.seeds("cpu")
    return jax_batched_rollout(jax.value_and_grad(ss.jax_loss("cpu")))((jnp.asarray(rads), jnp.asarray(drops)))


def test_unsharded_matches_jax(runs):
    _, (ref, _), _ = runs
    vals, (g_rad, g_drop) = _from_jax.keyed("unsharded", _jax_unsharded)
    np.testing.assert_allclose(ref["loss"].numpy(), vals, rtol=RTOL_JAX, atol=0)
    np.testing.assert_allclose(ref["d_rad"].numpy(), g_rad, rtol=RTOL_JAX, atol=0)
    np.testing.assert_allclose(ref["d_drop"].numpy(), g_drop, rtol=RTOL_JAX, atol=0)


def test_worker_exception_reaches_caller(runs, seed_batch):
    """A worker's exception raises in the caller with its traceback; the
    mesh then serves the next call (a function from the standard library,
    unpickled in the workers)."""
    mesh = runs[0]
    with pytest.raises(WorkerError, match=r"(?s)worker 0 on cpu failed \(and workers \[1\]\).*KeyError: 'nosuch'"):
        batched_rollout(functools.partial(ss.seed_step, "nosuch"), mesh, device="cpu")(seed_batch)
    out = batched_rollout(operator.itemgetter(0), mesh, device="cpu")(seed_batch)
    assert torch.equal(out, seed_batch[0])


def test_no_card_without_cpu_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default mesh and step run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched_rollout(STEP)


def test_worker_death_fails_the_call(runs, seed_batch):
    """A worker that exits during a call raises in the caller and closes the
    mesh. (It takes the module's mesh down: the file's last test.)"""
    mesh = runs[0]
    with pytest.raises(WorkerError, match="exited with code 1"):
        batched_rollout(sys.exit, mesh, device="cpu")(seed_batch)
    with pytest.raises(RuntimeError, match="the mesh is closed"):
        batched_rollout(operator.itemgetter(0), mesh, device="cpu")(seed_batch)
