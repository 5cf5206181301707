"""Port parity, the solver fallback (``ops/qp.escalated_resolve``,
``pdipm_solve_checked``; ``SimConfig.solver_fallback``) and
post-stabilization on the lane axis (``physics/batched.py``), float64 on
the CPU, against the JAX package's results in
``tests/golden/fallback_f64.npz`` (``gen_torch_fallback_golden.py``) and
against the port's single path.

- ``pdipm_solve_checked`` on ``tests/test_qp.py``'s under-iterated LCP
  (JAX's draws): the same fallback decision, the solution within 1e-10.
- ``escalated_resolve`` on a batch of bench contact LCPs solved with one
  iteration: one host read, and the re-solve equal to a fresh solve of
  the whole batch at ``solver_fallback_iters`` (bitwise on the CPU).
- The bench world with ``solver_max_iter=2, solver_fallback=True``, 20
  frames, at radius 0.5 and 0.58, single and as a 2-lane sweep: identical
  decisions and the bench's tolerances against JAX (height 1e-6,
  vertical velocity 1e-5, every component 5e-2: touchdown ties, ROADMAP
  queue 3, item 1); one fallback read per probe solve with a contact and
  one re-solve of the whole batch per triggering stage; each lane
  within 1e-12 of the single path.
- ``tests/test_batched.py``'s sideways sphere with ``post_stab=True`` at
  three radii, 10 frames: the single path against JAX within 1e-8, the
  sweep's lanes (one batched solve of every lane's post-stabilization
  LCP) against the single path within 1e-10.
"""

import os

import numpy as np
import pytest
import torch

from diffsdfsim_torch.config import SimConfig
from diffsdfsim_torch.ops import qp as tqp
from diffsdfsim_torch.physics import (BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world,
                                      make_world_batched, rollout_batched, trajectory_lanes_first)
from diffsdfsim_torch.physics import engine as teng
from diffsdfsim_torch.physics.world import rollout
from torch_jax_bridge import BENCH_CFG, one_torch_thread, torch_bench_world  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "fallback_f64.npz")
FB_CFG = dict(BENCH_CFG, solver_max_iter=2, solver_fallback=True)
PS_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=1, max_substeps=4, max_bisect=4,
              post_stab=True)
DECISIONS = ("valid", "n_halvings", "bisect_failed", "truncated")
ATOL_Y, ATOL_VY, ATOL_ALL = 1e-6, 1e-5, 5e-2


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("it", [1, 20])
def test_pdipm_solve_checked_matches_jax(golden, it):
    args = [_t(golden[f"qp/{k}"]) for k in "Q p G h A b F".split()]
    sol, res, bad = tqp.pdipm_solve_checked(*args, max_iter=it, eps=1e-12, fallback_iters=25, fallback_thresh=1e-6)
    assert bool(bad) == bool(golden[f"qp/it{it}/fell_back"]) == (it == 1)
    for name, x in zip("xyzs", sol):
        np.testing.assert_allclose(x.numpy(), golden[f"qp/it{it}/{name}"], rtol=0, atol=1e-10)
    assert float(res.max()) < 1e-6


def test_escalated_resolve_resolves_the_whole_batch():
    spec, state = torch_bench_world(drop=0.5 + 5e-4, v_sphere=[0.2, -0.1, 0.05, 0.3, -3.0, 0.1])
    args, structure = teng.dump_contact_lcp(spec.bodies, spec.joints, spec.forces, state, state.contacts, 1 / 30,
                                            spec.cfg)
    B = 3
    args = tuple(a.expand((B,) + a.shape[1:]).clone() for a in args)
    args[1][1:] *= torch.tensor([[0.5], [0.25]], dtype=torch.float64)  # three different problems
    invQ = tqp.blockdiag_inv3(args[0])
    rough = tqp.pdipm_solve_raw(*args, 1, 1e-12, 3, structure)
    reads = []

    def read(x):
        reads.append(bool(x))
        return reads[-1]

    out = tqp.escalated_resolve(*args, invQ, rough, iters_hi=30, eps=1e-12, thresh=1e-3, structure=structure,
                                read=read)
    assert reads == [True]
    fresh = tqp.pdipm_solve_raw(*args, 30, 1e-12, 6, structure)
    for a, b in zip(out, fresh):
        assert torch.equal(a, b)
    assert float(tqp.lcp_residuals(*args, out).max()) < 1e-8
    again = tqp.escalated_resolve(*args, invQ, out, iters_hi=30, eps=1e-12, thresh=1e-3, structure=structure,
                                  read=read)
    assert reads == [True, False] and again is out


def _bench(rad, cfg_kw, floor_subdiv=3, sphere_subdiv=2, v_side=0.0):
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=floor_subdiv, fric_coeff=0.25, device="cpu")
    sphere = make_body(SphereShape(rad), subdiv=sphere_subdiv, fric_coeff=0.25, device="cpu")
    vels = np.zeros((2, 6))
    vels[1, 3] = v_side
    return make_world([floor, sphere], [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, 1.2, 0.0]], vels,
                      joints=(TotalConstraint3D(body1=0),), forces=((), (Gravity3D(10.0),)),
                      cfg=SimConfig(**cfg_kw), device="cpu")


def _hold_bench(traj, golden, key):
    for k in DECISIONS:
        assert np.array_equal(traj[k], golden[f"{key}/{k}"]), f"{key}: {k} differs from JAX's"
    pos, v = traj["pos"][..., 1, :], traj["v"][..., 1, :]
    gpos, gv = golden[f"{key}/pos"][..., 1, :], golden[f"{key}/v"][..., 1, :]
    assert np.abs(pos[..., 1] - gpos[..., 1]).max() < ATOL_Y
    assert np.abs(v[..., 4] - gv[..., 4]).max() < ATOL_VY
    assert np.abs(pos - gpos).max() < ATOL_ALL and np.abs(v - gv).max() < ATOL_ALL


def _np(traj):
    return {k: x.detach().numpy() for k, x in traj._asdict().items()}


@pytest.fixture(scope="module")
def fallback_singles():
    out = {}
    for rad in (0.5, 0.58):
        spec, state = _bench(torch.tensor(rad, dtype=torch.float64), FB_CFG)
        _, traj = rollout(spec, state, 20)
        out[rad] = (spec, _np(traj))
    return out


@pytest.mark.parametrize("rad", [0.5, 0.58])
def test_bench_fallback_matches_jax(golden, fallback_singles, rad):
    spec, traj = fallback_singles[rad]
    _hold_bench(traj, golden, f"fb{rad}")
    # one read per probe solve with a contact, and some re-solves
    assert spec.host_reads["fallback"] >= spec.stages["resolve"] > 0


def test_bench_fallback_lanes(golden, fallback_singles):
    rads = torch.tensor([0.5, 0.58], dtype=torch.float64)
    spec, bodies_b, state_b = make_world_batched(lambda r: _bench(r, FB_CFG), rads)
    _, traj = rollout_batched(spec, bodies_b, state_b, 20)
    lanes = _np(trajectory_lanes_first(traj))
    # one read per probe stage that solves the LCP, one re-solve of the
    # whole batch per stage whose residuals trigger it
    assert spec.host_reads["fallback"] == spec.stages["lcp"] >= spec.stages["resolve"] > 0
    for i, rad in enumerate((0.5, 0.58)):
        lane = {k: x[i] for k, x in lanes.items()}
        _hold_bench(lane, golden, f"fb{rad}")
        single = fallback_singles[rad][1]
        for k in DECISIONS:
            assert np.array_equal(lane[k], single[k])
        np.testing.assert_allclose(lane["pos"], single["pos"], rtol=0, atol=1e-12)


def test_post_stab_lanes_match_single_and_jax(golden):
    rads = (0.45, 0.6, 0.8)
    kw = dict(floor_subdiv=2, sphere_subdiv=1, v_side=2.0)
    spec, bodies_b, state_b = make_world_batched(lambda r: _bench(r, PS_CFG, **kw),
                                                 torch.tensor(rads, dtype=torch.float64))
    _, traj = rollout_batched(spec, bodies_b, state_b, 10)
    lanes = _np(trajectory_lanes_first(traj))
    assert spec.stages["post_stab_lcp"] > 0 and spec.host_reads["post_stab"] == spec.stages["substep"]
    for i, rad in enumerate(rads):
        s_spec, s_state = _bench(torch.tensor(rad, dtype=torch.float64), PS_CFG, **kw)
        _, s_traj = rollout(s_spec, s_state, 10)
        single = _np(s_traj)
        for k in DECISIONS:
            assert np.array_equal(single[k], golden[f"ps{rad}/{k}"]), f"ps{rad}: {k} differs from JAX's"
            assert np.array_equal(lanes[k][i], single[k])
        for k in ("pos", "quat", "v"):
            np.testing.assert_allclose(single[k], golden[f"ps{rad}/{k}"], rtol=0, atol=1e-8)
            np.testing.assert_allclose(lanes[k][i], single[k], rtol=0, atol=1e-10)
