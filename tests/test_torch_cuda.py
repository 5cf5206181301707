"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a machine without an NVIDIA GPU every test here skips.
Whether a card is present is decided inside the ``cuda`` fixture, never
while the module is imported. This file imports no JAX, so it also runs
where JAX is not installed (tests/conftest.py imports it, hence
``--noconftest``). Run on the card with

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are the main path's: the bench scene's LCPs (nz 12, neq 6, k 4,
fd 8) at D = 3 and 6 rungs and a 576-problem seed sweep (K1), 1, 6 and 576
problems (K2), and the shape-space scene's k = 8 contact buffer (K1 at 4
rungs, K2 at 1 problem), optim_pointcloud's fd = 4 (K1 at 3 rungs, K2 at 6
problems; K2 also on the sysid friction fit's taped replays, where the
friction cones are tight), optim_sphere's room (nz 18, neq 12, k 8: K1
at 3 and 150 problems, K2 at 1 and 50, the runtime-sized instantiation);
a latent lane body's query (one K4 launch for all lanes); K1's solver
fallback relaunch; both bench
directed pairs (768-face floor,
320-face sphere) at three rung poses, a 3072-face floor (K3 on a cluster
per pose) and a 20,480-face sphere (past K3's one-face-per-thread cap);
K4 at the reference's width (N to 20,000; 12,288 is a 128 x 96 render's
query) and at IGR's 512-wide shape-space decoder;
K5's fused grid query at 33^3, 64^3 and 128^3; float64. Tolerances: PDIPM x within
1e-8 (Gauss-Jordan vs Cholesky rounding), KKT residuals no worse than 10x
the plain version's; FW search outputs within 1e-9 and masks equal; the
backward KKT solve within 1e-9 relative, of the plain version and of the
plain version of its algorithm ``kkt_grad_reduced``.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def _lcps(B, device, k=4):
    return _chip_smoke().physics_lcps(B, seed=B, device=device, dtype=torch.float64, k=k)


@pytest.mark.parametrize("k,B", [(4, 3), (4, 6), (4, 576), (8, 4)])
def test_pdipm_kernel_matches_plain(cuda, k, B):
    from diffsdfsim_torch.ops.qp import lcp_residuals, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import pdipm_fric

    Q, p, G, h, A, b, F, invQ = _lcps(B, cuda, k)
    args = (Q, p, G, h, A, b, F)
    before = pdipm_fric.launches
    sol_k = pdipm_fric(*args, invQ, 10, 1e-12, 3, ("fric", k, 8))
    torch.cuda.synchronize()
    assert pdipm_fric.launches == before + 1
    sol_p = pdipm_solve_raw(*args, 10, 1e-12, 3, ("fric", k, 8))
    assert float((sol_k[0] - sol_p[0]).abs().max()) <= 1e-8
    assert bool(torch.all(lcp_residuals(*args, sol_k) <= 10 * lcp_residuals(*args, sol_p) + 1e-10))


@pytest.mark.parametrize("B", [3, 16])
def test_pdipm_kernel_fallback_relaunch(cuda, B):
    """The solver fallback on the card (``ops/qp.escalated_resolve``): bench
    LCPs under-solved by K1 at one iteration trigger one relaunch of K1 on
    the whole batch at 30 iterations (stall limit 6), equal to the plain
    fallback (a fresh plain solve at 30) within 1e-10; a converged batch
    triggers none."""
    from diffsdfsim_torch.ops.qp import escalated_resolve, lcp_residuals, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import pdipm_fric

    Q, p, G, h, A, b, F, invQ = _lcps(B, cuda)
    args, structure = (Q, p, G, h, A, b, F), ("fric", 4, 8)
    rough = pdipm_fric(*args, invQ, 1, 1e-12, 3, structure)
    before = pdipm_fric.launches
    sol = escalated_resolve(*args, invQ, rough, iters_hi=30, eps=1e-12, thresh=1e-3, structure=structure, read=bool)
    torch.cuda.synchronize()
    assert pdipm_fric.launches == before + 1
    plain = pdipm_solve_raw(*args, 30, 1e-12, 6, structure)
    assert float((sol[0] - plain[0]).abs().max()) <= 1e-10
    assert float(lcp_residuals(*args, sol).max()) < 1e-8
    assert escalated_resolve(*args, invQ, sol, iters_hi=30, eps=1e-12, thresh=1e-3, structure=structure,
                             read=bool) is sol
    assert pdipm_fric.launches == before + 1


@pytest.mark.parametrize("B", [3, 150])
def test_pdipm_kernel_room_size(cuda, B):
    """K1 on optim_sphere's room (a floor and a wall, each fixed, and the
    sphere at both: nz 18, neq 12, k 8, fd 8, m2 52, past the compile-time
    instantiations) at the single path's 3 rungs and the 50-seed sweep's
    150 problems: the runtime-sized instantiation, x within 1e-8 of the
    plain version, KKT residuals no worse than 10x its."""
    from diffsdfsim_torch.ops.qp import lcp_residuals, pdipm_solve_raw
    from diffsdfsim_torch.ops.qp_cuda import pdipm_fric

    Q, p, G, h, A, b, F, invQ = _chip_smoke().room_lcps(B, seed=B, device=cuda, dtype=torch.float64)
    assert not pdipm_fric.info(torch.float64, 18, 12, 80, 8, 8)["static_m2"]
    args = (Q, p, G, h, A, b, F)
    before = pdipm_fric.launches
    sol_k = pdipm_fric(*args, invQ, 10, 1e-12, 3, ("fric", 8, 8))
    torch.cuda.synchronize()
    assert pdipm_fric.launches == before + 1
    sol_p = pdipm_solve_raw(*args, 10, 1e-12, 3, ("fric", 8, 8))
    assert float((sol_k[0] - sol_p[0]).abs().max()) <= 1e-8
    assert bool(torch.all(lcp_residuals(*args, sol_k) <= 10 * lcp_residuals(*args, sol_p) + 1e-10))


@pytest.mark.parametrize("direction", ["sphere->floor", "floor->sphere"])
def test_fw_kernel_matches_plain(cuda, direction):
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.physics import BoxShape, SphereShape, make_body
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    cfg = SimConfig(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, tol=1e-8)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device=cuda)
    sphere = make_body(SphereShape(torch.tensor(0.5)), subdiv=2, device=cuda)
    eye = torch.tensor([[1.0, 0, 0, 0]] * 3, dtype=torch.float64, device=cuda)
    ps = torch.tensor([[0.0, 0.5 + 1e-5, 0.0], [0.0, 0.5 - 1e-4, 0.0], [0.01, 0.5 - 1e-3, 0.0]],
                      dtype=torch.float64, device=cuda)
    fp = torch.tensor([[0.0, -0.5, 0.0]] * 3, dtype=torch.float64, device=cuda)
    if direction == "sphere->floor":
        args = (sphere, eye, ps, floor, eye, fp)
    else:
        args = (floor, eye, fp, sphere, eye, ps)
    before = fw_search_pair.launches
    out_k = fw_search_pair(*args, cfg)
    torch.cuda.synchronize()
    assert fw_search_pair.launches == before + 1
    out_p = search_pair_raw_plain(*args, cfg)
    assert torch.equal(out_k.cmask, out_p.cmask) and torch.equal(out_k.cand, out_p.cand)
    for name in ("abc", "n_ng", "p1_ng", "x1", "pen"):
        a, b = getattr(out_k, name), getattr(out_p, name)
        assert float((a - b).abs().max()) <= 1e-9, name
    fin = torch.isfinite(out_p.max_pen)
    assert torch.equal(torch.isfinite(out_k.max_pen), fin)
    if bool(fin.any()):
        assert float((out_k.max_pen - out_p.max_pen)[fin].abs().max()) <= 1e-9


def test_fw_kernel_cluster_path(cuda):
    """A 3072-face floor: each pose spreads over a cluster of 16 CTAs (a
    non-portable cluster size) with one vote word in CTA 0, a pose tensor
    expanded from one row (stride 0); held against the plain version as
    above."""
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.physics import BoxShape, SphereShape, make_body
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    cfg = SimConfig(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, tol=1e-8)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=4, device=cuda)
    sphere = make_body(SphereShape(torch.tensor(0.5)), subdiv=2, device=cuda)
    q = torch.tensor([[1.0, 0, 0, 0], [0.99, 0.1, 0.05, 0.0]], dtype=torch.float64, device=cuda)
    q = q / q.norm(dim=-1, keepdim=True)
    ps = torch.tensor([[0.0, 0.5 + 1e-6, 0.0], [0.01, 0.5 - 1e-3, 0.02]], dtype=torch.float64, device=cuda)
    fp = torch.tensor([0.0, -0.5, 0.0], dtype=torch.float64, device=cuda).expand(2, 3)
    out_k = fw_search_pair(floor, q[:1].expand(2, 4), fp, sphere, q, ps, cfg)
    out_p = search_pair_raw_plain(floor, q[:1].expand(2, 4), fp, sphere, q, ps, cfg)
    assert torch.equal(out_k.cmask, out_p.cmask) and torch.equal(out_k.cand, out_p.cand)
    for name in ("abc", "n_ng", "p1_ng", "x1", "pen", "max_pen"):
        a, b = getattr(out_k, name), getattr(out_p, name)
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin), name
        if bool(fin.any()):
            assert float((a - b)[fin].abs().max()) <= 1e-9, name


@pytest.mark.parametrize("R", [3, 9])
@pytest.mark.parametrize("case", ["sphere20480->floor touch", "sphere20480->sphere gap"])
def test_fw_kernel_past_the_face_cap(cuda, case, R):
    """The sphere at subdiv 5 (20,480 faces: 16 CTAs of 512 threads per
    pose, each thread looping over 2-3 faces) touching the floor and tilted
    0-1 cm above the bench sphere, in one launch, held against the plain
    version as test_fw_kernel_matches_plain holds the bench pairs."""
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    cfg = SimConfig(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, tol=1e-8)
    _, bd1, bd2, q1, p1, q2, p2 = next(c for c in _chip_smoke().k3_big_cases(cuda, torch.float64, R)
                                       if c[0].startswith(case))
    before = fw_search_pair.launches
    out_k = fw_search_pair(bd1, q1, p1, bd2, q2, p2, cfg)
    torch.cuda.synchronize()
    assert fw_search_pair.launches == before + 1 and bd1.faces_t.shape[0] == 20480
    out_p = search_pair_raw_plain(bd1, q1, p1, bd2, q2, p2, cfg)
    assert torch.equal(out_k.cmask, out_p.cmask) and torch.equal(out_k.cand, out_p.cand)
    assert bool(out_k.cmask.any())
    for name in ("abc", "n_ng", "p1_ng", "x1", "pen"):
        a, b = getattr(out_k, name), getattr(out_p, name)
        assert float((a - b).abs().max()) <= 1e-9, name
    fin = torch.isfinite(out_p.max_pen)
    assert torch.equal(torch.isfinite(out_k.max_pen), fin)
    if bool(fin.any()):
        assert float((out_k.max_pen - out_p.max_pen)[fin].abs().max()) <= 1e-9


@pytest.mark.parametrize("B", [16, 64])
@pytest.mark.parametrize("direction", ["sphere->floor", "floor->sphere"])
def test_fw_kernel_lane_bodies(cuda, direction, B):
    """A seed sweep's probe stage: a sphere of another radius in each of B
    lanes, 3 rung poses per lane, one launch, held against the plain version
    on the same per-lane bodies as test_fw_kernel_matches_plain holds the
    bench pairs."""
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    cfg = SimConfig(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, tol=1e-8)
    _, bd1, bd2, q1, p1, q2, p2 = next(c for c in _chip_smoke().k3_lane_cases(cuda, torch.float64, B, 3)
                                       if c[0].startswith(f"lanes {direction}"))
    before = fw_search_pair.launches
    out_k = fw_search_pair(bd1, q1, p1, bd2, q2, p2, cfg)
    torch.cuda.synchronize()
    assert fw_search_pair.launches == before + 1 and max(bd1.lanes, bd2.lanes) == B
    out_p = search_pair_raw_plain(bd1, q1, p1, bd2, q2, p2, cfg)
    assert torch.equal(out_k.cmask, out_p.cmask) and torch.equal(out_k.cand, out_p.cand)
    for name in ("abc", "n_ng", "p1_ng", "x1", "pen"):
        a, b = getattr(out_k, name), getattr(out_p, name)
        assert float((a - b).abs().max()) <= 1e-9, name
    fin = torch.isfinite(out_p.max_pen)
    assert torch.equal(torch.isfinite(out_k.max_pen), fin)
    if bool(fin.any()):
        assert float((out_k.max_pen - out_p.max_pen)[fin].abs().max()) <= 1e-9


@pytest.mark.parametrize("direction", ["cube->floor", "floor->cube"])
@pytest.mark.parametrize("D", [3, 6])
def test_fw_kernel_sysid_lane_boxes(cuda, direction, D):
    """optim_sysid's friction sweep at a probe stage: the floor and the cube
    both lane bodies (16 lanes, each its own sizes), box against box, one
    launch; each lane bitwise its own launch, max_pen within 1e-6 of the
    plain search (the per-face fields tie on the boxes' template vertices)."""
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.ops.fw_cuda import fw_search_pair
    from diffsdfsim_torch.physics.contacts import search_pair_raw_plain

    cs = _chip_smoke()
    cfg = SimConfig(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, tol=1e-8)
    _, bd1, bd2, q1, p1, q2, p2 = next(c for c in cs.k3_sysid_cases(cuda, torch.float64, 16, D)
                                       if direction in c[0])
    before = fw_search_pair.launches
    out_k = fw_search_pair(bd1, q1, p1, bd2, q2, p2, cfg)
    torch.cuda.synchronize()
    assert fw_search_pair.launches == before + 1 and bd1.lanes == bd2.lanes == 16
    assert cs.k3_lane_mismatches(bd1, q1, p1, bd2, q2, p2, cfg, out_k) == []
    out_p = search_pair_raw_plain(bd1, q1, p1, bd2, q2, p2, cfg)
    fin = torch.isfinite(out_p.max_pen)
    assert torch.equal(torch.isfinite(out_k.max_pen), fin)
    if bool(fin.any()):
        assert float((out_k.max_pen - out_p.max_pen)[fin].abs().max()) <= 1e-6


def _kkt_inputs(cuda, k, B):
    """The backward's inputs at the plain solution of B bench LCPs with k
    contact slots (k = "room": optim_sphere's room, 8 slots): (Q^-1, G, A,
    F, d, rx)."""
    import numpy as np

    from diffsdfsim_torch.ops.qp import blockdiag_inv3, pdipm_solve_raw

    Q, p, G, h, A, b, F, _ = _chip_smoke().case_lcps(k, B, seed=B, device=cuda, dtype=torch.float64)
    k = G.shape[-2] // 10
    x, y, z, s = pdipm_solve_raw(Q, p, G, h, A, b, F, 10, 1e-12, 3, ("fric", k, 8))
    d = torch.clamp(torch.clamp(z, min=1e-8) / torch.clamp(s, min=1e-8), max=1e12)
    rx = torch.tensor(np.random.default_rng(B).normal(size=tuple(x.shape)), dtype=torch.float64, device=cuda)
    return blockdiag_inv3(Q), G, A, F, d, rx


@pytest.mark.parametrize("k,B", [(4, 1), (4, 6), (4, 576), (8, 1)])
def test_kkt_grad_kernel_matches_plain(cuda, k, B):
    """K2 against the plain backward KKT solve on the same (Q^-1, G, A, F,
    d, rx): 1e-9 relative to the largest entry."""
    from diffsdfsim_torch.ops.qp import kkt_grad_plain
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    ins = _kkt_inputs(cuda, k, B)
    before = kkt_grad_fric.launches
    out_k = kkt_grad_fric(*ins, ("fric", k, 8))
    torch.cuda.synchronize()
    assert kkt_grad_fric.launches == before + 1
    for a, r in zip(out_k, kkt_grad_plain(*ins, ("fric", k, 8))):
        assert float((a - r).abs().max()) <= 1e-9 * float(r.abs().max())


@pytest.mark.parametrize("k", [4, "room"])
def test_kkt_grad_kernel_lanes_bitwise(cuda, k):
    """K2 over a batch of 6 problems: each problem's (dx, dlam, dnu) bitwise
    its own launch's (one block per problem), as a seed sweep's taped
    replay relies on."""
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    ins = _kkt_inputs(cuda, k, 6)
    kk = ins[1].shape[-2] // 10
    out = kkt_grad_fric(*ins, ("fric", kk, 8))
    for i in range(6):
        one = kkt_grad_fric(*(t[i : i + 1] for t in ins), ("fric", kk, 8))
        assert all(torch.equal(a, b[i : i + 1]) for a, b in zip(one, out))


@pytest.mark.parametrize("B", [1, 50])
def test_kkt_grad_kernel_room_size(cuda, B):
    """K2 on optim_sphere's room LCPs (m2 52, the runtime-sized
    instantiation) at one replay and a 50-seed sweep's, against the plain
    version within chip_smoke.RTOL_K2_ROOM relative (the plain version's
    own error: the reduced block's condition number reaches 2.1e10 there;
    see that constant) and against the exact solution of the full KKT
    system within chip_smoke.RTOL_K2_EXACT (the kernel's refinement)."""
    from diffsdfsim_torch.ops.qp import kkt_grad_plain
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    cs = _chip_smoke()
    iq, G, A, F, d, rx = ins = _kkt_inputs(cuda, "room", B)
    assert not kkt_grad_fric.info(torch.float64, 18, 12, 80, 8, 8)["static_m2"]
    before = kkt_grad_fric.launches
    out_k = kkt_grad_fric(*ins, ("fric", 8, 8))
    torch.cuda.synchronize()
    assert kkt_grad_fric.launches == before + 1
    Q = cs.case_lcps("room", B, seed=B, device=cuda, dtype=torch.float64)[0]  # the inputs' own Q
    ex = cs.kkt_exact(*cs.kkt_system(Q, G, A, F, d, rx))
    ex = (ex[:, :18], ex[:, 18:98], ex[:, 98:])
    rel = lambda outs, refs: max(float((a - r).abs().max()) / float(r.abs().max()) for a, r in zip(outs, refs))  # noqa: E731
    assert rel(out_k, ex) <= cs.RTOL_K2_EXACT
    assert rel(out_k, kkt_grad_plain(*ins, ("fric", 8, 8))) <= cs.RTOL_K2_ROOM


@pytest.mark.parametrize("k", [4, 8])
def test_kkt_grad_kernel_matches_fric_reduced_solve(cuda, k):
    """K2's (dx, dlam, dnu) against the plain version of its algorithm on
    the same inputs (``kkt_grad_reduced``: the reduced Schur solve,
    ``fric_reduced_solve``, and two refinement steps): 1e-9 relative to the
    largest entry."""
    from diffsdfsim_torch.ops.qp import kkt_grad_reduced
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    ins = _kkt_inputs(cuda, k, 6)
    out = kkt_grad_fric(*ins, ("fric", k, 8))
    for a, r in zip(out, kkt_grad_reduced(*ins, ("fric", k, 8))):
        assert float((a - r).abs().max()) <= 1e-9 * float(r.abs().max())


def test_fric_kernels_at_the_pointcloud_shape(cuda):
    """optim_pointcloud's LCPs (nz 12, neq 6, k 4, fd 4: the runtime-sized
    instantiation): K1 at a probe stage's 3 rungs, x within 1e-8 of the
    plain version and KKT residuals no worse than 10x its; K2 at 6 problems
    within 1e-9 relative of the plain version and of ``kkt_grad_reduced``,
    and within chip_smoke.RTOL_K2_EXACT of the KKT system's exact solution."""
    import numpy as np

    from diffsdfsim_torch.ops.qp import (blockdiag_inv3, kkt_grad_plain, kkt_grad_reduced, lcp_residuals,
                                         pdipm_solve_raw)
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric, pdipm_fric

    cs = _chip_smoke()
    st = ("fric", 4, 4)
    assert not pdipm_fric.info(torch.float64, 12, 6, 24, 4, 4)["static_m2"]
    Q, p, G, h, A, b, F, invQ = cs.case_lcps("pc", 3, seed=3, device=cuda, dtype=torch.float64)
    args = (Q, p, G, h, A, b, F)
    sol_k = pdipm_fric(*args, invQ, 10, 1e-12, 3, st)
    sol_p = pdipm_solve_raw(*args, 10, 1e-12, 3, st)
    assert float((sol_k[0] - sol_p[0]).abs().max()) <= 1e-8
    assert bool(torch.all(lcp_residuals(*args, sol_k) <= 10 * lcp_residuals(*args, sol_p) + 1e-10))
    Q, p, G, h, A, b, F, _ = cs.case_lcps("pc", 6, seed=6, device=cuda, dtype=torch.float64)
    x, y, z, s = pdipm_solve_raw(Q, p, G, h, A, b, F, 10, 1e-12, 3, st)
    d = torch.clamp(torch.clamp(z, min=1e-8) / torch.clamp(s, min=1e-8), max=1e12)
    rx = torch.tensor(np.random.default_rng(6).normal(size=tuple(x.shape)), dtype=torch.float64, device=cuda)
    ins = (blockdiag_inv3(Q), G, A, F, d, rx)
    out_k = kkt_grad_fric(*ins, st)
    rel = lambda outs, refs: max(float((a - r).abs().max()) / float(r.abs().max()) for a, r in zip(outs, refs))  # noqa: E731
    assert rel(out_k, kkt_grad_plain(*ins, st)) <= 1e-9 and rel(out_k, kkt_grad_reduced(*ins, st)) <= 1e-9
    ex = cs.kkt_exact(*cs.kkt_system(Q, G, A, F, d, rx))
    assert rel(out_k, (ex[:, :12], ex[:, 12:36], ex[:, 36:])) <= cs.RTOL_K2_EXACT


def test_kkt_grad_kernel_tight_cones(cuda):
    """K2 on the taped replays of optim_sysid's friction fit (the cube pushed
    over the floor, 15 frames; its contacts stick, so the friction cones'
    d reach ~3e8): dlam within chip_smoke.RTOL_K2_REPLAY_EXACT of the KKT
    systems' exact solution, and the cone rows (dh, dG, dF) and d loss /
    d mu within chip_smoke.RTOL_K2_CONE of the plain KKT solve
    (chip_smoke.check_k2_replays)."""
    from diffsdfsim_torch.experiments import optim_sysid as osy
    from diffsdfsim_torch.experiments.losses import trajectory_loss
    from diffsdfsim_torch.ops import qp

    cs = _chip_smoke()
    c = dict(osy.DEFAULTS, param="friction", run_time=0.5)
    cfg = osy.build_cfg(c)
    with torch.no_grad():
        _, tgt = osy.simulate(torch.tensor(0.45, dtype=torch.float64, device=cuda), c, cfg, cuda)
    th = torch.tensor(0.3, dtype=torch.float64, device=cuda, requires_grad=True)
    with cs.Calls(qp, "_lcp_bwd") as calls:
        torch.autograd.grad(trajectory_loss(osy.simulate(th, c, cfg, cuda)[1], tgt, body=1), th)
    assert len(calls.calls) > 0
    cs.check_k2_replays(calls.calls, "sysid friction, single path")


def test_bench_gradient_runs_through_k2(cuda):
    """d loss / d rad of the 20-frame bench rollout on CUDA launches K2 and
    matches the plain CPU gradient within 1e-8 relative."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    before = kkt_grad_fric.launches
    grads = []
    for device in ("cuda", "cpu"):
        loss, rad, _ = chip_smoke.bench_loss(device, 20)
        loss.backward()
        grads.append(float(rad.grad))
    assert kkt_grad_fric.launches > before
    assert abs(grads[0] - grads[1]) <= 1e-8 * abs(grads[1])


def _igr_net(cuda, dtype=torch.float64):
    import numpy as np

    from diffsdfsim_torch.models.igr import init_implicit_net

    return init_implicit_net(5, radius_init=0.55, generator=np.random.default_rng(1234), dtype=dtype).to(cuda)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n", [1, 100, 2304, 12288, 20000])
def test_igr_kernel_matches_plain(cuda, dtype, rtol, n):
    """K4 against implicit_net_apply at the reference's width ((128,)*8,
    skip at 4): relative to the largest value; 2304 points take 40 per
    cluster, 20000 several waves."""
    from diffsdfsim_torch.models.igr import implicit_net_apply
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp

    net = _igr_net(cuda, dtype)
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.rand((n, 5), generator=g, device=cuda, dtype=dtype) * 2 - 1
    before = igr_mlp.launches
    out = igr_mlp(net.params(), x)
    torch.cuda.synchronize()
    assert igr_mlp.launches == before + 1
    ref = implicit_net_apply(net.params(), x)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n", [7, 576, 2304])
def test_igr_kernel_wide_decoder(cuda, dtype, rtol, n):
    """K4 on IGR's shape-space decoder ((512,)*8, skip at 4, a 256-dim
    latent: d_in 259; each CTA of a cluster of 8 computes two 32-column
    slices, 16 points per cluster in float64) against implicit_net_apply,
    at the 128-wide case's tolerance."""
    import numpy as np

    from diffsdfsim_torch.models.igr import implicit_net_apply, init_implicit_net
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp

    net = init_implicit_net(259, (512,) * 8, (4,), radius_init=0.55, generator=np.random.default_rng(512),
                            dtype=dtype).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.rand((n, 259), generator=g, device=cuda, dtype=dtype) * 2 - 1
    x[:, :256] *= 0.3
    before = igr_mlp.launches
    out = igr_mlp(net.params(), x)
    torch.cuda.synchronize()
    assert igr_mlp.launches == before + 1
    ref = implicit_net_apply(net.params(), x)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())


def test_igr_kernel_backward_gradcheck(cuda):
    """The K4 Function's backward (the plain version's VJP) against finite
    differences of the kernel's forward, float64, a narrow net."""
    import numpy as np

    from diffsdfsim_torch.models.igr import init_implicit_net
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp

    net = init_implicit_net(5, (32,) * 4, (2,), radius_init=0.55, generator=np.random.default_rng(0)).to(cuda)
    x = (torch.rand((7, 5), dtype=torch.float64, device=cuda) * 2 - 1).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: igr_mlp(net.params(), t), (x,), eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("B", [2, 8])
def test_latent_lane_query_is_one_k4_launch(cuda, B):
    """A latent lane body's SDF query (B codes, the decoder shared, full
    width) under its ``torch.func.vmap``: exactly one K4 launch for the
    values of all lanes, bitwise each lane's own K4 call on its points; the
    backward to the codes (the plain vector-Jacobian product over the
    lanes' points at once, whose matrix products sum in another order than
    one lane's) within 1e-12 relative, the query's normals (the decoder's
    plain point gradient) within 1e-13 of each lane's."""
    import numpy as np

    from diffsdfsim_torch.ops.igr_cuda import igr_mlp
    from diffsdfsim_torch.physics import LatentShape, make_body
    from diffsdfsim_torch.physics.bodies import stack_lanes
    from diffsdfsim_torch.physics.shapes import query_sdfs

    net = _igr_net(cuda)
    codes = torch.tensor(np.random.default_rng(B).normal(size=(B, 2)) * 0.3, device=cuda)
    lane_codes = codes.clone().requires_grad_(True)
    bodies = [make_body(LatentShape(lane_codes[i], torch.tensor(1.0), net), subdiv=1, project_iters=16, device=cuda)
              for i in range(B)]
    lane = stack_lanes(bodies)
    assert lane.lanes == B and lane.shape.decoder is net
    pts = torch.rand((B, 96, 3), dtype=torch.float64, device=cuda, generator=torch.Generator(device=cuda).manual_seed(B))
    pts = pts * 2.2 - 1.1
    before = igr_mlp.launches
    sd, nrm = lane.query_sdfs(pts)
    torch.cuda.synchronize()
    assert igr_mlp.launches == before + 1
    (g,) = torch.autograd.grad(sd.sum(), lane_codes)
    for i in range(B):
        z = codes[i].clone().requires_grad_(True)
        one = LatentShape(z, torch.tensor(1.0, dtype=torch.float64, device=cuda), net)
        s1, n1 = query_sdfs(one, pts[i])
        (g1,) = torch.autograd.grad(s1.sum(), z)
        assert torch.equal(sd[i], s1.detach()), f"lane {i}: values"
        assert float((g[i] - g1).abs().max()) <= 1e-12 * float(g1.abs().max()), f"lane {i}: d sdf / d code"
        assert float((nrm[i] - n1).abs().max()) <= 1e-13


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("channels", [1, 3])
def test_grid_kernel_matches_plain(cuda, dtype, channels):
    """K5 against sdf.grid_interp bitwise (the same products in the same
    order, no FMA contraction), points in, on and outside the grid."""
    from diffsdfsim_torch.ops import sdf
    from diffsdfsim_torch.ops.grid_cuda import grid_interp

    g = torch.Generator(device=cuda).manual_seed(channels)
    shape = (channels, 33, 33, 33) if channels > 1 else (33, 33, 33)
    grid = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    inds = torch.rand((1000, 3), generator=g, device=cuda, dtype=dtype) * 36 - 2
    inds[:3] = torch.tensor([[32.0, 32.0, 32.0], [0.0, 0.0, 0.0], [32.0, 0.5, 31.999]], dtype=dtype)
    before = grid_interp.launches
    out = grid_interp(grid, inds)
    torch.cuda.synchronize()
    assert grid_interp.launches == before + 1
    assert torch.equal(out, sdf.grid_interp(grid, inds))


def _grid_query_inputs(cuda, res, dtype, n=2000):
    cs = _chip_smoke()
    grid = torch.tensor(cs.sphere_grid(res), dtype=dtype, device=cuda)
    scale = torch.tensor(0.75, dtype=dtype, device=cuda)
    pts = torch.tensor(cs.k5_query_points(res, 0.75, n, seed=res), dtype=dtype, device=cuda)
    return cs, grid, scale, pts


@pytest.mark.parametrize("grads", [True, False], ids=["value+gradient", "value"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("res", [33, 64, 128])
def test_grid_query_kernel_matches_plain(cuda, res, dtype, grads):
    """K5's fused query against its plain version (chip_smoke.k5_query_plain)
    on a sphere grid, points inside, on, just outside and outside the grid:
    every output bitwise (chip_smoke.K5_ULPS = 0: the kernel sums
    normalize's squares in the order torch's CUDA sum takes); a GridShape
    query through the public path is one launch."""
    from diffsdfsim_torch.ops.grid_cuda import grid_query_kernel
    from diffsdfsim_torch.physics import GridShape
    from diffsdfsim_torch.physics.shapes import query_sdfs

    cs, grid, scale, pts = _grid_query_inputs(cuda, res, dtype)
    outs = grid_query_kernel.run(pts, grid, scale, grad=grads, grad_in=grads, grad_raw=grads)
    errs, ok = cs.k5_query_errors(outs, cs.k5_query_plain(pts, grid, scale))
    assert ok, errs
    before = grid_query_kernel.launches
    got = query_sdfs(GridShape(grid=grid, scale_=scale), pts, return_grads=grads)
    torch.cuda.synchronize()
    assert grid_query_kernel.launches == before + 1
    assert torch.equal(got[0] if grads else got, outs[0])
    if grads:
        assert torch.equal(got[1], outs[1])


@pytest.mark.parametrize("output", ["value", "gradient", "both", "scale"])
def test_grid_query_kernel_vjp(cuda, output):
    """The fused query's vector-Jacobian products with respect to the points
    (and the scale) against autograd of the plain composition, float64: the
    value's is GridSdf's saved-gradient product, the gradient output's and
    the scale's the plain composition's own."""
    from diffsdfsim_torch.ops import grid_cuda, sdf

    cs, grid, scale, pts = _grid_query_inputs(cuda, 64, torch.float64, n=500)
    g = torch.Generator(device=cuda).manual_seed(5)
    cot_s = torch.randn(pts.shape[0], generator=g, device=cuda, dtype=torch.float64)
    cot_g = torch.randn(pts.shape, generator=g, device=cuda, dtype=torch.float64)
    grads = []
    for fn in (grid_cuda.grid_query, sdf.grid_query):
        p = pts.clone().requires_grad_(True)
        s = scale.clone().requires_grad_(output == "scale")
        sdfs, gr = fn(p, grid, s)
        loss = (sdfs * cot_s).sum() * (output != "gradient") + (gr * cot_g).sum() * (output != "value")
        grads.append(torch.autograd.grad(loss, [p, s] if output == "scale" else [p]))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1.0)


@pytest.mark.parametrize("shared", [False, True], ids=["lane grids", "shared grid"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grid_query_lanes_kernel_matches_plain_and_singles(cuda, dtype, shared):
    """K5's lane entry at 4 lanes of 2 poses each, a grid (or one shared
    grid) and a scale per lane: every output as k5_query_errors holds the
    single query against the plain version of each lane, and bitwise equal
    to one single launch per lane; a GridShape lane body's query under
    torch.func.vmap is one lane launch."""
    from diffsdfsim_torch.ops.grid_cuda import grid_query_kernel, grid_query_lanes_kernel
    from diffsdfsim_torch.physics import GridShape, make_body
    from diffsdfsim_torch.physics.bodies import stack_lanes
    from diffsdfsim_torch.physics.shapes import query_sdfs

    cs, grid, scale, _ = _grid_query_inputs(cuda, 33, dtype)
    L, M = 4, 600
    grids = torch.stack([grid * (1.0 + 0.05 * i) for i in range(L)])
    scales = scale * torch.linspace(0.9, 1.1, L, dtype=dtype, device=cuda)
    pts = torch.stack([torch.tensor(cs.k5_query_points(33, float(scales[i]), M, seed=i), dtype=dtype, device=cuda)
                       for i in range(L)])
    g = grids[0] if shared else grids
    outs = grid_query_lanes_kernel.run(pts, g, scales, True, True, True)
    for i in range(L):
        gi = g if shared else grids[i]
        errs, ok = cs.k5_query_errors([o[i] for o in outs], cs.k5_query_plain(pts[i], gi, scales[i]))
        assert ok, errs
        one = grid_query_kernel.run(pts[i], gi, scales[i], True, True, True)
        assert all(torch.equal(a[i], b) for a, b in zip(outs, one))
    bodies = [make_body(GridShape(grids[i], scales[i]), template="ico", subdiv=1, device=cuda, dtype=dtype)
              for i in range(2)]
    lane = stack_lanes(bodies)
    before, single = grid_query_lanes_kernel.launches, grid_query_kernel.launches
    sdfs, _ = lane.query_sdfs(pts[:2])
    torch.cuda.synchronize()
    assert (grid_query_lanes_kernel.launches, grid_query_kernel.launches) == (before + 1, single)
    assert all(torch.equal(sdfs[i], query_sdfs(bodies[i].shape, pts[i])[0]) for i in range(2))


def test_grid_query_lanes_vjp(cuda):
    """A lane body's query's vector-Jacobian products with respect to the
    points and each lane's scale against autograd of the plain composition
    mapped over the lanes, float64: a lane's d scale reaches that lane
    only."""
    from diffsdfsim_torch.ops import grid_cuda, sdf

    cs, grid, scale, pts = _grid_query_inputs(cuda, 64, torch.float64, n=300)
    grids = torch.stack([grid, grid * 1.1, grid * 0.9])
    pts = torch.stack([pts, pts * 0.9, pts * 1.1])
    g = torch.Generator(device=cuda).manual_seed(6)
    cot_s = torch.randn(pts.shape[:2], generator=g, device=cuda, dtype=torch.float64)
    cot_g = torch.randn(pts.shape, generator=g, device=cuda, dtype=torch.float64)
    grads = []
    for fn in (grid_cuda.grid_query, sdf.grid_query):
        p = pts.clone().requires_grad_(True)
        s = (scale * torch.tensor([1.0, 0.95, 1.05], dtype=torch.float64, device=cuda)).requires_grad_(True)
        sdfs, gr = torch.func.vmap(fn)(p, grids, s)
        loss = (sdfs * cot_s).sum() + (gr * cot_g).sum()
        grads.append(torch.autograd.grad(loss, [p, s]))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1.0)


def test_igr_kernel_refuses_weights_that_require_grad(cuda):
    """K4 differentiates with respect to x only: in grad mode a decoder
    whose weights require grad raises (no launch, rather than a result with
    no weight gradient); under no_grad it launches; the plain decoder
    (``implicit_net_apply``, what a trainer calls) gives the weights their
    gradient on the card."""
    import numpy as np

    from diffsdfsim_torch.models.igr import implicit_net_apply, init_implicit_net
    from diffsdfsim_torch.ops.igr_cuda import igr_mlp

    net = init_implicit_net(5, (32,) * 4, (2,), radius_init=0.55, generator=np.random.default_rng(0)).to(cuda)
    p = net.params()
    p = p._replace(weights=tuple(w.detach().clone().requires_grad_(True) for w in p.weights))
    x = torch.rand((9, 5), dtype=torch.float64, device=cuda) * 2 - 1
    before = igr_mlp.launches
    with pytest.raises(ValueError, match="require grad"):
        igr_mlp(p, x)
    assert igr_mlp.launches == before
    with torch.no_grad():
        igr_mlp(p, x)
    assert igr_mlp.launches == before + 1
    (g,) = torch.autograd.grad(implicit_net_apply(p, x).sum(), p.weights[0])
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kkt_grad_kernel_tight_cones(cuda, dtype):
    """K2 on the tight case (every contact's cone row at d = 3e8 in float64,
    at the float32 cap 1e5 in float32) against the KKT system's exact
    solution: float64 within 1e-9 relative; float32 (computed in float64)
    within 1e-4 and no farther than the plain float32 path."""
    from diffsdfsim_torch.ops.qp import kkt_grad_plain
    from diffsdfsim_torch.ops.qp_cuda import kkt_grad_fric

    cs = _chip_smoke()
    ins, structure, Q = cs.tight_k2_case(dtype, device=cuda)
    nz, nineq = Q.shape[-1], ins[1].shape[-2]
    kkt, rhs = cs.kkt_system(Q.double(), *(t.double() for t in ins[1:]))
    ex = cs.kkt_exact(kkt, rhs)
    ex = (ex[:, :nz], ex[:, nz : nz + nineq], ex[:, nz + nineq :])

    def rel(outs):
        return max(float((a.double() - r).abs().max()) / float(r.abs().max()) for a, r in zip(outs, ex))

    e_k = rel(kkt_grad_fric(*ins, structure))
    if dtype == torch.float64:
        assert e_k <= 1e-9
    else:
        assert e_k <= 1e-4 and e_k <= rel(kkt_grad_plain(*ins, structure))


def test_utility_entry_points_default_to_the_card(cuda, tmp_path):
    """``viz.sample_sdf_volume``, ``marching2d.grid_from_sdf_fn``,
    ``contour_2d`` on a numpy grid and ``checkpoint.load_state`` without
    ``like`` work on the card when no device is named; ``load_state`` with
    ``like`` follows the ``like`` tensors."""
    from diffsdfsim_torch.ops.marching2d import grid_from_sdf_fn
    from diffsdfsim_torch.physics2d import contour_2d
    from diffsdfsim_torch.utils import checkpoint, viz

    seen = []

    def sdf(p, r):
        seen.append(p.device.type)
        return torch.linalg.norm(p, dim=-1) - r

    assert viz.sample_sdf_volume(sdf, (0.5,), res=9).shape == (9, 9, 9) and seen == ["cuda"]
    g = grid_from_sdf_fn(lambda p: torch.linalg.norm(p, dim=-1) - 0.3, 17)
    assert g.is_cuda
    segs, valid = contour_2d(g.cpu().numpy(), 2.0)
    assert segs.is_cuda and valid.is_cuda and bool(valid.any())
    path = tmp_path / "state.pkl"
    checkpoint.save_state(path, {"a": torch.arange(3.0, device=cuda)})
    assert checkpoint.load_state(path)["a"].is_cuda
    assert checkpoint.load_state(path, like={"a": torch.zeros(3)})["a"].device.type == "cpu"
