"""Port parity, seed sweeps of grid, bowl, hull and 2D-grid bodies: lane
bodies of every shape class (``physics/bodies.stack_lanes``,
``make_body_lanes``) through ``make_world_batched`` and ``rollout_batched``
on the CPU, against the JAX package's sweeps (committed golden file
``tests/golden/lanes_f64.npz``, written by
``tests/golden/gen_torch_lanes_golden.py``; the sweeps are
``tests/scenes_lanes.py``'s ``cpu`` size) and each lane against the port's
own single rollout; the K5 lane entry's autograd Function and its vmap rule
on a kernel stand-in; ``stack_lanes`` for each shape class.

Tolerances: the discrete decisions (valid substeps, accepted rungs,
bisection failures, truncated frames) identical everywhere. Against JAX:
the grid sweep's poses within 1e-7 (the grid drop's tolerance) and its
d / d scale within 1e-6 relative; the bowl's poses within 1e-7 (the single
marble's); the hull stack's within 1e-8 (the 2D scenes'); the 2D grid
drop's within 1e-8 up to a witnessed contact tie (``scenes2d.hold``, or
``scenes_lanes.hold_lane``: a tie the JAX package's own compiled and
op-by-op searches witness, where the port keeps one side's points within
1e-6 m and 1e-8 m of depth) and its d height / d grid values within 1e-6
relative where it holds throughout (or, where its kept contacts part at a
witnessed tie that leaves the poses equal, reported). Against the single path: poses within 1e-10 (the batched
solve may round apart at its margin, as ``test_torch_batched.py`` allows),
values and gradients within 1e-9 relative. The Function on the stand-in:
bitwise the plain version's values and gradients.
"""

import functools
import os

import numpy as np
import pytest
import torch

import scenes2d
import scenes_lanes as SL
from diffsdfsim_torch.ops import grid_cuda, sdf
from diffsdfsim_torch.physics import (BowlShape, GridShape, make_body, make_world_batched, rollout, rollout_batched,
                                      trajectory_lanes_first)
from diffsdfsim_torch.physics.bodies import make_body_lanes, stack_lanes
from diffsdfsim_torch.physics.contacts import per_pose
from torch_jax_bridge import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "lanes_f64.npz")
P = SL.namespace("torch", "cpu")
ATOL_JAX = {"grid": 1e-7, "bowl": 1e-7, "hull": 1e-8, "grid2d": 1e-8}
RTOL_GRAD_JAX = 1e-6
ATOL_SINGLE, RTOL_SINGLE = 1e-10, 1e-9
KEYS = ("pos", "quat", "v")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _body(sweep):
    """The index of the body whose final height the sweep differentiates."""
    return 2 if sweep == "hull" else 1


def _differentiated(sweep, ins):
    """The input the sweep differentiates (grid: the scales, grid2d: the
    grids), marked requiring grad."""
    j = {"grid": 1, "grid2d": 0}.get(sweep)
    if j is not None:
        ins[j].requires_grad_(True)
    return j


@functools.lru_cache(maxsize=None)
def _sweep(sweep):
    """The sweep's batched run: (spec, bodies, numpy trajectory lanes first,
    final heights (B,), their gradients or None, the inputs, each lane's
    single world (spec, state) as the one-lane constructor made it)."""
    ins = [torch.tensor(x) for x in SL.inputs(sweep, "cpu")]
    j = _differentiated(sweep, ins)
    build, worlds = SL.world_fn(P, sweep, "cpu"), []

    def recorded(*args):
        worlds.append(build(*args))
        return worlds[-1]

    spec, bodies_b, state_b = make_world_batched(recorded, *ins)
    with torch.set_grad_enabled(j is not None):
        final, traj = rollout_batched(spec, bodies_b, state_b, SL.frames(sweep, "cpu"))
        heights = final.pos[:, _body(sweep), 1]
        # a lane's height depends on its own input alone: the gradient of
        # their sum holds each lane's in its slice (the lanes' construction
        # is kept for their single runs)
        grad = torch.autograd.grad(heights.sum(), ins[j], retain_graph=True)[0] if j is not None else None
    tr = {k: v.detach().numpy() for k, v in trajectory_lanes_first(traj)._asdict().items()}
    return spec, bodies_b, tr, heights.detach().numpy(), None if grad is None else grad.numpy(), ins, worlds


@functools.lru_cache(maxsize=None)
def _single(sweep, i):
    """Lane i's single rollout, of the world its one-lane constructor made:
    (spec, numpy trajectory, final height, its gradient or None)."""
    *_, ins, worlds = _sweep(sweep)
    j = {"grid": 1, "grid2d": 0}.get(sweep)
    spec, state = worlds[i]
    with torch.set_grad_enabled(j is not None):
        final, traj = rollout(spec, state, SL.frames(sweep, "cpu"))
        h = final.pos[_body(sweep), 1]
        g = torch.autograd.grad(h, ins[j], retain_graph=True)[0][i].numpy() if j is not None else None
    return spec, {k: v.detach().numpy() for k, v in traj._asdict().items()}, float(h.detach()), g


def rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _lane(tr, i):
    return {k: v[i] for k, v in tr.items()}


@pytest.mark.parametrize("sweep", SL.SWEEPS)
def test_sweep_matches_jax_golden(golden, sweep):
    """Each lane of the port's sweep against the JAX package's."""
    spec, bodies_b, tr, heights, grad, *_ = _sweep(sweep)
    B = len(SL.inputs(sweep, "cpu")[0])
    assert [bd.lanes for bd in bodies_b] == {"bowl": [B, 0], "hull": [0, B, B]}.get(sweep, [0, B])
    gold = {k: golden[f"{sweep}/{k}"] for k in scenes2d.TRAJ_KEYS}
    for i in range(heights.shape[0]):
        a, b = _lane(tr, i), _lane(gold, i)
        if sweep == "grid2d":
            ok, held, line = SL.hold_lane(a, golden, sweep, i, ATOL_JAX[sweep], f"grid2d lane {i}",
                                          scenes2d.port_contacts_at(_single(sweep, i)[0], a))
            print(line)
            assert ok, line
            if held:
                np.testing.assert_allclose(heights[i], golden["grid2d/value"][i], rtol=0, atol=ATOL_JAX[sweep])
                if rel_err(grad[i], golden["grid2d/grad"][i]) > RTOL_GRAD_JAX:
                    # the poses hold; the gradient may part only at a tie of the kept contacts
                    assert SL.kept_contacts_tie(a, b, scenes2d.port_contacts_at(_single(sweep, i)[0], a),
                                                SL.golden_contacts(golden, sweep, i)) is not None, line
            continue
        for key in scenes2d.DECISIONS:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{sweep} lane {i} {key}")
        for key in KEYS:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=ATOL_JAX[sweep], err_msg=f"{sweep} lane {i} {key}")
    if sweep == "grid":
        np.testing.assert_allclose(heights.sum(), golden["grid/value"], rtol=0, atol=ATOL_JAX["grid"])
        np.testing.assert_allclose(grad, golden["grid/grad"], rtol=RTOL_GRAD_JAX)
    assert int(tr["valid"].sum()) > tr["valid"].shape[0] * tr["valid"].shape[1]  # some lane took extra substeps


def test_hold_lane_takes_a_side_of_jax_tie(golden):
    """scenes_lanes.hold_lane on the recorded 2D grid lane 1 alone: a run
    that parts from JAX's after the tie JAX's own compiled and op-by-op
    searches witness is accepted where it kept either search's points at
    the tie, and refused where it kept points of another depth."""
    i, keys = 1, scenes2d.CONTACT_KEYS
    b = {k: golden[f"grid2d/{k}"][i] for k in scenes2d.TRAJ_KEYS}
    f, s = SL.jax_ties(golden, "grid2d", i)[0][:2]
    a = {k: v.copy() for k, v in b.items()}
    a["pos"][f + 1:] += 1e-6

    def kept(side, pen_shift=0.0):
        def at(ff, ss):
            v, p1, pen, m = (golden[f"grid2d/{side}_{k}"][i][ff, ss] for k in keys)
            return v, p1, pen, m + (pen_shift if (ff, ss) == (f, s) else 0.0)
        return at

    for side in ("c", "e"):
        ok, held, line = SL.hold_lane(a, golden, "grid2d", i, ATOL_JAX["grid2d"], "side " + side, kept(side))
        assert ok and not held, line
    ok, _, line = SL.hold_lane(a, golden, "grid2d", i, ATOL_JAX["grid2d"], "neither", kept("c", 1e-6))
    assert not ok, line


@pytest.mark.parametrize("sweep", SL.SWEEPS)
def test_lanes_match_single_path(sweep):
    """Each lane against the port's single rollout of its inputs: the same
    decisions, poses, final height and (grid, grid2d) gradient."""
    _, _, tr, heights, grad, *_ = _sweep(sweep)
    for i in range(heights.shape[0]):
        _, single, h, g = _single(sweep, i)
        if g is not None:
            np.testing.assert_allclose(grad[i], g, rtol=RTOL_SINGLE, atol=0)
        for key in scenes2d.DECISIONS:
            np.testing.assert_array_equal(tr[key][i], single[key], err_msg=f"{sweep} lane {i} {key}")
        for key in KEYS:
            np.testing.assert_allclose(tr[key][i], single[key], rtol=0, atol=ATOL_SINGLE, err_msg=f"{sweep} {i} {key}")
        np.testing.assert_allclose(heights[i], h, rtol=RTOL_SINGLE)


def _class_bodies(name):
    """Two bodies of one shape class that differ (lane 0, lane 1)."""
    if name == "GridShape":
        return [make_body(GridShape(torch.tensor(SL.sphere_grid(9, r)), torch.tensor(s)), template="ico", subdiv=1,
                          device="cpu") for r, s in ((0.5, 0.75), (0.4, 0.7))]
    if name == "BowlShape":
        return [make_body(BowlShape(torch.tensor(r), torch.tensor(d)), custom_mesh=True, device="cpu")
                for r, d in ((1.0, 0.1), (0.9, 0.12))]
    if name == "HullShape":
        return [P.m.Hull(P.arr(scenes2d.TOP_HULL) * f, **P.kw) for f in (1.0, 0.8)]
    return [P.m.GridSDF2D(P.arr(scenes2d.circle_grid(9, r)), 2.0, **P.kw) for r in (0.4, 0.3)]


@pytest.mark.parametrize("name", ["GridShape", "BowlShape", "HullShape", "GridShape2D"])
def test_stack_lanes_takes_every_shape_class(name):
    """stack_lanes makes a lane body of two bodies of any shape class that
    differ; each lane's tensors, scale and SDF query equal its own body's,
    and a probe stage's body of 3 poses per lane (``per_pose``) keeps the
    shape's tensors (no copy per rung), queries as the repeated lanes and
    refuses a per-lane view."""
    bodies = _class_bodies(name)
    lane = stack_lanes(bodies)
    assert type(lane.shape).__name__ == name and lane.lanes == 2
    pts = torch.tensor(np.random.default_rng(0).uniform(-0.6, 0.6, (2, 3, 7, 3)))
    sdfs, grads = lane.query_sdfs(pts.reshape(2, 21, 3))
    for i, bd in enumerate(bodies):
        for k, t in bd.tensors().items():
            assert torch.equal(lane.tensors()[k][i], t), k
        assert torch.equal(lane.scale()[i], bd.scale())
        s1, g1 = bd.query_sdfs(pts[i].reshape(21, 3))
        assert torch.equal(sdfs[i], s1) and torch.equal(grads[i], g1)
    stage = per_pose(lane, 6)
    assert stage.lanes == 6 and stage.shape_div == 3
    assert all(stage.shape_params()[k].data_ptr() == v.data_ptr() for k, v in lane.shape_params().items())
    s3, g3 = stage.query_sdfs(pts.reshape(6, 7, 3))
    assert torch.equal(s3, sdfs.reshape(6, 7)) and torch.equal(g3, grads.reshape(6, 7, 3))
    assert torch.equal(stage.scale(), lane.scale().repeat_interleave(3))
    with pytest.raises(ValueError, match="shape lane"):
        stage.lane(0)  # the stage's shape keeps 2 lanes for its 6 poses: no per-lane view


def test_stack_lanes_refuses_lanes_whose_faces_differ():
    """Lanes must share their topology: grid bodies projected from templates
    of different subdivisions are refused."""
    a = make_body(GridShape(torch.tensor(SL.sphere_grid(9, 0.5)), torch.tensor(0.75)), template="ico", subdiv=1,
                  device="cpu")
    b = make_body(GridShape(torch.tensor(SL.sphere_grid(9, 0.4)), torch.tensor(0.75)), template="ico", subdiv=2,
                  device="cpu")
    with pytest.raises(ValueError, match="faces"):
        stack_lanes([a, b])


def test_make_body_lanes_grid_and_bowl_match_stack_lanes():
    """make_body_lanes (a vmap of make_body) builds grid and bowl lane
    bodies equal to stack_lanes of each lane's make_body."""
    grids = torch.tensor(np.stack([SL.sphere_grid(9, r) for r in (0.5, 0.4)]))
    scales = torch.tensor([0.75, 0.7], dtype=torch.float64)
    cases = ((lambda p: GridShape(p[0], p[1]), (grids, scales), dict(template="ico", subdiv=1)),
             (lambda p: BowlShape(p[0], p[1]), (torch.tensor([1.0, 0.9]), torch.tensor([0.1, 0.12])),
              dict(custom_mesh=True)))
    for shape_fn, params, kw in cases:
        lane = make_body_lanes(shape_fn, params, device="cpu", **kw)
        ref = stack_lanes([make_body(shape_fn(tuple(p[i] for p in params)), device="cpu", **kw) for i in range(2)])
        assert lane.lanes == 2 and np.array_equal(lane.faces, ref.faces)
        for k, t in ref.tensors().items():
            torch.testing.assert_close(lane.tensors()[k], t, rtol=0, atol=1e-15, msg=k)


class _KernelStandIn:
    """K5's launches on CPU tensors: the plain composition in the kernel's
    output layout, counting launches (single and lane entries apart)."""

    def __init__(self, lanes):
        self.lanes, self.launches = lanes, 0

    def one(self, pts, grid, scale):
        pin = pts if scale is None else pts / scale
        gi = sdf.grid_sdf_grad(pin, grid)
        if scale is None:
            return sdf.grid_sdf_raw(pts, grid), None, gi
        s, g = sdf.grid_query(pts, grid, scale)
        return s, g, gi

    def run(self, pts, grid, scale=None, grad=False, grad_in=False, grad_raw=False):
        self.launches += 1
        with torch.no_grad():
            if not self.lanes:
                out = self.one(pts, grid, scale)
            else:
                per = [self.one(pts[i], grid[i] if grid.dim() == 4 else grid,
                                None if scale is None else (scale[i] if scale.dim() == 1 else scale))
                       for i in range(pts.shape[0])]
                out = [None if x is None else torch.stack([p[k] for p in per]) for k, x in enumerate(per[0])]
        return out[0], out[1] if grad else None, out[2] if grad_in else None, None


def test_grid_query_function_vmap_rule(monkeypatch):
    """The K5 autograd Function under torch.func.vmap, on a kernel stand-in:
    a query of per-lane grids and scales is one lane-entry launch (a shared
    grid and scale: one single launch of all the points; a nested vmap: one
    lane launch of every lane), and values, d / d points and d / d scale
    equal the plain version mapped over the lanes; grid_query_lanes takes d
    poses per lane."""
    single, lanes = _KernelStandIn(False), _KernelStandIn(True)
    monkeypatch.setattr(grid_cuda, "grid_query_kernel", single)
    monkeypatch.setattr(grid_cuda, "grid_query_lanes_kernel", lanes)
    rng = np.random.default_rng(1)
    grids = torch.tensor(np.stack([SL.sphere_grid(9, r) for r in (0.5, 0.45, 0.4)]))
    kq = lambda p, g, s: grid_cuda._query(p, g, s, True)  # noqa: E731
    pq = lambda p, g, s: sdf.grid_query(p, g, s, True)  # noqa: E731
    cases = [((0, 0, 0), (3, 20), lambda s: s, (0, 1)), ((0, None, 0), (3, 20), lambda s: s, (0, 1)),
             ((0, None, None), (3, 20), lambda s: s[0], (1, 0))]
    for dims, shape, scale_of, launches in cases:
        pts = torch.tensor(rng.uniform(-0.8, 0.8, shape + (3,)), requires_grad=True)
        scales = torch.tensor([0.75, 0.7, 0.8], dtype=torch.float64, requires_grad=True)
        g_arg = grids if dims[1] == 0 else grids[0]
        n0, l0 = single.launches, lanes.launches
        a = torch.func.vmap(kq, in_dims=dims)(pts, g_arg, scale_of(scales))
        assert (single.launches - n0, lanes.launches - l0) == launches, dims
        b = torch.func.vmap(pq, in_dims=dims)(pts, g_arg, scale_of(scales))
        cot = [torch.tensor(rng.normal(size=x.shape)) for x in a]
        ga = torch.autograd.grad(a, (pts, scales), cot)
        gb = torch.autograd.grad(b, (pts, scales), cot)
        for x, y in zip(tuple(a) + ga, tuple(b) + gb):
            assert torch.equal(x, y), dims
    # nested: 2 outer lanes over the 3 inner ones, the grids shared by the outer
    pts = torch.tensor(rng.uniform(-0.8, 0.8, (2, 3, 7, 3)), requires_grad=True)
    sc = torch.tensor(rng.uniform(0.6, 0.9, (2, 3)), requires_grad=True)
    l0 = lanes.launches
    a = torch.func.vmap(torch.func.vmap(kq), in_dims=(0, None, 0))(pts, grids, sc)
    b = torch.func.vmap(torch.func.vmap(pq), in_dims=(0, None, 0))(pts, grids, sc)
    assert lanes.launches - l0 == 1
    cot = [torch.ones_like(x) for x in a]
    for x, y in zip(tuple(a) + torch.autograd.grad(a, (pts, sc), cot), tuple(b) + torch.autograd.grad(b, (pts, sc), cot)):
        assert torch.equal(x, y)
    # the public lane entry: d = 2 poses per lane, lane-major
    ptsr = torch.tensor(rng.uniform(-0.8, 0.8, (6, 5, 3)))
    s, g = grid_cuda.grid_query_lanes(ptsr, grids, torch.tensor([0.75, 0.7, 0.8], dtype=torch.float64))
    for r in range(6):
        s1, g1 = sdf.grid_query(ptsr[r], grids[r // 2], torch.tensor([0.75, 0.7, 0.8], dtype=torch.float64)[r // 2])
        assert torch.equal(s[r], s1) and torch.equal(g[r], g1)
