"""Seed sweeps of grid, bowl, hull and 2D-grid bodies, built in either
package.

The sweeps that hold the port's lane bodies of every shape class against
the JAX package, written once for both: ``namespace("jax")`` or
``namespace("torch", device)`` gives the package's API, and each constructor
returns that package's ``(spec, state)`` of one lane, for
``make_world_batched``. The module imports neither package itself
(``chip_smoke.py`` uses it for the port alone). Each sweep has two sizes:
``"cpu"`` (the CPU tests, ``tests/test_torch_lanes.py``, against
``tests/golden/lanes_f64.npz``) and ``"card"``
(``chip_smoke.phase_lanes_3d`` and ``phase_lanes_2d``, against
``tests/golden/lanes_card_f64.npz``); the generator
``tests/golden/gen_torch_lanes_golden.py`` writes both.

- ``grid``: a voxelized sphere of its own radius in each lane (a grid of
  its own, lane 0 the grid path's radius 0.5) on a grid of ``res``^3, with
  its own ``scale_`` (0.75, requiring grad), dropped onto the floor box as
  the grid path's drop; the lanes' summed final heights and their d / d
  scale.
- ``bowl``: the marble dropped into a bowl of its own (r, d) in each lane
  (lane 0 the single marble's bowl; on the CPU from a lower start), no
  gradient.
- ``hull``: the hull stack (``scenes2d.hull_stack``) under the analytic
  narrowphase, each lane's two hulls scaled by its own factor.
- ``grid2d``: the grid-circle drop from 0.45 m (``scenes2d`` ``grid_low``),
  each lane a circle of its own radius on a ``res`` x ``res`` grid; each
  lane's final height and its d / d grid values.
"""

import types

import numpy as np

import scenes2d

GRID_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                max_bisect=6)
BOWL_CFG = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4,
                max_bisect=6, time_of_contact_diff=False)
SIZES = {
    "cpu": dict(
        grid=dict(res=17, rads=(0.45, 0.5, 0.55), frames=6, drop=0.62),
        bowl=dict(r=(1.0, 0.9), d=(0.1, 0.12), frames=8, drop=-0.05),
        hull=dict(factors=(1.0, 0.9), frames=5),
        grid2d=dict(res=17, rads=(0.4, 0.35), frames=6),
    ),
    "card": dict(
        grid=dict(res=64, rads=tuple(np.r_[0.5, np.linspace(0.4, 0.6, 15)]), frames=16, drop=1.0),
        bowl=dict(r=tuple(np.r_[1.0, np.linspace(0.85, 1.15, 7)]), d=tuple(np.r_[0.1, np.linspace(0.08, 0.13, 7)]),
                  frames=30, drop=1.2),
        hull=dict(factors=(1.0, 0.9, 0.95, 0.85), frames=8),
        grid2d=dict(res=65, rads=(0.4, 0.35, 0.45, 0.38), frames=8),
    ),
}
SWEEPS = ("grid", "bowl", "hull", "grid2d")
GRID_SCALE = 0.75


def namespace(pkg: str, device=None):
    """``scenes2d.namespace`` with the 3D API of ``pkg`` beside it: ``p3``
    (the physics package), ``batched`` (its ``make_world_batched`` and
    ``rollout_batched``)."""
    P = scenes2d.namespace(pkg, device)
    if pkg == "jax":
        from diffsdfsim_tpu import physics as p3
    else:
        from diffsdfsim_torch import physics as p3
    return types.SimpleNamespace(**vars(P), p3=p3)


def sphere_grid(res, rad):
    """A res^3 grid over [-1, 1]^3 of the sphere SDF whose metric radius is
    ``rad`` at scale GRID_SCALE (numpy)."""
    lin = np.linspace(-1.0, 1.0, res)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    return np.sqrt(np.maximum(np.sum(pts * pts, axis=-1), 1e-24)) - rad / GRID_SCALE


def grid_inputs(size):
    """(grids (B, res, res, res), scales (B,)) of the grid sweep (numpy)."""
    s = SIZES[size]["grid"]
    return np.stack([sphere_grid(s["res"], r) for r in s["rads"]]), np.full(len(s["rads"]), GRID_SCALE)


def grid_world(P, size):
    """The grid sweep's one-lane constructor ``(grid, scale) -> (spec, state)``."""
    drop = SIZES[size]["grid"]["drop"]
    cfg = P.SimConfig(**GRID_CFG)

    def build(grid, scale):
        m = P.p3
        floor = m.make_body(m.BoxShape(P.arr([20.0, 1.0, 20.0])), fric_coeff=0.25, subdiv=3, **P.kw)
        ball = m.make_body(m.GridShape(grid=grid, scale_=scale), fric_coeff=0.25, template="ico", subdiv=2,
                           project_iters=16, **P.kw)
        return m.make_world([floor, ball], P.arr([[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, drop, 0]]),
                            P.arr(np.zeros((2, 6))), joints=(m.TotalConstraint3D(body1=0),),
                            forces=((), (m.Gravity3D(10.0),)), cfg=cfg, **P.kw)

    return build


def bowl_inputs(size):
    s = SIZES[size]["bowl"]
    return np.asarray(s["r"]), np.asarray(s["d"])


def bowl_world(P, size):
    """The bowl sweep's one-lane constructor ``(r, d) -> (spec, state)``: the
    marble of ``tests/test_bowl.py`` (dropped from ``drop``, 1.2 m there)
    into a bowl of mid-radius r and half-thickness d."""
    cfg = P.SimConfig(**BOWL_CFG)
    drop = SIZES[size]["bowl"]["drop"]
    s = float(np.sqrt(0.5))

    def build(r, d):
        m = P.p3
        bowl = m.make_body(m.BowlShape(r, d), custom_mesh=True, **P.kw)
        marble = m.make_body(m.SphereShape(P.arr(0.2)), subdiv=1, fric_coeff=0.3, **P.kw)
        return m.make_world([bowl, marble], P.arr([[s, -s, 0, 0, 0.0, 0.0, 0.0], [1.0, 0, 0, 0, 0.15, drop, 0.0]]),
                            P.arr(np.zeros((2, 6))), joints=(m.TotalConstraint3D(body1=0),),
                            forces=((), (m.Gravity3D(10.0),)), cfg=cfg, **P.kw)

    return build


def hull_inputs(size):
    return np.asarray(SIZES[size]["hull"]["factors"])


def hull_world(P, size=None):
    """The hull sweep's one-lane constructor ``(factor) -> (spec, state)``."""

    def build(f):
        bodies = [P.m.Rect([20.0, 1.0], **P.kw), P.m.Hull(P.arr(scenes2d.BASE_HULL) * f, **P.kw),
                  P.m.Hull(P.arr(scenes2d.TOP_HULL) * f, **P.kw)]
        cfg = P.SimConfig(**scenes2d.CFG2D).replace(max_substeps=3, tol=1e-6)
        return scenes2d._grounded(P, bodies, [[0.0, 0.0, -0.5], [0.0, 0.0, 0.52], [0.0, 0.0, 1.65]],
                                  np.zeros((3, 3)), cfg, "analytic")

    return build


def grid2d_inputs(size):
    s = SIZES[size]["grid2d"]
    return np.stack([scenes2d.circle_grid(s["res"], r) for r in s["rads"]])


def grid2d_world(P, size=None):
    """The 2D grid sweep's one-lane constructor ``(grid) -> (spec, state)``."""
    return lambda g: scenes2d.grid_drop(P, grid=g, drop=0.45)


SWEEP_FNS = {"grid": (grid_world, grid_inputs), "bowl": (bowl_world, bowl_inputs), "hull": (hull_world, hull_inputs),
            "grid2d": (grid2d_world, grid2d_inputs)}


def inputs(sweep, size):
    """The sweep's per-lane inputs, a tuple of numpy arrays with the lane
    axis first."""
    x = SWEEP_FNS[sweep][1](size)
    return x if isinstance(x, tuple) else (x,)


def world_fn(P, sweep, size):
    return SWEEP_FNS[sweep][0](P, size)


def frames(sweep, size):
    return SIZES[size][sweep]["frames"]


def jax_ties(golden, sweep, lane):
    """The substeps (f, s) of a lane where the JAX package's compiled and
    op-by-op contact searches (the golden's ``c_*`` and ``e_*``) keep other
    points, their deepest penetrations within ``scenes2d.ATOL_TIE_PEN``:
    there rounding decides which points are kept."""
    c = {k: golden[f"{sweep}/c_{k}"][lane] for k in scenes2d.CONTACT_KEYS}
    e = {k: golden[f"{sweep}/e_{k}"][lane] for k in scenes2d.CONTACT_KEYS}
    valid = golden[f"{sweep}/valid"][lane]
    ties = []
    for f in range(valid.shape[0]):
        for s in range(valid.shape[1]):
            if not valid[f, s]:
                continue
            part = scenes2d.contact_parting(
                {"valid": valid[f:f + 1, s:s + 1]}, {"valid": valid[f:f + 1, s:s + 1]},
                lambda *_: tuple(c[k][f, s] for k in scenes2d.CONTACT_KEYS),
                lambda *_: tuple(e[k][f, s] for k in scenes2d.CONTACT_KEYS), 0)
            if part is not None and part[3] <= scenes2d.ATOL_TIE_PEN:
                ties.append((f, s, part[2], part[3]))
    return ties


def _same_contacts(x, y) -> bool:
    """Two contact sets (valid, p1, pen, max_pen_all) keep the same points
    (``scenes2d.contact_parting``) at one depth (within
    ``scenes2d.ATOL_TIE_PEN``)."""
    one = {"valid": np.ones((1, 1), dtype=bool)}
    return (scenes2d.contact_parting(one, one, lambda *_: x, lambda *_: y, 0) is None
            and abs(float(x[3]) - float(y[3])) <= scenes2d.ATOL_TIE_PEN)


def hold_lane(a: dict, golden, sweep: str, lane: int, atol: float, tag: str, contacts_a):
    """Hold a port lane (trajectory dict ``a``) against the JAX golden's
    lane: ``scenes2d.hold`` with the golden's compiled contacts, and where
    the poses part with no contact parting between the two, accepted only
    at a tie the JAX package witnesses itself (``jax_ties``: a substep up to
    the parting frame where its compiled and op-by-op searches keep other
    points) at whose first substep the port keeps one side of it (its
    contacts at its own pose those of the compiled or of the op-by-op
    search), with the decisions equal and the poses within ``atol`` before
    the parting. Returns (ok, held throughout, the line that reports it)."""
    b = {k: golden[f"{sweep}/{k}"][lane] for k in scenes2d.TRAJ_KEYS}
    ok, held, line = scenes2d.hold(a, b, atol, tag, contacts_a, golden_contacts(golden, sweep, lane))
    if ok or held:
        return ok, held, line
    fp = scenes2d.pose_parting(a, b, atol)
    ties = [t for t in jax_ties(golden, sweep, lane) if t[0] <= fp]
    d_before = max(float(np.abs(a[k][:fp] - b[k][:fp]).max()) for k in ("pos", "quat", "v")) if fp else 0.0
    same = all(np.array_equal(a[k][:fp], b[k][:fp]) for k in scenes2d.DECISIONS)
    if not ties:
        return False, False, line + "; no tie of JAX's own witnessed up to it"
    f, s, dist, dpen = ties[0]
    mine = contacts_a(f, s)
    side = [name for name, x in (("compiled", "c"), ("op-by-op", "e"))
            if _same_contacts(mine, tuple(golden[f"{sweep}/{x}_{k}"][lane][f, s] for k in scenes2d.CONTACT_KEYS))]
    line = (f"{tag}: poses part at frame {fp}; JAX's compiled and op-by-op searches keep points {dist:.3e} m apart "
            f"at frame {f} substep {s} (deepest penetrations {dpen:.1e} apart): a tie, where the port keeps "
            + (f"the {side[0]} search's points" if side else "neither side's points")
            + f"; before frame {fp}: poses within {d_before:.2e}, decisions {'equal' if same else 'differ'}; after it "
            f"the positions part by up to {float(np.abs(a['pos'] - b['pos']).max()):.2e} m")
    return bool(side) and same and d_before <= atol, False, line


def rounding_parting(P, spec, state, single: dict, fp: int, body: int, atol: float,
                     deltas=(1e-12, -1e-12, 1e-11)):
    """Whether rounding decides a single run's frames fp - 1 and fp: the
    world ``(spec, state)``, run without a tape to the start of frame
    fp - 1 (where it must be within ``atol`` of ``single``, the run held)
    and restarted there, parts from itself (poses beyond ``atol``) by the
    end of frame fp when body ``body``'s position changes by one of
    ``deltas`` metres along each axis (tried in turn). Returns (witnessed,
    the line that reports it)."""
    import torch

    f0 = max(fp - 1, 0)
    n = min(fp + 1, single["pos"].shape[0]) - f0
    with torch.no_grad():
        start = P.rollout(spec, state, f0)[0] if f0 else state
        base = scenes2d.traj_numpy(P.rollout(spec, start, n)[1])
    same, d_start, _ = scenes2d.compare({k: v[:1] for k, v in base.items()},
                                        {k: v[f0:f0 + 1] for k, v in single.items()}, atol)
    line = f"the single world restarted at frame {f0} ({d_start:.1e} from the run held there)"
    if not (same and d_start <= atol):
        return False, line + " is not the run held"
    for delta in deltas:
        pos = start.pos.clone()
        pos[body] += delta
        with torch.no_grad():
            moved = scenes2d.traj_numpy(P.rollout(spec, start._replace(pos=pos), n)[1])
        _, err, first = scenes2d.compare(moved, base, atol)
        line += f", moved by {delta:g} m, parts from itself by {err:.2e}"
        if first is not None:
            return True, line + f" (beyond {atol:g} at frame {f0 + first}): rounding decides"
    return False, line + f": within {atol:g}, no witness that rounding decides"


def hold_single(a: dict, single: dict, atol: float, tag: str, contacts_a, contacts_b, witness):
    """Hold a lane (trajectory dict ``a``) against its single run:
    ``scenes2d.hold``, and where that finds no tie, accepted only where the
    single run's own frames at the poses' parting are decided by rounding
    (``witness(fp)``, ``rounding_parting`` of the single world), with the
    decisions equal and the poses within ``atol`` before the parting and
    any contact parting before it a tie. Returns (ok, held throughout, the
    line that reports it)."""
    ok, held, line = scenes2d.hold(a, single, atol, tag, contacts_a, contacts_b)
    if ok or held:
        return ok, held, line
    fp = scenes2d.pose_parting(a, single, atol)
    cp = scenes2d.contact_parting(a, single, contacts_a, contacts_b, fp)
    if cp is not None and cp[0] < fp and cp[3] > scenes2d.ATOL_TIE_PEN:
        return False, False, line
    d_before = max(float(np.abs(a[k][:fp] - single[k][:fp]).max()) for k in ("pos", "quat", "v")) if fp else 0.0
    same = all(np.array_equal(a[k][:fp], single[k][:fp]) for k in scenes2d.DECISIONS)
    witnessed, w_line = witness(fp)
    return witnessed and same and d_before <= atol, False, f"{line}; {w_line}"


def kept_contacts_tie(a: dict, b: dict, contacts_a, contacts_b):
    """The first substep (frame, slot, point distance, penetration
    difference) where two runs that hold together keep other contact points
    (farther apart than ``scenes2d.ATOL_TIE_POINT``) while their deepest
    penetrations agree within ``scenes2d.ATOL_TIE_PEN``: a tie that may leave
    the poses equal and move a gradient. None where there is none."""
    cp = scenes2d.contact_parting(a, b, contacts_a, contacts_b, a["pos"].shape[0] - 1)
    return cp if cp is not None and cp[3] <= scenes2d.ATOL_TIE_PEN else None


def golden_contacts(golden, sweep: str, lane: int):
    """``contacts_at`` of a lane of the golden's compiled contacts."""
    ref = {k: golden[f"{sweep}/c_{k}"][lane] for k in scenes2d.CONTACT_KEYS}
    return lambda f, s: tuple(ref[k][f, s] for k in scenes2d.CONTACT_KEYS)
