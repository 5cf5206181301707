"""The JAX package's 2D scenes, built in either package.

The planar worlds of ``tests/test_physics2d.py``, ``test_physics2d_extra.py``,
``test_narrowphase2d.py`` and ``test_marching2d.py``, written once for both
the JAX package and the PyTorch port: ``namespace("jax")`` or
``namespace("torch", device)`` gives the package's 2D API, and each scene
builder returns that package's ``(spec, state)``. The module imports neither
package itself, so ``chip_smoke.py`` uses it for the port alone.

``CASES`` names every rollout held against a JAX golden
(``tests/golden/gen_torch_2d_golden.py`` writes them all to
``tests/golden/scenes2d_f64.npz``): the scene, its arguments and frames.
``GRADS`` names the two gradients: d(final height) / d(circle radius) of the
circle drop under the analytic narrowphase (with the time-of-contact
differential), and d(final height) / d(grid values) of the grid drop.
"""

import types

import numpy as np

CFG2D = dict(fric_dirs=4, max_contacts_per_pair=4, max_contacts_total=8, mesh_subdiv=2, max_substeps=4, max_bisect=6,
             time_of_contact_diff=False)
PARITY_CFG = dict(fric_dirs=4, max_contacts_per_pair=2, max_contacts_total=4, mesh_subdiv=1, max_substeps=4,
                  max_bisect=6, tol=1e-8, eps=1e-2, strict_no_penetration=False)
GRID_CFG = dict(fric_dirs=4, max_contacts_per_pair=2, max_contacts_total=4, mesh_subdiv=2, max_substeps=3, max_bisect=6)

BASE_HULL = [[-1.0, -0.5], [1.0, -0.5], [1.2, 0.1], [0.0, 0.6], [-1.2, 0.1]]
TOP_HULL = [[-0.4, -0.4], [0.4, -0.4], [0.4, 0.4], [-0.4, 0.4]]
PARITY_HULL = [[0.5, 0.5], [-0.5, 0.5], [-0.7, -0.3], [0.0, -0.6], [0.6, -0.2]]


def namespace(pkg: str, device=None):
    """The 2D API of ``pkg`` ("jax" or "torch"; the port's bodies and worlds
    on ``device``): ``m`` (the physics2d package), ``SimConfig``,
    ``Gravity3D``, ``Total`` (TotalConstraint3D), ``arr`` (numpy to the
    package's float64 arrays), ``kw`` (the device keyword of the port's
    builders) and ``rollout``."""
    if pkg == "jax":
        import jax.numpy as jnp

        from diffsdfsim_tpu import physics2d as m
        from diffsdfsim_tpu.config import SimConfig
        from diffsdfsim_tpu.physics import Gravity3D, TotalConstraint3D
        from diffsdfsim_tpu.physics.world import rollout

        return types.SimpleNamespace(m=m, SimConfig=SimConfig, Gravity3D=Gravity3D, Total=TotalConstraint3D,
                                     arr=lambda x: jnp.asarray(x, dtype=jnp.float64), kw={}, rollout=rollout)
    import torch

    from diffsdfsim_torch import physics2d as m
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import Gravity3D, TotalConstraint3D
    from diffsdfsim_torch.physics.world import rollout

    def arr(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    return types.SimpleNamespace(m=m, SimConfig=SimConfig, Gravity3D=Gravity3D, Total=TotalConstraint3D, arr=arr,
                                 kw={"device": device}, rollout=rollout)


def _grounded(P, bodies, poses, vels, cfg, narrowphase="fw", **kw):
    """Body 0 fixed (TotalConstraint3D), gravity 10 on the others."""
    return P.m.make_world_2d(
        bodies, P.arr(poses), P.arr(vels), joints=(P.Total(body1=0),) + kw.pop("joints", ()),
        forces=tuple(() if i == 0 else (P.Gravity3D(10.0),) for i in range(len(bodies))), cfg=cfg,
        narrowphase=narrowphase, **kw, **P.kw)


def circle_drop(P, narrowphase="fw", rad=0.5, toc=False):
    """A circle dropped from 2 m onto a 20 x 1 Rect (test_physics2d.py:15);
    ``toc`` turns the time-of-contact differential on (the gradient's case:
    without it the bounce's height does not depend on the radius)."""
    bodies = [P.m.Rect([20.0, 1.0], **P.kw), P.m.Circle(rad, **P.kw)]
    cfg = P.SimConfig(**CFG2D).replace(time_of_contact_diff=toc)
    return _grounded(P, bodies, [[0.0, 0.0, -0.5], [0.0, 0.0, 2.0]], np.zeros((2, 3)), cfg, narrowphase)


def hull_stack(P, narrowphase="fw"):
    """A square hull on a pentagon hull on the floor (test_physics2d.py:45)."""
    bodies = [P.m.Rect([20.0, 1.0], **P.kw), P.m.Hull(BASE_HULL, **P.kw), P.m.Hull(TOP_HULL, **P.kw)]
    cfg = P.SimConfig(**CFG2D).replace(max_substeps=3, tol=1e-6)
    return _grounded(P, bodies, [[0.0, 0.0, -0.5], [0.0, 0.0, 0.52], [0.0, 0.0, 1.65]], np.zeros((3, 3)), cfg,
                     narrowphase)


def parity(P, scene, narrowphase):
    """test_narrowphase2d.py:108-152: a tilted box on a box ("stack"), or a
    hull and a circle thrown at each other over the floor ("hulls")."""
    if scene == "stack":
        bodies = [P.m.Rect([8.0, 1.0], fric_coeff=0.5, **P.kw), P.m.Rect([1.0, 1.0], fric_coeff=0.5, **P.kw)]
        poses, vels = [[0.0, 0.0, 0.0], [0.05, 0.0, 1.1]], np.zeros((2, 3))
    else:
        bodies = [P.m.Rect([8.0, 1.0], fric_coeff=0.4, **P.kw), P.m.Hull(PARITY_HULL, fric_coeff=0.4, **P.kw),
                  P.m.Circle(0.4, fric_coeff=0.4, **P.kw)]
        poses = [[0.0, 0.0, 0.0], [0.2, -0.8, 1.4], [0.0, 0.9, 1.2]]
        vels = np.zeros((3, 3))
        vels[1, 1], vels[2, 1] = 1.0, -1.0
    return _grounded(P, bodies, poses, vels, P.SimConfig(**PARITY_CFG), narrowphase)


def pendulum(P):
    """A circle hinged 1 m from a fixed anchor (test_physics2d_extra.py:40)."""
    bodies = [P.m.Circle(0.1, **P.kw), P.m.Circle(0.2, **P.kw)]
    hinge = P.m.RevoluteJoint2D(body1=0, body2=1, r1_local=(0.0, 0.0), r2_local=(-1.0, 0.0))
    return _grounded(P, bodies, [[0.0, 0.0, 2.0], [0.0, 1.0, 2.0]], np.zeros((2, 3)), P.SimConfig(**CFG2D),
                     joints=(hinge,), no_contact=[(0, 1)])


def fixed_joint(P):
    """Two circles welded, the first spinning (test_physics2d_extra.py:66)."""
    bodies = [P.m.Circle(0.2, **P.kw), P.m.Circle(0.2, **P.kw)]
    vels = np.zeros((2, 3))
    vels[0, 0] = 2.0
    weld = P.m.FixedJoint2D(body1=0, body2=1, r1_local=(0.3, 0.0), r2_local=(-0.3, 0.0))
    return P.m.make_world_2d(bodies, P.arr([[0.0, 0.0, 2.0], [0.0, 0.6, 2.0]]), P.arr(vels), joints=(weld,),
                             no_contact=[(0, 1)], cfg=P.SimConfig(**CFG2D), **P.kw)


def circle_grid(res=65, rad=0.4, scale=2.0):
    """The world-units circle SDF grid of test_marching2d.py:66-101."""
    xs = np.linspace(-scale / 2, scale / 2, res)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    return np.sqrt(px**2 + py**2) - rad


def grid_drop(P, grid=None, drop=1.0):
    """A 65 x 65 circle-grid body dropped on the floor (test_marching2d.py:
    66-101); ``grid`` may be the package's array (a gradient's input)."""
    grid = P.arr(circle_grid()) if grid is None else grid
    bodies = [P.m.Rect([20.0, 1.0], fric_coeff=0.3, restitution=0.0, **P.kw),
              P.m.GridSDF2D(grid, 2.0, fric_coeff=0.3, restitution=0.0, **P.kw)]
    return _grounded(P, bodies, [[0.0, 0.0, -0.5], [0.0, 0.0, drop]], np.zeros((2, 3)), P.SimConfig(**GRID_CFG))


SCENES = {"circle": circle_drop, "hull_stack": hull_stack, "parity": parity, "pendulum": pendulum,
          "fixed": fixed_joint, "grid": grid_drop}

# case -> (scene, arguments, frames); the "_low" cases start the body a
# short drop above the floor, so a short rollout reaches its contacts
CASES = {
    "circle_fw": ("circle", dict(narrowphase="fw"), 20),
    "circle_analytic": ("circle", dict(narrowphase="analytic"), 20),
    "hull_stack_fw": ("hull_stack", dict(narrowphase="fw"), 30),
    "hull_stack_analytic": ("hull_stack", dict(narrowphase="analytic"), 30),
    "stack_fw": ("parity", dict(scene="stack", narrowphase="fw"), 10),
    "stack_analytic": ("parity", dict(scene="stack", narrowphase="analytic"), 10),
    "hulls_fw": ("parity", dict(scene="hulls", narrowphase="fw"), 10),
    "hulls_analytic": ("parity", dict(scene="hulls", narrowphase="analytic"), 10),
    "pendulum": ("pendulum", {}, 15),
    "fixed": ("fixed", {}, 5),
    "grid": ("grid", {}, 25),
    "grid_low": ("grid", dict(drop=0.45), 8),
}
# gradient -> (scene, arguments, frames, parameter: "rad" or "grid")
GRADS = {
    "grad_circle": ("circle", dict(narrowphase="analytic", toc=True), 20, "rad"),
    "grad_grid": ("grid", {}, 25, "grid"),
    "grad_grid_low": ("grid", dict(drop=0.45), 8, "grid"),
}
TRAJ_KEYS = ("pos", "quat", "v", "valid", "n_halvings", "bisect_failed", "truncated")


def build(P, case):
    scene, kw, n = CASES[case]
    return SCENES[scene](P, **kw), n


def grad_world(P, name, param):
    """The world of gradient ``name`` built from ``param`` (the circle's
    radius or the grid's values, as the package's array)."""
    scene, kw, _, which = GRADS[name]
    if which == "rad":
        return circle_drop(P, rad=param, **kw)
    return grid_drop(P, grid=param, **kw)


def grad_param(name):
    """The gradient's parameter value (numpy)."""
    return np.asarray(0.5) if GRADS[name][3] == "rad" else circle_grid()

DECISIONS = ("valid", "n_halvings", "bisect_failed", "truncated")


def traj_numpy(traj) -> dict:
    """A rollout's Trajectory (either package) as numpy arrays by key."""
    out = {}
    for k in TRAJ_KEYS:
        x = getattr(traj, k)
        out[k] = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return out


def golden_run(golden, case: str) -> dict:
    """The golden's trajectory of ``case`` by key."""
    return {k: golden[f"{case}/{k}"] for k in TRAJ_KEYS}


def golden_contacts(golden, case: str):
    """``contacts_at`` of the golden's run: its contacts at substep (f, s)."""
    return lambda f, s: tuple(golden[f"{case}/c_{k}"][f, s] for k in CONTACT_KEYS)


def compare(a: dict, b: dict, atol: float = 1e-7):
    """How run a holds against run b (trajectories by key): (the discrete
    decisions are identical, the largest pose / velocity difference, the
    first frame where one leaves ``atol`` or None)."""
    same = all(np.array_equal(a[k], b[k]) for k in DECISIONS)
    diff = np.zeros(a["pos"].shape[0])
    for k in ("pos", "quat", "v"):
        d = np.abs(a[k] - b[k])
        diff = np.maximum(diff, d.reshape(d.shape[0], -1).max(axis=1))
    off = np.nonzero(diff > atol)[0]
    return same, float(diff.max()), (int(off[0]) if off.size else None)


# Under the Frank-Wolfe search a 2D contact is a line or a face along the
# extrusion, whose points lie at one depth: which of them the search keeps is
# decided by the last bits of the arithmetic (ROADMAP queue 3, items 3 and
# 11). Such a rollout is held up to its first contact parting: the first
# substep whose kept contacts differ between the two runs (a count of valid
# contacts, or a point farther than ATOL_TIE_POINT from the other set). The
# poses may not part before it; before it they agree within the rollout's
# tolerance with identical decisions; at it, the deepest penetration of the
# two searches agrees within ATOL_TIE_PEN (the runs kept other points of the
# same contact). What follows is reported, not held.
ATOL_TIE_POINT, ATOL_TIE_PEN = 1e-6, 1e-8
CONTACT_KEYS = ("valid", "p1", "pen", "max_pen_all")
FW_CASES = ("circle_fw", "hull_stack_fw", "stack_fw", "hulls_fw", "grid", "grid_low")


def pose_parting(a: dict, b: dict, atol: float):
    """The first frame whose poses / velocities leave ``atol`` or whose
    decisions differ between runs a and b (None: never)."""
    _, _, first = compare(a, b, atol)
    bad = [f for f in range(a["pos"].shape[0]) if not all(np.array_equal(a[k][f], b[k][f]) for k in DECISIONS)]
    cands = [f for f in (first, bad[0] if bad else None) if f is not None]
    return min(cands) if cands else None


def contact_parting(a: dict, b: dict, contacts_a, contacts_b, last_frame: int):
    """The first substep (frame, slot) up to ``last_frame`` whose contacts at
    run a's pose differ from those at run b's (``contacts_x(f, s)``: numpy
    (valid, p1, pen, max_pen_all)); None or (frame, slot, the largest point
    distance, the max_pen_all difference)."""
    for f in range(last_frame + 1):
        for s in range(a["valid"].shape[1]):
            if not (a["valid"][f, s] and b["valid"][f, s]):
                continue
            va, pa, _, ma = contacts_a(f, s)
            vb, pb, _, mb = contacts_b(f, s)
            pa, pb = pa[va], pb[vb]
            d_pen = abs(float(ma) - float(mb))
            if len(pa) != len(pb):
                return f, s, float("inf"), d_pen
            if len(pa):
                dist = np.linalg.norm(pa[:, None] - pb[None], axis=-1)
                d = max(dist.min(1).max(), dist.min(0).max())
                if d > ATOL_TIE_POINT:
                    return f, s, float(d), d_pen
    return None


def hold(a: dict, b: dict, atol: float, tag: str, contacts_a=None, contacts_b=None):
    """Hold run a against run b: throughout, or with ``contacts_*`` (a
    Frank-Wolfe case) up to their first contact parting (see above).
    Returns (ok, whether it held throughout, the line that reports it)."""
    fp = pose_parting(a, b, atol)
    same, err, _ = compare(a, b, atol)
    if fp is None:
        return same and err < atol, True, f"{tag}: decisions equal, poses within {err:.2e} throughout"
    if contacts_a is None:
        return False, False, f"{tag}: decisions {'equal' if same else 'differ'}, poses leave {atol:g} at frame {fp}"
    cp = contact_parting(a, b, contacts_a, contacts_b, fp)
    n = fp if cp is None else cp[0]
    d_before = max((float(np.abs(a[k][:n] - b[k][:n]).max()) for k in ("pos", "quat", "v")), default=0.0) if n \
        else 0.0
    same = all(np.array_equal(a[k][:n], b[k][:n]) for k in DECISIONS)
    line = (f"{tag}: poses part at frame {fp}, contacts at "
            + ("no substep" if cp is None else f"frame {cp[0]} substep {cp[1]} (kept points up to {cp[2]:.3e} m "
               f"apart, deepest penetrations {cp[3]:.3e} apart)")
            + f"; before frame {n}: poses within {d_before:.2e}, decisions {'equal' if same else 'differ'}; "
            f"after it the positions part by up to {float(np.abs(a['pos'] - b['pos']).max()):.2e} m")
    ok = cp is not None and cp[3] <= ATOL_TIE_PEN and d_before <= atol and same
    return ok, False, line


def port_contacts_at(spec, tr: dict):
    """``contacts_at`` of a port run: the contacts of ``spec``'s world at
    the run's pose of substep (f, s), as numpy."""
    import torch

    from diffsdfsim_torch.physics.contacts import find_contacts

    dev = spec.bodies[0].verts.device

    def at(f, s):
        q = torch.as_tensor(tr["quat"][f, s], device=dev)
        p = torch.as_tensor(tr["pos"][f, s], device=dev)
        with torch.no_grad():
            c = find_contacts(spec.bodies, q, p, spec.directed_pairs, spec.n_unordered, spec.cfg)
        return tuple(getattr(c, k).cpu().numpy() for k in CONTACT_KEYS)

    return at


def hold_run(spec, tr: dict, golden, case: str, atol: float):
    """Hold a port run (``tr``, numpy) of ``case`` against the JAX golden
    (``hold``; a Frank-Wolfe case up to its first contact parting)."""
    fw = case in FW_CASES
    return hold(tr, golden_run(golden, case), atol, case, port_contacts_at(spec, tr) if fw else None,
                golden_contacts(golden, case) if fw else None)
