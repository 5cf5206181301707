"""Port parity, the gradient path's modules: the LCP backward (plain version
of kernel K2) and its autograd Functions, the TOC differential, the MeshSDF
surface gradient and body construction, differentiable initial contacts,
and the stop-gradient flags, against the JAX package in float64 on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Where
the JAX function reaches a Pallas kernel (``kkt_grad_pallas``), it runs in
interpret mode, as the JAX package's own tests run it. The JAX side's
results (each compiled program takes seconds to build) are read from
``tests/golden/grad_leaf_jax.pkl``, which
``tests/golden/gen_torch_grad_leaf_golden.py`` writes by running these
tests with the JAX calls live (``torch_jax_bridge.JaxGolden``); regenerate
it when a test's inputs change.

Tolerances (each stated where it is used): 1e-9 relative to the largest
gradient entry where both sides run the same algorithm and only rounding
differs; the bench LCPs' diagonals d span 1e-8 .. 1e12, so there the
backward is held at 1e-7 relative.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.ops import qp as tqp
from diffsdfsim_torch.ops import qp_cuda
from diffsdfsim_torch.ops import toc as ttoc
from diffsdfsim_tpu.ops import qp as jqp
from diffsdfsim_tpu.ops import toc as jtoc
from test_torch_qp import bench_contact_lcps, fric_pm_problem
from torch_jax_bridge import JaxGolden, jax_body_from_torch, one_torch_thread, torch_bench_world  # noqa: F401


def _rel(t, j, rel, name=""):
    """|t - j| <= rel * max|j| (or rel when j is all zero)."""
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    scale = max(float(np.abs(j).max(initial=0.0)), 1.0 if not np.any(j) else 0.0)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * scale, err_msg=name)


_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "grad_leaf_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


def _jax_vjp(fn, primals, cts):
    """(fn(*primals), its vjp with cotangents cts), as one jitted program."""
    return _from_jax(lambda: jax.jit(lambda p, c: (fn(*p), jax.vjp(fn, *p)[1](c)))(tuple(primals), cts))


LCP_NAMES = ("Q", "p", "G", "h", "A", "b", "F")
_jsolve_jit = jax.jit(jqp.pdipm_solve_raw, static_argnums=(7, 8, 9, 10))


def _jsolve(*args):
    return _from_jax(lambda: _jsolve_jit(*args))


def _port_lcp_grads(args, sol, g, structure, kkt_solve=None):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    x = tqp.lcp_solve_from_solution(*ts, tuple(torch.tensor(s) for s in sol), structure, kkt_solve=kkt_solve)
    torch.sum(x * torch.tensor(g)).backward()
    return [t.grad for t in ts]


@functools.lru_cache(maxsize=None)
def _jax_lcp_vjp(structure):
    """Jitted vjp of JAX lcp_solve_from_solution, compiled once per structure and shape."""
    return jax.jit(lambda a, sol, g: jax.vjp(lambda *aa: jqp.lcp_solve_from_solution(*aa, sol, structure), *a)[1](g))


def _jax_lcp_grads(args, sol, g, structure):
    return _from_jax(lambda: _jax_lcp_vjp(structure)(tuple(jnp.asarray(a) for a in args),
                                                     tuple(jnp.asarray(s) for s in sol), jnp.asarray(g)))


@pytest.mark.parametrize("neq,k,fd,nb", [(6, 4, 8, 3), (0, 2, 4, 2), (3, 1, 2, 2)])
def test_lcp_backward_random_fric(neq, k, fd, nb):
    """Random +/- structured friction LCPs: the same (x, y, z, s) into the
    JAX XLA backward and the port's (same Cholesky + Woodbury algorithm,
    1e-9 relative)."""
    rng = np.random.default_rng(10 * neq + k + fd)
    args = fric_pm_problem(rng, nb, neq=neq, k=k, fd=fd)
    structure = ("fric", k, fd)
    sol = [np.asarray(s) for s in _jsolve(*[jnp.asarray(a) for a in args], 10, 1e-9, 3, structure)]
    g = rng.normal(size=sol[0].shape)
    tg = _port_lcp_grads(args, sol, g, structure)
    jg = _jax_lcp_grads(args, sol, g, structure)
    for name, t, j in zip(LCP_NAMES, tg, jg):
        _rel(t, j, 1e-9, name)


def test_lcp_backward_bench_lcps():
    """Bench LCPs at contact (block-diagonal mass matrix): the port's replay
    backward (the engine's KKT solve: analytic Q^-1, the plain version of
    K2) against the JAX XLA backward and the JAX K2 Pallas kernel in
    interpret mode ("fric_pallas"), fed the same solution; 1e-7 relative
    (d spans 1e-8 .. 1e12)."""
    from diffsdfsim_torch.physics.engine import _replay_kkt_solve

    rng = np.random.default_rng(7)
    for args, structure in bench_contact_lcps()[::2]:
        sol = [np.asarray(s) for s in _jsolve(*[jnp.asarray(a) for a in args], 10, 1e-12, 3, structure)]
        g = rng.normal(size=sol[0].shape)
        tg = _port_lcp_grads(args, sol, g, structure, _replay_kkt_solve)
        for jstruct in (structure, ("fric_pallas",) + tuple(structure[1:])):
            jg = _jax_lcp_grads(args, sol, g, jstruct)
            for name, t, j in zip(LCP_NAMES, tg, jg):
                _rel(t, j, 1e-7, f"{name} vs {jstruct[0]}")


def test_kkt_grad_matches_jax_kernel():
    """kkt_grad_fric on CPU tensors (the plain solve) against the JAX K2
    kernel in interpret mode on the same (Q^-1, G, A, F, d, rx): 1e-9
    relative."""
    from diffsdfsim_tpu.ops.qp_pallas import kkt_grad_pallas

    rng = np.random.default_rng(3)
    Q, p, G, h, A, b, F = fric_pm_problem(rng, 4)
    blocks = rng.normal(size=(4, 4, 3, 3))
    invQ = np.zeros((4, 12, 12))
    for i in range(4):
        invQ[:, 3 * i : 3 * i + 3, 3 * i : 3 * i + 3] = blocks[:, i] @ np.swapaxes(blocks[:, i], -1, -2) + np.eye(3)
    d = np.exp(rng.uniform(-6, 6, size=(4, 40)))
    rx = rng.normal(size=(4, 12))
    before = qp_cuda.kkt_grad_fric.launches
    tout = qp_cuda.kkt_grad_fric(*[torch.tensor(a) for a in (invQ, G, A, F, d, rx)], ("fric", 4, 8))
    assert qp_cuda.kkt_grad_fric.launches == before
    pout = tqp.kkt_grad_plain(*[torch.tensor(a) for a in (invQ, G, A, F, d, rx)], ("fric", 4, 8))
    jout = _from_jax(lambda: kkt_grad_pallas(*[jnp.asarray(a) for a in (invQ, G, A, F, d, rx)], interpret=True,
                                             structure=("fric", 4, 8)))
    for name, t, pl, j in zip(("dx", "dlam", "dnu"), tout, pout, jout):
        assert torch.equal(t, pl), name  # the CPU wrapper is the plain version
        _rel(t, j, 1e-9, name)


def test_kkt_grad_wrapper_validation():
    """What K2 does not take raises before any launch."""
    rng = np.random.default_rng(6)
    Q, p, G, h, A, b, F = [torch.tensor(a) for a in fric_pm_problem(rng, 2)]
    d, rx = torch.ones((2, 40), dtype=torch.float64), p
    qp_cuda.check_grad_inputs(Q, G, A, F, d, rx, ("fric", 4, 8))
    for structure in (None, ("plain",), ("fric", 4, 3)):
        with pytest.raises(ValueError):
            qp_cuda.check_grad_inputs(Q, G, A, F, d, rx, structure)
    with pytest.raises(TypeError):
        qp_cuda.check_grad_inputs(Q, G, A, F, d.float(), rx, ("fric", 4, 8))
    with pytest.raises(ValueError):
        qp_cuda.check_grad_inputs(Q, G, A, F, d[:, :6], rx, ("fric", 4, 8))


@pytest.mark.parametrize("structure", [("plain",), None])
def test_lcp_solve_matches_jax(structure):
    """The full differentiable solve (post-stabilization's) against JAX
    lcp_solve on problems without friction coupling: x at atol 1e-9, the
    gradients at 1e-8 relative."""
    rng = np.random.default_rng(8)
    Q, p, G, h, A, b, F = fric_pm_problem(rng, 3, k=2, fd=2)
    args = (Q, p, G[:, :2], np.abs(h[:, :2]), A, b, np.zeros((3, 2, 2)))
    g = rng.normal(size=(3, 12))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tx = tqp.lcp_solve(*ts, 10, 1e-9, 3, structure)
    torch.sum(tx * torch.tensor(g)).backward()
    jx, jg = _jax_vjp(lambda *a: jqp.lcp_solve(*a, 10, 1e-9, 3, structure), [jnp.asarray(a) for a in args],
                      jnp.asarray(g))
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    for name, t, j in zip(LCP_NAMES, ts, jg):
        _rel(t.grad, j, 1e-8, name)


# ---------------------------------------------------------------- TOC


def _toc_args(rng, K, vel_scale):
    from diffsdfsim_torch.utils.quaternion import quat_to_matrix

    q = rng.normal(size=(2, K, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rots = quat_to_matrix(torch.tensor(q)).numpy()
    n = rng.normal(size=(K, 3))
    return ttoc.TocArgs(
        cs1=rng.normal(size=(K, 3)) * 0.3, cs2=rng.normal(size=(K, 3)) * 0.3,
        vs1=rng.normal(size=(K, 6)) * vel_scale, vs2=rng.normal(size=(K, 6)) * vel_scale,
        poss1=rng.normal(size=(K, 3)), poss2=rng.normal(size=(K, 3)),
        rots1=rots[0], rots2=rots[1], ns2=n / np.linalg.norm(n, axis=-1, keepdims=True),
        as1=rng.normal(size=(K, 6)) * vel_scale, as2=rng.normal(size=(K, 6)) * vel_scale,
    )


@pytest.mark.parametrize("case", ["masked", "guard"])
def test_toc_dt_matches_jax(case):
    """Gradients of h and of every TocArgs field against JAX toc_dt, 1e-10
    relative. "masked": two of six slots masked, the rest with both signs of
    dD/dh (motion out of collision is zeroed). "guard": velocities and accelerations 1e-4, so
    sum (dD/dh)^2 <= 1e-5 and only h keeps a gradient."""
    rng = np.random.default_rng(0 if case == "masked" else 1)
    K = 6
    a = _toc_args(rng, K, 2.0 if case == "masked" else 1e-4)
    mask = np.array([True, True, False, True, False, True]) if case == "masked" else np.ones(K, dtype=bool)
    h, dL = 1.0 / 30.0, 1.7
    th = torch.tensor(h, dtype=torch.float64, requires_grad=True)
    targs = [torch.tensor(x, requires_grad=True) for x in a]
    out = ttoc.toc_dt(th, ttoc.TocArgs(*targs), torch.tensor(mask))
    assert float(out) == h
    (out * dL).backward()
    _, (jh, jargs) = _jax_vjp(lambda hh, aa: jtoc.toc_dt(hh, aa, jnp.asarray(mask)),
                              [jnp.asarray(h), jtoc.TocArgs(*[jnp.asarray(x) for x in a])], jnp.asarray(dL))
    assert float(th.grad) == float(jh)
    for name, t, j in zip(ttoc.TocArgs._fields, targs, jargs):
        _rel(t.grad, j, 1e-10, name)
    if case == "guard":
        assert all(float(t.grad.abs().max()) == 0.0 for t in targs)
    else:
        assert float(targs[0].grad.abs().max()) > 0


# ---------------------------------------------------------------- bodies


@pytest.mark.parametrize("kind", ["sphere", "box", "cylinder"])
def test_make_body_gradients_match_jax(kind):
    """d(verts, ang_inertia, mass)/d(shape parameters) of make_body (template
    projection with the MeshSDF correction, Mirtich inertia) against JAX,
    through one vjp with random cotangents; the mass is a density times the
    parameters' volume so that it carries a gradient too. 1e-9 relative."""
    from diffsdfsim_torch.physics import BoxShape, CylinderShape, SphereShape, make_body
    from diffsdfsim_tpu.physics import shapes as jshapes
    from diffsdfsim_tpu.physics.bodies import make_body as jmake_body

    params = {"sphere": [0.5], "box": [0.6, 0.4, 0.5], "cylinder": [0.4, 0.8]}[kind]

    def build(p, lib):
        if lib == "torch":
            shape = {"sphere": lambda: SphereShape(p[0]), "box": lambda: BoxShape(p),
                     "cylinder": lambda: CylinderShape(p[0], p[1])}[kind]()
            return make_body(shape, mass=3.0 * p.prod(), subdiv=1, device="cpu")
        shape = {"sphere": lambda: jshapes.SphereShape(p[0]), "box": lambda: jshapes.BoxShape(p),
                 "cylinder": lambda: jshapes.CylinderShape(p[0], p[1])}[kind]()
        return jmake_body(shape, mass=3.0 * jnp.prod(p), subdiv=1)

    tp = torch.tensor(params, dtype=torch.float64, requires_grad=True)
    tb = build(tp, "torch")
    rng = np.random.default_rng(2)
    cts = [rng.normal(size=tuple(x.shape)) for x in (tb.verts, tb.ang_inertia, tb.mass)]
    loss = sum(torch.sum(x * torch.tensor(c)) for x, c in zip((tb.verts, tb.ang_inertia, tb.mass), cts))
    loss.backward()

    def jfn(p):
        b = build(p, "jax")
        return b.verts, b.ang_inertia, b.mass

    jout, (jg,) = _jax_vjp(jfn, [jnp.asarray(params)], tuple(jnp.asarray(c) for c in cts))
    _rel(tb.verts, jout[0], 1e-12, "verts")
    _rel(tp.grad, jg, 1e-9, "d/dparams")
    assert tb.verts.grad_fn is not None and tb.ang_inertia.grad_fn is not None


def test_make_world_in_contact_is_differentiable():
    """Fault 1: make_world finds the initial contacts differentiably. The
    sphere (rad 0.5) starts 5e-4 above the floor, within the contact eps:
    d(contact normal, p1, p2, pen)/d rad through one vjp against JAX's
    find_contacts at the same bodies and pose, 1e-9 relative."""
    from diffsdfsim_torch.physics import SphereShape, make_body
    from diffsdfsim_tpu.physics import make_body as jmake_body
    from diffsdfsim_tpu.physics import shapes as jshapes
    from diffsdfsim_tpu.physics.contacts import find_contacts as jfind

    spec0, _ = torch_bench_world(drop=0.5 + 5e-4)
    rad = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    bodies = [spec0.bodies[0], make_body(SphereShape(rad), subdiv=2, fric_coeff=0.25, device="cpu")]
    spec, st = torch_bench_world(drop=0.5 + 5e-4, bodies=bodies)
    c = st.contacts
    assert bool(c.valid.any()) and c.p1.requires_grad
    rng = np.random.default_rng(4)
    fields = ("normal", "p1", "p2", "pen")
    cts = [rng.normal(size=tuple(getattr(c, f).shape)) for f in fields]
    sum(torch.sum(getattr(c, f) * torch.tensor(g)) for f, g in zip(fields, cts)).backward()

    floor = jax_body_from_torch(spec.bodies[0])
    quat = jnp.asarray(st.quat.detach().numpy())
    pos = jnp.asarray(st.pos.detach().numpy())

    def jfn(r):
        sphere = jmake_body(jshapes.SphereShape(r), subdiv=2, fric_coeff=0.25)
        jc = jfind([floor, sphere], quat, pos, spec.directed_pairs, spec.n_unordered, jax_cfg(spec))
        return tuple(getattr(jc, f) for f in fields)

    jout, (jg,) = _jax_vjp(jfn, [jnp.asarray(0.5)], tuple(jnp.asarray(g) for g in cts))
    for f, j in zip(fields, jout):
        _rel(getattr(c, f), j, 1e-9, f)
    _rel(rad.grad, jg, 1e-9, "d/drad")
    assert float(rad.grad) != 0.0


def jax_cfg(tspec, **kw):
    from diffsdfsim_tpu.config import SimConfig

    from torch_jax_bridge import BENCH_CFG

    return SimConfig(**{f: getattr(tspec.cfg, f) for f in BENCH_CFG}, **kw)


# ---------------------------------------------------------------- flags


@pytest.mark.parametrize("stop_contact,stop_friction", [(False, False), (True, False), (False, True)])
def test_stop_grad_flags_in_assembly(stop_contact, stop_friction):
    """Fault 3: stop_contact_grad / stop_friction_grad cut the contact
    geometry out of Jc / Jf. d(G, F, h)/d(normal, p1, p2) through one vjp
    against JAX assemble_contact_lcp, 1e-10 relative."""
    from diffsdfsim_torch.physics import engine as teng
    from diffsdfsim_tpu.physics import engine as jeng
    from diffsdfsim_tpu.physics.contacts import Contacts as JContacts

    tspec, tst = torch_bench_world(drop=0.5 + 5e-4, v_sphere=[0.2, -0.1, 0.05, 0.3, -3.0, 0.1])
    cfg = tspec.cfg.replace(stop_contact_grad=stop_contact, stop_friction_grad=stop_friction)
    jc = jax_cfg(tspec, stop_contact_grad=stop_contact, stop_friction_grad=stop_friction)
    c = tst.contacts
    geo = {f: getattr(c, f).detach().clone().requires_grad_() for f in ("normal", "p1", "p2")}
    tc = type(c)(**{**{f: getattr(c, f) for f in c.__dataclass_fields__}, **geo})
    v = tst.v.reshape(-1)
    G, F, h, *_ = teng.assemble_contact_lcp(tspec.bodies, tc, v, cfg)
    rng = np.random.default_rng(5)
    cts = [rng.normal(size=tuple(x.shape)) for x in (G, F, h)]
    sum(torch.sum(x * torch.tensor(g)) for x, g in zip((G, F, h), cts)).backward()

    jbodies = [jax_body_from_torch(b) for b in tspec.bodies]
    base = {f: jnp.asarray(getattr(c, f).detach().numpy()) for f in c.__dataclass_fields__}
    for f in ("i1", "i2", "pair_id"):
        base[f] = base[f].astype(jnp.int32)

    def jfn(n, p1, p2):
        cc = JContacts(**{**base, "normal": n, "p1": p1, "p2": p2})
        return jeng.assemble_contact_lcp(jbodies, cc, jnp.asarray(v.numpy()), jc)[:3]

    _, jg = _jax_vjp(jfn, [base[f] for f in ("normal", "p1", "p2")], tuple(jnp.asarray(g) for g in cts))
    for f, j in zip(("normal", "p1", "p2"), jg):
        _rel(geo[f].grad, j, 1e-10, f)


@pytest.mark.parametrize("detach_b2", [False, True])
def test_contact_recompute_flags(detach_b2):
    """Fault 3: the polish anchor is detached, and detach_contact_b2 cuts
    the body-2-frame contact point. d(normal, p1, p2, pen)/d(poses, anchor)
    of the sphere->floor recompute through one vjp against JAX
    _compute_contacts, 1e-10 relative; the anchor's gradient is zero."""
    from diffsdfsim_torch.physics import contacts as tcon
    from diffsdfsim_tpu.physics import contacts as jcon

    tspec, _ = torch_bench_world()
    floor, sphere = tspec.bodies
    rng = np.random.default_rng(9)
    n = 4
    anchor = rng.normal(size=(n, 3))
    anchor = 0.5 * anchor / np.linalg.norm(anchor, axis=-1, keepdims=True)
    q1 = rng.normal(size=4)
    q1 /= np.linalg.norm(q1)
    inputs = dict(q1=q1, p1=np.array([0.01, 0.499, -0.02]), q2=np.array([1.0, 0, 0, 0]),
                  p2=np.array([0.0, -0.5, 0.0]), anchor=anchor)
    valid = np.array([True, True, False, True])
    t = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    abc = torch.zeros((n, 3), dtype=torch.float64)
    fidx = torch.zeros(n, dtype=torch.long)
    out = tcon._compute_contacts(sphere, t["q1"], t["p1"], floor, t["q2"], t["p2"], abc, fidx,
                                 torch.tensor(valid), 1e-3, detach_b2, True, anchor_b1=t["anchor"])
    cts = [rng.normal(size=tuple(x.shape)) for x in out]
    sum(torch.sum(x * torch.tensor(g)) for x, g in zip(out, cts)).backward()

    jsphere, jfloor = jax_body_from_torch(sphere), jax_body_from_torch(floor)

    def jfn(q1, p1, q2, p2, anchor):
        return jcon._compute_contacts(jsphere, q1, p1, jfloor, q2, p2, jnp.zeros((n, 3)),
                                      jnp.zeros(n, dtype=jnp.int32), jnp.asarray(valid), 1e-3, detach_b2,
                                      True, anchor_b1=anchor)

    jout, jg = _jax_vjp(jfn, [jnp.asarray(v) for v in inputs.values()], tuple(jnp.asarray(g) for g in cts))
    for name, a, j in zip(("normal", "p1", "p2", "pen"), out, jout):
        _rel(a, j, 1e-12, name)
    for (name, tt), j in zip(t.items(), jg):
        _rel(tt.grad if tt.grad is not None else torch.zeros_like(tt), j, 1e-10, name)
    assert t["anchor"].grad is None or float(t["anchor"].grad.abs().max()) == 0.0
