"""Port parity, the contact search (plain version of kernel K3): the port's
``search_pair_raw_plain`` against the JAX package's ``_search_pair_raw_xla``
for both bench directed pairs, float64 on the CPU.

Poses: free flight, touching, penetrating by 1e-3, and a box tilted by
1e-3 rad on the floor (a 4-point manifold). Tolerance: abc, normal, p1, x1,
pen and max_pen within atol 1e-9 (same algorithm, rounding differences);
the contact mask equal; ``cache_from_raw`` selects the same faces, or
faces with the same contact point where several tie exactly.

The JAX side's results (each jitted search compiles for seconds) are read
from ``tests/golden/contacts_jax.pkl``, which
``tests/golden/gen_torch_contacts_golden.py`` writes by running these tests
with the JAX calls live (``torch_jax_bridge.JaxGolden``); regenerate it when
a test's inputs change.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.config import SimConfig as TConfig
from diffsdfsim_torch.physics import BoxShape, contacts as tcon, make_body
from diffsdfsim_tpu.config import SimConfig as JConfig
from diffsdfsim_tpu.physics import contacts as jcon
from torch_jax_bridge import BENCH_CFG, JaxGolden, jax_body_from_torch, one_torch_thread, torch_bench_world  # noqa: F401

ATOL = 1e-9
_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "contacts_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()
RAW = ("cmask", "abc", "n_ng", "p1_ng", "x1", "pen", "max_pen")
CACHE = ("sel_valid", "sel_idx", "x1_sel")
FOUND = ("valid", "i1", "i2", "pair_id", "pair_active", "normal", "p1", "p2", "pen", "max_pen_all")
EYE = [1.0, 0.0, 0.0, 0.0]
FLOOR_POS = [0.0, -0.5, 0.0]


def _tilt(angle):
    return [np.cos(angle / 2), np.sin(angle / 2) * 0.6, 0.0, np.sin(angle / 2) * 0.8]


@pytest.fixture(scope="module")
def bodies():
    """name -> (JAX body, port body) holding the same values."""
    spec, _ = torch_bench_world()
    floor, sphere = spec.bodies
    box = make_body(BoxShape(torch.tensor([0.4, 0.4, 0.4])), subdiv=2, fric_coeff=0.25, device="cpu")
    return {name: (jax_body_from_torch(b), b) for name, b in (("floor", floor), ("sphere", sphere), ("box", box))}


@pytest.fixture(scope="module")
def jax_search(bodies):
    cfg = JConfig(**BENCH_CFG)
    fns = {}

    def get(b1, b2):
        if (b1, b2) not in fns:
            bd1, bd2 = bodies[b1][0], bodies[b2][0]
            fns[b1, b2] = jax.jit(lambda q1, p1, q2, p2: jcon._search_pair_raw_xla(bd1, q1, p1, bd2, q2, p2, cfg))
        return fns[b1, b2]

    return get


CASES = [
    ("sphere", "floor", EYE, [0.0, 0.9, 0.0], "free"),
    ("floor", "sphere", EYE, [0.0, 0.9, 0.0], "free"),
    ("sphere", "floor", EYE, [0.0, 0.5 + 1e-5, 0.0], "touch"),
    ("floor", "sphere", EYE, [0.0, 0.5 + 1e-5, 0.0], "touch"),
    ("sphere", "floor", EYE, [0.03, 0.5 - 1e-3, -0.02], "pen1e-3"),
    ("floor", "sphere", EYE, [0.03, 0.5 - 1e-3, -0.02], "pen1e-3"),
    ("box", "floor", _tilt(1e-3), [0.0, 0.2 - 1e-4, 0.0], "box-4pt"),
]


def _poses(b1, q, p):
    """(q1, p1, q2, p2) with the moving body (not the floor) at (q, p)."""
    if b1 == "floor":
        return EYE, FLOOR_POS, q, p
    return q, p, EYE, FLOOR_POS


@pytest.mark.parametrize("b1,b2,q,p,tag", CASES, ids=[f"{c[0]}->{c[1]}-{c[4]}" for c in CASES])
def test_pair_search_matches_xla(b1, b2, q, p, tag, bodies, jax_search):
    q = list(np.asarray(q) / np.linalg.norm(q))
    q1, p1, q2, p2 = _poses(b1, q, p)

    def jfn():
        raw = jax_search(b1, b2)(*(jnp.asarray(x) for x in (q1, p1, q2, p2)))
        cache = jcon.cache_from_raw(raw, JConfig(**BENCH_CFG))
        return tuple(getattr(raw, f) for f in RAW) + tuple(getattr(cache, f) for f in CACHE)

    out = _from_jax(jfn)
    jraw, jc = dict(zip(RAW, out)), dict(zip(CACHE, out[len(RAW):]))
    cfg = TConfig(**BENCH_CFG)
    tt = lambda x: torch.tensor([x], dtype=torch.float64)
    traw = tcon.search_pair_raw_plain(bodies[b1][1], tt(q1), tt(p1), bodies[b2][1], tt(q2), tt(p2), cfg)
    np.testing.assert_array_equal(traw.cmask[0].numpy(), jraw["cmask"])
    for name in ("abc", "n_ng", "p1_ng", "x1", "pen"):
        np.testing.assert_allclose(getattr(traw, name)[0].numpy(), jraw[name], rtol=0, atol=ATOL, err_msg=name)
    jmp, tmp = float(jraw["max_pen"]), float(traw.max_pen[0])
    assert (np.isinf(jmp) and jmp == tmp) or abs(jmp - tmp) <= ATOL
    if tag == "box-4pt":
        assert int(traw.cmask.sum()) >= 4

    # the filter keeps the same representatives: the same faces, or faces
    # whose contact point is the same point (faces sharing a box corner tie
    # exactly, and rounding picks among them)
    tc = tcon.cache_from_raw(traw, cfg)
    sel = jc["sel_valid"]
    np.testing.assert_array_equal(tc.sel_valid.numpy(), sel)
    tidx, jidx = tc.sel_idx.numpy()[sel], jc["sel_idx"][sel]
    p1 = traw.p1_ng[0].numpy()
    np.testing.assert_allclose(p1[tidx], p1[jidx], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.x1_sel.numpy()[sel], jc["x1_sel"][sel], rtol=0, atol=ATOL)
    if tag == "box-4pt":
        assert int(sel.sum()) == 4


def test_find_contacts_at_contact(bodies):
    """The full search + filter + recompute (with the stability test) and
    the compaction into the global buffer, at the bench touching pose."""
    jcfg, tcfg = JConfig(**BENCH_CFG), TConfig(**BENCH_CFG)
    from diffsdfsim_tpu.physics.world import WorldSpec as JSpec
    from diffsdfsim_torch.physics.world import WorldSpec as TSpec

    jspec = JSpec([bodies["floor"][0], bodies["sphere"][0]], cfg=jcfg)
    tspec = TSpec([bodies["floor"][1], bodies["sphere"][1]], cfg=tcfg)
    quat = np.array([EYE, EYE])
    pos = np.array([FLOOR_POS, [0.01, 0.5 - 5e-4, 0.0]])
    found = _from_jax(lambda: tuple(getattr(jax.jit(lambda q, p: jcon.find_contacts(
        jspec.bodies, q, p, jspec.directed_pairs, jspec.n_unordered, jcfg))(jnp.asarray(quat), jnp.asarray(pos)), f)
        for f in FOUND))
    jc = dict(zip(FOUND, found))
    tc = tcon.find_contacts(tspec.bodies, torch.tensor(quat), torch.tensor(pos), tspec.directed_pairs,
                            tspec.n_unordered, tcfg)
    assert bool(tc.valid.any())
    for name in ("valid", "i1", "i2", "pair_id", "pair_active"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), jc[name], err_msg=name)
    for name in ("normal", "p1", "p2", "pen", "max_pen_all"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), jc[name], rtol=0, atol=ATOL, err_msg=name)


def test_fw_kernel_body_constants_cache():
    """K3's per-body constant block (``fw_cuda.body_consts``: the scale,
    then the normalized kind parameters, zero-padded) is cached by the shape
    parameters' storage and version: reused while ``rad`` is unchanged,
    rebuilt after an in-place update (an optimizer step), and the new block
    holds the new values."""
    from diffsdfsim_torch.ops import fw_cuda
    from diffsdfsim_torch.physics import SphereShape

    kernel = fw_cuda._FwKernel()
    cpu, f64 = torch.device("cpu"), torch.float64
    rad = torch.tensor(0.5, dtype=f64, requires_grad=True)
    sphere, box = SphereShape(rad), BoxShape(torch.tensor([20.0, 1.0, 20.0], dtype=f64))

    def expected(shape):
        vals = torch.stack([shape.scale(), *[torch.as_tensor(v, dtype=f64) for v in shape.kernel_params()]])
        return torch.nn.functional.pad(vals.detach(), (0, fw_cuda.NBODY - vals.numel()))

    c = kernel.consts(sphere, f64, cpu)
    assert torch.equal(c, expected(sphere)) and not c.requires_grad
    assert kernel.consts(sphere, f64, cpu) is c
    assert torch.equal(kernel.consts(box, f64, cpu), expected(box))
    with torch.no_grad():
        rad.add_(0.25)
    c_new = kernel.consts(sphere, f64, cpu)
    assert c_new is not c and torch.equal(c_new, expected(sphere)) and float(c_new[0]) == 1.125
    assert kernel.consts(sphere, f64, cpu) is c_new
