"""Port parity, the analytic 2D narrowphase (``diffsdfsim_torch/physics2d/
narrowphase.py``) and the contact search's 2D backend
(``physics/contacts.search_pair_raw_2d``) against the JAX package, float64
on the CPU.

- ``circle_circle``, ``circle_hull`` (shallow and deep), ``hull_hull`` and
  ``pair_candidates`` at R seeded configurations in one call (the pose
  axis) against the JAX functions at each one: candidates, masks and
  separations within 1e-12; the JAX package's closed-form cases.
- ``search_pair_raw_2d`` against JAX's ``_search_pair_raw_2d`` pose by
  pose: normals, offsets, penetrations, masks and anchors within 1e-12;
  the contact recompute reads the anchors (``pair_uses_anchors``).
- ``test_narrowphase2d.py``'s scenes under both backends against the JAX
  goldens (``tests/golden/scenes2d_f64.npz``): identical decisions, poses
  within 1e-8; under the Frank-Wolfe search up to the first contact
  parting, where a tie must be witnessed (the boxes rest face on face:
  ``scenes2d.hold_to_parting``). The hull-and-circle scene under the search
  (9 s of plain hull searches) runs under ``-m slow``.

The JAX side of the first two groups is read from
``tests/golden/narrowphase2d_jax.pkl`` (``gen_torch_narrowphase2d_golden.py``
runs these tests with the JAX calls live, ``torch_jax_bridge.JaxGolden``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes2d
from diffsdfsim_torch.config import SimConfig
from diffsdfsim_torch.physics import contacts as tcon
from diffsdfsim_torch.physics2d import narrowphase as tnp
from torch_jax_bridge import JaxGolden, jax_body_from_torch, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
_from_jax = JaxGolden(os.path.join(HERE, "golden", "narrowphase2d_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()
ATOL = 1e-12
ATOL_POSE = 1e-8
R = 16


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _jnp2d():
    from diffsdfsim_tpu.physics2d import narrowphase as jnp2d

    return jnp2d


def _hold(t_out, j_out):
    for a, b in zip(t_out, j_out):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def _configs(seed):
    """R seeded planar configurations: centres, radii, two hulls (a pentagon
    and a square, rotated and placed near each other)."""
    rng = np.random.default_rng(seed)
    pent = np.asarray(scenes2d.PARITY_HULL)
    sq = np.asarray(scenes2d.TOP_HULL)
    out = []
    for _ in range(R):
        th = rng.uniform(-np.pi, np.pi, 2)
        rot = [np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]) for t in th]
        ca, cb = rng.uniform(-0.3, 0.3, 2), rng.uniform(-0.3, 0.3, 2) + rng.uniform(0.3, 1.2) * np.array([1.0, 0.4])
        out.append((ca, cb, rng.uniform(0.2, 0.6), rng.uniform(0.2, 0.6), ca + pent @ rot[0].T, cb + sq @ rot[1].T))
    return [np.stack(x) for x in zip(*out)]


def test_circle_circle_matches_jax():
    ca, cb, ra, rb, _, _ = _configs(0)
    j = _from_jax(lambda: jax.vmap(_jnp2d().circle_circle)(*(jnp.asarray(x) for x in (ca, ra, cb, rb))))
    _hold(tnp.circle_circle(_t(ca), _t(ra), _t(cb), _t(rb)), j)


@pytest.mark.parametrize("which", ["pentagon", "square"])
def test_circle_hull_matches_jax(which):
    ca, cb, ra, _, pa, sb = _configs(1)
    c, hull = (cb, pa) if which == "pentagon" else (ca, sb)
    j = _from_jax(lambda: jax.vmap(_jnp2d().circle_hull)(jnp.asarray(c), jnp.asarray(ra), jnp.asarray(hull)))
    out = tnp.circle_hull(_t(c), _t(ra), _t(hull))
    _hold(out, j)
    inside = (j[2] + ra) < 0
    assert 0 < inside.sum() < R or which == "square", "the configurations should cover both branches"


def test_hull_hull_matches_jax():
    _, _, _, _, pa, sb = _configs(2)
    j = _from_jax(lambda: jax.vmap(_jnp2d().hull_hull)(jnp.asarray(pa), jnp.asarray(sb)))
    _hold(tnp.hull_hull(_t(pa), _t(sb)), j)


def test_closed_forms():
    """The JAX package's closed-form cases (test_narrowphase2d.py:25-70)."""
    pts, valid, sep = tnp.circle_circle(_t([0.0, 0.0]), _t(1.0), _t([1.8, 0.0]), _t(1.0))
    assert valid.tolist() == [True, False]
    np.testing.assert_allclose(pts[0].numpy(), [1.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(float(sep), -0.2, atol=1e-12)
    square = _t([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]])
    pts, _, sep = tnp.circle_hull(_t([1.4, 0.2]), _t(0.5), square)
    np.testing.assert_allclose(pts[0].numpy(), [1.0, 0.2], atol=1e-12)
    np.testing.assert_allclose(float(sep), -0.1, atol=1e-12)
    pts, _, sep = tnp.circle_hull(_t([0.8, 0.0]), _t(0.3), square)
    np.testing.assert_allclose(pts[0].numpy(), [1.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(float(sep), -0.5, atol=1e-12)
    top = square * 0.5 + _t([0.3, 1.4])
    pts, valid, sep, _ = tnp.hull_hull(square, top)
    np.testing.assert_allclose(float(sep), -0.1, atol=1e-12)
    np.testing.assert_allclose(np.sort(pts[:, 1].numpy()), [0.9, 0.9], atol=1e-12)
    np.testing.assert_allclose(np.sort(pts[:, 0].numpy()), [-0.2, 0.8], atol=1e-12)


@pytest.fixture(scope="module")
def bodies():
    """The port's planar bodies of the parity scenes (CPU)."""
    from diffsdfsim_torch import physics2d as t2d

    return {"rect": t2d.Rect([8.0, 1.0], device="cpu"), "box": t2d.Rect([1.0, 1.0], device="cpu"),
            "hull": t2d.Hull(scenes2d.PARITY_HULL, device="cpu"), "circle": t2d.Circle(0.4, device="cpu")}


HALF = {"rect": 0.5, "box": 0.5, "hull": 0.55, "circle": 0.4}  # half heights


def _poses(seed, b1, b2):
    """R poses of a pair near contact, body 2 above body 1, slightly
    rotated: quats about z and positions ((2, R, 4), (2, R, 3))."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-0.3, 0.3, (2, R))
    q = np.zeros((2, R, 4))
    q[:, :, 0], q[:, :, 3] = np.cos(th / 2), np.sin(th / 2)
    pos = np.zeros((2, R, 3))
    pos[1, :, 0] = rng.uniform(-0.3, 0.3, R)
    pos[1, :, 1] = HALF[b1] + HALF[b2] + rng.uniform(-0.1, 0.05, R)
    return q, pos


PAIRS = [("rect", "circle"), ("circle", "rect"), ("rect", "hull"), ("hull", "rect"), ("hull", "circle"),
         ("rect", "box"), ("circle", "circle")]


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_search_pair_raw_2d_matches_jax(bodies, pair):
    b1, b2 = pair
    bd1, bd2 = bodies[b1], bodies[b2]
    q, pos = _poses(PAIRS.index(pair), b1, b2)
    cfg = SimConfig(**scenes2d.PARITY_CFG).replace(narrowphase2d=True)
    assert tcon.use_narrowphase2d(bd1, bd2, cfg) and tcon.pair_uses_anchors(bd1, bd2, cfg.replace(
        contact_polish_iters=0))
    out = tcon.search_pair_raw(bd1, _t(q[0]), _t(pos[0]), bd2, _t(q[1]), _t(pos[1]), cfg)

    def jax_side():
        from diffsdfsim_tpu.config import SimConfig as JCfg
        from diffsdfsim_tpu.physics import contacts as jcon

        jb1, jb2 = jax_body_from_torch(bd1), jax_body_from_torch(bd2)
        jcfg = JCfg(**scenes2d.PARITY_CFG).replace(narrowphase2d=True)
        cand = jax.vmap(lambda a, b, c, d: _jnp2d().pair_candidates(jb1, a, b, jb2, c, d))(
            *(jnp.asarray(x) for x in (q[0], pos[0], q[1], pos[1])))
        raw = [jcon._search_pair_raw_2d(jb1, jnp.asarray(q[0, r]), jnp.asarray(pos[0, r]), jb2,
                                        jnp.asarray(q[1, r]), jnp.asarray(pos[1, r]), jcfg) for r in range(R)]
        return cand, tuple(np.stack([np.asarray(getattr(x, k)) for x in raw])
                           for k in ("n_ng", "p1_ng", "pen", "cmask", "max_pen", "x1"))

    cand, raw = _from_jax(jax_side)
    _hold(tnp.pair_candidates(bd1, _t(q[0]), _t(pos[0]), bd2, _t(q[1]), _t(pos[1])), cand)
    _hold((out.n_ng, out.p1_ng, out.pen, out.cmask, out.max_pen, out.x1), raw)
    assert out.cand.tolist() == cand[1].tolist()
    assert bool(out.cmask.any()), "the poses should hold some contact"


@pytest.fixture(scope="module")
def golden():
    with np.load(os.path.join(HERE, "golden", "scenes2d_f64.npz")) as g:
        return dict(g)


@pytest.mark.parametrize("case", ["stack_fw", "stack_analytic", "hulls_analytic",
                                  pytest.param("hulls_fw", marks=pytest.mark.slow)])
def test_parity_scene_matches_jax(golden, case):
    P = scenes2d.namespace("torch", "cpu")
    (spec, state), n = scenes2d.build(P, case)
    _, traj = P.rollout(spec, state, n)
    tr = scenes2d.traj_numpy(traj)
    assert np.isfinite(tr["pos"]).all()
    ok, _, line = scenes2d.hold_run(spec, tr, golden, case, ATOL_POSE)
    print(line)
    assert ok, line
