"""Port parity, the PDIPM forward (plain version of kernel K1): the port's
``pdipm_solve_raw`` with ``structure=("fric", k, fd)`` against the JAX XLA
path on the same LCPs, float64 on the CPU.

Inputs: LCPs of the bench scene at contact (``engine.dump_contact_lcp``)
and +/- structured random LCPs built the way tests/test_qp_fric_reduced.py
builds them, from a numpy seed. Tolerance: x, y, z and s within atol 1e-9
(same Cholesky + Woodbury algorithm; LAPACK rounding differs). On the bench
LCPs the friction duals z and s are not unique (eight pyramid directions
span a 2-D tangent plane), so rounding moves them along the solution set:
there z and s are held at atol 1e-6 and through the KKT residual.

The JAX side's results (each jitted solve compiles for seconds) are read
from ``tests/golden/qp_jax.pkl``, which ``tests/golden/gen_torch_qp_golden.py``
writes by running these tests with the JAX calls live
(``torch_jax_bridge.JaxGolden``); regenerate it when a test's inputs change.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.ops import qp as tqp
from diffsdfsim_torch.ops import qp_cuda
from diffsdfsim_tpu.ops import qp as jqp
from torch_jax_bridge import JaxGolden, one_torch_thread, torch_bench_world  # noqa: F401

ATOL = 1e-9
_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "qp_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


def fric_pm_problem(rng, nb, nz=12, neq=6, k=4, fd=8):
    """Random mixed LCPs with the physics friction layout (Jf per contact
    [+dirs | -dirs], E/mu cone coupling), as numpy."""
    L = rng.normal(size=(nb, nz, nz))
    Q = L @ np.swapaxes(L, -1, -2) + nz * np.eye(nz)
    p = rng.normal(size=(nb, nz))
    Jc = rng.normal(size=(nb, k, nz))
    Jb = rng.normal(size=(nb, k, fd // 2, nz))
    Jf = np.concatenate([Jb, -Jb], axis=2).reshape(nb, k * fd, nz)
    G = np.concatenate([Jc, Jf, np.zeros((nb, k, nz))], axis=1)
    A = rng.normal(size=(nb, neq, nz))
    b = np.zeros((nb, neq))
    mu = rng.uniform(0.1, 0.9, size=(nb, k))
    E = np.repeat(np.eye(k), fd, axis=0)
    nineq = k * (2 + fd)
    F = np.zeros((nb, nineq, nineq))
    F[:, k : k + k * fd, -k:] = E
    F[:, -k:, :k] = mu[:, :, None] * np.eye(k)
    F[:, -k:, k : k + k * fd] = -E.T
    h = np.concatenate([rng.uniform(size=(nb, k)) + 0.5, np.zeros((nb, k * fd + k))], axis=1)
    return Q, p, G, h, A, b, F


@pytest.fixture(scope="module")
def jax_solve():
    return jax.jit(jqp.pdipm_solve_raw, static_argnums=(7, 8, 9, 10))


def bench_contact_lcps():
    """Bench-scene LCPs at contact (assembled by the port's engine, which
    test_torch_engine.py holds against JAX): the sphere within eps of the
    floor, falling at 3 m/s, at three dts and two sphere orientations."""
    from diffsdfsim_torch.physics.engine import dump_contact_lcp

    out = []
    spec, st = torch_bench_world(drop=0.5 + 5e-4, v_sphere=[0.0, 0.0, 0.0, 0.3, -3.0, 0.1])
    assert bool(st.contacts.valid.any())
    for quat in ([1.0, 0, 0, 0], [0.98, 0.1, 0.15, -0.05]):
        q = torch.tensor(quat, dtype=torch.float64)
        st = st._replace(quat=torch.stack([st.quat[0], q / torch.linalg.norm(q)]))
        for dt in (1 / 30, 1 / 60, 1 / 120):
            args, structure = dump_contact_lcp(spec.bodies, spec.joints, spec.forces, st, st.contacts, dt, spec.cfg)
            out.append(([a.numpy() for a in args], structure))
    return out


def _check(args, structure, jax_solve, max_iter=10, eps=1e-12, dual_atol=ATOL):
    jsol = _from_jax(lambda: jax_solve(*[jnp.asarray(a) for a in args], max_iter, eps, 3, structure))
    targs = [torch.tensor(a) for a in args]
    tsol = tqp.pdipm_solve_raw(*targs, max_iter, eps, 3, structure)
    for name, t, j in zip("xyzs", tsol, jsol):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL if name in "xy" else dual_atol,
                                   err_msg=name)
    jres = _from_jax(lambda: jqp.lcp_residuals(*[jnp.asarray(a) for a in args], tuple(jnp.asarray(j) for j in jsol)))
    assert np.all(tqp.lcp_residuals(*targs, tsol).numpy() <= 10 * jres + 1e-12)
    return tsol


def test_bench_contact_lcps(jax_solve):
    for args, structure in bench_contact_lcps():
        _check(args, structure, jax_solve, dual_atol=1e-6)


@pytest.mark.parametrize("neq,k,fd,nb", [(6, 4, 8, 5), (0, 2, 4, 3), (3, 1, 2, 4)])
def test_random_fric_lcps(neq, k, fd, nb, jax_solve):
    rng = np.random.default_rng(neq * 7 + k * 3 + fd)
    _check(fric_pm_problem(rng, nb, neq=neq, k=k, fd=fd), ("fric", k, fd), jax_solve, eps=1e-9)


@pytest.mark.parametrize("structure", [None, ("plain",)])
def test_other_structures(structure, jax_solve):
    """The generic (LU) and plain (Cholesky) Schur paths, on problems
    without friction coupling."""
    rng = np.random.default_rng(3)
    Q, p, G, h, A, b, F = fric_pm_problem(rng, 3, k=2, fd=2)
    G, h = G[:, :2], np.abs(h[:, :2])
    F = np.zeros((3, 2, 2))
    _check((Q, p, G, h, A, b, F), structure, jax_solve, eps=1e-9)


def test_residuals_and_blockdiag_inverse():
    rng = np.random.default_rng(4)
    args = fric_pm_problem(rng, 2)
    sol = tqp.pdipm_solve_raw(*[torch.tensor(a) for a in args], 10, 1e-12, 3, ("fric", 4, 8))
    jres = _from_jax(lambda: jqp.lcp_residuals(*[jnp.asarray(a) for a in args],
                                               tuple(jnp.asarray(s.numpy()) for s in sol)))
    np.testing.assert_allclose(
        tqp.lcp_residuals(*[torch.tensor(a) for a in args], sol).numpy(), np.asarray(jres), rtol=1e-9, atol=1e-14
    )
    from diffsdfsim_tpu.ops.qp_pallas import blockdiag_inv3

    blocks = rng.normal(size=(2, 4, 3, 3)) + 3 * np.eye(3)
    Q = np.zeros((2, 12, 12))
    for i in range(4):
        Q[:, 3 * i : 3 * i + 3, 3 * i : 3 * i + 3] = blocks[:, i]
    np.testing.assert_allclose(tqp.blockdiag_inv3(torch.tensor(Q)).numpy(),
                               _from_jax(lambda: blockdiag_inv3(jnp.asarray(Q))), rtol=0, atol=1e-12)


def test_kernel_wrapper_on_cpu_takes_plain_version():
    """On CPU tensors the K1 wrapper returns the plain version's result and
    launches nothing."""
    rng = np.random.default_rng(5)
    args = [torch.tensor(a) for a in fric_pm_problem(rng, 3)]
    invQ = torch.linalg.inv(args[0])
    before = qp_cuda.pdipm_fric.launches
    out = qp_cuda.pdipm_fric(*args, invQ, 10, 1e-12, 3, ("fric", 4, 8))
    ref = tqp.pdipm_solve_raw(*args, 10, 1e-12, 3, ("fric", 4, 8))
    assert qp_cuda.pdipm_fric.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_kernel_wrapper_validation():
    """What the kernel does not take raises before any launch: other
    structures, an odd friction fan, mixed dtypes, wrong shapes."""
    rng = np.random.default_rng(6)
    args = [torch.tensor(a) for a in fric_pm_problem(rng, 2)]
    invQ = torch.linalg.inv(args[0])
    qp_cuda.check_inputs(*args, invQ, ("fric", 4, 8))
    for structure in (None, ("plain",), ("fric", 4, 3), ("fric", 0, 8)):
        with pytest.raises(ValueError):
            qp_cuda.check_inputs(*args, invQ, structure)
    with pytest.raises(TypeError):
        qp_cuda.check_inputs(*args[:-1], args[-1].float(), invQ, ("fric", 4, 8))
    with pytest.raises(ValueError):
        qp_cuda.check_inputs(*args, invQ[:, :6], ("fric", 4, 8))


def test_degenerate_contact_row_gives_jax_answer(jax_solve):
    """A contact whose rows are all zero (a valid slot with a zero normal)
    with h = 0 makes d infinite and the Schur complement singular: the
    Cholesky factor is NaN there, as JAX's, and the solve returns what
    JAX's returns instead of raising."""
    rng = np.random.default_rng(5)
    k, fd = 2, 4
    Q, p, G, h, A, b, F = fric_pm_problem(rng, 2, neq=3, k=k, fd=fd)
    rows = [0, *range(k, k + fd), k + k * fd]
    G[0, rows] = 0.0
    h[0, rows] = 0.0
    p[0], A[0] = 0.0, 0.0  # x = 0 and s = h: exact zeros, d = z / s infinite
    args = (Q, p, G, h, A, b, F)
    jsol = _from_jax(lambda: jax_solve(*[jnp.asarray(a) for a in args], 10, 1e-9, 3, ("fric", k, fd)))
    tsol = tqp.pdipm_solve_raw(*[torch.tensor(a) for a in args], 10, 1e-9, 3, ("fric", k, fd))
    for name, t, j in zip("xyzs", tsol, jsol):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL, equal_nan=True, err_msg=name)
