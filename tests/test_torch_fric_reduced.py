"""The reduced friction-structure Schur solve that kernels K1 and K2 run
(``ops/csrc/fric_schur.cuh``), in its plain PyTorch version
``ops/qp.fric_reduced_solve``, on the CPU in float64.

Seeded numpy problems with the physics layout (G = [Jc; Jf; 0] with Jf per
contact [+dirs | -dirs], F the E/mu cone coupling, Q^-1 symmetric positive
definite, d in [0.1, 10]) are solved for S w = hvec and held, within 1e-10
relative to the largest entry, against

- the JAX package's ``_make_fric_ops`` (qp_pallas.py:107-244), called
  directly on CPU arrays (plain ``jnp``, no ``pallas_call``) with base_red and
  mu formed as its wrapper forms them;
- the plain full Schur solve: S assembled and solved by LU
  (``ops/qp._factor_S`` with no structure), and its friction-structured
  Cholesky + Woodbury branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.ops import qp as tqp
from diffsdfsim_tpu.ops.qp_pallas import _make_fric_ops

RTOL = 1e-10


def _problem(neq, k, fd, nb=2, nz=12, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(nb, nz, nz))
    invQ = np.linalg.inv(L @ L.transpose(0, 2, 1) + nz * np.eye(nz))
    invQ = 0.5 * (invQ + invQ.transpose(0, 2, 1))
    Jc = rng.normal(size=(nb, k, nz))
    Jb = rng.normal(size=(nb, k, fd // 2, nz))
    Jf = np.concatenate([Jb, -Jb], axis=2).reshape(nb, k * fd, nz)
    G = np.concatenate([Jc, Jf, np.zeros((nb, k, nz))], axis=1)
    A = rng.normal(size=(nb, neq, nz))
    nineq = k * (2 + fd)
    E = np.repeat(np.eye(k), fd, axis=0)
    F = np.zeros((nb, nineq, nineq))
    F[:, k : k + k * fd, -k:] = E
    F[:, -k:, :k] = np.eye(k) * rng.uniform(0.1, 0.9, size=(nb, 1, k))
    F[:, -k:, k : k + k * fd] = -E.T
    d = np.exp(rng.uniform(np.log(0.1), np.log(10.0), size=(nb, nineq)))
    hvec = rng.normal(size=(nb, neq + nineq))
    return invQ, G, A, F, d, hvec


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _jax_reduced(invQ, G, A, F, d, hvec, neq, k, fd):
    """w = S^-1 hvec by the JAX package's reduced solve, with base_red and mu
    as ``_pdipm_pallas_flat`` forms them; one compiled call (its Gauss-Jordan
    as a loop), which costs less than running the ops one by one."""
    fd2 = fd // 2
    idx = np.concatenate([np.arange(neq + k), neq + k + (np.arange(k * fd2) // fd2) * fd + np.arange(k * fd2) % fd2])

    def solve_S(invQ, G, A, F, d, hvec):
        AG = jnp.concatenate([A, G], axis=-2)
        base = AG @ invQ @ jnp.swapaxes(AG, -1, -2)
        base_red = base[:, idx][:, :, idx]
        mu = jnp.diagonal(F[:, k * (1 + fd) :, :k], axis1=-2, axis2=-1)
        factor, solve = _make_fric_ops(neq, neq, k, fd, neq + G.shape[1], G.shape[0], jnp.float64, base_red, mu,
                                       False)
        return solve(factor(1.0 / d), hvec)

    return jax.jit(solve_S)(invQ, G, A, F, d, hvec)


@pytest.mark.parametrize("neq,k,fd", [(1, 1, 4), (6, 4, 8), (6, 8, 8)])
def test_fric_reduced_solve_matches_jax_and_full_schur(neq, k, fd):
    invQ, G, A, F, d, hvec = _problem(neq, k, fd, seed=neq * 100 + k * 10 + fd)
    t = [torch.tensor(x) for x in (invQ, G, A, F, d, hvec)]
    w = tqp.fric_reduced_solve(*t, ("fric", k, fd)).numpy()

    assert _rel(w, _jax_reduced(invQ, G, A, F, d, hvec, neq, k, fd)) <= RTOL

    AG = torch.cat([t[2], t[1]], dim=-2)
    for structure in (None, ("fric", k, fd)):
        cache = tqp._KKTCache(t[0], AG @ t[0] @ AG.transpose(-1, -2), t[1], t[2], t[3], structure)
        w_full = tqp._solve_S(cache, tqp._factor_S(cache, t[4]), t[5]).numpy()
        assert _rel(w, w_full) <= RTOL, structure


def test_kkt_grad_reduced_refines_tight_cones():
    """``kkt_grad_reduced`` (kernel K2's algorithm: the reduced solve, then
    two refinement steps on the unreduced KKT rows' residual) where every
    friction cone is tight (its d at 3e8, the other rows in [0.1, 10]):
    (dx, dlam, dnu) within 1e-9 relative of the full KKT system's solution
    (numpy's LU, float64), while the reduced solve alone recovers the cone
    rows as d times a difference of its outputs and is off by more than
    1e-6."""
    neq, k, fd = 6, 4, 8
    invQ, G, A, F, d, _ = _problem(neq, k, fd, nb=2, seed=11)
    d[:, -k:] = 3e8
    rx = np.random.default_rng(12).normal(size=(2, 12))
    nz, nineq = 12, G.shape[1]
    n = nz + nineq + neq
    kkt = np.zeros((2, n, n))
    kkt[:, :nz, :nz] = np.linalg.inv(invQ)
    kkt[:, :nz, nz : nz + nineq] = np.swapaxes(G, -1, -2)
    kkt[:, :nz, nz + nineq :] = np.swapaxes(A, -1, -2)
    kkt[:, nz : nz + nineq, :nz] = G
    kkt[:, nz : nz + nineq, nz : nz + nineq] = -(np.eye(nineq) / d[:, None, :] + F)
    kkt[:, nz + nineq :, :nz] = A
    rhs = np.concatenate([-rx, np.zeros((2, nineq + neq))], axis=1)
    ex = np.linalg.solve(kkt, rhs[..., None])[..., 0]
    ex = (ex[:, :nz], ex[:, nz : nz + nineq], ex[:, nz + nineq :])
    t = [torch.tensor(x) for x in (invQ, G, A, F, d, rx)]
    out = tqp.kkt_grad_reduced(*t, ("fric", k, fd))
    assert max(_rel(a.numpy(), r) for a, r in zip(out, ex)) <= 1e-9
    iqrx = np.einsum("bij,bj->bi", invQ, rx)
    hv = np.concatenate([np.einsum("bij,bj->bi", A, iqrx), np.einsum("bij,bj->bi", G, iqrx)], axis=1)
    w = -tqp.fric_reduced_solve(*t[:5], torch.tensor(hv), ("fric", k, fd)).numpy()
    assert _rel(w[:, neq:], ex[1]) > 1e-6
