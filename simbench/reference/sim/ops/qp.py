"""Batched differentiable mixed-LCP / QP solver (primal-dual interior point).

PyTorch counterpart of ``diffsdfsim_tpu/ops/qp.py`` (reference
``lcp_physics/lcp/lcp.py`` + ``lcp/solvers/batch.py:70-231``): a Mehrotra
predictor-corrector interior-point method solving, per batch element,

    min_z  1/2 z'Qz + p'z   s.t.  Gz <= h + Fz,  Az = b,

with gradients by implicit differentiation of the KKT conditions
(``lcp.py:155-213``).

``pdipm_solve_raw`` is the plain version of the port's CUDA kernel K1. It
keeps the JAX XLA path's arithmetic: Q inverted
once by Cholesky, the Schur complement factored per iteration by Cholesky
(``("plain",)``), Cholesky + rank-k Woodbury (``("fric", k, fd)``), or LU
(``None``), best-iterate tracking, a NaN freeze, per-lane not-improved /
eps stopping, and a loop that exits once every lane is done. Like the JAX
``while_loop``, a lane that finished early still gets its last step's
iterate checked for improvement while other lanes keep iterating.

The backward (``_lcp_bwd``) is one KKT solve with right-hand side
(dL/dz, 0, 0, 0) and the outer-product gradients of Q, p, G, h, A, b, F.
``kkt_grad_plain`` is that solve given Q^-1, the plain version of the CUDA
kernel K2; ``LcpSolveFromSolution`` (re-emission of a cached solution, the
replay's solve) is the ``torch.autograd.Function`` around it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _bouter(a, b):
    """Batched outer product a b': (nb,n),(nb,m) -> (nb,n,m)."""
    return a[..., :, None] * b[..., None, :]


def _bmv(M, v):
    """Batched matrix-vector: (nb,n,m),(nb,m) -> (nb,n)."""
    return torch.einsum("...ij,...j->...i", M, v)


def _bmtv(M, v):
    """Batched M' v: (nb,n,m),(nb,n) -> (nb,m)."""
    return torch.einsum("...ij,...i->...j", M, v)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _cho_solve(L, B):
    return torch.cholesky_solve(B, L)


def _cholesky(M):
    """Cholesky factor that is NaN where M is not positive definite, as the
    JAX package's ``jnp.linalg.cholesky`` returns, instead of raising (a
    degenerate contact row, e.g. one with a zero normal, leaves a zero row
    and column in the Schur complement); the solver's best-iterate logic
    then handles the NaN lanes as the reference does."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)


class _KKTCache(NamedTuple):
    invQ: torch.Tensor  # (nb, nz, nz)
    base: torch.Tensor  # (nb, m, m) = [A;G] Q^-1 [A;G]', m = neq+nineq
    G: torch.Tensor
    A: torch.Tensor
    F: torch.Tensor
    structure: tuple | None  # None | ("plain",) | ("fric", k, fd)


def _pre_factor(Q, G, A, F, structure=None):
    """One-time products (reference pre_factor_kkt, batch.py:413-479)."""
    nz = Q.shape[-1]
    Q_chol = _cholesky(Q)
    invQ = _cho_solve(Q_chol, _eye(nz, Q).expand(Q.shape))
    AG = torch.cat([A, G], dim=-2) if A.shape[-2] > 0 else G
    base = AG @ invQ @ AG.transpose(-1, -2)
    return _KKTCache(invQ, base, G, A, F, structure)


def _small_solve(C, r):
    """Solve the tiny (nb,k,k) system by unrolled pivot-free Gauss-Jordan
    with the zero-pivot guard of the JAX package (a healthy pivot is left
    bit-exact; a degenerate one becomes a tiny constant)."""
    k = C.shape[-1]
    tiny = 1e-30 if C.dtype == torch.float32 else 1e-200
    M = torch.cat([C, r[..., None]], dim=-1)
    for i in range(k):
        pv = M[..., i, i][..., None]
        pv = torch.where(torch.abs(pv) < tiny, torch.full_like(pv, tiny), pv)
        piv = M[..., i, :] / pv
        M = M - M[..., :, i][..., None] * piv[..., None, :]
        M[..., i, :] = piv
    return M[..., -1]


class _SFactor(NamedTuple):
    """Factored Schur complement for one diagonal d (see _factor_S)."""

    kind: str  # "lu" | "plain" | "fric"
    mat: torch.Tensor  # "lu": S itself; else the Cholesky factor
    d: torch.Tensor
    Z: torch.Tensor | None = None  # "fric": M^-1 U (Woodbury)
    C: torch.Tensor | None = None  # "fric": I + V' M^-1 U (nb,k,k)
    mu: torch.Tensor | None = None  # "fric": (nb,k)
    dc: torch.Tensor | None = None  # "fric": (nb,k) cone-row d


def _fric_sizes(cache: _KKTCache):
    _, k, fd = cache.structure
    return cache.A.shape[-2], k, k * fd


def _ebig(k, fd, like):
    return torch.repeat_interleave(_eye(k, like), fd, dim=0)  # (nf,k)


def _factor_S(cache: _KKTCache, d):
    """Factor the Schur complement S for a diagonal d = z/s:

    S = [[A Q^-1 A', A Q^-1 G'], [G Q^-1 A', G Q^-1 G' + F + D^-1]].

    "fric" eliminates the K cone rows analytically; the rest is SPD plus a
    rank-K correction, factored by one Cholesky + Woodbury. "plain" (F = 0)
    is SPD outright. Otherwise dense LU."""
    neq = cache.A.shape[-2]
    nineq = cache.G.shape[-2]
    dtype = d.dtype
    if dtype == torch.float32:
        # f32 conditioning cap (ops/qp.py:141-151 of the JAX package); a
        # no-op in f64
        d = torch.clamp(d, min=1e-5, max=1e5)
    dinv = 1.0 / d

    if cache.structure is not None and cache.structure[0] == "fric":
        _, k, nf = _fric_sizes(cache)
        m = neq + k + nf
        fd = nf // k
        dn, df = dinv[..., :k], dinv[..., k : k + nf]
        dc = d[..., k + nf :]
        diag_add = torch.cat(
            [torch.zeros(dn.shape[:-1] + (neq,), dtype=dtype, device=d.device), dn, df], dim=-1
        )
        M = cache.base[..., :m, :m] + _eye(m, d) * diag_add[..., None, :]
        Ebig = _ebig(k, fd, d)
        edce = torch.einsum("ik,...k,jk->...ij", Ebig, dc, Ebig)
        M = M.clone()
        M[..., neq + k :, neq + k :] += edce
        if dtype == torch.float32:
            # f32 PD ridge (JAX ops/qp.py:168-176); a no-op in f64
            diag_scale = torch.amax(torch.abs(torch.diagonal(M, dim1=-2, dim2=-1)), dim=-1)
            M = M + (1e-6 * diag_scale)[..., None, None] * _eye(m, d)
        cholM = _cholesky(M)
        U = torch.cat(
            [
                torch.zeros(dc.shape[:-1] + (neq + k, k), dtype=dtype, device=d.device),
                -(Ebig * dc[..., None, :]),
            ],
            dim=-2,
        )
        Z = _cho_solve(cholM, U)
        mu = torch.diagonal(cache.F[..., k + nf :, :k], dim1=-2, dim2=-1)
        C = _eye(k, d) + mu[..., :, None] * Z[..., neq : neq + k, :]
        return _SFactor("fric", cholM, d, Z=Z, C=C, mu=mu, dc=dc)

    F_pad = cache.F
    if neq > 0:
        F_pad = torch.zeros_like(cache.base)
        F_pad[..., neq:, neq:] = cache.F
    zeros_eq = torch.zeros(dinv.shape[:-1] + (neq,), dtype=dtype, device=d.device)
    S = cache.base + F_pad + _eye(neq + nineq, d) * torch.cat([zeros_eq, dinv], dim=-1)[..., None, :]
    if cache.structure is not None and cache.structure[0] == "plain":
        return _SFactor("plain", _cholesky(S), d)
    return _SFactor("lu", S, d)


def _solve_S(cache: _KKTCache, fac: _SFactor, hvec):
    """Solve S w = hvec with the factored Schur complement."""
    if fac.kind == "lu":
        return torch.linalg.solve(fac.mat, hvec[..., None])[..., 0]
    if fac.kind == "plain":
        return _cho_solve(fac.mat, hvec[..., None])[..., 0]

    neq, k, nf = _fric_sizes(cache)
    Ebig = _ebig(k, nf // k, hvec)
    he = hvec[..., :neq]
    hn = hvec[..., neq : neq + k]
    hf = hvec[..., neq + k : neq + k + nf]
    hc = hvec[..., neq + k + nf :]
    hf2 = hf - torch.einsum("ik,...k->...i", Ebig, fac.dc * hc)
    rhs = torch.cat([he, hn, hf2], dim=-1)
    w0 = _cho_solve(fac.mat, rhs[..., None])[..., 0]
    alpha = _small_solve(fac.C, fac.mu * w0[..., neq : neq + k])
    w = w0 - _bmv(fac.Z, alpha)
    wn = w[..., neq : neq + k]
    wf = w[..., neq + k :]
    wc = fac.dc * (hc - fac.mu * wn + torch.einsum("ik,...i->...k", Ebig, wf))
    return torch.cat([w, wc], dim=-1)


def _solve_kkt_factored(cache: _KKTCache, fac: _SFactor, d, rx, rs, rz, ry):
    """Reduced KKT solve with a prefactored Schur complement (reference
    solve_kkt, batch.py:380-410). Returns (dx, ds, dz, dy)."""
    G, A = cache.G, cache.A
    neq = A.shape[-2]
    invQ_rx = _bmv(cache.invQ, rx)
    h_ineq = _bmv(G, invQ_rx) + rs / d - rz
    if neq > 0:
        hvec = torch.cat([_bmv(A, invQ_rx) - ry, h_ineq], dim=-1)
    else:
        hvec = h_ineq
    w = -_solve_S(cache, fac, hvec)
    w_eq, w_ineq = w[..., :neq], w[..., neq:]
    g1 = -rx - _bmtv(G, w_ineq)
    if neq > 0:
        g1 = g1 - _bmtv(A, w_eq)
    g2 = -rs - w_ineq
    return _bmv(cache.invQ, g1), g2 / d, w_ineq, w_eq


def _solve_kkt(cache: _KKTCache, d, rx, rs, rz, ry):
    return _solve_kkt_factored(cache, _factor_S(cache, d), d, rx, rs, rz, ry)


def _get_step(v, dv):
    """Max step in [0,1] keeping v + a*dv > 0 (reference get_step)."""
    neg = dv < 0
    a = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)), torch.full_like(v, float("inf")))
    return torch.amin(a, dim=-1)


def _residuals(Q, p, G, h, A, b, F, x, s, z, y):
    """(rx, rz, ry, mu, resids) of an iterate (reference batch.py:117-131)."""
    neq = A.shape[-2]
    nineq = G.shape[-2]
    rx = _bmtv(G, z) + _bmv(Q.transpose(-1, -2), x) + p
    if neq > 0:
        rx = rx + _bmtv(A, y)
    rz = _bmv(G, x) + s - h - _bmv(F, z)
    mu = torch.abs(torch.sum(s * z, dim=-1) / nineq)
    pri = torch.linalg.norm(rz, dim=-1)
    ry = _bmv(A, x) - b
    if neq > 0:
        pri = pri + torch.linalg.norm(ry, dim=-1)
    resids = pri + torch.linalg.norm(rx, dim=-1) + nineq * mu
    return rx, rz, ry, mu, resids


def _pdipm_forward(Q, p, G, h, A, b, F, max_iter, eps, not_improved_lim, structure=None):
    """Mehrotra predictor-corrector loop (reference batch.py:70-231)."""
    nb, nineq, nz = G.shape
    neq = A.shape[-2]
    dtype = Q.dtype
    cache = _pre_factor(Q, G, A, F, structure)

    # initialization: one KKT solve with d = 1 (batch.py:84-90)
    d0 = torch.ones((nb, nineq), dtype=dtype, device=Q.device)
    zi = torch.zeros((nb, nineq), dtype=dtype, device=Q.device)
    x, s, z, y = _solve_kkt(cache, d0, p, zi, -h, -b if neq > 0 else b)

    def shift(v):
        m = torch.amin(v, dim=-1, keepdim=True)
        return torch.where(m < 0, v - m + 1.0, v)

    s = shift(s)
    z = shift(z)

    best = [x, s, z, y]
    best_res = torch.full((nb,), torch.finfo(dtype).max, dtype=dtype, device=Q.device)
    n_not_improved = torch.zeros((nb,), dtype=torch.int64, device=Q.device)
    done = torch.zeros((nb,), dtype=torch.bool, device=Q.device)

    def sel(mask, a, b):
        return torch.where(mask[:, None], a, b)

    it = 0
    while it < max_iter and not bool(torch.all(done)):
        rx, rz, ry, mu, resids = _residuals(Q, p, G, h, A, b, F, x, s, z, y)
        rs = z
        if neq == 0:
            ry = ry[:, :0]
        # per-lane best-iterate tracking and stopping (JAX ops/qp.py:338-362)
        improved = resids < best_res
        best = [sel(improved, c, bb) for c, bb in zip((x, s, z, y), best)]
        best_res = torch.where(improved, resids, best_res)
        n_not_improved = torch.where(improved, torch.zeros_like(n_not_improved), n_not_improved + 1)
        new_done = (
            done | (n_not_improved >= not_improved_lim) | (best_res < eps) | (mu > 1e32)
        )

        d = z / s
        fac = _factor_S(cache, d)
        dx_a, ds_a, dz_a, dy_a = _solve_kkt_factored(cache, fac, d, rx, rs, rz, ry)

        alpha = torch.clamp(torch.minimum(_get_step(z, dz_a), _get_step(s, ds_a)), max=1.0)
        t1 = s + alpha[:, None] * ds_a
        t2 = z + alpha[:, None] * dz_a
        sig = (torch.sum(t1 * t2, dim=-1) / torch.sum(s * z, dim=-1)) ** 3

        rs_cor = ((-mu * sig)[:, None] + ds_a * dz_a) / s
        dx_c, ds_c, dz_c, dy_c = _solve_kkt_factored(
            cache, fac, d, torch.zeros_like(x), rs_cor, torch.zeros_like(z), torch.zeros_like(y)
        )

        dx, ds, dz = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c
        alpha = torch.clamp(0.999 * torch.minimum(_get_step(z, dz), _get_step(s, ds)), max=1.0)
        x_new = x + alpha[:, None] * dx
        s_new = s + alpha[:, None] * ds
        z_new = z + alpha[:, None] * dz
        y_new = y + alpha[:, None] * (dy_a + dy_c) if neq > 0 else y

        # NaN guard: freeze on a non-finite step (batch.py:134-137)
        finite = (
            torch.all(torch.isfinite(x_new), dim=-1)
            & torch.all(torch.isfinite(s_new), dim=-1)
            & torch.all(torch.isfinite(z_new), dim=-1)
        )
        keep = done | ~finite
        x, s, z, y = (sel(keep, o, n) for o, n in ((x, x_new), (s, s_new), (z, z_new), (y, y_new)))
        done = new_done | ~finite
        it += 1

    # final best-iterate check on the last iterate
    _, _, _, _, resids = _residuals(Q, p, G, h, A, b, F, x, s, z, y)
    improved = (resids < best_res) & ~done
    bx, bs, bz, by = (sel(improved, c, bb) for c, bb in zip((x, s, z, y), best))
    return bx, by, bz, bs


def pdipm_solve_raw(Q, p, G, h, A, b, F, max_iter=10, eps=1e-12, not_improved_lim=3, structure=None):
    """Forward solve returning the full primal-dual solution (x, y, z, s).

    The plain PyTorch version of the port's CUDA kernel K1."""
    return _pdipm_forward(Q, p, G, h, A, b, F, max_iter, eps, not_improved_lim, structure)


def kkt_grad_plain(invQ, G, A, F, d, rx, structure=None):
    """The backward KKT solve given Q^-1 (reference lcp.py:184-198: rhs
    (rx, 0, 0, 0) at diagonal d), returning (dx, dlam, dnu). The plain
    version of the port's CUDA kernel K2; the
    Schur strategy follows ``structure`` as in the forward."""
    nb, nineq, _ = G.shape
    neq = A.shape[-2]
    AG = torch.cat([A, G], dim=-2) if neq > 0 else G
    cache = _KKTCache(invQ, AG @ invQ @ AG.transpose(-1, -2), G, A, F, structure)
    zi = torch.zeros((nb, nineq), dtype=d.dtype, device=d.device)
    ze = torch.zeros((nb, neq), dtype=d.dtype, device=d.device)
    dx, _, dlam, dnu = _solve_kkt(cache, d, rx, zi, zi, ze)
    return dx, dlam, dnu


def _lcp_bwd(Q, G, A, F, zhat, nu, lam, slack, dl_dzhat, structure, kkt_solve=None):
    """Gradients (dQ, dp, dG, dh, dA, db, dF) of the LCP solution's x
    (JAX ops/qp.py:485-533). ``kkt_solve(Q, G, A, F, d, rx, structure)``,
    where given, takes the place of the plain KKT solve and returns (dx,
    dlam, dnu): the engine passes the analytic-Q^-1 solve, as the JAX
    package's "fric_pallas" branch does."""
    nb, nineq, nz = G.shape
    neq = A.shape[-2]
    # clamp to avoid blow-up on tiny slacks (lcp.py:174-176); in f32 also
    # cap d, a no-op in f64 (JAX ops/qp.py:491-497)
    cap = 1e5 if Q.dtype == torch.float32 else 1e12
    d = torch.clamp(torch.clamp(lam, min=1e-8) / torch.clamp(slack, min=1e-8), max=cap)
    if kkt_solve is not None:
        dx, dlam, dnu = kkt_solve(Q, G, A, F, d, dl_dzhat, structure)
    else:
        cache = _pre_factor(Q, G, A, F, structure)
        zi = torch.zeros((nb, nineq), dtype=Q.dtype, device=Q.device)
        ze = torch.zeros((nb, neq), dtype=Q.dtype, device=Q.device)
        dx, _, dlam, dnu = _solve_kkt(cache, d, dl_dzhat, zi, zi, ze)

    dF = _bouter(dlam, lam)
    dG = _bouter(dlam, zhat) + _bouter(lam, dx)
    if neq > 0:
        dA = _bouter(dnu, zhat) + _bouter(nu, dx)
    else:
        dA = torch.zeros_like(A)
    dQ = 0.5 * (_bouter(dx, zhat) + _bouter(zhat, dx))
    return dQ, dx, dG, -dlam, dA, -dnu, dF


class LcpSolveFromSolution(torch.autograd.Function):
    """Re-emission of a precomputed solution (x, y, z, s) with the exact
    KKT implicit-diff backward (JAX ops/qp.py:550-580). The solution gets no
    gradient; it must come from a solve of the identical problem."""

    @staticmethod
    def forward(ctx, Q, p, G, h, A, b, F, x, y, z, s, structure, kkt_solve):
        ctx.save_for_backward(Q, G, A, F, x, y, z, s)
        ctx.structure, ctx.kkt_solve = structure, kkt_solve
        return x.clone()

    @staticmethod
    def backward(ctx, dl_dx):
        Q, G, A, F, x, y, z, s = ctx.saved_tensors
        grads = _lcp_bwd(Q, G, A, F, x, y, z, s, dl_dx, ctx.structure, ctx.kkt_solve)
        return grads + (None,) * 6


def lcp_solve_from_solution(Q, p, G, h, A, b, F, sol, structure=None, kkt_solve=None):
    """x of the cached solution ``sol`` = (x, y, z, s), differentiable in
    (Q, p, G, h, A, b, F) through the KKT backward (``kkt_solve``: see
    ``_lcp_bwd``)."""
    x, y, z, s = (t.detach() for t in sol)
    return LcpSolveFromSolution.apply(Q, p, G, h, A, b, F, x, y, z, s, structure, kkt_solve)


def blockdiag_inv3(Q):
    """Inverse of a (nb, nz, nz) matrix made of 3x3 diagonal blocks (the
    generalized mass matrix layout), analytic adjugate/det per block."""
    out = torch.zeros_like(Q)
    for i in range(Q.shape[-1] // 3):
        s = slice(3 * i, 3 * i + 3)
        out[:, s, s] = inv3(Q[:, s, s])
    return out


def inv3(B):
    """Analytic inverse of (..., 3, 3) via adjugate/det."""
    a, b, c = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    d, e, f = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    g, h, i = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]
