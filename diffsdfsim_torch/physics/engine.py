"""Dynamics assembly and the PDIPM engine.

PyTorch counterpart of ``diffsdfsim_tpu/physics/engine.py`` (reference
``PdipmEngine``, ``lcp_physics/physics/engines.py:16-121``, and the matrix
assembly of ``World``/``World3D``):

- M: block-diagonal per-body [R I R', m I3], and its analytic inverse;
- Je: joint rows; Jc: per-contact rows [c x n, n | -(c2 x n), -n]; Jf: the
  friction pyramid with each contact's rows laid out [+dirs | -dirs], the
  layout the PDIPM kernel's reduced solve relies on;
- padded (invalid) contact slots get zero rows and h = 1, strictly feasible
  and inert in the LCP.

``probe_dynamics_batch`` solves one LCP per candidate dt of the probe ladder
in a single batched call, without gradients: the CUDA kernel K1
(``ops/qp_cuda.py``) on CUDA tensors, its plain version on CPU tensors.
Without a valid contact it takes the exact equality-constrained solve
instead. With ``SimConfig.solver_fallback`` a probe solve whose residuals
are too large is solved again, the whole batch in one more K1 launch
(``_fallback``). ``solve_dynamics(lcp_sol=...)`` is the differentiable replay of the
accepted rung: it re-emits the probe's solution through
``lcp_solve_from_solution``, whose backward is the KKT solve (kernel K2 on
CUDA tensors).

The ``*_lanes`` functions are the same assembly for a seed sweep's B worlds
at once (``physics/batched.py``): bodies may carry a lane axis
(``physics/bodies.py``), states and contact buffers carry it first, and the
KKT data is (B, ...). The probe expands it over the D rungs to B D problems,
lane-major, for one K1 launch; the replay's backward is one K2 launch over
the B lanes; ``post_stabilization_lanes`` solves every lane's
post-stabilization LCP in one batched call. Their eager ops do not grow
with B.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..ops import qp_cuda
from ..ops.qp import (
    _small_solve,
    blockdiag_inv3,
    escalated_resolve,
    inv3,
    lcp_solve,
    lcp_solve_from_solution,
    pdipm_solve_raw,
)
from ..utils.quaternion import quat_to_matrix
from ..utils.spherical import normalize, orthogonal
from .contacts import Contacts

_inv3 = inv3


def mass_matrix(bodies, quat):
    """(6B, 6B) block-diagonal generalized mass matrix."""
    nb = len(bodies)
    M = torch.zeros((6 * nb, 6 * nb), dtype=quat.dtype, device=quat.device)
    R = quat_to_matrix(quat)
    for b, bd in enumerate(bodies):
        M[6 * b : 6 * b + 3, 6 * b : 6 * b + 3] = R[b] @ bd.ang_inertia @ R[b].T
        M[6 * b + 3 : 6 * b + 6, 6 * b + 3 : 6 * b + 6] = torch.eye(3, dtype=quat.dtype, device=quat.device) * bd.mass
    return M


def mass_matrix_inv(bodies, quat):
    """(6B, 6B) inverse generalized mass matrix, analytic per 3x3 block."""
    nb = len(bodies)
    Minv = torch.zeros((6 * nb, 6 * nb), dtype=quat.dtype, device=quat.device)
    R = quat_to_matrix(quat)
    for b, bd in enumerate(bodies):
        Minv[6 * b : 6 * b + 3, 6 * b : 6 * b + 3] = _inv3(R[b] @ bd.ang_inertia @ R[b].T)
        Minv[6 * b + 3 : 6 * b + 6, 6 * b + 3 : 6 * b + 6] = torch.eye(3, dtype=quat.dtype, device=quat.device) / bd.mass
    return Minv


def joint_jacobian(joints, nb, state):
    """(neq, 6B) equality Jacobian (reference Je, world.py:414-428)."""
    neq = sum(j.num_constraints for j in joints)
    Je = torch.zeros((neq, 6 * nb), dtype=state.pos.dtype, device=state.pos.device)
    row = 0
    for j in joints:
        J1, J2 = j.rows(state)
        r = j.num_constraints
        Je[row : row + r, 6 * j.body1 : 6 * j.body1 + 6] = J1
        if J2 is not None:
            Je[row : row + r, 6 * j.body2 : 6 * j.body2 + 6] = J2
        row += r
    return Je


def _one_hot(idx, nb, like):
    return torch.nn.functional.one_hot(idx, nb).to(like.dtype)


def _maybe_detach(x, flag: bool):
    return x.detach() if flag else x


def contact_jacobian(contacts: Contacts, nb: int, stop_grad: bool = False):
    """(K, 6B) normal contact Jacobian (world3d.py:56-70); (L, K, 6B) for a
    contact buffer with a lane axis."""
    n, p1, p2 = (_maybe_detach(t, stop_grad) for t in (contacts.normal, contacts.p1, contacts.p2))
    vm = contacts.valid[..., None].to(n.dtype)
    J1 = torch.cat([torch.linalg.cross(p1, n, dim=-1), n], dim=-1) * vm
    J2 = -torch.cat([torch.linalg.cross(p2, n, dim=-1), n], dim=-1) * vm
    oh1, oh2 = _one_hot(contacts.i1, nb, n), _one_hot(contacts.i2, nb, n)
    Jc = torch.einsum("...kb,...kx->...kbx", oh1, J1) + torch.einsum("...kb,...kx->...kbx", oh2, J2)
    return Jc.reshape(Jc.shape[:-2] + (6 * nb,))


def friction_dirs(n, fric_dirs: int):
    """(K, fd, 3) pyramid directions (world3d.py:84-94): [+dirs | -dirs]."""
    dir1 = normalize(orthogonal(n))
    dir2 = normalize(torch.linalg.cross(dir1, n, dim=-1))
    dirs = [dir1, dir2]
    if fric_dirs == 8:
        dir3 = normalize(dir1 + dir2)
        dir4 = normalize(torch.linalg.cross(dir3, n, dim=-1))
        dirs += [dir3, dir4]
    base = torch.stack(dirs, dim=-2)
    return torch.cat([base, -base], dim=-2)


def friction_jacobian(contacts: Contacts, nb: int, fric_dirs: int, stop_grad: bool = False):
    """(K*fd, 6B) friction Jacobian (world3d.py:72-101); (L, K*fd, 6B) for
    a contact buffer with a lane axis."""
    n, p1, p2 = (_maybe_detach(t, stop_grad) for t in (contacts.normal, contacts.p1, contacts.p2))
    k = n.shape[-2]
    vm = contacts.valid[..., None, None].to(n.dtype)
    dirs = friction_dirs(n, fric_dirs) * vm
    J1 = torch.cat([torch.linalg.cross(p1[..., None, :].expand(dirs.shape), dirs, dim=-1), dirs], dim=-1)
    J2 = torch.cat([torch.linalg.cross(p2[..., None, :].expand(dirs.shape), dirs, dim=-1), dirs], dim=-1)
    oh1, oh2 = _one_hot(contacts.i1, nb, n), _one_hot(contacts.i2, nb, n)
    Jf = torch.einsum("...kb,...kdx->...kdbx", oh1, J1) - torch.einsum("...kb,...kdx->...kdbx", oh2, J2)
    return Jf.reshape(Jf.shape[:-4] + (k * fric_dirs, 6 * nb))


def contact_coeffs(contacts: Contacts, bodies):
    """Per-contact friction coefficient and restitution averages."""
    fric = torch.stack([b.fric_coeff for b in bodies])
    rest = torch.stack([b.restitution for b in bodies])
    mu = 0.5 * (fric[contacts.i1] + fric[contacts.i2])
    restitution = 0.5 * (rest[contacts.i1] + rest[contacts.i2])
    return mu, restitution


def apply_forces(bodies, forces, t):
    """(6B,) generalized force vector."""
    out = []
    for bd, flist in zip(bodies, forces):
        f = torch.zeros(6, dtype=bd.mass.dtype, device=bd.mass.device)
        for force in flist:
            f = f + force.force(t, bd)
        out.append(f)
    return torch.cat(out)


def _eq_constrained_solve(Minv, Je, u, b_eq=None):
    """Solve [[M, -Je'], [Je, 0]] [x; y] = [u; b_eq] for x via the joint
    Schur complement (analytic M^-1 + unrolled Gauss-Jordan). ``u`` may be
    (n,) or (D, n)."""
    squeeze = u.dim() == 1
    if squeeze:
        u = u[None]
    Minv_u = u @ Minv.T
    neq = Je.shape[0]
    if neq == 0:
        return Minv_u[0] if squeeze else Minv_u
    S = Je @ Minv @ Je.T
    rhs = Minv_u @ Je.T if b_eq is None else Minv_u @ Je.T - b_eq[None]
    y = -_small_solve(S.expand(rhs.shape[0], neq, neq), rhs)
    x = Minv_u + (y @ Je) @ Minv.T
    return x[0] if squeeze else x


def assemble_contact_lcp(bodies, contacts: Contacts, v, cfg: SimConfig, stop_grads: bool | None = None):
    """Contact-LCP constraint data: G = [Jc; Jf; 0], the friction coupling F
    (reference world.py:493-501) and h = [restitution * Jc v; 0; 0] with
    strictly feasible inert rows for padded slots. The contact geometry is
    detached from Jc / Jf under ``cfg.stop_contact_grad`` /
    ``cfg.stop_friction_grad``, or from both when ``stop_grads`` says so.
    Returns (G, F, h, k, fd, nineq)."""
    nb = v.shape[0] // 6
    dtype, device = v.dtype, v.device
    k = contacts.valid.shape[0]
    fd = cfg.fric_dirs
    nineq = k * (2 + fd)
    sg_c = cfg.stop_contact_grad if stop_grads is None else stop_grads
    sg_f = cfg.stop_friction_grad if stop_grads is None else stop_grads
    Jc = contact_jacobian(contacts, nb, sg_c)
    Jf = friction_jacobian(contacts, nb, fd, sg_f)
    mu, restitution = contact_coeffs(contacts, bodies)

    E = torch.repeat_interleave(torch.eye(k, dtype=dtype, device=device), fd, dim=0)  # (k*fd, k)
    G = torch.cat([Jc, Jf, torch.zeros((k, 6 * nb), dtype=dtype, device=device)])
    F = torch.zeros((nineq, nineq), dtype=dtype, device=device)
    F[k : k + k * fd, -k:] = E
    F[-k:, :k] = torch.diag(mu)
    F[-k:, k : k + k * fd] = -E.T

    hvec = torch.cat([(Jc @ v) * restitution, torch.zeros(k * fd + k, dtype=dtype, device=device)])
    invalid = ~contacts.valid
    pad = torch.cat([invalid, torch.repeat_interleave(invalid, fd), invalid]).to(dtype)
    return G, F, hvec + pad, k, fd, nineq


def _solver_eps(cfg: SimConfig, dtype):
    # the reference eps 1e-12 is below f32 resolution: floor it there
    # (engine.py:418 of the JAX package)
    return cfg.solver_eps if dtype == torch.float64 else max(cfg.solver_eps, 1e-6)


def dump_contact_lcp(bodies, joints, forces, state, contacts: Contacts, dt, cfg: SimConfig):
    """The (Q, p, G, h, A, b, F) batch-of-1 mixed LCP ``solve_dynamics``
    hands the solver at this state, with its structure tag."""
    nb = len(bodies)
    v = state.v.reshape(-1)
    M = mass_matrix(bodies, state.quat)
    Je = joint_jacobian(joints, nb, state)
    u = M @ v + dt * apply_forces(bodies, forces, state.t)
    G, F, hvec, k, fd, _ = assemble_contact_lcp(bodies, contacts, v, cfg)
    neq = Je.shape[0]
    return (
        M[None], u[None], G[None], hvec[None], Je[None],
        torch.zeros((1, neq), dtype=v.dtype, device=v.device), F[None],
    ), ("fric", k, fd)


def solve_dynamics(bodies, joints, forces, state, contacts: Contacts, dt, cfg: SimConfig,
                   lcp_sol=None, return_sol: bool = False, any_contact: bool | None = None):
    """New generalized velocities after the impulse solve (engines.py:31-83).

    ``return_sol=True`` also returns the primal-dual solution (x, y, z, s);
    ``lcp_sol`` re-emits a cached solution instead of solving, with the
    KKT implicit-diff backward. ``any_contact`` may pass the host's
    knowledge of whether a contact is valid (saving a device sync)."""
    nb = len(bodies)
    dtype, device = state.v.dtype, state.v.device
    v = state.v.reshape(-1)
    M = mass_matrix(bodies, state.quat)
    Je = joint_jacobian(joints, nb, state)
    neq = Je.shape[0]
    u = M @ v + dt * apply_forces(bodies, forces, state.t)
    k = contacts.valid.shape[0]
    nineq = k * (2 + cfg.fric_dirs)

    def zero_sol():
        z = lambda n: torch.zeros((1, n), dtype=dtype, device=device)
        return z(6 * nb), z(neq), z(nineq), z(nineq)

    if any_contact is None:
        any_contact = bool(torch.any(contacts.valid))
    if not any_contact:
        x = _eq_constrained_solve(mass_matrix_inv(bodies, state.quat), Je, u)
        _, zy, zz, zs = zero_sol()
        sol = (-x[None], zy, zz, zs)
        return (x, sol) if return_sol else x

    G, F, hvec, _, fd, _ = assemble_contact_lcp(bodies, contacts, v, cfg)
    args = (M[None], u[None], G[None], hvec[None], Je[None],
            torch.zeros((1, neq), dtype=dtype, device=device), F[None])
    structure = ("fric", k, fd)
    if lcp_sol is not None:
        x = lcp_solve_from_solution(*args, lcp_sol, structure, kkt_solve=_replay_kkt_solve)
        sol = lcp_sol
    else:
        sol = pdipm_solve_raw(*args, cfg.solver_max_iter, _solver_eps(cfg, dtype), 3, structure)
        x = sol[0]
    new_v = -x[0, : 6 * nb]
    return (new_v, sol) if return_sol else new_v


def _replay_kkt_solve(Q, G, A, F, d, rx, structure):
    """The replay backward's KKT solve (JAX "fric_pallas"): Q is the
    block-diagonal mass matrix, so its inverse is analytic, and the solve is
    kernel K2 on CUDA tensors, its plain version on CPU tensors."""
    return qp_cuda.kkt_grad_fric(blockdiag_inv3(Q), G, A, F, d, rx, structure)


def _fallback(args, invQ, sol, cfg: SimConfig, eps, structure, read):
    """``cfg.solver_fallback``'s re-solve of a probe's batch (JAX
    engine.py:436-447): K1 again, at ``solver_fallback_iters``, when a
    residual exceeds ``solver_fallback_thresh``; ``read`` takes the trigger
    to the host (one read per probe solve while the flag is on)."""
    if not cfg.solver_fallback:
        return sol
    return escalated_resolve(*args, invQ, sol, iters_hi=cfg.solver_fallback_iters, eps=eps,
                             thresh=cfg.solver_fallback_thresh, structure=structure, read=read)


def probe_dynamics_batch(bodies, joints, forces, state, contacts: Contacts, dts, cfg: SimConfig,
                         any_contact: bool | None = None, *, read_fallback):
    """Dynamics solve for a ladder of D candidate timesteps in one batched
    call: the KKT data (M, Je, Jc, Jf, F, h) is dt-independent; only
    u = M v + dt f varies. Returns (new_vs (D, 6B), sol) with sol leaves of
    leading D. ``any_contact`` may pass the host's knowledge of whether a
    contact is valid (saving a device sync); ``read_fallback`` reads the
    solver fallback's trigger (see ``_fallback``)."""
    nb = len(bodies)
    dtype, device = state.v.dtype, state.v.device
    v = state.v.reshape(-1)
    n = 6 * nb
    D = dts.shape[0]
    M = mass_matrix(bodies, state.quat)
    Je = joint_jacobian(joints, nb, state)
    neq = Je.shape[0]
    u = M @ v + dts[:, None] * apply_forces(bodies, forces, state.t)  # (D, n)
    k = contacts.valid.shape[0]
    fd = cfg.fric_dirs
    nineq = k * (2 + fd)
    Minv = mass_matrix_inv(bodies, state.quat)

    if any_contact is None:
        any_contact = bool(torch.any(contacts.valid))
    if not any_contact:
        x = _eq_constrained_solve(Minv, Je, u)
        z = lambda m: torch.zeros((D, m), dtype=dtype, device=device)
        return x, (-x, z(neq), z(nineq), z(nineq))

    G, F, hvec, _, _, _ = assemble_contact_lcp(bodies, contacts, v, cfg, stop_grads=True)
    bc = lambda a: a.expand((D,) + a.shape)
    args = (bc(M), u, bc(G), bc(hvec), bc(Je), torch.zeros((D, neq), dtype=dtype, device=device), bc(F))
    eps, structure = _solver_eps(cfg, dtype), ("fric", k, fd)
    sol = qp_cuda.pdipm_fric(*args, bc(Minv), cfg.solver_max_iter, eps, 3, structure)
    sol = _fallback(args, bc(Minv), sol, cfg, eps, structure, read_fallback)
    return -sol[0][:, :n], sol


def post_stabilization(bodies, joints, state, contacts: Contacts, cfg: SimConfig):
    """Positional correction velocities (engines.py:85-121)."""
    nb = len(bodies)
    dtype, device = state.v.dtype, state.v.device
    v = state.v.reshape(-1)
    Je = joint_jacobian(joints, nb, state)
    neq = Je.shape[0]
    ge = Je @ v
    if not bool(torch.any(contacts.valid)):
        x = _eq_constrained_solve(
            mass_matrix_inv(bodies, state.quat), Je, torch.zeros(6 * nb, dtype=dtype, device=device), b_eq=ge
        )
        return -x
    M = mass_matrix(bodies, state.quat)
    Jc = contact_jacobian(contacts, nb, cfg.stop_contact_grad)
    _, restitution = contact_coeffs(contacts, bodies)
    gc = (Jc @ v) + (Jc @ v) * -restitution + (~contacts.valid).to(dtype)
    k = Jc.shape[0]
    x = lcp_solve(
        M[None], torch.zeros((1, 6 * nb), dtype=dtype, device=device), Jc[None], gc[None],
        Je[None], ge[None], torch.zeros((1, k, k), dtype=dtype, device=device),
        cfg.solver_max_iter, cfg.solver_eps, 3, ("plain",),
    )
    return -x[0, : 6 * nb]


# ---------------------------------------------------------------- lanes


def body_lanes(bodies, name: str, B: int):
    """(B, nb, ...) of a per-body tensor (``mass``, ``ang_inertia``,
    ``fric_coeff``, ``restitution``) over the lanes."""
    return torch.stack([getattr(bd, name) if bd.lanes else getattr(bd, name).expand(
        (B,) + getattr(bd, name).shape) for bd in bodies], dim=1)


def mass_matrix_lanes(bodies, quat):
    """(B, 6nb, 6nb) mass matrices and their analytic inverses of B worlds
    (quat (B, nb, 4))."""
    B, nb = quat.shape[:2]
    dtype, device = quat.dtype, quat.device
    R = quat_to_matrix(quat)
    inert = body_lanes(bodies, "ang_inertia", B)
    mass = body_lanes(bodies, "mass", B)
    rot = R @ inert @ R.transpose(-1, -2)  # (B, nb, 3, 3)
    eye = torch.eye(3, dtype=dtype, device=device)
    M = torch.zeros((B, 6 * nb, 6 * nb), dtype=dtype, device=device)
    Minv = torch.zeros_like(M)
    rot_inv = _inv3(rot)
    for b in range(nb):
        s, t = slice(6 * b, 6 * b + 3), slice(6 * b + 3, 6 * b + 6)
        M[:, s, s] = rot[:, b]
        M[:, t, t] = eye * mass[:, b, None, None]
        Minv[:, s, s] = rot_inv[:, b]
        Minv[:, t, t] = eye / mass[:, b, None, None]
    return M, Minv


def joint_jacobian_lanes(joints, nb, state):
    """(B, neq, 6nb) joint rows of B worlds (``state`` with a lane axis);
    a joint's rows come from its ``rows`` mapped over the lanes."""
    B = state.pos.shape[0]
    neq = sum(j.num_constraints for j in joints)
    Je = torch.zeros((B, neq, 6 * nb), dtype=state.pos.dtype, device=state.pos.device)
    row = 0
    for j in joints:
        rows = torch.func.vmap(lambda q, p: tuple(J for J in j.rows(_PoseState(q, p)) if J is not None))(
            state.quat, state.pos)
        r = j.num_constraints
        Je[:, row : row + r, 6 * j.body1 : 6 * j.body1 + 6] = rows[0]
        if len(rows) > 1:
            Je[:, row : row + r, 6 * j.body2 : 6 * j.body2 + 6] = rows[1]
        row += r
    return Je


class _PoseState(NamedTuple):
    quat: torch.Tensor
    pos: torch.Tensor


def apply_forces_lanes(bodies, forces, t):
    """(B, 6nb) generalized forces of B worlds at their times t (B,).
    ``forces`` holds a lane axis on its tensor attributes where they differ
    per lane (``physics/forces.py``)."""
    B = t.shape[0]
    out = []
    for bd, flist in zip(bodies, forces):
        f = torch.zeros((B, 6), dtype=t.dtype, device=t.device)
        for force in flist:
            f = f + force.force(t, bd)
        out.append(f)
    return torch.cat(out, dim=-1)


def assemble_contact_lcp_lanes(bodies, contacts: Contacts, v, cfg: SimConfig, stop_grads: bool | None = None):
    """``assemble_contact_lcp`` for B worlds: contacts (B, K, ...), v (B,
    6nb). Returns (G, F, h, k, fd, nineq) with G, F, h carrying the lane
    axis."""
    B, n = v.shape
    nb = n // 6
    dtype, device = v.dtype, v.device
    k = contacts.valid.shape[-1]
    fd = cfg.fric_dirs
    nineq = k * (2 + fd)
    sg_c = cfg.stop_contact_grad if stop_grads is None else stop_grads
    sg_f = cfg.stop_friction_grad if stop_grads is None else stop_grads
    Jc = contact_jacobian(contacts, nb, sg_c)
    Jf = friction_jacobian(contacts, nb, fd, sg_f)
    fric = body_lanes(bodies, "fric_coeff", B)
    rest = body_lanes(bodies, "restitution", B)
    mu = 0.5 * (torch.gather(fric, 1, contacts.i1) + torch.gather(fric, 1, contacts.i2))
    restitution = 0.5 * (torch.gather(rest, 1, contacts.i1) + torch.gather(rest, 1, contacts.i2))

    E = torch.repeat_interleave(torch.eye(k, dtype=dtype, device=device), fd, dim=0)  # (k*fd, k)
    G = torch.cat([Jc, Jf, torch.zeros((B, k, n), dtype=dtype, device=device)], dim=1)
    F = torch.zeros((B, nineq, nineq), dtype=dtype, device=device)
    F[:, k : k + k * fd, -k:] = E
    F[:, -k:, :k] = torch.diag_embed(mu)
    F[:, -k:, k : k + k * fd] = -E.T

    jv = (Jc @ v[:, :, None])[..., 0]
    hvec = torch.cat([jv * restitution, torch.zeros((B, k * fd + k), dtype=dtype, device=device)], dim=1)
    invalid = ~contacts.valid
    pad = torch.cat([invalid, torch.repeat_interleave(invalid, fd, dim=1), invalid], dim=1).to(dtype)
    return G, F, hvec + pad, k, fd, nineq


def _eq_constrained_solve_lanes(Minv, Je, u, b_eq=None):
    """``_eq_constrained_solve`` for B worlds: Minv (B, n, n), Je (B, neq,
    n), u (B, D, n), b_eq (B, neq) -> x (B, D, n)."""
    Minv_u = u @ Minv.transpose(-1, -2)
    neq = Je.shape[-2]
    if neq == 0:
        return Minv_u
    B, D, _ = u.shape
    S = Je @ Minv @ Je.transpose(-1, -2)
    rhs = Minv_u @ Je.transpose(-1, -2)
    if b_eq is not None:
        rhs = rhs - b_eq[:, None]
    y = -_small_solve(S[:, None].expand(B, D, neq, neq).reshape(B * D, neq, neq), rhs.reshape(B * D, neq))
    return Minv_u + (y.reshape(B, D, neq) @ Je) @ Minv.transpose(-1, -2)


def _lane_select(pred, a, b):
    """Per-lane select of a over b (leading lane axis), pred (B,)."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)


def probe_dynamics_lanes(bodies, joints, forces, state, dts, cfg: SimConfig, any_contact: bool, *, read_fallback):
    """``probe_dynamics_batch`` for B worlds: dts (B, D), the state with a
    lane axis. One K1 launch over the B D problems (lane-major) when the
    host knows some lane starts with a contact (``any_contact``), and the
    solver fallback's one re-solve of them all when it triggers; each lane
    takes the LCP's solution or, without a valid contact, the exact
    equality-constrained solve, as the JAX package's vmapped ``lax.cond``
    selects. Returns (new_vs (B, D, 6nb), sol with leaves (B, D, ...))."""
    B, nb = state.pos.shape[:2]
    n = 6 * nb
    D = dts.shape[1]
    dtype, device = state.v.dtype, state.v.device
    v = state.v.reshape(B, n)
    M, Minv = mass_matrix_lanes(bodies, state.quat)
    Je = joint_jacobian_lanes(joints, nb, state)
    neq = Je.shape[1]
    u = (M @ v[:, :, None])[:, None, :, 0] + dts[:, :, None] * apply_forces_lanes(bodies, forces, state.t)[:, None]
    k = state.contacts.valid.shape[-1]
    fd = cfg.fric_dirs
    nineq = k * (2 + fd)
    x_eq = _eq_constrained_solve_lanes(Minv, Je, u)
    z = lambda m: torch.zeros((B, D, m), dtype=dtype, device=device)  # noqa: E731
    sol_eq = (-x_eq, z(neq), z(nineq), z(nineq))
    if not any_contact:
        return x_eq, sol_eq

    G, F, hvec, _, _, _ = assemble_contact_lcp_lanes(bodies, state.contacts, v, cfg, stop_grads=True)
    bc = lambda a: a[:, None].expand((B, D) + a.shape[1:]).reshape((B * D,) + a.shape[1:])  # noqa: E731
    args = (bc(M), u.reshape(B * D, n), bc(G), bc(hvec), bc(Je), torch.zeros((B * D, neq), dtype=dtype, device=device),
            bc(F))
    eps, structure = _solver_eps(cfg, dtype), ("fric", k, fd)
    sol = qp_cuda.pdipm_fric(*args, bc(Minv), cfg.solver_max_iter, eps, 3, structure)
    sol = _fallback(args, bc(Minv), sol, cfg, eps, structure, read_fallback)
    sol = tuple(x.reshape((B, D) + x.shape[1:]) for x in sol)
    contact = torch.any(state.contacts.valid, dim=-1)
    sol = tuple(_lane_select(contact, a, b) for a, b in zip(sol, sol_eq))
    return -sol[0][..., :n], sol


def post_stabilization_lanes(bodies, joints, state, contacts: Contacts, cfg: SimConfig, any_contact: bool):
    """``post_stabilization`` of B worlds (the state and contact buffer with
    a lane axis): one batched solve of every lane's contact LCP (F = 0, the
    ``("plain",)`` structure, as the JAX package's vmapped ``lcp_solve``:
    its XLA solver, not the PDIPM kernel) when the host knows some lane has
    a valid contact (``any_contact``); a lane without a valid contact takes
    the exact equality-constrained solve. Returns (B, 6nb)."""
    B, nb = state.pos.shape[:2]
    n = 6 * nb
    dtype, device = state.v.dtype, state.v.device
    v = state.v.reshape(B, n)
    M, Minv = mass_matrix_lanes(bodies, state.quat)
    Je = joint_jacobian_lanes(joints, nb, state)
    ge = (Je @ v[:, :, None])[..., 0]
    x_eq = _eq_constrained_solve_lanes(Minv, Je, torch.zeros((B, 1, n), dtype=dtype, device=device), b_eq=ge)[:, 0]
    if not any_contact:
        return -x_eq
    Jc = contact_jacobian(contacts, nb, cfg.stop_contact_grad)
    rest = body_lanes(bodies, "restitution", B)
    restitution = 0.5 * (torch.gather(rest, 1, contacts.i1) + torch.gather(rest, 1, contacts.i2))
    jv = (Jc @ v[:, :, None])[..., 0]
    gc = jv + jv * -restitution + (~contacts.valid).to(dtype)
    k = Jc.shape[1]
    x = lcp_solve(M, torch.zeros((B, n), dtype=dtype, device=device), Jc, gc, Je, ge,
                  torch.zeros((B, k, k), dtype=dtype, device=device), cfg.solver_max_iter, cfg.solver_eps, 3,
                  ("plain",))
    return _lane_select(torch.any(contacts.valid, dim=-1), -x[:, :n], -x_eq)


def replay_dynamics_lanes(bodies, joints, forces, state, dt, cfg: SimConfig, lcp_sol, any_contact: bool):
    """The replay's step velocities (B, 6nb) of B worlds at their dts (B,):
    the cached solutions' values (``-x``), taped through the LCP's KKT
    backward (one K2 launch over the B lanes) for a lane with a contact and
    through the exact equality-constrained solve for one without
    (``solve_dynamics(lcp_sol=...)`` per lane)."""
    B, nb = state.pos.shape[:2]
    n = 6 * nb
    dtype, device = state.v.dtype, state.v.device
    v = state.v.reshape(B, n)
    M, Minv = mass_matrix_lanes(bodies, state.quat)
    Je = joint_jacobian_lanes(joints, nb, state)
    neq = Je.shape[1]
    u = (M @ v[:, :, None])[..., 0] + dt[:, None] * apply_forces_lanes(bodies, forces, state.t)
    v_val = -lcp_sol[0][:, :n]
    # the exact solve recomputed here may round differently from the probe's
    new_v = _Emit.apply(_eq_constrained_solve_lanes(Minv, Je, u[:, None])[:, 0], v_val)
    if not any_contact:
        return new_v
    G, F, hvec, k, fd, _ = assemble_contact_lcp_lanes(bodies, state.contacts, v, cfg)
    args = (M, u, G, hvec, Je, torch.zeros((B, neq), dtype=dtype, device=device), F)
    x = lcp_solve_from_solution(*args, lcp_sol, ("fric", k, fd), kkt_solve=_replay_kkt_solve)
    return _lane_select(torch.any(state.contacts.valid, dim=-1), -x[:, :n], new_v)


class _Emit(torch.autograd.Function):
    """The value of ``value`` with the gradient of ``inline``: re-emits a
    value the probe computed while the tape records its differentiable
    recomputation (the JAX package's emission replay, world.py:434-513),
    whose last bits may differ."""

    @staticmethod
    def forward(ctx, inline, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None
