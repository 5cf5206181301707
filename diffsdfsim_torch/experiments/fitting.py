"""What the fitting experiments share: their draws, optax's update rules,
the gradient-descent loop and the per-lane trajectory losses.

- ``uniform_draws``: each lane's (target, start) pair, uniform in a range,
  from one ``torch.Generator`` seeded from the config, in lane order, so
  lane 0 of a sweep draws what the single run of the same seed draws (the
  draws differ from the JAX package's ``jax.random`` ones);
- ``Adam`` and ``SGD``: ``optax.adam`` / ``optax.sgd`` written out on
  tensors (each element its own Adam count, as ``jnp.where`` over optax's
  state leaves it in a sweep that freezes converged lanes), in plain
  elementwise operations, so a lane of a (B,) parameter steps bitwise as
  the same parameter alone;
- ``descend``: the experiments' loop, ``value_and_grad``, the update, the
  clip to the range and, with ``conv_thresh``, the reference's convergence
  freeze (``optim_sphere.py``): a lane whose loss moved less than the
  threshold since its last step keeps its parameter and optimizer state;
- ``lane_losses``: ``trajectory_loss`` of each lane of a lanes-first
  ``Trajectory`` (``physics/batched.trajectory_lanes_first``).
"""

from __future__ import annotations

import torch

from ..physics.world import Trajectory
from .losses import trajectory_loss


def uniform_draws(seed: int, n: int, lo: float, hi: float, dtype=torch.float64):
    """(targets (n,), starts (n,)) uniform in [lo, hi), lane i drawing its
    target then its start."""
    u = torch.rand((n, 2), generator=torch.Generator().manual_seed(seed), dtype=dtype)
    x = lo + (hi - lo) * u
    return x[:, 0], x[:, 1]


class SGD:
    """``optax.sgd(lr)``: the update is -lr g; no state."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, grad, state):
        return (-self.lr) * grad, state


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): the
    moments, an element-wise count, the bias corrections and the update
    -lr mu_hat / (sqrt(nu_hat) + eps), in optax's order of operations."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        return torch.zeros_like(params), torch.zeros_like(params), torch.zeros_like(params)

    def update(self, grad, state):
        count, mu, nu = state
        mu = (1 - self.b1) * grad + self.b1 * mu
        nu = (1 - self.b2) * (grad * grad) + self.b2 * nu
        count = count + 1
        mu_hat = mu / (1 - torch.pow(self.b1, count))
        nu_hat = nu / (1 - torch.pow(self.b2, count))
        return (-self.lr) * (mu_hat / (torch.sqrt(nu_hat) + self.eps)), (count, mu, nu)


def make_optimizer(name: str, lr: float):
    if name == "Adam":
        return Adam(lr)
    if name == "GD":
        return SGD(lr)
    raise ValueError(f"optimizer {name!r}: GD or Adam")


def descend(value_and_grad, start, opt, max_iter: int, clip=None, conv_thresh=None):
    """Run ``max_iter`` steps from ``start`` (a parameter tensor, with or
    without a lane axis): ``value_and_grad(x) -> (loss, d sum(loss) / dx)``
    with one loss per lane; the update; the clip to ``clip = (lo, hi)``.
    With ``conv_thresh`` a lane is done once |last loss - loss| <
    conv_thresh, tested before its step, and keeps its parameter and
    optimizer state from then on; when every lane is done the histories
    repeat their last entry (the reference breaks there). Returns
    (final x, losses, params after each step, gradients), each history
    stacked on a leading step axis."""
    x = start.detach().clone()
    state = opt.init(x)
    losses, params, grads = [], [], []
    for _ in range(max_iter):
        val, g = value_and_grad(x)
        upd, new_state = opt.update(g, state)
        new_x = x + upd
        if clip is not None:
            new_x = torch.clamp(new_x, *clip)
        if conv_thresh is None:
            x, state = new_x, new_state
        else:
            if not losses:
                last, done = torch.full_like(val, 1e10), torch.zeros_like(val, dtype=torch.bool)
            done = done | (torch.abs(last - val) < conv_thresh)
            x = torch.where(done, x, new_x)
            state = tuple(torch.where(done, a, b) for a, b in zip(state, new_state))
        last = val
        losses.append(val)
        params.append(x)
        grads.append(g)
        if conv_thresh is not None and bool(torch.all(done)):
            break
    pad = max_iter - len(losses)
    hist = lambda xs: torch.stack(xs + xs[-1:] * pad) if xs else torch.zeros((0,) + x.shape, dtype=x.dtype)  # noqa: E731
    return x, hist(losses), hist(params), hist(grads)


def lane(traj: Trajectory, i: int) -> Trajectory:
    """Lane i of a lanes-first Trajectory."""
    return Trajectory(*(t[i] for t in traj))


def lane_losses(traj: Trajectory, target: Trajectory, body: int):
    """(B,) ``trajectory_loss`` of each lane against its target, both
    lanes-first."""
    n = traj.pos.shape[0]
    return torch.stack([trajectory_loss(lane(traj, i), lane(target, i), body=body) for i in range(n)])
