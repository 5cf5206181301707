"""The seed sweep that the JAX package shards over a device mesh, built in
either package.

``tests/test_sharding.py`` and ``__graft_entry__.dryrun_multichip`` drop a
sphere of radius ``rad`` from height ``drop`` onto a fixed 20 x 1 x 20 floor
box (gravity 10, friction 0.25, dt 1/30) and take ``value_and_grad`` of the
loss ``sum(pos[..., sphere, :]**2 * valid)`` over the frames, one lane per
seed. The module imports numpy alone, so the JAX golden generator
(``tests/golden/gen_torch_sharding_golden.py``), the CPU test
(``tests/test_torch_sharding.py``) and ``chip_smoke.py`` (the port alone)
share it. Its functions are at module level because the port's sharded
sweep pickles them into its worker processes.

``SIZES``:

- ``cpu``: the JAX tests' small configuration (``fric_dirs=4``, 2 contacts,
  floor and sphere subdivisions 2 and 1, ``max_substeps=2``,
  ``max_bisect=3``) at 8 seeds and 14 frames (at the JAX test's 2 frames no
  lane has touched the floor; at 14 every lane has);
- ``card``: ``__graft_entry__._bounce_loss(bench_scale=True)``, the bench's
  configuration (``fric_dirs=8``, 4 contacts, subdivisions 3 and 2,
  ``max_substeps=4``, ``max_bisect=8``), at 16 seeds and 20 frames, past
  every lane's touchdown;
- ``jax_test`` and ``bench_2``: the small and the bench configuration at the
  JAX tests' own 8 seeds and 2 frames (``tests/test_sharding.py``).

The seeds are ``rads = linspace(0.4, 0.7, n)``, ``drops = linspace(1.0,
1.5, n)`` (numpy's, fed to both packages).
"""

import functools
import types

import numpy as np

SIZES = {
    "cpu": dict(cfg=dict(fric_dirs=4, max_contacts_per_pair=2, max_contacts_total=2, mesh_subdiv=1, max_substeps=2,
                         max_bisect=3),
                subdiv=(2, 1), lanes=8, frames=14),
    "card": dict(cfg=dict(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=2, max_substeps=4,
                          max_bisect=8, substep_unroll=4),
                 subdiv=(3, 2), lanes=16, frames=20),
}
SIZES["jax_test"] = dict(SIZES["cpu"], frames=2)
SIZES["bench_2"] = dict(SIZES["card"], lanes=8, frames=2)
LR = 1e-3  # dryrun_multichip's simulated update: rad - LR * d loss / d rad
DECISIONS = ("valid", "n_halvings", "bisect_failed", "truncated")
FLOOR_POSE = [1.0, 0, 0, 0, 0.0, -0.5, 0.0]
SPHERE_POSE = [1.0, 0, 0, 0, 0.0, 0.0, 0.0]  # its height is the seed's drop


def seeds(size):
    """(rads, drops) of a size's lanes (numpy float64)."""
    n = SIZES[size]["lanes"]
    return np.linspace(0.4, 0.7, n), np.linspace(1.0, 1.5, n)


# ---------------------------------------------------------------- JAX


def jax_world(size, rad, drop):
    """The JAX package's (spec, state) of one seed."""
    import jax.numpy as jnp

    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world

    sz = SIZES[size]
    floor = make_body(BoxShape(jnp.array([20.0, 1.0, 20.0])), subdiv=sz["subdiv"][0], fric_coeff=0.25)
    sphere = make_body(SphereShape(rad), subdiv=sz["subdiv"][1], fric_coeff=0.25)
    poses = jnp.array([FLOOR_POSE, SPHERE_POSE]).at[1, 5].set(drop)
    return make_world([floor, sphere], poses, jnp.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**sz["cfg"]))


def jax_loss(size):
    """``tests/test_sharding.py``'s per-seed loss over the size's frames:
    ``loss((rad, drop))``, for ``batched_rollout(jax.value_and_grad(loss))``."""
    import jax.numpy as jnp

    from diffsdfsim_tpu.physics import rollout

    def loss(args):
        _, traj = rollout(*jax_world(size, *args), n_frames=SIZES[size]["frames"])
        return jnp.sum(traj.pos[:, :, 1, :] ** 2 * traj.valid[:, :, None])

    return loss


def jax_seed_step(size, rads, drops):
    """``dryrun_multichip``'s ``seed_step`` over the size's frames: the
    batched-native rollout of every seed, each lane's loss, d loss / d rad
    and the updated radii; with the trajectory's discrete decisions, lanes
    first. Returns a dict of arrays with a leading lane axis."""
    import jax
    import jax.numpy as jnp

    from diffsdfsim_tpu.physics import make_world_batched, rollout_batched

    def f(r):
        spec, bodies_b, state_b = make_world_batched(functools.partial(jax_world, size), r, drops)
        _, traj = rollout_batched(spec, bodies_b, state_b, SIZES[size]["frames"])
        losses = jnp.sum(traj.pos[:, :, :, 1, :] ** 2 * traj.valid[..., None], axis=(0, 1, 3))
        return jnp.sum(losses), (losses, traj)

    (_, (vals, traj)), g = jax.value_and_grad(f, has_aux=True)(rads)
    out = dict(loss=vals, d_rad=g, rad=rads - LR * g)
    for key in DECISIONS:
        x = getattr(traj, key)
        out[key] = jnp.moveaxis(x, 1 if key == "truncated" else 2, 0)
    return out


# ---------------------------------------------------------------- the port

_FLOORS = {}


def torch_world(size, rad, drop, device):
    """The port's (spec, state) of one seed on ``device`` (``rad`` and
    ``drop`` tensors there); the floor, the same in every lane and
    requiring no grad, is built once per size and device in a process."""
    import torch

    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world

    sz = SIZES[size]
    key = (size, str(device))
    if key not in _FLOORS:
        _FLOORS[key] = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=sz["subdiv"][0], fric_coeff=0.25,
                                 device=device)
    sphere = make_body(SphereShape(rad), subdiv=sz["subdiv"][1], fric_coeff=0.25, device=device)
    poses = torch.tensor([FLOOR_POSE, SPHERE_POSE], dtype=torch.float64, device=device)
    poses[1, 5] = drop
    return make_world([_FLOORS[key], sphere], poses, np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**sz["cfg"]), device=device)


def seed_step(size, batch):
    """The port's counterpart of ``dryrun_multichip``'s ``seed_step`` and of
    ``tests/test_sharding.py``'s ``vmap(value_and_grad(loss))``, for
    ``diffsdfsim_torch.parallel.batched_rollout(..., has_aux=True)``: the
    batched-native rollout of the lanes ``batch = (rads, drops)`` (on their device)
    over the size's frames, fwd+bwd. Returns (outputs, aux): outputs a dict
    of tensors with a leading lane axis (each lane's ``loss``, its
    ``d_rad`` and ``d_drop``, the updated radius ``rad = rads - LR *
    d_rad``, whether the sphere ever moved up (``bounced``: it touched the
    floor) and the trajectory's discrete decisions); aux the world's counts
    as the spec holds them (``stages``, ``host_reads`` by decision kind,
    ``host_syncs``, ``directed_pairs``)."""
    import torch

    from diffsdfsim_torch.physics import make_world_batched, rollout_batched, trajectory_lanes_first

    rads, drops = batch
    r = rads.detach().clone().requires_grad_(True)
    d = drops.detach().clone().requires_grad_(True)
    spec, bodies_b, state_b = make_world_batched(functools.partial(torch_world, size, device=rads.device), r, d)
    _, traj = rollout_batched(spec, bodies_b, state_b, SIZES[size]["frames"])
    losses = torch.sum(traj.pos[:, :, :, 1, :] ** 2 * traj.valid[..., None], dim=(0, 1, 3))
    g_rad, g_drop = torch.autograd.grad(losses.sum(), (r, d))
    lanes = trajectory_lanes_first(traj)
    out = dict(loss=losses.detach(), d_rad=g_rad, d_drop=g_drop, rad=rads - LR * g_rad,
               bounced=(lanes.v[:, :, :, 1, 4] > 0).flatten(1).any(dim=1),
               **{key: getattr(lanes, key) for key in DECISIONS})
    counts = types.SimpleNamespace(stages=spec.stages, host_reads=spec.host_reads, host_syncs=spec.host_syncs,
                                   directed_pairs=spec.directed_pairs)
    return out, counts
