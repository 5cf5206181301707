"""Port parity, shape-space (IGR latent) bodies and the shape-space fit
(diffsdfsim_torch vs diffsdfsim_tpu, float64 on the CPU), at a small width:
the decoder ``(32,)*4`` with a skip at 2 and geometric init toward radius
0.4, weights from a numpy seed handed to both packages.

- ``query_sdfs`` of a latent body (the JAX body built through
  tests/torch_jax_bridge.py), the static kernel choice, the body's interop
  round trip, ``parse_cli`` and ``trajectory_loss``: against JAX, 1e-10
  absolute (1e-14 for the losses). The JAX side of these is read from
  ``tests/golden/shapespace_jax.pkl`` (``gen_torch_shapespace_jax_golden.py``
  runs these tests with the JAX calls live, ``torch_jax_bridge.JaxGolden``).
- ``make_body`` (verts and inertia, 1e-10) and one latent-to-floor contact
  search (1e-9 for its per-face outputs, which go through 32 Frank-Wolfe and
  10 polish steps) against the JAX package's values in the golden file
  below.
- The 20-frame drop of ``optim_shapespace``'s scene at the start latent,
  taped, and the fit's first loss and d loss / d latent against the JAX
  golden file
  ``tests/golden/latent32_f64.npz`` (``tests/golden/gen_torch_shape_golden.py``):
  identical discrete decisions, poses and velocities within 1e-8, the loss
  and gradient within 1e-6 relative. Two whole Adam steps (latents within
  1e-9) run under ``-m slow``: they cost another ~10 s.
"""

import os

import numpy as np
import pytest
import torch

from diffsdfsim_torch.models import igr as tigr
from diffsdfsim_torch.physics import shapes as tshapes
from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "latent32_f64.npz")
_from_jax = JaxGolden(os.path.join(HERE, "golden", "shapespace_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def net(golden):
    return tigr.init_implicit_net(5, tuple(golden["dims"].tolist()), tuple(golden["skip_in"].tolist()),
                                  radius_init=float(golden["radius"]),
                                  generator=np.random.default_rng(int(golden["weight_seed"])))


def _close(t, j, atol=1e-10):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def test_latent_query_sdfs_matches_jax(net, golden):
    """The body's SDF queries in the port and in the JAX package, the JAX
    body built from the port body's numpy dict (the decoder's weights
    carried across by tests/torch_jax_bridge.py)."""
    from torch_jax_bridge import jax_body_from_torch

    _, body = _bodies(net, golden["start_latent"])
    pts = np.random.default_rng(0).uniform(-1.1, 1.1, (100, 3))

    def jax_side():
        import jax

        return jax.jit(jax_body_from_torch(body).query_sdfs)(pts)

    for a, b in zip(body.query_sdfs(torch.tensor(pts)), _from_jax(jax_side)):
        _close(a, b)


def _bodies(net, latent):
    from diffsdfsim_torch.physics import BoxShape, make_body

    shape = tshapes.LatentShape(torch.tensor(latent), torch.tensor(1.0, dtype=torch.float64), net)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, device="cpu")
    return floor, make_body(shape, subdiv=2, project_iters=16, device="cpu")


def test_make_body_matches_jax(net, golden):
    """Template projection ('auto' picks the cube template) and Mirtich
    inertia at the start latent, against the JAX package's make_body."""
    _, body = _bodies(net, golden["start_latent"])
    assert body.faces.shape == (192, 3)
    _close(body.verts, golden["start_verts"])
    _close(body.ang_inertia, golden["start_ang_inertia"])


def test_latent_pair_search_matches_xla(net, golden):
    """The latent body's mesh against the floor (its surface push and polish
    query the decoder), rotated by the fit's initial rotation with its
    lowest vertex 1e-3 into the floor, against the JAX package's
    ``_search_pair_raw_xla`` at the same pose."""
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics.contacts import search_pair_raw

    floor, body = _bodies(net, golden["start_latent"])
    t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64))[None]  # noqa: E731
    cfg = SimConfig(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=8, tol=1e-8)
    out = search_pair_raw(body, t(golden["quat0"]), t(golden["search_pos"]), floor, t([1.0, 0, 0, 0]),
                          t([0.0, -0.5, 0.0]), cfg)
    np.testing.assert_array_equal(out.cmask[0].numpy(), golden["search_cmask"])
    assert int(out.cmask.sum()) > 0
    for name in ("abc", "n_ng", "p1_ng", "x1", "pen", "max_pen"):
        _close(getattr(out, name)[0], golden[f"search_{name}"], atol=1e-9)


def test_no_frank_wolfe_kernel_for_grid_or_latent_shapes(net, golden):
    from diffsdfsim_torch.ops.fw_cuda import supported_pair

    floor, body = _bodies(net, golden["start_latent"])
    grid = tshapes.GridShape(torch.zeros((4, 4, 4), dtype=torch.float64), torch.tensor(1.0))
    gbody = type(body)(**{**body.__dict__, "shape": grid})
    for a, b in ((body, floor), (floor, body), (gbody, floor), (floor, gbody)):
        assert not supported_pair(a, b)
    assert supported_pair(floor, type(body)(**{**body.__dict__, "shape": floor.shape}))


def test_latent_body_interop_roundtrip(net, golden):
    """The body's numpy dict rebuilds it, decoder included."""
    from diffsdfsim_torch import interop

    _, body = _bodies(net, golden["start_latent"])
    back = interop.body_from_numpy(interop.body_to_numpy(body), device="cpu")
    pts = torch.tensor(np.random.default_rng(1).uniform(-1, 1, (20, 3)))
    for a, b in zip(back.query_sdfs(pts), body.query_sdfs(pts)):
        assert torch.equal(a, b)
    assert torch.equal(back.verts, body.verts)


def test_parse_cli_matches_jax():
    """The JAX package's ``parse_cli`` is plain Python: held live."""
    from diffsdfsim_torch.experiments import common as tcommon
    from diffsdfsim_torch.experiments.optim_shapespace import DEFAULTS
    from diffsdfsim_tpu.experiments import common as jcommon

    for argv in (["with", "seed=3", "lr=0.5", "trained_space=true"], ["--max_iter", "2", "--model_path", "a/b.pth"], []):
        assert tcommon.parse_cli(DEFAULTS, argv) == jcommon.parse_cli(DEFAULTS, argv)
    with pytest.raises(SystemExit):
        tcommon.parse_cli(DEFAULTS, ["nope=1"])


def test_trajectory_loss_matches_jax():
    from diffsdfsim_torch.experiments.losses import final_velocity_loss, trajectory_loss
    from diffsdfsim_torch.physics.world import Trajectory

    rng = np.random.default_rng(2)

    def trajs(T):
        return dict(t=np.sort(rng.uniform(0, 1, (T, 4)).reshape(-1)).reshape(T, 4), quat=rng.normal(size=(T, 4, 2, 4)),
                    pos=rng.normal(size=(T, 4, 2, 3)), v=rng.normal(size=(T, 4, 2, 6)), valid=rng.random((T, 4)) < 0.7,
                    bisect_failed=np.zeros((T, 4), bool), truncated=np.zeros(T, bool),
                    n_halvings=np.zeros((T, 4), int))

    da, db = trajs(6), trajs(5)
    kws = ({}, {"with_vel": True, "vel_weight": 0.3})

    def jax_side():
        import jax
        import jax.numpy as jnp
        from diffsdfsim_tpu.experiments import losses as jlosses
        from diffsdfsim_tpu.physics.world import Trajectory as JTrajectory

        ja, jb = (JTrajectory(**{k: jnp.asarray(v) for k, v in d.items()}) for d in (da, db))
        return tuple(jax.jit(lambda x, y: jlosses.trajectory_loss(x, y, body=1, **kw))(ja, jb) for kw in kws) + (
            jlosses.final_velocity_loss(ja.v[0, 0], jb.v[0, 0], 1),)

    j = _from_jax(jax_side)
    a, b = (Trajectory(**{k: torch.tensor(v) for k, v in d.items()}) for d in (da, db))
    for kw, jl in zip(kws, j):
        _close(trajectory_loss(a, b, body=1, **kw), jl, atol=1e-14)
    _close(final_velocity_loss(a.v[0, 0], b.v[0, 0], 1), j[-1], atol=1e-14)


def _scene(golden):
    from diffsdfsim_torch.experiments import optim_shapespace as oss

    c = dict(oss.DEFAULTS, run_time=int(golden["frames"]) / 30.0)
    return oss, c, oss.build_cfg(c), [torch.tensor(golden[k]) for k in ("target_latent", "start_latent", "quat0")]


def test_shapespace_drop_and_gradient_match_golden(net, golden):
    """The JAX package's draws (target, start, rotation) through the port:
    the taped drop at the start latent against JAX's, then the fit's first
    loss (against JAX's drop at the target latent) and d loss / d latent."""
    from diffsdfsim_torch.experiments.losses import trajectory_loss
    from diffsdfsim_torch.physics.world import Trajectory

    oss, c, cfg, (_, start, quat0) = _scene(golden)
    z = start.clone().requires_grad_(True)
    _, traj = oss.simulate(z, quat0, net, c, cfg, device="cpu")
    for key in ("valid", "n_halvings", "bisect_failed", "truncated"):
        np.testing.assert_array_equal(getattr(traj, key).numpy(), golden[f"start_traj_{key}"])
    for key in ("pos", "quat", "v"):
        _close(getattr(traj, key), golden[f"start_traj_{key}"], atol=1e-8)
    tgt = Trajectory(*(torch.tensor(golden[f"traj_{k}"]) for k in Trajectory._fields))
    loss = trajectory_loss(traj, tgt, body=1) + c["latent_reg"] * torch.sum(z**2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), golden["loss_0"], rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), golden["grad_0"], rtol=1e-6)


@pytest.mark.slow
def test_shapespace_fit_matches_golden(net, golden):
    """Two Adam steps of ``optim_shapespace.fit`` (torch.optim.Adam against
    optax.adam): each step's loss and gradient, and the latent after them."""
    oss, c, cfg, args = _scene(golden)
    out = oss.fit(net, *args, c, cfg, device="cpu", max_iter=2)
    for i in range(2):
        np.testing.assert_allclose(float(out["loss_hist"][i]), golden[f"loss_{i}"], rtol=1e-6)
        np.testing.assert_allclose(out["grad_hist"][i].numpy(), golden[f"grad_{i}"], rtol=1e-6)
    _close(out["final_latent"], golden["latent_2"], atol=1e-9)
