"""Port parity, the utilities: ``utils/checkpoint.py`` (a world state and
an optimizer's state restored bit for bit, and a resumed step equal to the
uninterrupted one), ``utils/profiling.py`` (``Timer``, ``trace``,
``annotate`` on the CPU), ``utils/viz.py`` (the sampled SDF volume against
the JAX package's ``sample_sdf_volume`` within 1e-12, the slice figure),
``ops/inertia.mesh_volume`` and ``utils/meshes.face_areas`` against the
JAX package's within 1e-12, and the 2D helpers of ``utils/spherical`` and
``utils/quaternion``, float64 on the CPU. The JAX side is read from
``tests/golden/utils_jax.pkl`` (``gen_torch_utils_golden.py`` runs these
tests with the JAX calls live, ``torch_jax_bridge.JaxGolden``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.config import SimConfig
from diffsdfsim_torch.experiments.fitting import Adam
from diffsdfsim_torch.physics import BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world
from diffsdfsim_torch.physics.world import step_frame
from diffsdfsim_torch.utils import checkpoint, meshes, profiling, quaternion, spherical, viz
from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "utils_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()
ATOL = 1e-12


def _world():
    """tests/test_checkpoint.py's world."""
    cfg = SimConfig(fric_dirs=4, max_contacts_per_pair=2, max_contacts_total=2, mesh_subdiv=1, max_substeps=2,
                    max_bisect=3)
    floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=2, device="cpu")
    ball = make_body(SphereShape(torch.tensor(0.5, dtype=torch.float64)), subdiv=1, device="cpu")
    poses = [[1.0, 0, 0, 0, 0, -0.5, 0], [1.0, 0, 0, 0, 0, 2.0, 0]]
    return make_world([floor, ball], poses, np.zeros((2, 6)), joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(10.0),)), cfg=cfg, device="cpu")


def test_checkpoint_resumes_bit_exactly(tmp_path):
    spec, state = _world()
    state1 = step_frame(spec, state)[0]
    path = tmp_path / "ck" / "state.pkl"
    checkpoint.save_state(path, state1)
    state2 = step_frame(spec, state1)[0]
    for restored in (checkpoint.load_state(path, like=state1), checkpoint.load_state(path, device="cpu")):
        for a, b in zip(checkpoint._leaves(restored), checkpoint._leaves(state1)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state2b = step_frame(spec, restored)[0]
        assert torch.equal(state2.pos, state2b.pos) and torch.equal(state2.v, state2b.v)


def test_checkpoint_optimizer_state(tmp_path):
    opt = Adam(lr=0.1)
    params = torch.tensor([0.3, -1.2], dtype=torch.float64)
    st = opt.init(params)
    _, st = opt.update(torch.tensor([0.5, 2.0], dtype=torch.float64), st)
    path = tmp_path / "opt.pkl"
    checkpoint.save_state(path, {"params": params, "opt": st, "step": 3})
    back = checkpoint.load_state(path, device="cpu")
    assert back["step"] == 3 and torch.equal(back["params"], params)
    for a, b in zip(checkpoint._leaves(back["opt"]), checkpoint._leaves(st)):
        assert torch.equal(a, b)


def test_profiling_on_cpu(tmp_path):
    timer = profiling.Timer()
    with timer.phase("work"):
        with profiling.annotate("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.times["work"] > 0 and "work" in timer.report()
    path = tmp_path / "trace" / "t.json"
    with profiling.trace(str(path)) as prof:
        with profiling.annotate("region"):
            torch.ones(8).sum()
    assert path.exists() and any(e.key == "region" for e in prof.key_averages())


def test_viz_sample_and_plot():
    def sphere_sdf(pts, rad):
        return torch.linalg.norm(pts, dim=-1) - rad

    vol = viz.sample_sdf_volume(sphere_sdf, (0.5,), res=9, device="cpu")
    jvol = _from_jax(lambda: __import__("diffsdfsim_tpu.utils.viz", fromlist=["x"]).sample_sdf_volume(
        lambda p, r: jnp.linalg.norm(p, axis=-1) - r, (0.5,), res=9))
    np.testing.assert_allclose(vol, jvol, rtol=0, atol=ATOL)
    import matplotlib

    matplotlib.use("Agg")
    fig = viz.plot_sdf_slices(9, 2, sphere_sdf, (0.5,), plot_contours=(0.0,), device="cpu")
    assert len(fig.axes) == 2 * 3 * 2  # each slice and its colorbar


def test_utility_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """device=None means CUDA: without a card ``sample_sdf_volume``,
    ``grid_from_sdf_fn``, ``contour_2d`` on a numpy grid and ``load_state``
    without ``like`` raise with resolve_device's message; ``load_state``
    with CPU ``like`` tensors restores on the CPU."""
    from diffsdfsim_torch.ops.marching2d import grid_from_sdf_fn
    from diffsdfsim_torch.physics2d import contour_2d

    path = tmp_path / "state.pkl"
    checkpoint.save_state(path, {"a": torch.arange(3.0)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: viz.sample_sdf_volume(lambda p, r: p.sum(-1) - r, (0.5,), res=3),
                 lambda: grid_from_sdf_fn(lambda p: p.sum(-1), 5),
                 lambda: contour_2d(np.ones((5, 5)), 2.0),
                 lambda: checkpoint.load_state(path)):
        with pytest.raises(RuntimeError, match="no CUDA device is available; pass device='cpu'"):
            call()
    back = checkpoint.load_state(path, like={"a": torch.zeros(3)})
    assert back["a"].device.type == "cpu" and torch.equal(back["a"], torch.arange(3.0))


def test_mesh_volume_face_areas_and_2d_helpers_match_jax():
    from diffsdfsim_torch.ops.inertia import mesh_volume

    verts, faces = meshes.icosphere(2)
    v = torch.as_tensor(verts, dtype=torch.float64) * 0.7

    def jax_side():
        from diffsdfsim_tpu.ops.inertia import mesh_volume as jvol
        from diffsdfsim_tpu.utils import meshes as jm
        from diffsdfsim_tpu.utils import quaternion as jq
        from diffsdfsim_tpu.utils import spherical as js

        jv = jnp.asarray(verts) * 0.7
        pts = jnp.asarray(_PTS)
        return (jvol(jv, jnp.asarray(faces)), jm.face_areas(jv, jnp.asarray(faces)),
                *js.cart_to_polar(pts), js.cart_to_polar(pts, positive=False)[1], js.polar_to_cart(pts[:, 0], pts[:, 1]),
                js.left_orthogonal(pts), js.cross_2d(pts, pts[::-1]), jq.rotation_2d(pts[:, 0]))

    j = _from_jax(jax_side)
    pts = torch.as_tensor(_PTS)
    out = (mesh_volume(v, faces), meshes.face_areas(v, faces), *spherical.cart_to_polar(pts),
           spherical.cart_to_polar(pts, positive=False)[1], spherical.polar_to_cart(pts[:, 0], pts[:, 1]),
           spherical.left_orthogonal(pts), spherical.cross_2d(pts, pts.flip(0)), quaternion.rotation_2d(pts[:, 0]))
    for a, b in zip(out, j):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)
    assert abs(float(out[0]) - 4 / 3 * np.pi * 0.7**3) < 0.05


_PTS = np.array([[1.0, 0.0], [-0.5, 0.25], [0.0, -2.0], [-1.5, -1.5], [0.3, 0.7]])
