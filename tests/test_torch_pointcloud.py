"""Port parity, the point-cloud fits (``diffsdfsim_torch.experiments``:
``optim_pointcloud``, ``optim_pointcloud_real``, ``render_result``) against
the JAX package, float64 on the CPU.

- Live against JAX: ``erode_mask`` (equal), ``match_pointcloud``'s value
  and gradient in (pos, quat, size) for a sphere and a rounded box, within
  1e-12 relative; ``estimate_plane`` and ``wall_from_plane``'s pose within
  1e-12.
- Against ``tests/golden/pointcloud_sphere_f64.npz``
  (``tests/golden/gen_torch_pointcloud_golden.py``: 128 x 96, 30 frames, the
  draws of ``PRNGKey(0)``): the target rollout at JAX's draws (decisions
  equal, poses within 1e-9; read 5.4e-13), its renders at frames 0 and 29
  (segmentation equal but at most 2 pixels, depth within 1e-9 where both
  hit; read 0 pixels and 1.4e-12), and, on JAX's observations (its depth
  noise cannot be drawn here), the first-frame loss and gradient at each of
  JAX's three Adam iterates within 1e-8 relative (read 2e-16) with the Adam
  steps between them, and the trajectory loss and gradient at the start of
  the trajectory fit within 1e-6 relative (read 7e-11).
- ``optim_pointcloud_real.main``, 3 Adam steps on the synthetic recording
  of ``tests/test_pointcloud_real.py``, against its golden: losses and the
  fitted parameters within 1e-9 relative; and that test's 30-step fit.
- ``generate_jobs``' point-cloud jobs each parse and run
  ``optim_pointcloud.main`` (cut to 3 frames at 16 x 12 pixels, one step a
  phase), and ``evaluate`` reads their run directories as the JAX one does;
  ``render_result.main`` writes its frames, and its ``render_world`` the
  frames JAX's writes for the same trajectory.

The JAX side of the live comparisons (each jitted JAX program compiles for
seconds) is read from ``tests/golden/pointcloud_jax.pkl``, which
``tests/golden/gen_torch_pointcloud_jax_golden.py`` writes by running these
tests with the JAX calls live (``torch_jax_bridge.JaxGolden``); regenerate
it when a test's inputs change.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "pointcloud_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "pointcloud_{}_f64.npz")
RTOL_FRAME, RTOL_TRAJ, ATOL_TGT = 1e-8, 1e-6, 1e-9


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN.format("sphere")))


def _observations(g):
    """JAX's observations of the golden: [(t, pc (H, W, 3), seg (H, W))], the
    points set where the body's mask is."""
    seg = torch.tensor(g["seg"]).to(torch.int32)
    pcs = torch.zeros(tuple(seg.shape) + (3,), dtype=torch.float64)
    pcs[seg == 1] = torch.tensor(g["obs_pts"])
    return [(torch.tensor(t), pcs[i], seg[i]) for i, t in enumerate(g["obs_t"])]


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_erode_and_match_pointcloud_match_jax():
    from diffsdfsim_torch.experiments import optim_pointcloud as top
    from diffsdfsim_tpu.experiments import optim_pointcloud as jop

    rng = np.random.default_rng(0)
    masks = [rng.uniform(size=(12, 16)) < 0.7, np.zeros((9, 9), bool)]
    masks[1][2:7, 2:7] = True
    for m in masks:
        assert np.array_equal(top.erode_mask(torch.tensor(m)).numpy(), _from_jax(lambda: jop.erode_mask(jnp.asarray(m))))
    assert int(top.erode_mask(torch.tensor(masks[1])).sum()) == 9
    cam, pose = top.camera_setup(dict(top.DEFAULTS, width=16, height=12), device="cpu")
    pc = rng.normal(size=(12, 16, 3)) * 0.3 + np.array([0.0, 0.0, 6.0])
    pc[0, 0, 2] = 0.0
    seg = rng.uniform(size=(12, 16)) < 0.8
    x = np.concatenate([[0.1, 1.9, -0.2], [0.9, 0.1, -0.3, 0.2], [0.7]])
    for shape in ("sphere", "cube"):
        c = dict(top.DEFAULTS, shape=shape)

        def jloss(xx):
            q = xx[3:7] / jnp.linalg.norm(xx[3:7])
            return jop.match_pointcloud(jnp.asarray(pc), jnp.asarray(seg), jnp.asarray(pose.numpy()),
                                        jop._make_shape(c, xx[7]), xx[:3], q)

        jv, jg = _from_jax(lambda: jax.jit(jax.value_and_grad(jloss))(jnp.asarray(x)))
        xt = torch.tensor(x, requires_grad=True)
        v = top.frame_loss(xt, c, torch.tensor(pc), torch.tensor(seg), pose)
        (g,) = torch.autograd.grad(v, xt)
        assert _rel(float(v), float(jv)) <= 1e-12 and _rel(g.numpy(), jg) <= 1e-12, shape


def test_plane_and_wall_match_jax(monkeypatch):
    from diffsdfsim_torch.experiments import optim_pointcloud_real as topr
    from diffsdfsim_tpu.experiments import optim_pointcloud_real as jopr

    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-2, 2, (80, 1)), rng.normal(size=(80, 1)) * 1e-3 + 0.1,
                          rng.uniform(-2, 2, (80, 1))], axis=1)
    n, d = topr.estimate_plane(pts)
    jn, jd = _from_jax(lambda: jopr.estimate_plane(pts))
    np.testing.assert_allclose(n, jn, rtol=0, atol=1e-12)
    assert d == pytest.approx(jd, abs=1e-12) and n[1] > 0.99
    # the wall's pose; the JAX body is not built (make_body stands in)
    monkeypatch.setattr(jopr, "make_body", lambda shape, subdiv: shape)
    for normal, offset in ((n, d), ([0.0, -1.0, 0.0], 0.3), ([0.3, 0.2, -0.9], -1.0)):
        body, pose = topr.wall_from_plane(normal, offset, 1.0, device="cpu")

        def jax_wall():
            jshape, jpose = jopr.wall_from_plane(normal, offset, 1.0)
            return jpose, jshape.dims

        jpose, jdims = _from_jax(jax_wall)
        np.testing.assert_allclose(pose.numpy(), jpose, rtol=0, atol=1e-12)
        np.testing.assert_allclose(body.shape.dims.numpy(), jdims, rtol=0, atol=0)


def test_target_rollout_and_renders_match_golden(golden):
    from diffsdfsim_torch.experiments import optim_pointcloud as top
    from diffsdfsim_torch.physics import rollout

    c = dict(top.DEFAULTS)
    cfg = top.build_cfg(c)
    f64 = torch.float64
    spec, state = top.make_scene(c, cfg, torch.tensor(golden["target_size"]), torch.tensor(top.TARGET_POS, dtype=f64),
                                 torch.tensor(golden["target_quat"]), "cpu")
    with torch.no_grad():
        _, traj = rollout(spec, state, top.n_frames(c, cfg))
    assert np.array_equal(traj.valid.numpy(), golden["tgt_valid"])
    assert np.array_equal(traj.n_halvings.numpy(), golden["tgt_n_halvings"])
    for key in ("pos", "quat"):
        np.testing.assert_allclose(getattr(traj, key).numpy(), golden[f"tgt_{key}"], rtol=0, atol=ATOL_TGT)
    np.testing.assert_allclose(traj.t[:, 0].numpy(), golden["obs_t"], rtol=0, atol=1e-12)
    cam, pose = top.camera_setup(c, "cpu")
    for i in (0, 29):
        depth, seg = top.render_depth_seg(spec.bodies, traj.quat[i, 0], traj.pos[i, 0], cam, pose)
        assert int((seg.numpy() != golden[f"seg_{i}"]).sum()) <= 2
        both = (seg.numpy() >= 0) & (golden[f"seg_{i}"] >= 0)
        assert both.sum() > 400
        np.testing.assert_allclose(depth.numpy()[both], golden[f"depth_{i}"][both], rtol=0, atol=ATOL_TGT)
    # the body's mask of every frame is JAX's but for a few silhouette pixels
    assert np.array_equal(golden["seg"][0], golden[f"seg_{0}"])


def test_first_frame_fit_matches_golden(golden):
    """The first-frame loss and gradient at each of JAX's Adam iterates, and
    ``descend_pose``'s steps from JAX's start reproduce JAX's iterates."""
    from diffsdfsim_torch.experiments import optim_pointcloud as top

    c = dict(top.DEFAULTS)
    _, pose = top.camera_setup(c, "cpu")
    obs = _observations(golden)
    pc0, mask0 = obs[0][1], obs[0][2] == 1
    for i in range(len(golden["frame_loss"])):
        x = torch.tensor(golden["frame_x"][i], requires_grad=True)
        v = top.frame_loss(x, c, pc0, mask0, pose)
        (g,) = torch.autograd.grad(v, x)
        assert _rel(float(v), golden["frame_loss"][i]) <= RTOL_FRAME
        assert _rel(g.numpy(), golden["frame_grad"][i]) <= RTOL_FRAME
    x0 = torch.tensor(golden["frame_x"][0])
    for n in (1, 2):
        x, losses, _ = top.descend_pose(lambda xx: top.frame_loss(xx, c, pc0, mask0, pose), x0, c, c["lr_pose"], n + 1)
        np.testing.assert_allclose(losses, golden["frame_loss"][: n + 1], rtol=RTOL_FRAME)
    # the start the main path forms from the draws
    q = torch.tensor(golden["target_quat"]) + torch.tensor(golden["quat_noise"]) * 0.1
    start = top.pack(torch.tensor(top.TARGET_POS, dtype=torch.float64) + torch.tensor(golden["pos_noise"]) * 0.1,
                     q / torch.linalg.norm(q), torch.tensor(0.8, dtype=torch.float64))
    np.testing.assert_allclose(start.numpy(), golden["frame_x"][0], rtol=0, atol=1e-15)


def test_trajectory_fit_matches_golden(golden):
    """The trajectory loss and gradient at the trajectory fit's start (the
    first-frame fit's result), and its Adam step to JAX's next iterate."""
    from diffsdfsim_torch.experiments import optim_pointcloud as top
    from diffsdfsim_torch.experiments.fitting import Adam

    c = dict(top.DEFAULTS)
    cfg = top.build_cfg(c)
    _, pose = top.camera_setup(c, "cpu")
    obs = _observations(golden)
    masks = [seg == 1 for (_, _, seg) in obs]
    x = torch.tensor(golden["traj_x"][0], requires_grad=True)
    v = top.traj_loss(x, c, cfg, obs, masks, pose, "cpu")
    (g,) = torch.autograd.grad(v, x)
    assert _rel(float(v), golden["traj_loss"][0]) <= RTOL_TRAJ
    assert _rel(g.numpy(), golden["traj_grad"][0]) <= RTOL_TRAJ
    opt = Adam(c["lr_size"])
    upd, _ = opt.update(g, opt.init(x.detach()))
    x1 = x.detach() + upd
    x1 = torch.cat([x1[:3], x1[3:7] / torch.linalg.norm(x1[3:7]), x1[7:]])
    np.testing.assert_allclose(x1.numpy(), golden["traj_x"][1], rtol=0, atol=1e-9)


def _real_fixture(tmp_path):
    """tests/test_pointcloud_real.py's recording, which the port's
    ``synthetic_recording`` writes byte for byte."""
    from diffsdfsim_torch.experiments.optim_pointcloud_real import synthetic_recording
    from test_pointcloud_real import _make_fixture

    path = tmp_path / "rec.pkl"
    r = _make_fixture(path)
    assert synthetic_recording(tmp_path / "port.pkl") == r
    assert (tmp_path / "port.pkl").read_bytes() == path.read_bytes()
    return path, r


def test_pointcloud_real_main_matches_golden(tmp_path):
    from diffsdfsim_torch.experiments import optim_pointcloud_real as topr

    g = dict(np.load(GOLDEN.format("real")))
    path, r_target = _real_fixture(tmp_path)
    assert r_target == float(g["r_target"])
    out = topr.main(["with", f"data_path={path}", "max_iter=3", "mesh_subdiv=1", f"base_dir={tmp_path / 'out'}"],
                    device="cpu")
    import json

    losses = json.loads((tmp_path / "out" / "pointcloud_real" / "1" / "metrics.json").read_text())["loss"]["values"]
    np.testing.assert_allclose(losses, g["loss"], rtol=1e-9)
    for key in ("size", "pos0", "rot0"):
        np.testing.assert_allclose(out[key], g[key], rtol=1e-9, atol=1e-12, err_msg=key)


def test_pointcloud_real_fit_synthetic_recording(tmp_path):
    """tests/test_pointcloud_real.py's fit through the port: 30 Adam steps
    from size 0.5 move decisively toward the recording's 0.62 (~11 s)."""
    from diffsdfsim_torch.experiments import optim_pointcloud_real as topr

    path, r_target = _real_fixture(tmp_path)
    out = topr.main(["with", f"data_path={path}", "max_iter=30", "mesh_subdiv=1", f"base_dir={tmp_path / 'out'}"],
                    device="cpu")
    assert abs(float(out["size"]) - r_target) < 0.06


def test_pointcloud_jobs_run_and_evaluate(tmp_path):
    """Every point-cloud job ``generate_jobs`` emits parses and runs
    ``optim_pointcloud.main`` (cut to 3 frames at 16 x 12 pixels and one step
    a phase); the port's ``evaluate`` reads the runs' output keys
    (``frame_fit``, ``traj_fit``) as the JAX one does. Without a card
    ``main`` raises unless the CPU is asked for."""
    from diffsdfsim_torch.experiments import evaluate as tev
    from diffsdfsim_torch.experiments import generate_jobs as tgj
    from diffsdfsim_torch.experiments import optim_pointcloud as top
    from diffsdfsim_tpu.experiments import evaluate as jev

    cut = ["run_time=0.1", "width=16", "height=12", "frame_fit_iters=1", "traj_fit_iters=1", "mesh_subdiv=1",
           f"base_dir={tmp_path}"]
    lines = tgj.main(["pointcloud", "1"])
    assert len(lines) == 3
    for ln in lines:
        words = ln.split()
        assert words[:3] == ["python", "-m", "diffsdfsim_torch.experiments.optim_pointcloud"] and words[3] == "with"
        out = top.main(words[3:] + cut, device="cpu")
        assert set(out) == {"target_size", "target_pos", "target_quat", "init", "frame_fit", "traj_fit"}
        assert all(np.isfinite(out[k]["pos_err"]) for k in ("init", "frame_fit", "traj_fit"))
    for shape, n in (("sphere", 2), ("cube", 1)):
        base = tmp_path / f"pointcloud_{shape}"
        got, want = tev.read_runs(base), jev.read_runs(base)
        assert len(got) == len(want) == n and [r["cfg"] for r in got] == [r["cfg"] for r in want]
        assert set(got[0]["output"]) >= {"frame_fit", "traj_fit"}
        assert tev.main([str(base), str(n)]) == jev.main([str(base), str(n)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            top.main(["with", f"base_dir={tmp_path / 'none'}"])
        assert not (tmp_path / "none").exists()


def test_render_result_matches_jax(tmp_path, monkeypatch):
    """``render_result.main`` on an ``optim_sphere`` run directory writes
    every 5th frame of the start, final and target worlds; its
    ``render_world`` writes the frames JAX's writes for the same trajectory,
    segmentation equal but at most 2 pixels a frame and depth within 1e-9
    where both hit."""
    import json
    import pickle

    from diffsdfsim_torch.experiments import optim_sphere as tos
    from diffsdfsim_torch.experiments import render_result as trr
    from diffsdfsim_tpu.experiments import render_result as jrr
    from test_torch_render import _jitted_render
    from torch_jax_bridge import jax_body_from_torch

    cfg = dict(run_time=0.2, use_wall=False, mesh_subdiv=1)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with open(tmp_path / "output.pkl", "wb") as f:
        pickle.dump(dict(start_rad=np.array([0.6]), final_rad=np.array([0.75]), target_rad=np.array([0.8])), f)
    trr.main([str(tmp_path)], device="cpu")
    for name in ("start", "final", "target"):
        assert sorted(p.name for p in (tmp_path / "render" / name).iterdir()) == [
            "depth_0000.npy", "depth_0005.npy", "seg_0000.npy", "seg_0005.npy"]
    # render_world on one trajectory in both packages
    c = dict(tos.DEFAULTS, **cfg)
    spec, state, _, _ = tos.build_world(torch.tensor(0.8, dtype=torch.float64), c, tos.build_cfg(c), "cpu")
    with torch.no_grad():
        _, traj = tos.rollout(spec, state, 6)
    # render_result's camera looks up, away from the room (its frames above
    # show the sky, in both packages): the sphere is drawn 15 m higher
    lift = torch.zeros_like(traj.pos)
    lift[..., 1, 1] = 15.0
    traj = traj._replace(pos=traj.pos + lift)
    def jax_frames():
        jspec = type("Spec", (), {"bodies": [jax_body_from_torch(b) for b in spec.bodies]})
        jtraj = type("Traj", (), {k: jnp.asarray(getattr(traj, k).numpy()) for k in ("t", "quat", "pos")})
        monkeypatch.setattr(jrr, "render_depth_seg", _jitted_render(jrr.render_depth_seg))
        jrr.render_world(jspec, jtraj, tmp_path / "jax")
        return tuple((np.load(tmp_path / "jax" / f"seg_{i:04d}.npy"), np.load(tmp_path / "jax" / f"depth_{i:04d}.npy"))
                     for i in (0, 5))

    trr.render_world(spec, traj, tmp_path / "port")
    for i, (seg_b, depth_b) in zip((0, 5), _from_jax(jax_frames)):
        seg_a, depth_a = (np.load(tmp_path / "port" / f"{k}_{i:04d}.npy") for k in ("seg", "depth"))
        assert int((seg_a != seg_b).sum()) <= 2 and (seg_a == 1).sum() > 50
        both = (seg_a >= 0) & (seg_b >= 0)
        np.testing.assert_allclose(depth_a[both], depth_b[both], rtol=0, atol=1e-9)
