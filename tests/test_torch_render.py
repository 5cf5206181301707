"""Port parity, the observation layer (``diffsdfsim_torch.rendering``:
``raymarch``, ``arrows``, ``recorder``; ``run_world``'s recorder;
``utils.quaternion.so3_relative_angle``) against the JAX package, float64
on the CPU, live at 24 x 18 pixels.

- The ray-marcher on a floor, a rotated sphere and a rounded box seen by
  ``optim_pointcloud``'s camera, 3 m from them: segmentation equal but at most
  MAX_SEG_DIFF pixels (a grazing ray can hit in one package and miss in the
  other; read 0), depth within 1e-9 where both hit; d (sum of depth) / d
  pos against central differences within 1e-5 of its largest entry (JAX's
  is NaN);
  ``get_pointcloud`` at zero noise and with JAX's standard normal draws
  handed over as ``noise`` within 1e-12; ``render_color`` within 1e-9
  where both hit.
- ``scene_sdf`` with a latent body (a small IGR decoder through K4's plain
  version on the CPU) and an analytic one: values within 1e-12, the body
  index equal.
- ``force_arrows`` (a pushed body under gravity): arrow count, lengths,
  quaternions and positions within 1e-12; an arrow's SDF and gradient at
  points around it within 1e-12.
- ``Recorder3D`` through ``run_world`` (the bench world, 4 frames, the
  camera turning): the port's frames against the JAX ``Recorder3D`` fed the
  same states, depth and segmentation as above and the camera poses within
  1e-12; the pacing quirk (every call records, whatever the time between
  calls) in both.

The JAX side's results (each jitted JAX renderer compiles for seconds) are
read from ``tests/golden/render_jax.pkl``, which
``tests/golden/gen_torch_render_golden.py`` writes by running these tests
with the JAX calls live (``torch_jax_bridge.JaxGolden``); regenerate it when
a test's inputs change.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_bridge import JaxGolden, jax_body_from_torch, one_torch_thread, torch_bench_world  # noqa: F401

_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "render_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()

W, H = 24, 18
MAX_SEG_DIFF = 2
ATOL_DEPTH = 1e-9


@pytest.fixture(scope="module")
def scene():
    """The port's floor, sphere and rounded box (CPU), their poses, and a
    function making the JAX bodies that hold the same values."""
    from diffsdfsim_torch.physics import BoxShape, RoundedBoxShape, SphereShape, make_body

    f64 = torch.float64
    bodies = [make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=1, device="cpu"),
              make_body(SphereShape(torch.tensor(0.7, dtype=f64)), subdiv=1, device="cpu"),
              make_body(RoundedBoxShape(torch.tensor([1.2, 0.8, 1.0]), torch.tensor(0.15)), subdiv=1, device="cpu")]
    q = torch.tensor([[1.0, 0, 0, 0], [0.9, 0.3, -0.2, 0.1], [0.8, -0.1, 0.5, 0.2]], dtype=f64)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    p = torch.tensor([[0.0, -0.5, 0.0], [-0.6, 2.2, 0.3], [0.9, 2.6, -0.4]], dtype=f64)
    return bodies, q, p, lambda: [jax_body_from_torch(b) for b in bodies]


def _camera():
    """optim_pointcloud's camera, 3 m nearer."""
    from diffsdfsim_torch.experiments import optim_pointcloud as top

    cam, pose = top.camera_setup(dict(top.DEFAULTS, width=W, height=H), device="cpu")
    pose[2, 3] -= 3.0
    return cam, pose


def _close_where_hit(depth_t, seg_t, depth_j, seg_j, atol=ATOL_DEPTH):
    seg_t, seg_j = np.asarray(seg_t), np.asarray(seg_j)
    assert int((seg_t != seg_j).sum()) <= MAX_SEG_DIFF
    both = (seg_t >= 0) & (seg_j >= 0)
    assert both.sum() >= 30
    np.testing.assert_allclose(np.asarray(depth_t)[both], np.asarray(depth_j)[both], rtol=0, atol=atol)


def test_render_depth_seg_and_pointcloud_match_jax(scene):
    from diffsdfsim_torch.rendering import get_pointcloud, render_depth_seg
    from diffsdfsim_tpu.rendering import get_pointcloud as jget_pointcloud
    from diffsdfsim_tpu.rendering import render_depth_seg as jrender_depth_seg

    bodies, q, p, jbodies = scene
    cam, pose = _camera()
    pos = p.clone().requires_grad_(True)
    depth, seg = render_depth_seg(bodies, q, pos, cam, pose)
    (g,) = torch.autograd.grad(depth.sum(), pos)
    jdepth, jseg = _from_jax(lambda: jax.jit(lambda a, b, c: jrender_depth_seg(jbodies(), a, b, cam, c))(
        jnp.asarray(q.numpy()), jnp.asarray(p.numpy()), jnp.asarray(pose.numpy())))
    assert seg.dtype == torch.int32 and set(np.unique(seg.numpy())) == {-1, 1, 2}
    _close_where_hit(depth.detach(), seg, jdepth, jseg)
    # d (sum of depth) / d pos against central differences (JAX's gradient
    # is NaN: the norm of a zero vector in the distance to a body's cube,
    # under a jnp.where that discards it; ROADMAP queue 3)
    h = 1e-6
    fd = np.zeros((3, 3))
    with torch.no_grad():
        for b in (1, 2):
            for j in range(3):
                e = torch.zeros_like(p)
                e[b, j] = h
                fd[b, j] = float(render_depth_seg(bodies, q, p + e, cam, pose)[0].sum()
                                 - render_depth_seg(bodies, q, p - e, cam, pose)[0].sum()) / (2 * h)
    assert bool(torch.isfinite(g).all()) and float(g[1:].abs().max()) > 1.0
    np.testing.assert_allclose(g.numpy(), fd, rtol=0, atol=1e-5 * float(np.abs(fd).max()))

    # the point cloud: at zero noise, and with JAX's draws handed over
    dnp = depth.detach().numpy()
    np.testing.assert_allclose(get_pointcloud(depth.detach(), cam).numpy(),
                               _from_jax(lambda: jget_pointcloud(jnp.asarray(dnp), cam)), rtol=0, atol=1e-12)

    def noisy_jax():
        key = jax.random.PRNGKey(3)
        return (jax.random.normal(key, dnp.shape, jnp.float64),
                jget_pointcloud(jnp.asarray(dnp), cam, key=key, noise_factor=0.002))

    noise, jnoisy = _from_jax(noisy_jax)
    np.testing.assert_allclose(get_pointcloud(depth.detach(), cam, noise_factor=0.002, noise=noise).numpy(), jnoisy,
                               rtol=0, atol=1e-12)
    gen = torch.Generator().manual_seed(0)
    noisy = get_pointcloud(depth.detach(), cam, gen, noise_factor=0.002)
    assert noisy.shape == (H, W, 3) and not torch.equal(noisy, get_pointcloud(depth.detach(), cam))


def test_render_color_matches_jax(scene):
    from diffsdfsim_torch.rendering import render_color
    from diffsdfsim_tpu.rendering import render_color as jrender_color

    bodies, q, p, jbodies = scene
    cam, pose = _camera()
    rgb, depth, seg = render_color(bodies, q, p, cam, pose)
    jrgb, jdepth, jseg = _from_jax(lambda: jax.jit(lambda a, b, c: jrender_color(jbodies(), a, b, cam, c))(
        jnp.asarray(q.numpy()), jnp.asarray(p.numpy()), jnp.asarray(pose.numpy())))
    _close_where_hit(depth, seg, jdepth, jseg)
    same = seg.numpy() == np.asarray(jseg)
    np.testing.assert_allclose(rgb.numpy()[same], np.asarray(jrgb)[same], rtol=0, atol=1e-9)
    assert rgb.numpy()[seg.numpy() < 0].min() == 1.0


def test_scene_sdf_with_latent_body_matches_jax():
    from diffsdfsim_torch.models import igr as tigr
    from diffsdfsim_torch.physics import shapes as tshapes
    from diffsdfsim_torch.rendering.raymarch import scene_sdf
    from diffsdfsim_tpu.models import igr as jigr
    from diffsdfsim_tpu.physics import shapes as jshapes
    from diffsdfsim_tpu.rendering.raymarch import scene_sdf as jscene_sdf

    class ShapeBody:
        """The renderer's body surface around a bare shape."""

        def __init__(self, shape, query):
            self.shape, self.query = shape, query

        def scale(self):
            return self.shape.scale()

        def query_sdfs(self, pts, return_grads=True):
            return self.query(self.shape, pts, return_grads=return_grads)

    net = tigr.init_implicit_net(5, (32,) * 4, (2,), radius_init=0.55, generator=np.random.default_rng(0))
    prm = net.params()
    lat = np.array([0.2, -0.1])
    t_lat = tshapes.LatentShape(torch.tensor(lat), torch.tensor(0.8, dtype=torch.float64), net)
    t_sph = tshapes.SphereShape(torch.tensor(0.5, dtype=torch.float64))
    bodies = [ShapeBody(t_lat, tshapes.query_sdfs), ShapeBody(t_sph, tshapes.query_sdfs)]
    q = np.array([[0.9, 0.1, 0.3, -0.2], [1.0, 0, 0, 0]])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = np.array([[0.0, 0.0, 0.0], [1.1, 0.2, 0.0]])
    pts = np.random.default_rng(2).uniform(-1.5, 2.0, (200, 3))
    v, i = scene_sdf(bodies, torch.tensor(q), torch.tensor(p), torch.tensor(pts))

    def jax_side():
        jprm = jigr.ImplicitNetParams(tuple(jnp.asarray(w.numpy()) for w in prm.weights),
                                      tuple(jnp.asarray(b.numpy()) for b in prm.biases), (2,), 5)
        j_lat = jshapes.LatentShape(jnp.asarray(lat), jnp.asarray(0.8), jigr.make_decoder(jprm))
        j_sph = jshapes.SphereShape(jnp.asarray(0.5))
        jbodies = [ShapeBody(j_lat, jshapes.query_sdfs), ShapeBody(j_sph, jshapes.query_sdfs)]
        return jax.jit(lambda a, b, c: jscene_sdf(jbodies, a, b, c))(jnp.asarray(q), jnp.asarray(p), jnp.asarray(pts))

    jv, ji = _from_jax(jax_side)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-12)
    assert np.array_equal(i.numpy(), np.asarray(ji)) and set(i.numpy().tolist()) == {0, 1}


def test_force_arrows_match_jax(scene):
    from diffsdfsim_torch.physics import ExternalForce3D, Gravity3D
    from diffsdfsim_torch.physics.forces import RIGHT
    from diffsdfsim_torch.rendering.arrows import force_arrows
    from diffsdfsim_tpu.physics import ExternalForce3D as JExternalForce3D
    from diffsdfsim_tpu.physics import Gravity3D as JGravity3D
    from diffsdfsim_tpu.physics.forces import RIGHT as JRIGHT
    from diffsdfsim_tpu.rendering.arrows import force_arrows as jforce_arrows

    class Push(ExternalForce3D):
        def force(self, t, body):
            return 3.0 * RIGHT(torch.zeros((), dtype=torch.float64))

    class JPush(JExternalForce3D):
        def force(self, t, body):
            return 3.0 * JRIGHT()

    from diffsdfsim_torch.rendering.arrows import _quat_align_z
    from diffsdfsim_tpu.rendering.arrows import _quat_align_z as j_quat_align_z

    bodies, q, p, jbodies = scene
    forces = ((), (Gravity3D(10.0), Push()), ())
    kw = dict(render_forces=True, render_torques=True)
    arrows, aq, ap = force_arrows(bodies, forces, 0.0, q, p, **kw)
    pts = np.random.default_rng(4).uniform(-0.6, 1.6, (128, 3)) * np.array([0.5, 0.5, 1.0])
    # an arrow along -z (the half-turn branch) and an oblique one
    axes = ([0.0, 0.0, -1.0], [0.6, 0.0, 0.8])

    def jax_side():
        jforces = ((), (JGravity3D(10.0), JPush()), ())
        jarrows, jaq, jap = jforce_arrows(jbodies(), jforces, 0.0, jnp.asarray(q.numpy()), jnp.asarray(p.numpy()),
                                          **kw)
        sizes = [float(getattr(jarrows[0], f)) for f in ("length", "shaft_r", "head_r", "head_len")]
        return (len(jarrows), jaq, jap, sizes, *jax.jit(jarrows[0].query_sdfs)(jnp.asarray(pts)),
                *(jax.jit(j_quat_align_z)(jnp.asarray(v)) for v in axes))

    n_j, jaq, jap, sizes, jd, jg, *jquats = _from_jax(jax_side)
    assert len(arrows) == int(n_j) == 1
    np.testing.assert_allclose(aq.numpy(), jaq, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ap.numpy(), jap, rtol=0, atol=1e-12)
    for f, jf in zip(("length", "shaft_r", "head_r", "head_len"), sizes):
        np.testing.assert_allclose(float(getattr(arrows[0], f)), float(jf), rtol=1e-15)
    d, g = arrows[0].query_sdfs(torch.tensor(pts))
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-12)
    for v, jqa in zip(axes, jquats):
        np.testing.assert_allclose(_quat_align_z(torch.tensor(v, dtype=torch.float64)).numpy(), jqa, rtol=0, atol=1e-15)


def _jitted_render(fn):
    """``fn(bodies, quat, pos, cam, pose)`` compiled once per (bodies, cam)."""
    cache = {}

    def wrapped(bodies, quat, pos, cam, pose):
        key = (id(bodies), cam)
        if key not in cache:
            cache[key] = jax.jit(lambda q, p, c: fn(bodies, q, p, cam, c))
        return cache[key](quat, pos, pose)

    return wrapped


def test_recorder_through_run_world_matches_jax(monkeypatch):
    from diffsdfsim_torch.physics.world import run_world
    from diffsdfsim_torch.rendering import PinholeCamera, Recorder3D
    from diffsdfsim_tpu.rendering import Recorder3D as JRecorder3D

    cam = PinholeCamera.from_yfov(math.pi / 3, W, H)
    pose = np.eye(4)
    pose[:3, 3] = [0.0, 1.0, 5.0]
    kw = dict(rotate=True, record_points=True, record_seg=True)
    rec = Recorder3D(1.0 / 30, cam, pose, **kw)
    spec, state = torch_bench_world(cfg_kw=dict(fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4,
                                                 mesh_subdiv=1, max_substeps=4, max_bisect=8, tol=1e-8))
    with torch.no_grad():
        _, traj = run_world(spec, state, run_time=3.5 / 30, recorder=rec)
    assert len(rec.frames) == 4
    from diffsdfsim_tpu.rendering import recorder as jrecorder

    # the pacing: prev_t starts at -1e9 and grows by dt a call, so a call at
    # the same time as the last one records all the same
    t_last = rec.frames[-1][0]

    def jax_side():
        monkeypatch.setattr(jrecorder, "render_depth_seg", _jitted_render(jrecorder.render_depth_seg))
        jrec = JRecorder3D(1.0 / 30, cam, pose, **kw)
        jbodies = [jax_body_from_torch(b) for b in spec.bodies]
        frames = []
        for i, frame in enumerate(rec.frames):
            jf = jrec.record(frame[0], jbodies, jnp.asarray(traj.quat[i, -1].numpy()),
                             jnp.asarray(traj.pos[i, -1].numpy()))
            frames.append((jf[0], jf[1], jf[3], jf[4], jf[5] is None))
        out = jrec.record(t_last, jbodies, jnp.asarray(traj.quat[-1, -1].numpy()), jnp.asarray(traj.pos[-1, -1].numpy()))
        return frames, (out is not None, len(jrec.frames), jrec.prev_t)

    jframes, jpacing = _from_jax(jax_side)
    for frame, (jt, jdepth, jseg, jpose, jnone) in zip(rec.frames, jframes):
        assert frame[0] == float(jt)
        _close_where_hit(frame[1], frame[3], jdepth, jseg)
        np.testing.assert_allclose(frame[4], jpose, rtol=0, atol=1e-12)
        assert frame[2].shape == (H, W, 3) and frame[5] is None and bool(jnone)
    out = rec.record(t_last, spec.bodies, torch.as_tensor(traj.quat[-1, -1].numpy()),
                     torch.as_tensor(traj.pos[-1, -1].numpy()))
    for got, n, prev_t in ((out is not None, len(rec.frames), rec.prev_t), jpacing):
        assert bool(got) and int(n) == 5 and float(prev_t) == pytest.approx(-1e9 + 5 / 30)


def test_so3_relative_angle_matches_jax():
    from diffsdfsim_torch.utils.quaternion import quat_to_matrix, so3_relative_angle
    from diffsdfsim_tpu.utils.quaternion import so3_relative_angle as jso3_relative_angle

    q = np.random.default_rng(5).normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = quat_to_matrix(torch.tensor(q))
    R2 = torch.cat([R[1:], R[:1]])
    R2[0] = R[0]
    got = so3_relative_angle(R, R2).numpy()
    np.testing.assert_allclose(got, _from_jax(lambda: jso3_relative_angle(jnp.asarray(R.numpy()), jnp.asarray(R2.numpy()))),
                               rtol=0, atol=1e-12)
    assert got[0] < 1e-3
