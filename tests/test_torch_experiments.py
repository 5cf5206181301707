"""Port parity, the fitting experiments (``diffsdfsim_torch.experiments``:
``optim_sysid``, ``optim_sphere``, ``optim_shapespace`` at ``n_par > 1``,
``evaluate``, ``generate_jobs``) and what they run on, against the JAX
package, float64 on the CPU.

- Live against JAX, no rollout: the force library, ``chamfer_distance``,
  optax's Adam and SGD rules and the sphere's convergence freeze (to 0
  and 1e-15), ``evaluate`` on run directories and ``generate_jobs``' lines
  (equal).
- The sweeps against the JAX goldens ``tests/golden/sweep_*_f64.npz``
  (``tests/golden/gen_torch_experiments_golden.py``) at JAX's draws, each
  step's per-lane loss, gradient and parameter: ``optim_sysid`` for each
  parameter (2 lanes, ``run_time`` 0.3, ``mesh_subdiv`` 1, 2 Adam steps)
  within 1e-9 relative (read 2e-13); ``optim_sphere`` (2 lanes,
  ``run_time`` 1.0, the wall and the floor, ``mesh_subdiv`` 1, 1 GD step,
  within 1e-9, read 4e-15) and ``optim_shapespace`` (2 lanes of the
  ``latent32`` net, 1 Adam step, within 1e-6, the shape goldens'
  tolerance) under ``-m slow`` (33 s and 27 s of CPU).
- Each lane of a sweep against the single path at its draws. Not bitwise,
  as the bench sweep's lanes are: the lane axis' batched products sum in
  another order than the single path's 2-D ones (MKL's gemv for the
  contact velocity J v of a resting cube, whose terms cancel to ~1e-16;
  the decoder's matrix products over the lanes' points), and the LCP
  solve amplifies a difference of 2e-31 in h to ~1e-11 in x. The sphere's
  lanes within 1e-12 relative (read 0 and one ulp), the sysid and
  shape-space lanes within 1e-9 (read ~1e-11).
- Latent lane bodies: a lane body's SDF query equals each lane's own query
  (values and gradients within 1e-13); under ``torch.func.vmap`` the K4
  Function's vmap rule folds the lanes into one launch over their points,
  for the value and the backward (a stand-in kernel counts the launches on
  the CPU); ``stack_lanes`` refuses lanes whose decoders differ.
- The entry points run on the CPU only when asked (``device="cpu"``).

The JAX side of the live comparisons (eager JAX compiles each operation
once, seconds in all) is read from ``tests/golden/experiments_jax.pkl``,
which ``tests/golden/gen_torch_experiments_jax_golden.py`` writes by running
these tests with the JAX calls live (``torch_jax_bridge.JaxGolden``);
regenerate it when a test's inputs change.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "sweep_{}_f64.npz")
SYSID_SWEEP = dict(run_time=0.3, mesh_subdiv=1, n_par=2)
SPHERE_SWEEP = dict(run_time=1.0, mesh_subdiv=1, n_par=2)
RTOL_GOLDEN = 1e-9
RTOL_LANE = 1e-9
_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "experiments_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


def _golden(case):
    return dict(np.load(GOLDEN.format(case)))


# ---------------------------------------------------------------- live


@pytest.mark.parametrize("name", ["UP", "DOWN", "RIGHT", "LEFT", "FRONT", "BACK", "ROTX", "ROTY", "ROTZ", "ZERO6"])
def test_force_axes_match_jax(name):
    from diffsdfsim_torch.physics import forces as tf
    from diffsdfsim_tpu.physics import forces as jf

    like = torch.zeros((), dtype=torch.float64)
    got = getattr(tf, name)(like)
    assert got.dtype == torch.float64 and np.array_equal(got.numpy(), _from_jax(lambda: getattr(jf, name)()))


def test_impulses_match_jax():
    """The impulse helpers at times around their 0.1 s window, per time and
    for a lane axis of times."""
    from diffsdfsim_torch.physics import forces as tf
    from diffsdfsim_tpu.physics import forces as jf

    ts = [0.0, 0.05, 0.1, 0.2]
    for name in ("vert_impulse", "hor_impulse", "rot_impulse"):
        lanes = getattr(tf, name)(torch.tensor(ts, dtype=torch.float64))
        wants = _from_jax(lambda: tuple(getattr(jf, name)(jnp.asarray(t)) for t in ts))  # noqa: B023
        for i, (t, want) in enumerate(zip(ts, wants)):
            assert np.array_equal(getattr(tf, name)(torch.tensor(t, dtype=torch.float64)).numpy(), want)
            assert np.array_equal(lanes[i].numpy(), want)


def test_chamfer_distance_matches_jax():
    from diffsdfsim_torch.utils.meshes import chamfer_distance
    from diffsdfsim_tpu.utils import meshes as jmeshes

    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(50, 3)), rng.normal(size=(37, 3))
    np.testing.assert_allclose(float(chamfer_distance(torch.tensor(x), torch.tensor(y))),
                               float(_from_jax(lambda: jmeshes.chamfer_distance(jnp.asarray(x), jnp.asarray(y)))),
                               rtol=1e-15)


def test_optimizer_rules_and_freeze_match_optax():
    """Adam and SGD by optax's rule on a (B,) parameter, and the sphere's
    per-lane convergence freeze (``jnp.where(done, ...)`` over the state,
    each lane its own Adam count), against optax on a quadratic whose lanes
    converge at different steps."""
    import optax

    from diffsdfsim_torch.experiments.fitting import descend, make_optimizer

    a, x0 = np.array([1.0, 4.0, 0.25]), np.array([1.5, -0.7, 0.9])
    for name, opt in (("Adam", optax.adam(0.1)), ("GD", optax.sgd(0.1))):

        def vg(x):  # per-lane loss a (x - 0.3)^2, its gradient
            return torch.tensor(a) * (x - 0.3) ** 2, 2 * torch.tensor(a) * (x - 0.3)

        x, losses, xs, _ = descend(vg, torch.tensor(x0), make_optimizer(name, 0.1), 30, clip=(-1.0, 1.2),
                                   conv_thresh=1e-3)

        def jax_side():
            jx, js, last, done = jnp.asarray(x0), opt.init(jnp.asarray(x0)), jnp.full(3, 1e10), jnp.zeros(3, bool)  # noqa: B023
            want_l, want_x = [], []
            for _ in range(30):
                val, g = jnp.asarray(a) * (jx - 0.3) ** 2, 2 * jnp.asarray(a) * (jx - 0.3)
                done = done | (jnp.abs(last - val) < 1e-3)
                upd, new_s = opt.update(g, js)  # noqa: B023
                jx = jnp.where(done, jx, jnp.clip(jx + upd, -1.0, 1.2))
                js = jax.tree_util.tree_map(lambda p, q: jnp.where(done, p, q), js, new_s)  # noqa: B023
                last = val
                want_l.append(val)
                want_x.append(jx)
            return bool(done.any()), want_l, want_x

        any_done, want_l, want_x = _from_jax(jax_side)
        assert bool(any_done), f"{name}: no lane converged, the freeze is not exercised"
        np.testing.assert_allclose(losses.numpy(), np.asarray(want_l), rtol=0, atol=1e-15, err_msg=name)
        np.testing.assert_allclose(xs.numpy(), np.asarray(want_x), rtol=0, atol=1e-15, err_msg=name)


def _write_runs(base, cls_common, n=3):
    """n run directories of the sysid_mass experiment through ``common.Run``."""
    rng = np.random.default_rng(1)
    for i in range(n):
        run = cls_common.Run("sysid_mass", {"seed": i}, base_dir=str(base))
        run.log_scalar("loss", 0.5 / (i + 1), 0)
        run.save_output({"final_theta": rng.uniform(0.2, 1.4, size=(2,)), "target_theta": rng.uniform(0.2, 1.4, 2)})
        run.finish(status="COMPLETED" if i < n - 1 else "FAILED")


def test_evaluate_matches_jax(tmp_path):
    """The port's ``evaluate`` on run directories its ``common.Run`` wrote,
    against the JAX package's: the runs read, the errors, the summary."""
    from diffsdfsim_torch.experiments import common as tcommon
    from diffsdfsim_torch.experiments import evaluate as tev
    from diffsdfsim_tpu.experiments import evaluate as jev

    _write_runs(tmp_path, tcommon)
    base = tmp_path / "sysid_mass"
    got, want = tev.read_runs(base), jev.read_runs(base)
    assert [r["cfg"] for r in got] == [r["cfg"] for r in want] and len(got) == 2
    assert json.loads((base / "1" / "metrics.json").read_text())["loss"]["values"] == [0.5]
    fk, tk = tev.KEYMAP["sysid_mass"]
    assert tev.KEYMAP == jev.KEYMAP
    errs = tev.param_errors(got, fk, tk)
    np.testing.assert_array_equal(errs, jev.param_errors(want, fk, tk))
    assert tev.summarize(errs, "x") == jev.summarize(errs, "x")
    assert tev.main([str(base), "2"]) == jev.main([str(base), "2"])
    with open(base / "1" / "output.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"final_theta", "target_theta"}


def test_generate_jobs_matches_jax():
    from diffsdfsim_torch.experiments import generate_jobs as tgj
    from diffsdfsim_tpu.experiments import generate_jobs as jgj

    for argv in (["sphere", "3"], ["sysid", "2", "--spmd"], ["shapespace", "50", "--spmd"]):
        want = [ln.replace("diffsdfsim_tpu.", "diffsdfsim_torch.") for ln in jgj.main(argv)]
        assert tgj.main(argv) == want


# ---------------------------------------------------------------- latent lanes


@pytest.fixture(scope="module")
def net():
    from diffsdfsim_torch.models import igr

    g = dict(np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "latent32_f64.npz")))
    return igr.init_implicit_net(5, tuple(g["dims"].tolist()), tuple(g["skip_in"].tolist()),
                                 radius_init=float(g["radius"]), generator=np.random.default_rng(int(g["weight_seed"])))


def _latent_bodies(net, latents):
    from diffsdfsim_torch.physics import LatentShape, make_body

    return [make_body(LatentShape(torch.tensor(z), torch.tensor(1.0, dtype=torch.float64), net), subdiv=1,
                      project_iters=16, device="cpu") for z in latents]


def test_latent_lane_body_query_matches_each_lane(net):
    """A latent lane body (its code per lane, the decoder shared) answers
    each lane's points as that lane's own body does."""
    from diffsdfsim_torch.physics.bodies import stack_lanes

    latents = [[0.1, -0.2], [0.3, 0.25], [-0.2, 0.05]]
    bodies = _latent_bodies(net, latents)
    lane = stack_lanes(bodies)
    assert lane.lanes == 3 and lane.shape.latent.shape == (3, 2) and lane.shape.decoder is net
    pts = torch.tensor(np.random.default_rng(2).uniform(-1.2, 1.2, (3, 40, 3)))
    sd, gr = lane.query_sdfs(pts)
    for i, bd in enumerate(bodies):
        s1, g1 = bd.query_sdfs(pts[i])
        torch.testing.assert_close(sd[i], s1, rtol=0, atol=1e-13)
        torch.testing.assert_close(gr[i], g1, rtol=0, atol=1e-13)
    torch.testing.assert_close(lane.scale(), torch.ones(3, dtype=torch.float64), rtol=0, atol=0)


def test_stack_lanes_refuses_another_decoder(net):
    import copy

    from diffsdfsim_torch.physics.bodies import stack_lanes

    a, b = _latent_bodies(net, [[0.1, -0.2], [0.3, 0.25]])
    b.shape = type(b.shape)(b.shape.latent, b.shape.scale_, copy.deepcopy(net))
    with pytest.raises(ValueError, match="one object"):
        stack_lanes([a, b])


def test_igr_function_vmap_rule_is_one_launch(net):
    """Under ``torch.func.vmap`` (nested too) the K4 Function folds the
    mapped axes into the point axis: one ``kernel.run`` for the whole
    query, equal to the plain decoder per lane, and its backward the plain
    vector-Jacobian product over the folded points. A stand-in kernel runs
    the plain decoder and counts its launches."""
    from diffsdfsim_torch.models.igr import implicit_net_apply
    from diffsdfsim_torch.ops.igr_cuda import _IgrMlp

    class Kernel:
        launches = 0

        def run(self, params, x):
            assert x.dim() == 2
            self.launches += 1
            return implicit_net_apply(params, x.detach())

    kernel, p = Kernel(), net.params()
    lat = torch.tensor(np.random.default_rng(3).normal(size=(3, 2)) * 0.3, requires_grad=True)
    pts = torch.tensor(np.random.default_rng(4).uniform(-1, 1, (3, 11, 3)))

    def query(z, x):
        return _IgrMlp.apply(torch.cat([z.expand(x.shape[0], 2), x], -1), p, kernel)

    out = torch.func.vmap(query)(lat, pts)
    assert kernel.launches == 1 and out.shape == (3, 11)
    ref = torch.stack([implicit_net_apply(p, torch.cat([lat[i].expand(11, 2), pts[i]], -1)) for i in range(3)])
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-14)
    (g,), (g_ref,) = torch.autograd.grad(out.sum(), lat), torch.autograd.grad(ref.sum(), lat)
    torch.testing.assert_close(g, g_ref, rtol=0, atol=1e-13)
    nested = torch.func.vmap(torch.func.vmap(query))(lat[:, None].expand(3, 2, 2), pts[:, None].expand(3, 2, 11, 3))
    assert kernel.launches == 2 and nested.shape == (3, 2, 11)


# ---------------------------------------------------------------- sweeps


@pytest.fixture(scope="module")
def sysid_runs():
    """Each parameter's batched sweep at the golden's draws."""
    from diffsdfsim_torch.experiments import optim_sysid as osy

    out = {}
    for param in ("mass", "force", "friction"):
        g = _golden(f"sysid_{param}")
        c = dict(osy.DEFAULTS, param=param, **SYSID_SWEEP)
        res = osy.fit_batched(torch.tensor(g["target"]), torch.tensor(g["start"]), c, osy.build_cfg(c), "cpu",
                              max_iter=2)
        out[param] = (g, c, res)
    return out


@pytest.mark.parametrize("param", ["mass", "force", "friction"])
def test_sysid_sweep_matches_golden(sysid_runs, param):
    """Two Adam steps of the batched-native sweep: per-lane losses,
    gradients and parameters against JAX's ``simulate_batched`` sweep."""
    g, _, res = sysid_runs[param]
    for key, gk in (("loss_hist", "loss"), ("grad_hist", "grad"), ("theta_hist", "theta")):
        np.testing.assert_allclose(res[key].numpy(), g[gk], rtol=RTOL_GOLDEN, atol=0, err_msg=key)
    assert bool((res["theta_hist"][-1] != res["start_theta"]).all())


@pytest.mark.parametrize("param", ["mass", "force", "friction"])
def test_sysid_sweep_lanes_match_single(sysid_runs, param):
    """Each lane of the sweep against ``fit`` on the single path."""
    from diffsdfsim_torch.experiments import optim_sysid as osy

    g, c, res = sysid_runs[param]
    for i in range(2):
        one = osy.fit(torch.tensor(g["target"][i]), torch.tensor(g["start"][i]), c, osy.build_cfg(c), "cpu",
                      max_iter=2)
        for key in ("loss_hist", "grad_hist", "theta_hist"):
            np.testing.assert_allclose(res[key][:, i].numpy(), one[key].numpy(), rtol=RTOL_LANE, atol=0,
                                       err_msg=f"lane {i} {key}")


def test_sysid_lane_bodies_by_parameter():
    """Where the parameter puts the lane axis: mass the cube, friction the
    floor and the cube (each fric_coeff on its lane's tape), force the push."""
    from diffsdfsim_torch.experiments import optim_sysid as osy
    from diffsdfsim_torch.physics import make_world_batched

    for param, axes in (("mass", [0, 2]), ("friction", [2, 2]), ("force", [0, 0])):
        c = dict(osy.DEFAULTS, param=param, **SYSID_SWEEP)
        th = torch.tensor(osy.PARAM_SETUP[param]["range"], dtype=torch.float64, requires_grad=True)
        _, bodies_b, forces_b, _ = make_world_batched(lambda t: osy.build_world(t, c, osy.build_cfg(c), "cpu"), th,
                                                      return_forces=True)
        assert [bd.lanes for bd in bodies_b] == axes
        assert (forces_b[1][1].mag.shape == (2,)) == (param == "force")
        if param == "friction":
            (gr,) = torch.autograd.grad(bodies_b[0].fric_coeff[1] + bodies_b[1].fric_coeff[1], th)
            assert gr.tolist() == [0.0, 2.0]


@pytest.mark.slow
def test_sphere_sweep_matches_golden_and_single():
    """One GD step of the batched-native sphere sweep in the room (2 lanes,
    30 frames: each sphere reaches the wall, then the floor) against JAX's
    ``make_loss_batched`` sweep: loss, d loss / d rad and the radius after
    the step within 1e-9 relative (read 4e-15); each lane against the single
    path's ``fit`` within 1e-12 (read 0, and one ulp in lane 0's
    gradient)."""
    from diffsdfsim_torch.experiments import optim_sphere as osp

    g = _golden("sphere")
    c = dict(osp.DEFAULTS, **SPHERE_SWEEP)
    cfg = osp.build_cfg(c)
    target, start = torch.tensor(g["target"]), torch.tensor(g["start"])
    res = osp.fit_batched(target, start, c, cfg, "cpu", max_iter=1)
    for key, gk in (("loss_hist", "loss"), ("grad_hist", "grad"), ("rad_hist", "rad")):
        np.testing.assert_allclose(res[key].numpy(), g[gk], rtol=RTOL_GOLDEN, atol=0, err_msg=key)
    for i in range(2):
        one = osp.fit(target[i], start[i], c, cfg, "cpu", max_iter=1)
        for key in ("loss_hist", "grad_hist", "rad_hist"):
            np.testing.assert_allclose(res[key][:, i].numpy(), one[key].numpy(), rtol=1e-12, atol=0,
                                       err_msg=f"lane {i} {key}")


@pytest.mark.slow
def test_shapespace_sweep_matches_golden_and_single(net):
    """One Adam step of the batched-native shape-space sweep (2 lanes of the
    latent32 net, 20 frames) against JAX's ``run_one`` lane by lane: loss,
    d loss / d latent and the latent after the step within 1e-6 relative
    (the shape goldens' tolerance); each lane against the single path's
    ``fit`` within 1e-9."""
    from diffsdfsim_torch.experiments import optim_shapespace as oss

    g = _golden("shapespace")
    c = dict(oss.DEFAULTS, run_time=int(g["frames"]) / 30.0, n_par=2)
    cfg = oss.build_cfg(c)
    args = [torch.tensor(g[k]) for k in ("target", "start", "quat0")]
    res = oss.fit_batched(net, *args, c, cfg, "cpu", max_iter=1)
    for key, gk in (("loss_hist", "loss"), ("grad_hist", "grad"), ("latent_hist", "latent")):
        got = res[key] if key != "latent_hist" else res["final_latent"][None]
        np.testing.assert_allclose(got.numpy(), g[gk], rtol=1e-6, atol=0, err_msg=key)
    for i in range(2):
        one = oss.fit(net, *(a[i] for a in args), c, cfg, "cpu", max_iter=1)
        for key in ("loss_hist", "grad_hist", "latent_err_hist"):
            np.testing.assert_allclose(res[key][:, i].numpy(), one[key].numpy(), rtol=RTOL_LANE, atol=0,
                                       err_msg=f"lane {i} {key}")


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("module", ["optim_sysid", "optim_sphere", "optim_shapespace"])
def test_main_needs_cuda_or_cpu_asked(tmp_path, module):
    """Without a card an entry point raises before it writes a run
    directory, unless the CPU is asked for."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    m = importlib.import_module(f"diffsdfsim_torch.experiments.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.main(["with", f"base_dir={tmp_path}", "n_par=2"])
    assert not any(tmp_path.iterdir())


def test_sysid_main_runs_on_cpu(tmp_path):
    """``main`` at n_par = 2 and 1 on the CPU writes the run directory of the
    JAX package's layout, histories (max_iter, B) and (max_iter,)."""
    from diffsdfsim_torch.experiments import optim_sysid as osy

    argv = ["with", "param=force", "run_time=0.1", "mesh_subdiv=1", "max_iter=1", f"base_dir={tmp_path}"]
    out = osy.main(argv + ["n_par=2"], device="cpu")
    assert out["loss_hist"].shape == (1, 2) and out["final_theta"].shape == (2,)
    one = osy.main(argv, device="cpu")
    assert one["loss_hist"].shape == (1,)
    np.testing.assert_allclose(one["loss_hist"], out["loss_hist"][:, 0], rtol=RTOL_LANE)
    runs = sorted((tmp_path / "sysid_force").iterdir())
    assert [p.name for p in runs] == ["1", "2"]
    assert json.loads((runs[0] / "run.json").read_text())["status"] == "COMPLETED"
