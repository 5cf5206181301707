"""Port parity, leaf modules: quaternions, vector helpers, template meshes,
analytic SDFs and their gradients (diffsdfsim_torch vs diffsdfsim_tpu,
float64 on the CPU, atol 1e-12: same formulas, rounding-level differences
only).

The JAX side's results (eager JAX compiles each operation once, seconds
in all) are read from ``tests/golden/leaf_jax.pkl``, which
``tests/golden/gen_torch_leaf_golden.py`` writes by running these tests with
the JAX calls live (``torch_jax_bridge.JaxGolden``); regenerate it when a
test's inputs change.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.ops import sdf as tsdf
from diffsdfsim_torch.physics import shapes as tshapes
from diffsdfsim_torch.utils import meshes as tmeshes
from diffsdfsim_torch.utils import quaternion as tq
from diffsdfsim_torch.utils import spherical as tsph
from diffsdfsim_tpu.ops import sdf as jsdf
from diffsdfsim_tpu.physics import shapes as jshapes
from diffsdfsim_tpu.utils import meshes as jmeshes
from diffsdfsim_tpu.utils import quaternion as jq
from diffsdfsim_tpu.utils import spherical as jsph
from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

ATOL = 1e-12
_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "leaf_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def rng_data():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w = rng.normal(size=(16, 3)) * np.array([[1.0]] * 8 + [[1e-8]] * 8)  # incl. the Taylor branch
    pts = rng.normal(size=(64, 3)) * 0.6
    pts[:4] = [[0.0, 0.0, 0.0], [0.3, 0.0, 0.0], [0.0, -0.2, 0.0], [0.25, 0.25, 0.1]]  # ties, zeros
    return q, w, pts


def test_quaternion_maps(rng_data):
    q, w, pts = rng_data
    T = torch.tensor

    def jax_side():
        jqq, jw = jnp.asarray(q), jnp.asarray(w)
        R = jq.quat_to_matrix(jqq)
        return (R, jq.quat_multiply(jqq, jnp.asarray(q[::-1])), jq.quat_invert(jqq),
                jq.quat_apply(jqq, jnp.asarray(pts[:16])), jq.quat_exp_map(jw), jq.integrate_quat(jqq, jw, 1 / 30),
                jq.so3_exp_map(jw), jq.matrix_to_quat(R), jq.so3_log_map(R), jq.quat_from_euler(jw))

    R, jmul, jinv, japp, jexp, jint, jso3, jm2q, jlog, jeul = _from_jax(jax_side)
    _close(tq.quat_to_matrix(T(q)), R)
    _close(tq.quat_multiply(T(q), T(q[::-1].copy())), jmul)
    _close(tq.quat_invert(T(q)), jinv)
    _close(tq.quat_apply(T(q), T(pts[:16])), japp)
    _close(tq.quat_exp_map(T(w)), jexp)
    _close(tq.integrate_quat(T(q), T(w), 1 / 30), jint)
    _close(tq.so3_exp_map(T(w)), jso3)
    _close(tq.matrix_to_quat(T(R)), jm2q)
    _close(tq.so3_log_map(T(R)), jlog, atol=1e-10)
    _close(tq.quat_from_euler(T(w)), jeul)


def test_spherical_helpers(rng_data):
    _, w, pts = rng_data
    T = torch.tensor
    jn, jz, jo, jsk, jcs = _from_jax(lambda: (
        jsph.normalize(jnp.asarray(pts)), jsph.normalize(jnp.zeros(3)),
        jnp.stack([jsph.orthogonal(jnp.asarray(p)) for p in pts]), jsph.skew_symmetric_mat(jnp.asarray(w)),
        jsph.cart_to_spherical(jnp.asarray(pts[4:]))))
    _close(tsph.normalize(T(pts)), jn)
    _close(tsph.normalize(torch.zeros(3, dtype=torch.float64)), jz)
    _close(tsph.orthogonal(T(pts)), jo)
    _close(tsph.skew_symmetric_mat(T(w)), jsk)
    for a, b in zip(tsph.cart_to_spherical(T(pts[4:])), jcs):
        _close(a, b)


@pytest.mark.parametrize("subdiv", [1, 2, 3])
def test_template_meshes(subdiv):
    for tm, jm in ((tmeshes.icosphere(subdiv), jmeshes.icosphere(subdiv)),
                   (tmeshes.cube_template(2**subdiv), jmeshes.cube_template(2**subdiv))):
        np.testing.assert_array_equal(tm[1], jm[1])
        _close(tm[0], jm[0])


SHAPES = [
    ("SphereShape", dict(rad=0.5)),
    ("BoxShape", dict(dims=[0.6, 0.4, 0.5])),
    ("RoundedBoxShape", dict(dims=[0.6, 0.6, 0.6], r=0.05)),
    ("CylinderShape", dict(rad=0.4, height=0.8)),
    ("BrickShape", dict(dims=[0.6, 0.3, 0.4], r=0.05)),
]


@pytest.mark.parametrize("name,params", SHAPES, ids=[s[0] for s in SHAPES])
def test_shape_sdf_and_gradient(name, params, rng_data):
    _, _, pts = rng_data
    tshape = getattr(tshapes, name)(**{k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()})
    tp = torch.tensor(pts)

    def jax_side():
        jshape = getattr(jshapes, name)(**{k: jnp.asarray(v) for k, v in params.items()})
        jp = jnp.asarray(pts)
        return (jshape.scale(), jshape.sdf(jp), jshape.sdf_grad(jp)) + tuple(jshapes.query_sdfs(jshape, jp * 1.3))

    jscale, jsdf_, jgrad, js, jg = _from_jax(jax_side)
    _close(tshape.scale(), jscale)
    _close(tshape.sdf(tp), jsdf_)
    _close(tshape.sdf_grad(tp), jgrad)
    ts, tg = tshapes.query_sdfs(tshape, tp * 1.3)
    _close(ts, js)
    _close(tg, jg)


def test_sdf_primitives_failsafe(rng_data):
    """The box gradient's diagonal failsafe at ties and _sign_nonzero at 0."""
    _, _, pts = rng_data
    dims = np.array([0.6, 0.4, 0.5])
    x = np.array([-1.0, 0.0, 2.0])
    jbox, jsign, jbrick = _from_jax(lambda: (
        jsdf.box_sdf_grad(jnp.asarray(pts), jnp.asarray(dims)), jsdf._sign_nonzero(jnp.asarray(x)),
        jsdf.brick_sdf(jnp.asarray(pts), jnp.asarray(dims), jnp.asarray(0.05))))
    _close(tsdf.box_sdf_grad(torch.tensor(pts), torch.tensor(dims)), jbox)
    _close(tsdf._sign_nonzero(torch.tensor(x)), jsign)
    _close(tsdf.brick_sdf(torch.tensor(pts), torch.tensor(dims), torch.tensor(0.05, dtype=torch.float64)), jbrick)
