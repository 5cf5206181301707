"""Port parity, bodies: ``make_body`` for the bench sphere (icosphere subdiv
2) and floor box (cube template subdiv 3) and the other analytic kinds:
template-projected verts, faces, mass and Mirtich inertia, float64 on the
CPU, atol 1e-10 (12 Newton projection steps and the volume integrals repeat
the same formulas; differences are rounding), against the JAX package's
``make_body`` as ``tests/golden/gen_torch_bodies_golden.py`` wrote it to
``tests/golden/bodies_f64.npz`` (the JAX package's eager projection takes
seconds a body)."""

import os

import numpy as np
import pytest
import torch

from diffsdfsim_torch import interop
from diffsdfsim_torch.physics import shapes as tshapes
from diffsdfsim_torch.physics.bodies import make_body as t_make_body
from torch_jax_bridge import one_torch_thread  # noqa: F401

ATOL = 1e-10
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "bodies_f64.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))

CASES = [
    ("bench-floor", "BoxShape", dict(dims=[20.0, 1.0, 20.0]), dict(subdiv=3, fric_coeff=0.25)),
    ("bench-sphere", "SphereShape", dict(rad=0.5), dict(subdiv=2, fric_coeff=0.25)),
    ("cylinder-custom-inertia", "CylinderShape", dict(rad=0.4, height=0.8), dict(subdiv=2, custom_inertia=True)),
    ("rounded-box", "RoundedBoxShape", dict(dims=[0.6, 0.6, 0.6], r=0.05), dict(subdiv=2, mass=2.0)),
]


@pytest.mark.parametrize("name,kind,params,kw", CASES, ids=[c[0] for c in CASES])
def test_make_body_matches(golden, name, kind, params, kw):
    tb = t_make_body(getattr(tshapes, kind)(**{k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}),
                     device="cpu", **kw)
    np.testing.assert_array_equal(tb.faces, golden[f"{name}_faces"])
    for field in ("verts", "mass", "ang_inertia", "restitution", "fric_coeff"):
        np.testing.assert_allclose(getattr(tb, field).numpy(), golden[f"{name}_{field}"],
                                   rtol=0, atol=ATOL, err_msg=field)
    assert tb.is_sdf


def test_mesh_body_and_interop_roundtrip(golden):
    """Explicit verts/faces make a plain mesh body; interop carries a JAX
    body (the golden's sphere) across and back unchanged."""
    from diffsdfsim_torch.utils import meshes

    tv, tf = meshes.cube_template(2)
    tb = t_make_body(tshapes.BoxShape(torch.tensor([0.5, 0.5, 0.5])), verts=0.25 * tv, faces=tf, device="cpu")
    assert not tb.is_sdf and tb.kind == tshapes.KIND_NONE
    d = {k[len("interop_"):]: (v.item() if v.ndim == 0 and v.dtype.kind in "bU" else v) for k, v in golden.items()
         if k.startswith("interop_")}
    assert d["shape"] == "SphereShape" and d["is_sdf"] is True
    back = interop.body_to_numpy(interop.body_from_numpy(d, device="cpu"))
    for key, val in d.items():
        np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(val), err_msg=key)


def test_interop_defaults_to_cuda(monkeypatch):
    """interop's from_numpy entry points take device=None, meaning CUDA: without
    a card they raise with resolve_device's message."""
    from diffsdfsim_torch.utils import meshes

    tv, tf = meshes.cube_template(1)
    d = interop.body_to_numpy(t_make_body(tshapes.BoxShape(torch.tensor([0.5, 0.5, 0.5])), verts=0.25 * tv,
                                          faces=tf, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, arg in ((interop.body_from_numpy, d), (interop.contacts_from_numpy, {}), (interop.state_from_numpy, {})):
        with pytest.raises(RuntimeError, match="no CUDA device is available; pass device='cpu'"):
            fn(arg)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """device=None means CUDA: without a card the entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make_body(tshapes.SphereShape(torch.tensor(0.5)), subdiv=1)
