"""Port parity, the MeshSDF demo (``diffsdfsim_torch/demos/meshsdf.py``)
against the JAX package's ``demos/demo_meshsdf.py``, float64 on the CPU.

The JAX side is read from ``tests/golden/demo_f64.npz``
(``tests/golden/gen_torch_demo_golden.py``): the JAX demo's ``main`` run
for 2 SGD iterations with its ``init_implicit_net(PRNGKey(7))`` decoder
narrowed to two hidden layers of 32, every body's mesh one subdivision
coarser than the demo's (``coarser``) and 0.5 s of simulation (the body
lands on the pole at about 0.37 s), whose weights the file carries across
as numpy. The port's ``optimize`` runs from the same weights and meshes.

Tolerances: each iteration's loss and the latent after each step within
1e-6 relative of JAX's (the shape-space fit's tolerance, through the same
decoder and contacts); the clip equal to optax's ``clip_by_global_norm``
bitwise, on a vector below and above the norm.
"""

import os

import numpy as np
import optax
import jax.numpy as jnp
import pytest
import torch

from diffsdfsim_torch.demos import meshsdf as D
from diffsdfsim_torch.models.igr import ImplicitNet
from torch_jax_bridge import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "demo_f64.npz")
RTOL = 1e-6


def golden_decoder(g, device="cpu"):
    """The JAX demo's decoder weights as the port's ImplicitNet."""
    n = sum(1 for k in g if k.startswith("w"))
    return ImplicitNet.from_arrays([g[f"w{i}"] for i in range(n)], [g[f"b{i}"] for i in range(n)],
                                   skip_in=tuple(int(i) for i in g["skip_in"]), device=device)


def test_demo_matches_jax_golden(monkeypatch):
    g = dict(np.load(GOLDEN))
    make_body, coarser = D.make_body, int(g["coarser"])
    monkeypatch.setattr(D, "make_body", lambda shape, **kw: make_body(shape, **dict(kw, subdiv=kw["subdiv"] - coarser)))
    c = dict(D.DEFAULTS, iters=int(g["iters"]), run_time=float(g["run_time"]))
    hist = D.optimize(golden_decoder(g), torch.zeros(2, dtype=torch.float64), c, D.build_cfg(),
                      D.fixed_bodies("cpu"), log=lambda *_: None)
    np.testing.assert_allclose(hist["loss"], g["loss"], rtol=RTOL)
    np.testing.assert_allclose(np.stack(hist["latent"]), g["latent"], rtol=RTOL)
    assert np.all(np.abs(np.stack(hist["grad"])) > 1e-3)  # the contact moves the loss, not the regularizer alone


@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_clip_matches_optax(scale):
    """optax.clip_by_global_norm(10) on a vector below (0.5) and above (3.0)
    the norm."""
    g = np.array([-3.21421415, -1.28368552, 8.4]) * scale
    want, _ = optax.clip_by_global_norm(10.0).update(jnp.asarray(g), optax.EmptyState())
    got = D.clip_by_global_norm(torch.tensor(g), 10.0)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (np.linalg.norm(g) > 10.0) == (not np.array_equal(got.numpy(), g))


def test_main_needs_a_card_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.main(["iters=0"])
