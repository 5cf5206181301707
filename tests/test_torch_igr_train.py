"""The port's shape-space training (``diffsdfsim_torch/models/igr_train.py``)
against the JAX package's ``models/igr_train.py``, float64 on the CPU.

The JAX side of the loss and the Adam step is read from
``tests/golden/igr_train_f64.npz`` and the JAX package's cache file from
``tests/golden/igr_space_jax.pkl`` (``gen_torch_igr_train_golden.py``);
the cache written by the port is read back by the JAX package live.
"""

import os

import numpy as np
import pytest
import torch

from torch_jax_bridge import one_torch_thread  # noqa: F401

from diffsdfsim_torch import interop
from diffsdfsim_torch.experiments.fitting import Adam
from diffsdfsim_torch.models.igr import ImplicitNetParams, decode
from diffsdfsim_torch.models.igr_train import (
    adam_step,
    default_shape_fns,
    load_or_train,
    shapespace_loss,
    train_tiny_shapespace,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def gold():
    return dict(np.load(os.path.join(GOLDEN, "igr_train_f64.npz")))


def _layers(g, tag, name):
    n = sum(1 for k in g if k.startswith(f"{name}{tag}") and k[len(name) + len(tag):].isdigit())
    return [torch.tensor(g[f"{name}{tag}{i}"]) for i in range(n)]


def test_loss_and_adam_step_match_jax(gold):
    """At JAX's initial net, codes and first step's points, the port's loss
    (SDF regression, eikonal term through a double backward, latent L2)
    and one Adam step (lr 2e-3) match ``train_tiny_shapespace``'s within
    1e-10 relative (loss) and 1e-10 absolute (weights, biases, codes)."""
    ws, bs = _layers(gold, "", "w"), _layers(gold, "", "b")
    skip, d_in = tuple(int(i) for i in gold["skip_in"]), ws[0].shape[1]
    fns = default_shape_fns()
    surfb, uniform = torch.tensor(gold["surfb"]), torch.tensor(gold["uniform"])
    nl = len(ws)

    def loss_fn(xs):
        prm = ImplicitNetParams(tuple(xs[:nl]), tuple(xs[nl:2 * nl]), skip, d_in)
        return shapespace_loss(prm, xs[-1], surfb, uniform, fns)

    opt = Adam(2e-3)
    tensors = ws + bs + [torch.tensor(gold["codes"])]
    loss, new, _ = adam_step(tensors, [opt.init(t) for t in tensors], opt, loss_fn)
    assert abs(float(loss) - float(gold["loss"])) <= 1e-10 * abs(float(gold["loss"]))
    want = _layers(gold, "1_", "w") + _layers(gold, "1_", "b") + [torch.tensor(gold["codes1"])]
    for a, b in zip(new, want):
        assert float((a - b).abs().max()) <= 1e-10


def test_short_training_decodes_distinct_shapes(tmp_path):
    """80 steps of a (32,)*4 net on 64 points a step: every code decodes its
    shape within an RMSE of 0.12 and the sphere's and the box's codes decode
    different fields (RMSE > 0.05), the JAX package's test_igr_train.py
    property; the cache round trip through ``load_or_train`` decodes the
    same values (1e-12)."""
    path = str(tmp_path / "space.pkl")
    net, codes = load_or_train(path, dims=(32,) * 4, n_steps=80, n_pts=64, device="cpu")
    pts = torch.rand((256, 3), generator=torch.Generator().manual_seed(0), dtype=torch.float64) * 2 - 1
    errs = [float(torch.sqrt(torch.mean((decode(net, pts, codes[i]) - fn(pts)) ** 2)))
            for i, fn in enumerate(default_shape_fns())]
    assert max(errs) < 0.12, errs
    assert float(torch.sqrt(torch.mean((decode(net, pts, codes[0]) - decode(net, pts, codes[1])) ** 2))) > 0.05
    net2, codes2 = load_or_train(path, device="cpu")
    assert float((decode(net2, pts, codes2[2]) - decode(net, pts, codes[2])).abs().max()) <= 1e-12


def test_cache_crosses_both_packages(gold, tmp_path):
    """The JAX package's cache file loads in the port and decodes as JAX
    did (1e-12); a cache the port writes loads in the JAX package with the
    port's weights, biases, skip layers and codes, bit for bit."""
    net, codes = interop.read_space(os.path.join(GOLDEN, "igr_space_jax.pkl"), device="cpu")
    pts = torch.tensor(gold["cache_pts"])
    port = torch.stack([decode(net, pts, z) for z in codes]).numpy()
    np.testing.assert_allclose(port, gold["cache_sdf"], rtol=0, atol=1e-12)

    from diffsdfsim_tpu.models.igr_train import load_or_train as jax_load_or_train

    net, codes, _ = train_tiny_shapespace(dims=(16,) * 4, n_steps=2, n_pts=32, device="cpu")
    path = str(tmp_path / "port_space.pkl")
    interop.write_space(path, net, codes)
    jparams, jcodes = jax_load_or_train(path)
    p = net.params()
    for a, b in zip(jparams.weights + jparams.biases + (jcodes,), p.weights + p.biases + (codes,)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tuple(jparams.skip_in) == p.skip_in and jparams.d_in == p.d_in
