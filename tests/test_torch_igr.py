"""Port parity, the IGR shape-space decoder (diffsdfsim_torch.models.igr vs
diffsdfsim_tpu.models.igr, float64 on the CPU) at a small width: 5 inputs
(latent 2 + point 3), ``(32,)*4`` hidden, skip at layer 2, weights from a
numpy seed handed to both packages.

Tolerances: values and first derivatives 1e-12 absolute (same formulas,
matmul rounding only); the mixed second derivative d/d latent of the point
gradient 1e-10; the checkpoint round trip against a torch forward 1e-10.

The JAX side is read from ``tests/golden/igr_jax.pkl``
(``gen_torch_igr_golden.py`` runs these tests with the JAX calls live,
``torch_jax_bridge.JaxGolden``); the HOCON parser, plain Python in both
packages, is held live.
"""

import os

import numpy as np
import pytest
import torch

from diffsdfsim_torch.models import igr as tigr
from diffsdfsim_torch.ops.igr_cuda import igr_mlp
from torch_jax_bridge import JaxGolden, one_torch_thread  # noqa: F401

DIMS, SKIP = (32,) * 4, (2,)
_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "igr_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


def _jax_params(net):
    """The JAX package's decoder parameters holding the port net's weights."""
    import jax.numpy as jnp
    from diffsdfsim_tpu.models import igr as jigr

    p = net.params()
    return jigr.ImplicitNetParams(tuple(jnp.asarray(w.numpy()) for w in p.weights),
                                  tuple(jnp.asarray(b.numpy()) for b in p.biases), SKIP, 5)


@pytest.fixture(scope="module")
def nets():
    net = tigr.init_implicit_net(5, DIMS, SKIP, radius_init=0.55, generator=np.random.default_rng(0))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.0, 1.0, (64, 3))
    pts[0] = 0.0
    return net, None, pts, rng.normal(size=2) * 0.3


def test_structure_and_frozen_weights(nets):
    net, _, _, _ = nets
    assert [getattr(net, f"lin{i}").weight.shape for i in range(5)] == [
        (32, 5), (27, 32), (32, 32), (32, 32), (1, 32)]
    assert not any(p.requires_grad for p in net.parameters())
    full = tigr.init_implicit_net(5, (128,) * 8, (4,), generator=np.random.default_rng(0))
    assert full.num_layers == 9 and full.lin3.weight.shape == (123, 128) and full.lin4.weight.shape == (128, 128)
    assert sum(p.numel() for p in full.parameters()) == 115836


def test_geometric_init_approximates_sphere(nets):
    """The full-width net (the reference's (128,)*8) starts near |x| - r."""
    _, _, pts, _ = nets
    net = tigr.init_implicit_net(5, radius_init=0.55, generator=np.random.default_rng(0))
    sdf = tigr.decode(net, torch.tensor(pts * 0.8), torch.zeros(2, dtype=torch.float64))
    assert np.corrcoef(sdf.numpy(), np.linalg.norm(pts * 0.8, axis=-1) - 0.55)[0, 1] > 0.75


def test_values_point_and_latent_gradients_match_jax(nets):
    net, _, pts, lat = nets
    z = torch.tensor(lat, requires_grad=True)
    vals = tigr.decode(net, torch.tensor(pts), z)
    grads = tigr.decode_grad(net, torch.tensor(pts), torch.tensor(lat))
    (gz,) = torch.autograd.grad(vals.sum(), z)

    def jax_side():
        import jax
        import jax.numpy as jnp
        from diffsdfsim_tpu.models import igr as jigr

        jdec = jigr.make_decoder(_jax_params(net))

        @jax.jit
        def ref(p, zz):
            f = lambda p, zz: jnp.sum(jdec(p, zz))  # noqa: E731
            return jdec(p, zz), jax.grad(f, 0)(p, zz), jax.grad(f, 1)(p, zz)

        return ref(jnp.asarray(pts), jnp.asarray(lat))

    for a, b in zip((vals, grads, gz), _from_jax(jax_side)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-12)


def test_point_gradient_differentiates_in_the_latent(nets):
    """d/d latent of sum(w * d decoder / d pts): the mixed second derivative
    the contact normals carry into d loss / d latent."""
    net, _, pts, lat = nets
    w = np.random.default_rng(2).normal(size=pts.shape)
    z = torch.tensor(lat, requires_grad=True)
    (gz,) = torch.autograd.grad(torch.sum(tigr.decode_grad(net, torch.tensor(pts), z) * torch.tensor(w)), z)

    def jax_side():
        import jax
        import jax.numpy as jnp
        from diffsdfsim_tpu.models import igr as jigr

        jdec = jigr.make_decoder(_jax_params(net))

        def f(zz):
            g = jax.grad(lambda p: jnp.sum(jdec(p, zz)))(jnp.asarray(pts))
            return jnp.sum(g * w)

        return jax.jit(jax.grad(f))(jnp.asarray(lat))

    np.testing.assert_allclose(gz.numpy(), _from_jax(jax_side), rtol=0, atol=1e-10)


def test_kernel_wrapper_takes_the_plain_version_on_cpu(nets):
    net, _, pts, lat = nets
    x = torch.cat([torch.tensor(lat).expand(len(pts), 2), torch.tensor(pts)], dim=-1)
    before = igr_mlp.launches
    assert torch.equal(net(x), tigr.implicit_net_apply(net.params(), x))
    assert igr_mlp.launches == before


def test_softplus_matches_torch():
    x = torch.linspace(-1, 1, 101, dtype=torch.float64)
    np.testing.assert_allclose(tigr.softplus_beta(x).numpy(),
                               torch.nn.functional.softplus(x, beta=100).numpy(), rtol=0, atol=1e-15)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_checkpoint_roundtrip(tmp_path, weight_norm):
    """A fake IGR checkpoint (plain or weight-norm state dict) loads into
    both packages and gives the torch forward's values (test_models.py:46-74)."""
    dims = [8, 16, 16, 1]
    g = torch.Generator().manual_seed(0)
    sd, ws = {}, []
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i + 1], dims[i], dtype=torch.float64, generator=g)
        if weight_norm:
            sd[f"module.lin{i}.weight_g"] = torch.linalg.norm(w, dim=1, keepdim=True) * 2.0
            sd[f"module.lin{i}.weight_v"] = w
            w = 2.0 * w
        else:
            sd[f"lin{i}.weight"] = w
        sd[f"{'module.' if weight_norm else ''}lin{i}.bias"] = torch.randn(dims[i + 1], dtype=torch.float64, generator=g)
        ws.append(w)
    mp, lp = tmp_path / "model.pth", tmp_path / "latent.pth"
    torch.save({"model_state_dict": sd}, mp)
    torch.save({"latent_codes": {"weight": torch.randn(5, 2, dtype=torch.float64, generator=g)}}, lp)

    net, codes = tigr.load_torch_checkpoint(str(mp), str(lp), skip_in=(), device="cpu")

    def jax_side():
        import jax.numpy as jnp
        from diffsdfsim_tpu.models import igr as jigr

        jparams, jcodes = jigr.load_torch_checkpoint(str(mp), str(lp), skip_in=())
        return jcodes, jigr.implicit_net_apply(jparams, jnp.asarray(np.ones((3, 8))))

    jcodes, jout = _from_jax(jax_side)
    assert codes.shape == (5, 2)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    x = torch.ones(3, 8, dtype=torch.float64)
    tx = x
    for i, w in enumerate(ws):
        tx = torch.nn.functional.linear(tx, w, sd[f"{'module.' if weight_norm else ''}lin{i}.bias"])
        if i < len(ws) - 1:
            tx = torch.nn.functional.softplus(tx, beta=100)
    np.testing.assert_allclose(net(x).numpy(), tx[:, 0].numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(net(x).numpy(), jout, rtol=0, atol=1e-10)


def test_hocon_lite_matches_jax():
    text = """
    // IGR exp.conf excerpt
    train { latent_size = 2, epochs = 10000 }
    network {
        inputs { dims = [512, 512, 512, 512], skip_in = [4], geometric_init = True, radius_init = 1, beta = 100 }
        "loss" : { lambda = 0.1 }
    }
    """
    from diffsdfsim_tpu.models import igr as jigr

    assert tigr._parse_hocon_lite(text) == jigr._parse_hocon_lite(text)


def test_loaders_default_to_cuda(monkeypatch, tmp_path):
    """The IGR loaders take device=None, meaning CUDA: without a card they
    raise with resolve_device's message; device="cpu" builds the net and the
    codes on the CPU."""
    ws = [np.ones((4, 5)), np.ones((1, 4))]
    bs = [np.zeros(4), np.zeros(1)]
    mp, lp = tmp_path / "model.pth", tmp_path / "latent.pth"
    torch.save({"model_state_dict": {f"lin{i}.{k}": torch.tensor(v) for i, (w, b) in enumerate(zip(ws, bs))
                                     for k, v in (("weight", w), ("bias", b))}}, mp)
    torch.save({"latent_codes": torch.zeros(3, 2, dtype=torch.float64)}, lp)
    exp = tmp_path / "exp" / "2020_01_01"
    (exp / "checkpoints" / "ModelParameters").mkdir(parents=True)
    (exp / "checkpoints" / "LatentCodes").mkdir(parents=True)
    (exp / "exp.conf").write_text("network { inputs { skip_in = [] } }")
    (exp / "checkpoints" / "ModelParameters" / "latest.pth").write_bytes(mp.read_bytes())
    (exp / "checkpoints" / "LatentCodes" / "latest.pth").write_bytes(lp.read_bytes())
    calls = [lambda **kw: (tigr.ImplicitNet.from_arrays(ws, bs, skip_in=(), **kw), None),
             lambda **kw: tigr.load_torch_checkpoint(str(mp), str(lp), skip_in=(), **kw),
             lambda **kw: tigr.load_igr_experiment(str(tmp_path / "exp"), **kw)[:2]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device is available; pass device='cpu'"):
            call()
        net, codes = call(device="cpu")
        assert net.lin0.weight.device.type == "cpu"
        assert codes is None or codes.device.type == "cpu"


def test_kernel_weight_layout_roundtrip(nets):
    """K4's packed buffer (``igr_cuda.pack_params``: per hidden layer chunks
    of NS output rows by KC inputs, stored [rank][chunk][row][input], zero
    padded) unpacks exactly to the layers' weights and biases; the padding is
    zero. Nets: the test width and the reference's (128,)*8 with its skip."""
    from diffsdfsim_torch.ops import igr_cuda

    ref = tigr.init_implicit_net(5, (128,) * 8, (4,), radius_init=0.55, generator=np.random.default_rng(1))
    for p in (nets[0].params(), ref.params()):
        prm, dims, offs = igr_cuda.pack_params(p)
        n_layers = len(p.weights)
        assert dims.reshape(n_layers, 3).tolist() == [[w.shape[1], w.shape[0], int(i in p.skip_in)]
                                                      for i, w in enumerate(p.weights)]
        for i, (w, b) in enumerate(zip(p.weights, p.biases)):
            n_out, n_in = w.shape
            kp = -(-n_in // igr_cuda.KC) * igr_cuda.KC
            w_off, b_off = int(offs[2 * i]), int(offs[2 * i + 1])
            if i < n_layers - 1:
                np_ = -(-n_out // igr_cuda.NS) * igr_cuda.NS
                tiles = prm[w_off:b_off].reshape(np_ // igr_cuda.NS, kp // igr_cuda.KC, igr_cuda.NS, igr_cuda.KC)
                full = tiles.permute(0, 2, 1, 3).reshape(np_, kp)
                bias = prm[b_off:b_off + np_]
            else:
                full = prm[w_off:b_off].reshape(1, kp)
                bias = prm[b_off:b_off + 1]
            assert torch.equal(full[:n_out, :n_in], w) and torch.equal(bias[:n_out], b)
            assert not full[n_out:].any() and not full[:, n_in:].any() and not bias[n_out:].any()
            assert w_off % 2 == 0 and b_off % 2 == 0  # 16-byte aligned chunks in float64
        assert int(offs[-1]) + 1 == prm.numel()
