"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the bench
scene in both packages, and objects carried between them as the numpy dicts
of ``diffsdfsim_torch.interop``.

The port's bodies and states are built here and handed to the JAX package
(test_torch_bodies.py holds ``make_body`` itself against JAX), which keeps
eager JAX world construction out of the tier-1 time.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# bench.py's forward configuration with the float64 tolerance
BENCH_CFG = dict(
    fric_dirs=8, max_contacts_per_pair=4, max_contacts_total=4, mesh_subdiv=2,
    max_substeps=4, max_bisect=8, tol=1e-8,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager PyTorch on tiny tensors gains nothing from intra-op threads;
    under pytest-xdist they only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_body_np(bd) -> dict:
    d = {"shape": type(bd.shape).__name__, "faces": np.asarray(bd.faces), "is_sdf": bd.is_sdf}
    for name in bd.shape.__dataclass_fields__:
        d[name] = np.asarray(getattr(bd.shape, name))
    for name in ("verts", "mass", "ang_inertia", "restitution", "fric_coeff"):
        d[name] = np.asarray(getattr(bd, name))
    return d


def jax_decoder(d: dict):
    """The JAX package's decoder of the port's ``interop`` decoder arrays
    (``weights``, ``biases``, ``skip_in``): the weights-across function for
    ``ImplicitNetParams``."""
    from diffsdfsim_tpu.models.igr import ImplicitNetParams, make_decoder

    ws = tuple(jnp.asarray(w) for w in d["weights"])
    return make_decoder(ImplicitNetParams(ws, tuple(jnp.asarray(b) for b in d["biases"]),
                                          tuple(int(i) for i in d["skip_in"]), int(ws[0].shape[1])))


def jax_body_from_torch(tb):
    """The JAX package's BodyDef holding the port body's values (a latent
    body's decoder from the port's weights)."""
    from diffsdfsim_torch import interop
    from diffsdfsim_tpu.physics import shapes as jshapes
    from diffsdfsim_tpu.physics.bodies import BodyDef

    d = interop.body_to_numpy(tb)
    cls = getattr(jshapes, d["shape"])
    kw = {name: jnp.asarray(d[name]) for name in cls.__dataclass_fields__ if name != "decoder"}
    if d["shape"] == "LatentShape":
        kw["decoder"] = jax_decoder(d)
    shape = cls(**kw)
    return BodyDef(
        shape=shape, verts=jnp.asarray(d["verts"]), faces=np.asarray(d["faces"], dtype=np.int32),
        mass=jnp.asarray(d["mass"]), ang_inertia=jnp.asarray(d["ang_inertia"]),
        restitution=jnp.asarray(d["restitution"]), fric_coeff=jnp.asarray(d["fric_coeff"]),
        is_sdf=bool(d["is_sdf"]),
    )


def jax_state_from_torch(state):
    """The JAX package's WorldState holding the port state's values."""
    from diffsdfsim_torch import interop
    from diffsdfsim_tpu.physics.contacts import Contacts
    from diffsdfsim_tpu.physics.world import WorldState

    d = interop.state_to_numpy(state)
    c = d.pop("contacts")
    for key in ("i1", "i2", "pair_id"):
        c[key] = c[key].astype(np.int32)
    return WorldState(contacts=Contacts(**{k: jnp.asarray(v) for k, v in c.items()}),
                      **{k: jnp.asarray(v) for k, v in d.items()})


def torch_bench_world(drop=1.2, rad=0.5, cfg_kw=None, v_sphere=None, bodies=None):
    """The port's bench world (CPU, float64); ``bodies`` replaces the
    (floor, sphere) pair."""
    from diffsdfsim_torch.config import SimConfig
    from diffsdfsim_torch.physics import (
        BoxShape, Gravity3D, SphereShape, TotalConstraint3D, make_body, make_world,
    )

    if bodies is None:
        floor = make_body(BoxShape(torch.tensor([20.0, 1.0, 20.0])), subdiv=3, fric_coeff=0.25, device="cpu")
        sphere = make_body(SphereShape(torch.tensor(rad, dtype=torch.float64)), subdiv=2, fric_coeff=0.25,
                           device="cpu")
        bodies = [floor, sphere]
    poses = [[1.0, 0, 0, 0, 0.0, -0.5, 0.0], [1.0, 0, 0, 0, 0.0, drop, 0.0]]
    vels = np.zeros((2, 6))
    if v_sphere is not None:
        vels[1] = v_sphere
    return make_world(bodies, poses, vels, joints=(TotalConstraint3D(body1=0),),
                      forces=((), (Gravity3D(10.0),)), cfg=SimConfig(**(cfg_kw or BENCH_CFG)), device="cpu")


def jax_spec_like(tspec):
    """The JAX package's WorldSpec with the port spec's bodies (the bench
    joints, forces and config)."""
    from diffsdfsim_tpu.config import SimConfig
    from diffsdfsim_tpu.physics import Gravity3D, TotalConstraint3D
    from diffsdfsim_tpu.physics.world import WorldSpec

    cfg = SimConfig(**{f: getattr(tspec.cfg, f) for f in BENCH_CFG})
    return WorldSpec([jax_body_from_torch(b) for b in tspec.bodies], joints=(TotalConstraint3D(body1=0),),
                     forces=((), (Gravity3D(10.0),)), cfg=cfg)


def sphere_grid(res):
    """A res^3 grid of the sphere SDF of radius 0.5 / 0.75 over [-1, 1]^3
    (numpy; the grid body of tests/test_world_extra.py:53-67 and of
    tests/golden/gen_torch_shape_golden.py)."""
    lin = np.linspace(-1.0, 1.0, res)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    return np.sqrt(np.maximum(np.sum(pts * pts, axis=-1), 1e-24)) - 0.5 / 0.75


class JaxGolden:
    """The JAX side of a test module's comparisons, kept in a golden file.

    Each JAX program such a module compiles takes seconds to build, while
    its inputs are made from numpy seeds. ``jax_golden(fn)`` is the running
    test's next JAX result (nested tuples of numpy arrays), keyed by test
    name and call: with ``DIFFSDFSIM_RECORD_GOLDEN=1`` (the module's golden
    generator) it runs fn() live and the module writes every result to
    ``path`` at its end; otherwise it reads them from there. The module
    binds the two fixtures ``fixtures()`` returns to module-level names."""

    RECORD = os.environ.get("DIFFSDFSIM_RECORD_GOLDEN") == "1"

    def __init__(self, path):
        self.path, self.results, self.test, self.n = path, {}, None, 0

    def fixtures(self):
        @pytest.fixture(autouse=True, scope="module")
        def jax_golden_file():
            if not self.RECORD:
                with open(self.path, "rb") as f:
                    self.results.update(pickle.load(f))
            yield
            if self.RECORD:
                with open(self.path, "wb") as f:
                    pickle.dump(self.results, f)

        @pytest.fixture(autouse=True)
        def jax_golden_call(request):
            self.test, self.n = request.node.name, 0

        return jax_golden_file, jax_golden_call

    @staticmethod
    def _plain(x):
        if isinstance(x, (tuple, list)):
            return tuple(JaxGolden._plain(e) for e in x)
        return np.asarray(x)

    def __call__(self, fn):
        key = f"{self.test}/{self.n}"
        self.n += 1
        if self.RECORD:
            self.results[key] = self._plain(fn())
        return self.results[key]


def record_golden(test_file):
    """Run ``tests/<test_file>`` with its JAX calls live, rewriting its
    JaxGolden file (a golden generator's body); returns pytest's exit code."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DIFFSDFSIM_RECORD_GOLDEN="1", JAX_PLATFORMS="cpu")
    return subprocess.call([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist", "-m",
                            "", os.path.join("tests", test_file)], cwd=root, env=env)
