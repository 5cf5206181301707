"""Port parity, dynamics: ``probe_dynamics_batch`` (a probe-ladder stage of
D = 3 and 6 trial dts, through the plain version of kernel K1 on CPU
tensors) and ``solve_dynamics`` against the JAX XLA path at a contact state
of the bench scene, float64 on the CPU. Tolerance: new velocities and the
primal solution x within atol 1e-9; the friction duals are not unique (see
test_torch_qp.py) and are held through the KKT residual.

The JAX side's results (each jitted JAX program compiles for seconds) are
read from ``tests/golden/engine_jax.pkl``, which
``tests/golden/gen_torch_engine_golden.py`` writes by running these tests
with the JAX calls live (``torch_jax_bridge.JaxGolden``); regenerate it when
a test's inputs change."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.ops.qp import lcp_residuals
from diffsdfsim_torch.physics import engine as teng
from diffsdfsim_tpu.physics import engine as jeng
from torch_jax_bridge import (JaxGolden, jax_spec_like, jax_state_from_torch, one_torch_thread,  # noqa: F401
                              torch_bench_world)

ATOL = 1e-9
_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "engine_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()


@pytest.fixture(scope="module")
def worlds():
    """The bench world with the sphere within eps of the floor, falling,
    spinning slightly (a valid contact), and a free-flight copy: (a function
    making the JAX spec and state holding the same values, the port's spec,
    the port's state)."""
    out = {}
    for name, drop in (("contact", 0.5 + 5e-4), ("free", 1.2)):
        tspec, tst = torch_bench_world(drop=drop, v_sphere=[0.2, -0.1, 0.05, 0.3, -3.0, 0.1])
        out[name] = (lambda tspec=tspec, tst=tst: (jax_spec_like(tspec), jax_state_from_torch(tst)), tspec, tst)
    assert bool(torch.any(out["contact"][2].contacts.valid))
    assert not bool(torch.any(out["free"][2].contacts.valid))
    return out


@pytest.mark.parametrize("state", ["contact", "free"])
@pytest.mark.parametrize("D", [3, 6])
def test_probe_dynamics_batch(worlds, state, D):
    jax_world, tspec, tst = worlds[state]
    dts = (1 / 30) * 0.5 ** np.arange(D)

    def jax_side():
        jspec, jst = jax_world()
        fn = jax.jit(lambda st, d: jeng.probe_dynamics_batch(
            jspec.bodies, jspec.joints, jspec.forces, st, st.contacts, d, jspec.cfg))
        jv, jsol = fn(jst, jnp.asarray(dts))
        return jv, jsol[0]

    jv, jx = _from_jax(jax_side)
    tv, tsol = teng.probe_dynamics_batch(tspec.bodies, tspec.joints, tspec.forces, tst, tst.contacts,
                                         torch.tensor(dts), tspec.cfg, read_fallback=tspec.read_fallback)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tsol[0].numpy(), jx, rtol=0, atol=ATOL)
    if state == "contact":
        nb = len(tspec.bodies)
        for d in range(D):
            args, _ = teng.dump_contact_lcp(tspec.bodies, tspec.joints, tspec.forces, tst, tst.contacts,
                                            float(dts[d]), tspec.cfg)
            res = lcp_residuals(*args, tuple(s[d : d + 1] for s in tsol))
            assert float(res) < 1e-8
        assert tv.shape == (D, 6 * nb)


def test_solve_dynamics(worlds):
    jax_world, tspec, tst = worlds["contact"]

    def jax_side():
        jspec, jst = jax_world()
        fn = jax.jit(lambda st: jeng.solve_dynamics(
            jspec.bodies, jspec.joints, jspec.forces, st, st.contacts, 1 / 60, jspec.cfg, return_sol=True))
        jv, jsol = fn(jst)
        return jv, jsol[0]

    jv, jx = _from_jax(jax_side)
    tv, tsol = teng.solve_dynamics(tspec.bodies, tspec.joints, tspec.forces, tst, tst.contacts, 1 / 60,
                                   tspec.cfg, return_sol=True)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tsol[0].numpy(), jx, rtol=0, atol=ATOL)


def test_assembly_and_mass_matrices(worlds):
    """M, its analytic inverse and the contact LCP data (with Jf's per-contact
    [+dirs | -dirs] rows) equal the JAX package's."""
    jax_world, tspec, tst = worlds["contact"]

    def jax_side():
        jspec, jst = jax_world()
        jstruct = []

        def jdump(st):  # one compiled program; the structure is static, kept while tracing
            args, struct = jeng.dump_contact_lcp(jspec.bodies, jspec.joints, jspec.forces, st, st.contacts, 1 / 30,
                                                 jspec.cfg)
            jstruct.append(struct)
            return args, jeng.mass_matrix_inv(jspec.bodies, st.quat), jeng.friction_dirs(st.contacts.normal, 8)

        jargs, jminv, jdirs = jax.jit(jdump)(jst)
        return repr(tuple(jstruct[0])), jargs, jminv, jdirs

    jstruct, jargs, jminv, jdirs = _from_jax(jax_side)
    targs, tstruct = teng.dump_contact_lcp(tspec.bodies, tspec.joints, tspec.forces, tst, tst.contacts,
                                           1 / 30, tspec.cfg)
    assert str(jstruct) == repr(tuple(tstruct))
    for j, t in zip(jargs, targs):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(teng.mass_matrix_inv(tspec.bodies, tst.quat).numpy(), jminv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(teng.friction_dirs(tst.contacts.normal, 8).numpy(), jdirs, rtol=0, atol=1e-12)


def test_post_stabilization(worlds):
    jax_world, tspec, tst = worlds["contact"]

    def jax_side():
        jspec, jst = jax_world()
        return jax.jit(lambda st: jeng.post_stabilization(jspec.bodies, jspec.joints, st, st.contacts, jspec.cfg))(jst)

    tv = teng.post_stabilization(tspec.bodies, tspec.joints, tst, tst.contacts, tspec.cfg)
    np.testing.assert_allclose(tv.numpy(), _from_jax(jax_side), rtol=0, atol=ATOL)


def test_joint_rows(worlds):
    """Every joint kind's Jacobian rows equal the JAX package's."""
    from diffsdfsim_torch.physics import joints as tj
    from diffsdfsim_tpu.physics import joints as jj

    jax_world, tspec, tst = worlds["contact"]
    for name, kw in (("XConstraint3D", {}), ("YConstraint3D", {}), ("ZConstraint3D", {}),
                     ("RotConstraint3D", {}), ("TotalConstraint3D", {}),
                     ("GripperJoint", dict(body2=1, axis=(0.0, 1.0, 0.0)))):

        def jax_side():
            rows = jax.jit(jj.__dict__[name](body1=0, **kw).rows)(jax_world()[1])
            return tuple("none" if r is None else r for r in rows)  # noqa: B023

        jrows = _from_jax(jax_side)
        trows = tj.__dict__[name](body1=0, **kw).rows(tst)
        for t, j in zip(trows, jrows):
            if j.dtype.kind == "U":
                assert t is None
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-12, err_msg=name)
