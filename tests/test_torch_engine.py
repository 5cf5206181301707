"""Port parity, dynamics: ``probe_dynamics_batch`` (a probe-ladder stage of
D = 3 and 6 trial dts, through the plain version of kernel K1 on CPU
tensors) and ``solve_dynamics`` against the JAX XLA path at a contact state
of the bench scene, float64 on the CPU. Tolerance: new velocities and the
primal solution x within atol 1e-9; the friction duals are not unique (see
test_torch_qp.py) and are held through the KKT residual."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsdfsim_torch.ops.qp import lcp_residuals
from diffsdfsim_torch.physics import engine as teng
from diffsdfsim_tpu.physics import engine as jeng
from torch_jax_bridge import jax_spec_like, jax_state_from_torch, one_torch_thread, torch_bench_world  # noqa: F401

ATOL = 1e-9


@pytest.fixture(scope="module")
def worlds():
    """The bench world with the sphere within eps of the floor, falling,
    spinning slightly (a valid contact), and a free-flight copy."""
    out = {}
    for name, drop in (("contact", 0.5 + 5e-4), ("free", 1.2)):
        tspec, tst = torch_bench_world(drop=drop, v_sphere=[0.2, -0.1, 0.05, 0.3, -3.0, 0.1])
        out[name] = (jax_spec_like(tspec), jax_state_from_torch(tst), tspec, tst)
    assert bool(jnp.any(out["contact"][1].contacts.valid))
    assert not bool(jnp.any(out["free"][1].contacts.valid))
    return out


@pytest.mark.parametrize("state", ["contact", "free"])
@pytest.mark.parametrize("D", [3, 6])
def test_probe_dynamics_batch(worlds, state, D):
    jspec, jst, tspec, tst = worlds[state]
    dts = (1 / 30) * 0.5 ** np.arange(D)
    fn = jax.jit(lambda st, d: jeng.probe_dynamics_batch(
        jspec.bodies, jspec.joints, jspec.forces, st, st.contacts, d, jspec.cfg))
    jv, jsol = fn(jst, jnp.asarray(dts))
    tv, tsol = teng.probe_dynamics_batch(tspec.bodies, tspec.joints, tspec.forces, tst, tst.contacts,
                                         torch.tensor(dts), tspec.cfg)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tsol[0].numpy(), np.asarray(jsol[0]), rtol=0, atol=ATOL)
    if state == "contact":
        nb = len(tspec.bodies)
        for d in range(D):
            args, _ = teng.dump_contact_lcp(tspec.bodies, tspec.joints, tspec.forces, tst, tst.contacts,
                                            float(dts[d]), tspec.cfg)
            res = lcp_residuals(*args, tuple(s[d : d + 1] for s in tsol))
            assert float(res) < 1e-8
        assert tv.shape == (D, 6 * nb)


def test_solve_dynamics(worlds):
    jspec, jst, tspec, tst = worlds["contact"]
    fn = jax.jit(lambda st: jeng.solve_dynamics(
        jspec.bodies, jspec.joints, jspec.forces, st, st.contacts, 1 / 60, jspec.cfg, return_sol=True))
    jv, jsol = fn(jst)
    tv, tsol = teng.solve_dynamics(tspec.bodies, tspec.joints, tspec.forces, tst, tst.contacts, 1 / 60,
                                   tspec.cfg, return_sol=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tsol[0].numpy(), np.asarray(jsol[0]), rtol=0, atol=ATOL)


def test_assembly_and_mass_matrices(worlds):
    """M, its analytic inverse and the contact LCP data (with Jf's per-contact
    [+dirs | -dirs] rows) equal the JAX package's."""
    jspec, jst, tspec, tst = worlds["contact"]
    jstruct = []

    def jdump(st):  # one compiled program; the structure is static, kept while tracing
        args, struct = jeng.dump_contact_lcp(jspec.bodies, jspec.joints, jspec.forces, st, st.contacts, 1 / 30,
                                             jspec.cfg)
        jstruct.append(struct)
        return args, jeng.mass_matrix_inv(jspec.bodies, st.quat), jeng.friction_dirs(st.contacts.normal, 8)

    jargs, jminv, jdirs = jax.jit(jdump)(jst)
    targs, tstruct = teng.dump_contact_lcp(tspec.bodies, tspec.joints, tspec.forces, tst, tst.contacts,
                                           1 / 30, tspec.cfg)
    assert tuple(jstruct[0]) == tuple(tstruct)
    for j, t in zip(jargs, targs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(teng.mass_matrix_inv(tspec.bodies, tst.quat).numpy(), np.asarray(jminv), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(teng.friction_dirs(tst.contacts.normal, 8).numpy(), np.asarray(jdirs), rtol=0,
                               atol=1e-12)


def test_post_stabilization(worlds):
    jspec, jst, tspec, tst = worlds["contact"]
    jv = jax.jit(lambda st: jeng.post_stabilization(jspec.bodies, jspec.joints, st, st.contacts, jspec.cfg))(jst)
    tv = teng.post_stabilization(tspec.bodies, tspec.joints, tst, tst.contacts, tspec.cfg)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)


def test_joint_rows(worlds):
    """Every joint kind's Jacobian rows equal the JAX package's."""
    from diffsdfsim_torch.physics import joints as tj
    from diffsdfsim_tpu.physics import joints as jj

    jspec, jst, tspec, tst = worlds["contact"]
    for name, kw in (("XConstraint3D", {}), ("YConstraint3D", {}), ("ZConstraint3D", {}),
                     ("RotConstraint3D", {}), ("TotalConstraint3D", {}),
                     ("GripperJoint", dict(body2=1, axis=(0.0, 1.0, 0.0)))):
        jrows = jax.jit(jj.__dict__[name](body1=0, **kw).rows)(jst)
        trows = tj.__dict__[name](body1=0, **kw).rows(tst)
        for t, j in zip(trows, jrows):
            if j is None:
                assert t is None
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-12, err_msg=name)
