"""Port parity, the 2D recorder (``diffsdfsim_torch/physics2d/recorder.py``)
against the JAX package's (``diffsdfsim_tpu/physics2d/recorder.py``) on the
CPU: a Rect, a Circle, a Hull and a 2D grid body, rotated, drawn with the
force arrows, recorded with the reference's pacing, frame for frame and
pixel for pixel (headless pygame). The JAX side draws the same bodies
(``torch_jax_bridge.jax_body_from_torch``) and is read from
``tests/golden/recorder2d_jax.pkl`` (``gen_torch_recorder2d_golden.py``
runs these tests with the JAX calls live, ``torch_jax_bridge.JaxGolden``).
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes2d
from diffsdfsim_torch import physics2d as t2d
from diffsdfsim_torch.physics import Gravity3D
from diffsdfsim_torch.physics2d import recorder as trec
from torch_jax_bridge import JaxGolden, jax_body_from_torch, one_torch_thread  # noqa: F401

_from_jax = JaxGolden(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "recorder2d_jax.pkl"))
_jax_golden_file, _jax_golden_call = _from_jax.fixtures()
TIMES = (0.05, 0.11, 0.15, 0.21, 0.32)


@pytest.fixture(scope="module")
def scene():
    """Four planar bodies and a state: (bodies, forces, quat, pos, v)."""
    grid = scenes2d.circle_grid(res=17, rad=0.3, scale=1.0)
    bodies = [t2d.Rect([10.0, 1.0], subdiv=1, device="cpu"), t2d.Circle(0.5, subdiv=1, device="cpu"),
              t2d.Hull(scenes2d.PARITY_HULL, subdiv=1, device="cpu"), t2d.GridSDF2D(grid, 1.0, subdiv=1, device="cpu")]
    theta = np.array([0.0, 0.3, -0.7, 1.1])
    quat = np.stack([np.cos(theta / 2), 0 * theta, 0 * theta, np.sin(theta / 2)], axis=-1)
    pos = np.array([[0.0, -2.0, 0.0], [0.0, 1.0, 0.0], [-2.5, 0.5, 0.0], [2.4, 0.2, 0.0]])
    forces = ((), (Gravity3D(10.0),), (), (Gravity3D(10.0),))
    return bodies, forces, quat, pos, np.zeros((4, 6))


def _frames(rec_mod, bodies, forces, state, size, path=None):
    screen = rec_mod.make_screen(size)
    rec_mod.draw_world_2d(screen, bodies, state, forces=forces, t=0.0)
    rec = rec_mod.Recorder2D(dt=0.1, screen=screen, path=path, save_to_disk=path is not None)
    for t in TIMES:
        rec.record(t)
    return rec.frame, [t for t, _ in rec.frames], np.stack([a for _, a in rec.frames])


def test_recorder_frames_match_jax(scene, tmp_path):
    bodies, forces, quat, pos, v = scene
    tstate = types.SimpleNamespace(quat=torch.as_tensor(quat), pos=torch.as_tensor(pos), v=torch.as_tensor(v))
    n, times, frames = _frames(trec, bodies, forces, tstate, (320, 240), str(tmp_path))

    def jax_side():
        from diffsdfsim_tpu.physics import Gravity3D as JGravity
        from diffsdfsim_tpu.physics2d import recorder as jrec

        jstate = types.SimpleNamespace(quat=jnp.asarray(quat), pos=jnp.asarray(pos), v=jnp.asarray(v))
        jforces = tuple(tuple(JGravity(10.0) for _ in f) for f in forces)
        return _frames(jrec, [jax_body_from_torch(b) for b in bodies], jforces, jstate, (320, 240))

    jn, jtimes, jframes = _from_jax(jax_side)
    assert n == int(jn) == 3 and times == list(jtimes) == [0.11, 0.21, 0.32]
    assert frames.shape == (3, 240, 320, 3) and (frames != 255).any()
    np.testing.assert_array_equal(frames, jframes)
    assert sorted(os.listdir(tmp_path)) == ["0.bmp", "1.bmp", "2.bmp"]

