"""2D pygame recorder (reference ``lcp_physics/physics/utils.py:79-97``
Recorder and the per-body ``draw`` methods of ``lcp_physics/physics/
bodies.py`` and ``sdf_physics/physics/bodies.py``).

PyTorch counterpart of ``diffsdfsim_tpu/physics2d/recorder.py``: a headless
pygame surface, one draw per shape (a circle with its heading line, a hull
polygon, a rect, a 2D grid's marching-squares contour), optional force
arrows, and ``Recorder2D`` with the reference's frame pacing. pygame is
imported only when something is drawn or recorded, so the physics never
needs it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .facade import GridShape2D, HullShape, contour_2d, to_2d_state


def _pg():
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    import pygame

    return pygame


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_screen(size=(640, 480)):
    """Headless pygame surface (the reference draws on a display; a plain
    Surface needs no video device)."""
    return _pg().Surface(size)


def _to_px(p_xy, screen, pixels_per_meter, origin=None):
    w, h = screen.get_size()
    if origin is None:
        origin = (w // 2, h // 2)
    return (
        int(round(origin[0] + float(p_xy[0]) * pixels_per_meter)),
        int(round(origin[1] - float(p_xy[1]) * pixels_per_meter)),
    )


def draw_world_2d(screen, bodies, state, pixels_per_meter: float = 40.0, origin=None, colors=None, forces=None,
                  t: float = 0.0, force_scale: float = 0.1, bg=(255, 255, 255)):
    """Draw the 2D projection of a facade world's state.

    ``bodies`` are the BodyDefs given to make_world_2d; ``state`` is the 3D
    WorldState. Per shape, as the reference's draw methods: a Circle as
    ``pygame.draw.circle`` and a heading line (bodies.py:162-176), a Hull as
    a filled polygon (bodies.py:259-269), a Rect as a rotated rectangle
    (bodies.py:313-321), a 2D grid body as its zero contour. With
    ``forces``, each body's net applied force is drawn as an arrow from its
    centre."""
    pg = _pg()
    screen.fill(bg)
    p2 = _np(to_2d_state(state)[0])
    nb = len(bodies)
    if colors is None:
        base = [(217, 89, 64), (64, 140, 217), (89, 191, 89), (217, 191, 64), (166, 89, 191), (120, 120, 120)]
        colors = [base[i % len(base)] for i in range(nb)]

    handles = []
    for i, bd in enumerate(bodies):
        th, cx, cy = p2[i]
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s], [s, c]])
        ctr = _to_px((cx, cy), screen, pixels_per_meter, origin)
        shape = bd.shape
        if type(shape).__name__ == "CylinderShape":  # a facade Circle, extruded along z
            rad = float(shape.rad)
            handles.append(pg.draw.circle(screen, colors[i], ctr, max(int(round(rad * pixels_per_meter)), 1), 0))
            tip = _to_px((cx + rad * c, cy + rad * s), screen, pixels_per_meter, origin)
            handles.append(pg.draw.line(screen, (0, 0, 255), ctr, tip, 2))
        elif isinstance(shape, HullShape):
            v2 = _np(shape.verts2d) * float(shape.scale_)
            pts = [_to_px(R @ v + np.array([cx, cy]), screen, pixels_per_meter, origin) for v in v2]
            handles.append(pg.draw.polygon(screen, colors[i], pts, 0))
        elif isinstance(shape, GridShape2D):
            segs, valid = contour_2d(shape.grid.detach(), float(shape.scale_))
            for a, b in _np(segs)[_np(valid)]:
                pa = _to_px(R @ a + np.array([cx, cy]), screen, pixels_per_meter, origin)
                pb = _to_px(R @ b + np.array([cx, cy]), screen, pixels_per_meter, origin)
                handles.append(pg.draw.line(screen, colors[i], pa, pb, 2))
        else:  # a box (facade Rect): its xy cross-section
            dims = _np(shape.dims)[:2] / 2.0
            corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=np.float64) * dims
            pts = [_to_px(R @ v + np.array([cx, cy]), screen, pixels_per_meter, origin) for v in corners]
            handles.append(pg.draw.polygon(screen, colors[i], pts, 0))

    if forces is not None:
        from ..physics.engine import apply_forces

        dtype, device = bodies[0].mass.dtype, bodies[0].mass.device
        af = _np(apply_forces(tuple(bodies), tuple(forces), torch.tensor(t, dtype=dtype, device=device)))
        af = af.reshape(nb, 6)
        for i in range(nb):
            fx, fy = af[i, 3], af[i, 4]
            if fx * fx + fy * fy < 1e-12:
                continue
            th, cx, cy = p2[i]
            a = _to_px((cx, cy), screen, pixels_per_meter, origin)
            b = _to_px((cx + fx * force_scale, cy + fy * force_scale), screen, pixels_per_meter, origin)
            handles.append(pg.draw.line(screen, (0, 0, 0), a, b, 2))
            # arrowhead: two short back-angled lines
            v = np.array([b[0] - a[0], b[1] - a[1]], dtype=np.float64)
            n = np.linalg.norm(v)
            if n > 1:
                v /= n
                w = np.array([-v[1], v[0]])
                for sgn in (1.0, -1.0):
                    back = np.array(b, dtype=np.float64) - 8 * v + sgn * 5 * w
                    handles.append(pg.draw.line(screen, (0, 0, 0), b, (int(back[0]), int(back[1])), 2))
    return handles


class Recorder2D:
    """Frame recorder with the reference's pacing (utils.py:79-97): a frame
    is saved whenever sim time has advanced by ``dt`` since the last save
    (``prev_t`` starts at 0). Saves numbered .bmp files as the reference
    does, and keeps the frames as arrays in ``frames``."""

    def __init__(self, dt, screen, path=None, save_to_disk=True):
        self.dt = dt
        self.prev_t = 0.0
        self.frame = 0
        self.screen = screen
        self.path = path
        self.save_to_disk = save_to_disk and path is not None
        self.frames: list = []
        if self.save_to_disk:
            os.makedirs(path, exist_ok=True)

    def record(self, t):
        pg = _pg()
        if t - self.prev_t >= self.dt:
            if self.save_to_disk:
                pg.image.save(self.screen, os.path.join(self.path, f"{self.frame}.bmp"))
            arr = pg.surfarray.array3d(self.screen).swapaxes(0, 1).copy()
            self.frames.append((float(t), arr))
            self.frame += 1
            self.prev_t += self.dt
