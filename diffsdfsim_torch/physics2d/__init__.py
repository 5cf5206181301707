"""2D physics as a planar configuration of the 3D core (``facade.py``),
its analytic narrowphase (``narrowphase.py``) and the pygame recorder
(``recorder.py``, which imports pygame only when it draws)."""

from .facade import (
    Circle,
    FixedJoint2D,
    GridSDF2D,
    GridShape2D,
    Hull,
    HullShape,
    PlanarConstraint,
    Rect,
    RevoluteJoint2D,
    contour_2d,
    make_world_2d,
    polygon_sdf_2d,
    to_2d_state,
)
