from .shapes import (
    BoxShape,
    BrickShape,
    CylinderShape,
    GridShape,
    LatentShape,
    RoundedBoxShape,
    SphereShape,
    query_sdfs,
)
from .bodies import BodyDef, make_body
from .joints import (
    GripperJoint,
    RotConstraint3D,
    TotalConstraint3D,
    XConstraint3D,
    YConstraint3D,
    ZConstraint3D,
)
from .forces import ExternalForce3D, Gravity3D
from .world import Trajectory, WorldSpec, WorldState, make_world, rollout, run_world, step_frame
from .batched import (
    finish_step_batched,
    make_world_batched,
    rollout_batched,
    step_dt_batched,
    step_frame_batched,
    trajectory_lanes_first,
)
