from .shapes import BoxShape, LatentShape, SphereShape, query_sdfs
from .bodies import BodyDef, make_body
from .joints import TotalConstraint3D
from .forces import DOWN, Gravity3D
from .world import Trajectory, WorldSpec, WorldState, make_world
from .batched import (
    finish_step_batched,
    make_world_batched,
    rollout_batched,
    step_dt_batched,
    step_frame_batched,
    trajectory_lanes_first,
)
