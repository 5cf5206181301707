"""Seed sweeps split over worker processes, one per device
(counterpart of ``diffsdfsim_tpu.parallel``)."""

from .sharding import Mesh, WorkerError, batched_rollout, launch_counts, make_mesh, shard_batch

__all__ = ["Mesh", "WorkerError", "batched_rollout", "launch_counts", "make_mesh", "shard_batch"]
