"""Accepted substeps per lane and frame, from the trajectories' ``valid``
records (the stepping's work done, as a count)."""


def read(rec):
    frames = sum(u["lane_frames"] for u in rec.units)
    return sum(u["valid_substeps"] for u in rec.units) / frames if frames else None
