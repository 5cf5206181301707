"""Launches of the port's hand-written kernels per batch frame over the
traced window's units (the wrappers' ``launches`` counters,
``parallel.launch_counts``)."""


def read(rec):
    frames = sum(u["frames"] for u in rec.units)
    return sum(u["launches"] for u in rec.units) / frames if frames else None
