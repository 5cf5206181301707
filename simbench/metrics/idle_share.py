"""Share of the profiled slices' wall in which no operation ran on the
device: one minus the union of the device's activity intervals (raw
profiler events, CUDA activity only) over the slices of the traced unit."""

from simbench import tracing


def read(rec):
    p = rec.profile
    if p is None:
        return None
    busy, _ = tracing.busy_and_gaps(p["events"], p["windows"])
    window = sum(b - a for a, b in p["windows"]) / 1e9
    return 100.0 * (1.0 - busy / window) if window > 0 and busy > 0 else None
