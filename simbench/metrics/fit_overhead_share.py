"""Share of a fit iteration's wall outside the taped rollout (world build
and stepping) and the backward: the loss, the update, the clip and the
iteration's own glue, from the benchmark's spans over the traced units
other than the sync-counted one (the profiler's switches left out)."""

INSIDE = ("world", "rollout", "backward")


def read(rec):
    units = [u for u in rec.units if u["syncs"] is None]
    if not any(n == "backward" for u in units for n, *_ in u["spans"]):
        return None
    wall = sum(u["wall"] for u in units)
    inside = sum((b - a) / 1e9 - p for u in units for n, a, b, d, p in u["spans"] if n in INSIDE and d == 0)
    return 100.0 * (wall - inside) / wall if wall > 0 else None
