"""Share of a fit iteration's wall spent in ``torch.autograd.grad`` (the
autograd backward: the LCP and TOC backward functions and K2), from the
benchmark's span around it, over the traced units other than the
sync-counted one (the profiler's switches left out of both)."""


def read(rec):
    units = [u for u in rec.units if u["syncs"] is None]
    wall = sum(u["wall"] for u in units)
    back = sum((b - a) / 1e9 - p for u in units for n, a, b, d, p in u["spans"] if n == "backward")
    return 100.0 * back / wall if wall > 0 and back > 0 else None
