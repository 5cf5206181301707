"""The window's rate arithmetic, and the idle share, idle labels and
roofline arithmetic on synthetic device events."""

import types

import pytest

from simbench import core, tracing
from simbench.counts import k4


def test_window_counts_the_unit_in_flight():
    clock = types.SimpleNamespace(t=0.0)

    def step(u):
        clock.t += 4.0

    n, t0, t1 = core.window(step, 10.0, clock=lambda: clock.t)
    # units start at 0, 4 and 8 s; the third ends at 12 s, after the deadline, and counts
    assert (n, t0, t1) == (3, 0.0, 12.0)
    lanes, frames = 50, 45
    assert lanes * frames * n / (t1 - t0) == pytest.approx(562.5)
    assert core.window(step, 0.0, min_units=3, clock=lambda: clock.t)[0] == 3


def test_busy_gaps_and_labels():
    events = [("a", 10, 20), ("b", 15, 30), ("c", 40, 50), ("d", 55, 70)]
    busy, gaps = tracing.busy_and_gaps(events, [(0, 60)])
    assert busy == pytest.approx(35e-9)
    assert gaps == [(0, 10), (30, 40), (50, 55)]
    busy2, gaps2 = tracing.busy_and_gaps(events, [(0, 25), (45, 60)])
    assert busy2 == pytest.approx((15 + 5 + 5) * 1e-9) and gaps2 == [(0, 10), (50, 55)]
    spans = [("outer", 0, 35, 0), ("inner", 30, 45, 1)]
    assert tracing.label_gaps(gaps, spans) == pytest.approx({"outer": 10e-9, "inner": 10e-9,
                                                             "outside spans": 5e-9})


def test_roofline_and_idle_share():
    cell = types.SimpleNamespace()
    peaks = dict(hbm_bytes_per_s=1e12, flops={"float64_mma": 1e12})
    rec = core.Record(cell, peaks)
    s = dict(is64=1, N=1000, d_in=5, layers=[(3, 5), (1, 3)])
    ops, nbytes = k4.count(s)  # 48,000 operations, 60,176 bytes: bound by bytes
    rec.profile = dict(events=[("igr_mlp_kernel<double>", 0, 200), ("other", 300, 400)], windows=[(0, 1000)],
                       counts={"k4": k4}, sizes={"k4": [s, s]}, kernel_s={"igr_mlp_kernel<double>": 2e-7,
                                                                        "other": 1e-7})
    least = 2 * max(ops / 1e12, nbytes / 1e12)
    assert rec.roofline("k4") == pytest.approx(100 * least / 2e-7)
    assert rec.roofline("k1") is None
    reader = core.load_file(core.ROOT / "metrics" / "idle_share.py", "t_idle")
    assert reader.read(rec) == pytest.approx(70.0)


def test_sliced_trace_schedule(monkeypatch):
    """The profiler runs 2 s of every 5 from the first tick, and over the
    whole of a held span; switches are left out as pauses."""

    class FakeProfile:
        def __init__(self, activities):
            self.profiler = types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: []))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    import torch

    clock = [0]
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(tracing.time, "time_ns", lambda: clock[0])
    sizes = tracing.LaunchSizes({})
    tr = tracing.SlicedTrace(sizes, 2.0, 5.0)
    for s in range(0, 9):
        clock[0] = int(s * 1e9)
        tr.tick()
        assert sizes.active == (s % 5 < 2)
    with tr.whole():
        clock[0] = int(9.5e9)
        tr.tick()  # held: no switch
        assert sizes.active
    assert not sizes.active and tr.prof is None
    tr.close()
    assert tr.slices == [(0, int(2e9)), (int(5e9), int(7e9)), (int(8e9), int(9.5e9))]
    assert tr.paused(0, int(10e9)) == 0.0


def test_label_gaps_matches_the_plain_scan():
    """The swept labels agree with scanning every span at each gap."""
    import random

    rng = random.Random(7)
    spans, at = [], 0
    for k in range(40):  # nested as one thread's spans are: outers apart, inners within them
        a = at + rng.randrange(0, 100)
        b = a + rng.randrange(20, 400)
        spans.append((f"outer{k}", a, b, 0))
        c = rng.randrange(a, b - 10)
        spans.append((f"inner{k}", c, rng.randrange(c + 1, b), 1))
        at = b
    gaps = sorted((s, s + rng.randrange(1, 50)) for s in rng.sample(range(0, at + 100), 300))

    def plain(gaps, spans):
        out = {}
        for s, e in gaps:
            mid = (s + e) // 2
            inner = [(d, n) for n, a, b, d in spans if a <= mid < b]
            name = max(inner)[1] if inner else "outside spans"
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return out

    assert tracing.label_gaps(gaps, spans) == pytest.approx(plain(gaps, spans))
