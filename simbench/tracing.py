"""What a run records: spans, counters, launch sizes and the device trace.

- ``Spans``: named host intervals on the epoch clock (``time.time_ns``,
  the clock the profiler's events carry), nested. The coarse spans are the
  benchmark's own calls (world build, rollout, loss, backward, update);
  with ``--trace 1`` the layers beneath are spanned too, by wrapping the
  port's functions where their callers look them up (``FINE_SPANS``). A
  span synchronizes the device at both ends only where asked, so that its
  length is the layer's time.
- ``LaunchSizes``: each launch's problem sizes, recorded at the entry of the
  port's kernel wrappers that the kernel counts under ``counts/`` name.
- ``count_syncs``: the device synchronizations a call makes, counted by
  torch's sync debug mode.
- ``SlicedTrace``: the device's activity over slices of one unit, from
  the profiler's raw events with CUDA activity only (converting a whole
  unit of the sphere sweep's events takes over a minute; building the
  profiler's event tree, minutes).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import threading
import time
import warnings

import torch

# (module, attribute, span): layers beneath the benchmark's calls, spanned
# where their callers look them up
FINE_SPANS = (
    ("diffsdfsim_torch.physics.batched", "_probe_batched", "probe_ladder"),
    ("diffsdfsim_torch.physics.batched", "finish_step_batched", "replay"),
    ("diffsdfsim_torch.physics.batched", "_toc_recompute", "toc"),
    ("diffsdfsim_torch.physics.batched", "search_contacts_raw", "contact_search"),
    ("diffsdfsim_torch.physics.batched", "find_contacts_lanes", "contact_search"),
)


# coarse spans profiled whole in the traced unit
WHOLE_SPANS = ("backward",)


class Spans:
    def __init__(self):
        self.done = []  # (name, start ns, end ns, depth)
        self.depth = 0

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            self.done.append((name, t0, time.time_ns(), self.depth))


@contextlib.contextmanager
def no_spans(name: str):
    yield


@contextlib.contextmanager
def patched(targets):
    """Set ``(obj, attribute, value)`` for the duration, then restore."""
    saved = [(obj, attr, vars(obj).get(attr), attr in vars(obj)) for obj, attr, _ in targets]
    try:
        for obj, attr, value in targets:
            setattr(obj, attr, value)
        yield
    finally:
        for obj, attr, old, own in reversed(saved):
            if own:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)


def fine_spans(spans: Spans, tick):
    """The patches that span ``FINE_SPANS`` into ``spans``, calling
    ``tick()`` as each starts."""
    out = []
    for mod, attr, name in FINE_SPANS:
        m = importlib.import_module(mod)
        fn = getattr(m, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            tick()
            with spans(_name):
                return _fn(*a, **k)

        out.append((m, attr, wrapped))
    return out


def traced_spans(spans: Spans, tracer: SlicedTrace):
    """The coarse spans of the profiled unit: each ticks the tracer, and
    those in ``WHOLE_SPANS`` are profiled whole."""

    @contextlib.contextmanager
    def span(name: str):
        if name in WHOLE_SPANS:
            with tracer.whole(), spans(name):
                yield
        else:
            tracer.tick()
            with spans(name):
                yield

    return span


class LaunchSizes:
    """Records the problem sizes of each launch of the counted kernels
    while ``active``."""

    def __init__(self, counts: dict):
        self.counts = counts  # kernel id -> counts module
        self.sizes = {k: [] for k in counts}
        self.active = False

    def patches(self):
        out = []
        for kid, cm in self.counts.items():
            mod, obj, meth = cm.HOOK
            target = getattr(importlib.import_module(mod), obj)
            fn = getattr(target, meth)

            def wrapped(*a, _fn=fn, _kid=kid, _cm=cm, **k):
                if self.active:
                    self.sizes[_kid].append(_cm.sizes(*a, **k))
                return _fn(*a, **k)

            out.append((target, meth, wrapped))
        return out


def count_syncs(fn):
    """(fn(), synchronizing operations it made)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


class SlicedTrace:
    """The device's activity over slices of a call: the profiler (CUDA
    activity only) runs ``on_s`` seconds of every ``every_s``, from the
    call's start, switched at the ``tick`` calls the spans make, and over
    the whole of the spans in ``WHOLE_SPANS`` (the backward, in which no
    span of the main thread ticks). Each switch synchronizes the device
    first, so a slice holds the kernels launched in it; the launch sizes are
    recorded only inside a slice. The switches' own time (the profiler's start, and its stop, which
    converts the slice's events) is kept as ``pauses``, which the unit's and
    the spans' lengths leave out."""

    def __init__(self, sizes: "LaunchSizes", on_s: float, every_s: float):
        self.sizes, self.on_s, self.every_s = sizes, on_s, every_s
        self.prof = None
        self.held = False
        self.t0 = None
        self.slices = []  # (start ns, end ns) of each slice
        self.pauses = []  # (start ns, end ns) of each switch
        self.events = []  # (name, start ns, end ns)
        self.profiles = []

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        a = time.time_ns()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        b = time.time_ns()
        self.pauses.append((a, b))
        self.slice_start = b
        self.sizes.active = True

    def _stop(self):
        a = time.time_ns()
        torch.cuda.synchronize()
        self.sizes.active = False
        self.slices.append((self.slice_start, time.time_ns()))
        self.prof.__exit__(None, None, None)
        self.profiles.append(self.prof)
        self.prof = None
        self.pauses.append((a, time.time_ns()))

    def tick(self):
        """Switch the profiler by the schedule. Only the main thread
        switches it (autograd runs a CUDA backward's functions on a thread
        of its own), and not while a whole span holds it on."""
        if self.held or threading.current_thread() is not threading.main_thread():
            return
        now = time.time_ns()
        if self.t0 is None:
            self.t0 = now
        phase = ((now - self.t0) / 1e9) % self.every_s
        if self.prof is None and phase < self.on_s:
            self._start()
        elif self.prof is not None and phase >= self.on_s:
            self._stop()

    @contextlib.contextmanager
    def whole(self):
        """Profile the whole of what runs inside, whatever the schedule."""
        if self.prof is None:
            self._start()
        self.held = True
        try:
            yield
        finally:
            self.held = False
            self._stop()

    def close(self):
        if self.prof is not None:
            self._stop()
        for prof in self.profiles:
            raw = prof.profiler.kineto_results
            self.events += [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in raw.events()
                            if ev.device_type() == torch.autograd.DeviceType.CUDA and ev.duration_ns() > 0]
        self.profiles = []

    def paused(self, a: int, b: int) -> float:
        """Seconds of [a, b] (ns) spent switching the profiler."""
        return sum(max(0, min(b, e) - max(a, s)) for s, e in self.pauses) / 1e9


def union(intervals):
    """Merged (start, end) intervals of the given ones."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_and_gaps(events, windows):
    """(busy seconds, [(gap start ns, gap end ns)]) of the device within the
    host's windows [(start ns, end ns)]: the union of its activity and the
    idle stretches between."""
    busy, gaps = 0.0, []
    for t0, t1 in windows:
        merged = union((max(s, t0), min(e, t1)) for _, s, e in events if e > t0 and s < t1)
        busy += sum(e - s for s, e in merged) / 1e9
        at = t0
        for s, e in merged:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if t1 > at:
            gaps.append((at, t1))
    return busy, gaps


def label_gaps(gaps, spans):
    """Idle seconds by the innermost span the host was in at each gap's
    middle ("outside spans" where none): the spans' boundaries swept once
    into segments, each labelled by the deepest span open over it."""
    marks = sorted({t for _, a, b, _ in spans for t in (a, b)})
    inner = [None] * len(marks)  # (depth, name) of the deepest span open from marks[i]
    for name, a, b, depth in spans:
        for i in range(bisect.bisect_left(marks, a), bisect.bisect_left(marks, b)):
            if inner[i] is None or depth > inner[i][0]:
                inner[i] = (depth, name)
    out = {}
    for s, e in gaps:
        i = bisect.bisect_right(marks, (s + e) // 2) - 1
        name = inner[i][1] if i >= 0 and inner[i] is not None else "outside spans"
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def kernel_seconds(events) -> dict:
    out = {}
    for name, s, e in events:
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out
