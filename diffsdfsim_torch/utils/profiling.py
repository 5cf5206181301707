"""Profiling and tracing helpers.

PyTorch counterpart of ``diffsdfsim_tpu/utils/profiling.py`` (the
reference has no profiling subsystem):

- ``trace(path)``: a ``torch.profiler`` trace of the enclosed block (CPU
  and, where there is a card, CUDA activity), written as a Chrome trace;
- ``Timer``: wall-clock phases that end in ``torch.cuda.synchronize()`` on
  a card, so the phase holds the device work it queued;
- ``annotate(name)``: a named region in the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

annotate = torch.profiler.record_function


@contextlib.contextmanager
def trace(path: str = "torch-trace.json"):
    """Trace the enclosed block; yields the profiler, writes ``path`` (a
    Chrome trace) at the end."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


class Timer:
    """Wall-clock phase timer that waits for the device's queued work."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the block; on a CUDA ``device`` (default: the current card,
        when there is one) the phase ends after ``torch.cuda.synchronize``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
            if cuda:
                torch.cuda.synchronize(device)
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        return "\n".join(f"{k}: {v * 1e3:.2f} ms ({v / total * 100:.1f}%)"
                         for k, v in sorted(self.times.items(), key=lambda kv: -kv[1]))
