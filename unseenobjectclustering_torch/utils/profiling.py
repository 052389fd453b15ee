"""Timing and profiling: running averages, stage timers and a
torch.profiler trace.

Port of ``unseenobjectclustering_tpu/utils/profiling.py``: AverageMeter
(lib/fcn/train.py:15-34) and StageTimer as they are; ``trace`` writes a
torch.profiler Chrome trace where the JAX package takes a jax.profiler
trace, and ``annotate`` names a region in it (``record_function``).  The
JAX package's persistent XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class AverageMeter:
    """Running average (parity with lib/fcn/train.py:15-34)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class StageTimer:
    """Named stage wall-clock accumulator for pipeline breakdowns."""

    def __init__(self):
        self.meters: dict[str, AverageMeter] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.meters.setdefault(name, AverageMeter()).update(
                time.perf_counter() - t0)

    def summary(self) -> str:
        return " | ".join(f"{k}: {m.avg * 1000:.2f}ms"
                          for k, m in self.meters.items())


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block with torch.profiler (host ops, and the CUDA kernels
    when a card is present) and write ``<log_dir>/trace.json``, a Chrome
    trace (chrome://tracing or Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums the time by op and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up inside profiler traces."""
    with record_function(name):
        yield
