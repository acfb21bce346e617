"""Profiling and timing hooks (counterpart of
``sam2_video_tpu/utils/profiling.py``).

- ``trace(dir)``: a context manager around ``torch.profiler`` (CPU, and the
  card's kernels when CUDA is available) that writes a chrome trace,
  ``<dir>/trace.json`` (chrome://tracing or Perfetto).
- ``StepTimer``: wall-clock seconds per step; ``stop`` waits for the card
  first, since CUDA calls return before the device has finished.
- ``memory_stats``: the CUDA caching allocator's counts per card.
- ``log_compile_time``: the seconds of a function's first call, which
  includes the CUDA kernels' build (nvcc on first use) and warm-up.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the body; yields the ``torch.profiler.profile`` and writes
    ``<log_dir>/trace.json`` when the body ends."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def synchronize(value=None) -> None:
    """Wait for the card's pending work: that of ``value``'s device when it
    is a CUDA tensor, else of the current device when there is one."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Collects per-step wall times; ``summary()`` gives mean/p50/p90."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        """End the step once the card has finished ``sync_value``'s work
        (any pending work when it is not a tensor)."""
        synchronize(sync_value)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self, skip_first: int = 1) -> dict:
        ts = np.asarray(self.times[skip_first:] or self.times)
        if ts.size == 0:
            return {}
        return {"mean_s": float(ts.mean()), "p50_s": float(np.median(ts)),
                "p90_s": float(np.percentile(ts, 90)), "n": int(ts.size)}

    def save(self, path):
        Path(path).write_text(json.dumps(
            {"times": self.times, **self.summary()}, indent=2))


def memory_stats() -> dict:
    """Per-card memory counts of the caching allocator; empty without
    CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return out


def log_compile_time(fn, log=None, name: str | None = None):
    """``fn`` wrapped so that its first call is timed to the card's end and
    reported through ``log.info`` (print without a logger): the kernel
    build on first use and the warm-up are in that time. The wrapper's
    ``first_call_s`` holds the seconds, None before the first call."""
    label = name or getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if wrapped.first_call_s is not None:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize()
        wrapped.first_call_s = time.perf_counter() - t0
        msg = (f"{label}: first call {wrapped.first_call_s:.3f} s (kernel "
               "build and warm-up included)")
        (log.info if log is not None else print)(msg)
        return out

    wrapped.first_call_s = None
    return wrapped
