"""Tracing / profiling: phase timers, device-memory stats, profiler capture.

Counterpart of bnv_fusion_tpu/utils/profiling.py:17-86.  ``PhaseTimer`` is
unchanged; the device instruments use torch: ``torch.cuda.memory_stats``
per card, ``torch.profiler`` with a Chrome trace export, and
``torch.profiler.record_function`` for named regions.  Without a card they
report what torch gives and claim no device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


class PhaseTimer:
    """Accumulating phase timer with fps reporting."""

    def __init__(self, names):
        self.times: Dict[str, float] = {n: 0.0 for n in names}
        self.counts: Dict[str, int] = {n: 0 for n in names}
        self._start: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._start[name] = time.time()

    def log(self, name: str) -> None:
        self.times[name] += time.time() - self._start.pop(name)
        self.counts[name] += 1

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        self.start(name)
        try:
            yield
        finally:
            self.log(name)

    def fps(self, name: str, steps: Optional[int] = None) -> float:
        t = self.times.get(name, 0.0)
        n = steps if steps is not None else self.counts.get(name, 0)
        return n / t if t > 0 else float("inf")

    def summary(self) -> str:
        return " | ".join(
            f"{n}: {self.times[n]:.2f}s ({self.fps(n):.2f}/s)"
            for n in self.times)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory in GB, keyed ``cuda:<i> (<name>)``: bytes in use,
    the peak and the card's total.  Empty when torch sees no card."""
    gb = 1024 ** 3
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i} ({torch.cuda.get_device_name(i)})"] = {
            "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / gb,
            "peak_bytes_in_use_gb": stats.get("allocated_bytes.all.peak",
                                              0) / gb,
            "bytes_limit_gb":
                torch.cuda.get_device_properties(i).total_memory / gb,
        }
    return out


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler capture of the block (CPU, plus CUDA where a card is
    present) exported as ``<log_dir>/trace.json`` (Chrome trace format)
    when a log dir is given, else a no-op."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in profiler timelines."""
    with torch.profiler.record_function(name):
        yield
