"""Tracing / profiling: the phase timer, the profiler capture and the
program's spans.

Counterpart of bnv_fusion_tpu/utils/profiling.py:17-86.  ``PhaseTimer`` is
the JAX package's, with an optional ``sync`` run before each reading (on a
card, ``torch.cuda.synchronize``, so that device work is counted in the
phase that queued it).  ``maybe_trace`` captures a block with
``torch.profiler`` and exports a Chrome trace.

``span(name)`` names a stage of the program.  Outside a profiler capture it
costs one flag check and records nothing.  Inside one (``maybe_trace``, or
any ``torch.profiler.profile``) it opens a host range named ``name`` on the
profiler's clock, as a host operation (``_RecordFunctionFast``), so the
profiler makes no device-side copy of it.  What a stage costs is read from
the capture: its ranges' host time, and the CUDA runtime's host waits
(``cudaStreamSynchronize``, ``cudaEventSynchronize``) that start inside
them.

``count(name, value)`` is the program's counter: a host number (never a
tensor, whose read would wait on the device).  Outside a capture it costs
one flag check; inside one it records a host range named
``<name>=<value>`` that closes as it opens, which a reader of the capture
parses.
"""

from __future__ import annotations

import contextlib
import numbers
import os
import time
from typing import Dict, Iterator, Optional

import torch

_PROFILER = torch.autograd.profiler


class PhaseTimer:
    """Accumulating phase timer with fps reporting; ``sync`` (e.g.
    torch.cuda.synchronize) runs before each reading, so device work is
    counted in the phase that queued it."""

    def __init__(self, names, sync=None):
        self.times: Dict[str, float] = {n: 0.0 for n in names}
        self.counts: Dict[str, int] = {n: 0 for n in names}
        self._start: Dict[str, float] = {}
        self._sync = sync or (lambda: None)

    def start(self, name: str) -> None:
        self._sync()
        self._start[name] = time.time()

    def log(self, name: str) -> None:
        self._sync()
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


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler capture of the block (CPU, plus CUDA where a card is
    present) exported as ``<log_dir>/trace.json`` (Chrome trace format)
    when a log dir is given, else a no-op.  The program's spans are in the
    trace."""
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


_OFF = contextlib.nullcontext()


def span(name: str):
    """The program's span round a stage (a context manager; see the module
    docstring)."""
    if not _PROFILER._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def count(name: str, value) -> None:
    """The program's counter ``name`` at ``value``, a host number (see the
    module docstring)."""
    if not _PROFILER._is_profiler_enabled:
        return
    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise TypeError(f"profiling.count({name!r}) takes a host number, "
                        f"not {type(value).__name__}")
    with torch._C._profiler._RecordFunctionFast(f"{name}={value}"):
        pass
