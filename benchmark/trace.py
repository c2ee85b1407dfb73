"""Reading the traced unit's device timeline from ``torch.profiler``.

``Recorder`` profiles the host and the card (CUPTI); ``Timeline`` keeps the
device's kernel, copy and set intervals inside the harness's
``bench.window`` range, their union (``busy_s``), the longest idle gaps
named by what the host was doing (the harness's innermost ``bench.*`` span
and the innermost host operation at the gap's middle, ``python`` where the
host ran no traced operation) and device time by kernel name.  The
harness's own ranges (``bench.*``) also appear on the device's timeline as
annotations; they are not device work and are left out.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

import torch
from torch.autograd import DeviceType


class Recorder:
    def __init__(self, device: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def timeline(self) -> "Timeline":
        host, dev = [], []
        try:
            events = self.prof.profiler.kineto_results.events()
            for e in events:
                if hasattr(e, "start_ns"):
                    t0 = e.start_ns() / 1e3
                    t1 = t0 + e.duration_ns() / 1e3
                else:
                    t0 = float(e.start_us())
                    t1 = t0 + float(e.duration_us())
                on_dev = e.device_type() == DeviceType.CUDA
                (dev if on_dev else host).append((e.name(), t0, t1))
        except AttributeError:
            for e in self.prof.events():
                rec = (e.name, float(e.time_range.start),
                       float(e.time_range.end))
                (dev if e.device_type == DeviceType.CUDA else host).append(rec)
        return Timeline(host, dev)


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:80]


class Timeline:
    def __init__(self, host: List[Tuple[str, float, float]],
                 dev: List[Tuple[str, float, float]]):
        win = [h for h in host if h[0] == "bench.window"]
        if win:
            self.t0, self.t1 = win[0][1], win[0][2]
        else:
            spans = host + dev
            self.t0 = min(s[1] for s in spans) if spans else 0.0
            self.t1 = max(s[2] for s in spans) if spans else 0.0
        self.dev = [(n, max(a, self.t0), min(b, self.t1)) for n, a, b in dev
                    if not n.startswith("bench.") and b > self.t0 and
                    a < self.t1 and b > a]
        self.host = [h for h in host if h[0] != "bench.window" and
                     h[2] > self.t0 and h[1] < self.t1]
        self.window_s = (self.t1 - self.t0) / 1e6
        self._union = self._merge(sorted((a, b) for _, a, b in self.dev))
        self.busy_s = sum(b - a for a, b in self._union) / 1e6

    @staticmethod
    def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def device_time(self, names: Iterable[str]) -> Tuple[float, int]:
        """(seconds, launches) of the device events whose name holds any of
        ``names``."""
        names = tuple(names)
        hits = [(b - a) for n, a, b in self.dev if any(k in n for k in names)]
        return sum(hits) / 1e6, len(hits)

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.t0] + [x for iv in self._union for x in iv] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def _host_at(self, t: float) -> str:
        span, op = None, None
        for n, a, b in self.host:
            if a <= t <= b:
                if n.startswith("bench."):
                    if span is None or b - a < span[1]:
                        span = (n[6:], b - a)
                elif op is None or b - a < op[1]:
                    op = (n, b - a)
        return f"{span[0] if span else 'harness'}/{op[0] if op else 'python'}"

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        by: Dict[str, float] = {}
        for name, a, b in self.dev:
            k = short_name(name)
            by[k] = by.get(k, 0.0) + (b - a) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self._host_at(0.5 * (a + b)), (b - a) / 1e6]
                              for a, b in gaps]}
