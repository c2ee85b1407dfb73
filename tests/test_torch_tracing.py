"""The port's spans on its fuse path (utils/profiling.py): each stage a host
range under ``fuse`` inside a profiler capture, nothing outside one, and the
benchmark's span readers (benchmark/metrics/_fuse_spans.py) on CPU-sized
cells (benchmark/tests/tiny.py).  One traced run per cell serves every
test of that cell: the profiler is slow on a busy CPU."""

import functools
import json
import math
import os

import pytest
import torch

# benchmark.run points the kernel caches into the checkout on import; the
# other tests in this process keep their own
_ENV = {k: os.environ.get(k) for k in ("TORCH_EXTENSIONS_DIR",
                                       "TRITON_CACHE_DIR")}
from benchmark import run as bench_run  # noqa: E402
from benchmark import trace  # noqa: E402
from benchmark.metrics import _fuse_spans  # noqa: E402
from benchmark.tests.tiny import CASES, SEED, bench_with_parked  # noqa: E402
from bnv_fusion_tpu_torch.utils import profiling  # noqa: E402

for _k, _v in _ENV.items():
    if _v is None:
        os.environ.pop(_k, None)
    else:
        os.environ[_k] = _v

# the stages in the order one table update runs them
K16_STAGES = ["fuse.stage", "fuse.points", "fuse.sort1", "fuse.encode",
              "fuse.reduce1", "fuse.corners", "fuse.sort2", "fuse.reduce2",
              "fuse.merge", "fuse.table", "fuse.prior", "fuse.overflow"]
K1_STAGES = ["fuse.stage", "fuse.points", "fuse.sort1", "fuse.encode",
             "fuse.reduce1", "fuse.corners", "fuse.sort2", "fuse.reduce2",
             "fuse.table", "fuse.prior", "fuse.overflow"]
PATHS = {"scene3d.stream": K16_STAGES, "arkit.stream": K1_STAGES}
# frames per traced unit: two K=16 updates, four per-frame ones
FRAMES = {"scene3d.stream": 32, "arkit.stream": 4}


class _Capture:
    """The traced unit of one CPU-sized run of a cell: the run's result,
    its timeline and the profiler's own events (Chrome trace)."""

    def __init__(self, name, trace_dir):
        kept = {}
        recorder = trace.Recorder

        class _Keep(recorder):
            def timeline(self):
                kept["prof"] = self.prof
                kept["timeline"] = super().timeline()
                return kept["timeline"]

        case = dict(CASES[name])
        case["traffic_patch"] = dict(case["traffic_patch"],
                                     frames=FRAMES[name])
        threads = torch.get_num_threads()
        trace.Recorder = _Keep
        torch.set_num_threads(1)
        try:
            self.result = bench_run.run_cell(
                name, SEED, 0.1, True, device="cpu",
                bench=bench_with_parked(), **case)
        finally:
            trace.Recorder = recorder
            torch.set_num_threads(threads)
        self.timeline = kept["timeline"]
        path = os.path.join(trace_dir, name + ".trace.json")
        kept["prof"].export_chrome_trace(path)
        self.events = json.load(open(path))["traceEvents"]
        self.frames = FRAMES[name]
        self.updates = FRAMES[name] // (16 if name == "scene3d.stream" else 1)


@functools.lru_cache(maxsize=None)
def _capture(name, trace_dir):
    return _Capture(name, trace_dir)


@pytest.fixture
def capture(tmp_path_factory):
    root = str(tmp_path_factory.getbasetemp())
    return lambda name: _capture(name, root)


def _ours(events):
    return sorted((e for e in events if str(e.get("name", "")).startswith(
        "fuse") and e.get("ph") == "X"), key=lambda e: e["ts"])


@pytest.mark.parametrize("name", sorted(PATHS))
def test_stage_spans_are_host_ops_under_fuse(name, capture):
    cap = capture(name)
    ours = _ours(cap.events)
    assert ours and all(e["cat"] == "cpu_op" for e in ours)
    roots = [(e["ts"], e["ts"] + e["dur"]) for e in ours
             if e["name"] == "fuse"]
    stages = [e for e in ours if e["name"] != "fuse"]
    assert len(roots) == cap.updates
    for lo, hi in roots:
        assert [e["name"] for e in stages if lo <= e["ts"] <= hi] == \
            PATHS[name]
    assert all(any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                   for lo, hi in roots) for e in stages)


@pytest.mark.parametrize("name", sorted(PATHS))
def test_readers_on_a_cpu_capture(name, capture):
    """One ``fuse`` span per table update, no host waits on the CPU, and
    the three groups' time within the ``fuse`` spans'."""
    cap = capture(name)
    tl = cap.timeline
    fuse = [b - a for n, a, b in tl.host if n == "fuse"]
    assert len(fuse) == cap.updates
    assert not any(n in PATHS[name] or n == "fuse" for n, _, _ in tl.dev)
    ctx = _Ctx(tl, cap.frames)
    assert _fuse_spans.host_syncs(ctx) == 0.0
    groups = [_fuse_spans.front_ms(ctx), _fuse_spans.update_ms(ctx),
              _fuse_spans.prior_ms(ctx)]
    assert all(g > 0 for g in groups)
    assert sum(groups) <= sum(fuse) / 1e3 / cap.frames


class _Ctx:
    def __init__(self, timeline, frames):
        self.timeline, self.counters = timeline, {"frames": frames}


def test_no_capture_records_nothing(tmp_path):
    run = bench_run.Run("arkit.stream", SEED, False, "cpu",
                        bench=bench_with_parked(), **CASES["arkit.stream"])
    # outside a capture a span is one shared no-op
    assert profiling.span("fuse") is profiling.span("fuse.table")
    run.fuse(run.new_map(), [run.frame(0)])
    with profiling.maybe_trace(str(tmp_path)):
        with profiling.span("other"):
            pass
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert not _ours(events)
    assert [e["name"] for e in events if e.get("name") == "other"] == \
        ["other"]


def test_host_syncs_reader_counts_waits_inside_fuse():
    """The CUDA runtime's waits that start inside a ``fuse`` range count,
    per range; the harness's own syncs outside them do not."""
    host = [("bench.fuse", 0, 40), ("cudaDeviceSynchronize", 1, 2),
            ("fuse", 3, 20), ("fuse.table", 4, 19),
            ("cudaStreamSynchronize", 5, 6), ("aten::nonzero", 7, 9),
            ("cudaStreamSynchronize", 8, 9), ("fuse.overflow", 19, 20),
            ("cudaEventSynchronize", 19, 20), ("cudaLaunchKernel", 10, 11),
            ("fuse", 22, 30), ("cudaDeviceSynchronize", 31, 35)]
    ctx = _Ctx(trace.Timeline(host, [("kernel", 0, 40)]), 2)
    assert _fuse_spans.host_syncs(ctx) == 1.5
    assert _fuse_spans.update_ms(ctx) == pytest.approx(16e-3 / 2)
    assert _fuse_spans.front_ms(ctx) is None
    assert _fuse_spans.host_syncs(_Ctx(None, 2)) is None


NEW_METRICS = [(cell, base + sfx)
               for cell, sfx in (("scene3d.stream", ""),
                                 ("arkit.stream", ".k1"))
               for base in ("fuse.host_syncs", "fuse.front.ms_per_frame",
                            "fuse.update.ms_per_frame",
                            "fuse.prior.ms_per_frame")]


@pytest.mark.parametrize("cell,metric", NEW_METRICS)
def test_traced_run_reports_span_metric(cell, metric, capture):
    metrics = capture(cell).result["metrics"]
    assert metric in metrics and math.isfinite(metrics[metric]["value"])
    assert metrics[metric]["value"] >= 0
    entry = next(m for m in bench_run.load_json(
        bench_run.ROOT, "BENCHMARK.json")["per_layer"] if m["name"] == metric)
    assert entry["workloads"] == [cell]
    assert metrics[metric]["unit"] == entry["unit"]
    if "host_syncs" in metric:
        assert metrics[metric]["value"] == 0.0   # the tiny cells: CPU
