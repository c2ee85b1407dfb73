"""The system against the plain reference, every cell cut to a CPU size:
sound runs come out correct, with every compared number far under its
limit."""

import math

import pytest

from benchmark.tests.tiny import CASES, run_tiny


@pytest.mark.parametrize("name", sorted(CASES))
def test_sound_run_is_correct(name):
    r = run_tiny(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    for k, c in r["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"], k
    assert r["jax_modules"] == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_traced_run_reports_its_per_layer_metrics(name):
    r = run_tiny(name, traced=True)
    assert r["correct"]
    assert r["metrics"], "a traced run reports per-layer metrics"
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
