"""The control (the system's own lower-precision path, from the cell's
limits file) must come out not correct: at a CPU size here, and at the
cell's own size on three seeds on the card."""

import pytest

from benchmark import calibrate
from benchmark import run as bench_run
from benchmark.tests.tiny import CASES, run_tiny


@pytest.mark.parametrize("name", sorted(CASES))
def test_control_is_not_correct(name):
    ctl = bench_run.load_json(bench_run.HERE, "limits",
                              name + ".json")["control"]
    for seed in (3, 2 ** 34 + 1):
        r = run_tiny(name, seed=seed, more=ctl)
        assert not r["correct"], r["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(CASES))
def test_control_is_not_correct_on_the_card(name, cuda_device):
    limits = bench_run.load_json(bench_run.HERE, "limits",
                                 name + ".json")["checks"]
    out = calibrate.readings(name, [], [11, 12, 13], 1.0, cuda_device,
                             bench=bench_run.bench_with_parked())
    for vals in out["control"]:
        assert vals is None or any(vals[k] > limits[k] for k in limits)
