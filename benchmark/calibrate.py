#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 12 \\
        --control-seeds 3 [--seconds 1] [--first-seed N]

Runs the cell at its own size on ``--seeds`` seeds as configured (the lower
readings) and on ``--control-seeds`` seeds with the control switched on
(``benchmark/limits/<workload>.json``'s ``control``: the system's own
lower-precision path; the upper readings), each with a short window of
whole units, and prints one JSON line per run with every compared number,
then the largest program reading and the smallest control reading of each.
The cell may be one that BENCHMARK.json does not enrol yet
(``tests/parked.json``).  Set-up (kernels, the process, the card) is paid
once.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402


def readings(workload: str, seeds, control_seeds, seconds: float,
             device: str = "cuda", **patches):
    """{"program": [checks per seed], "control": [...]}, printed as they
    come."""
    ctl = bench_run.load_json(bench_run.HERE, "limits",
                              workload + ".json")["control"]
    out = {"program": [], "control": []}
    extra = list(patches.pop("extra_overrides", []))
    for kind, ss, more in (("program", seeds, []),
                           ("control", control_seeds, ctl)):
        for s in ss:
            try:
                r = bench_run.run_cell(workload, s, seconds, False, device,
                                       extra_overrides=extra + more,
                                       **patches)
                vals = r["readings"]
                extra_info = {"attempted": r["attempted"],
                              "failed": r["failed"]}
            except (RuntimeError, ValueError) as e:   # a control that fails
                vals, extra_info = None, {"error": repr(e)[:300]}
            out[kind].append(vals)
            print(json.dumps({"workload": workload, "kind": kind, "seed": s,
                              "checks": vals, **extra_info}), flush=True)
            if device == "cuda":
                torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    s0 = args.first_seed
    out = readings(args.workload, range(s0, s0 + args.seeds),
                   range(s0 + 1000, s0 + 1000 + args.control_seeds),
                   args.seconds, bench=bench_run.bench_with_parked())
    prog = [v for v in out["program"] if v]
    ctl = [v for v in out["control"] if v]
    summary = {}
    for k in (prog[0] if prog else {}):
        summary[k] = {"program_max": max(v[k] for v in prog),
                      "control_min": (min(v[k] for v in ctl) if ctl
                                      else None),
                      "control_failed_runs": len(out["control"]) - len(ctl)}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
