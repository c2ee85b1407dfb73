"""The harness loads neither JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and it
measures the card or nothing: without one it exits non-zero and prints no
result, as it does in a directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "bnv_fusion_tpu"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.tests.tiny import run_tiny
for name in ("scene3d.stream", "arkit.demo", "house.stream"):
    run_tiny(name, traced=True)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_no_jax_in_the_harness_process():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN
    assert "bnv_fusion_tpu_torch" in tops


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "scene3d.stream",
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
