"""The port's multi-process bring-up and entry points: two processes through
parallel.launch.initialize all-reduce a sum (the counterpart of
tests/test_launch.py:60), run_e2e under torchrun on 2 gloo ranks against a
single-process run, the multi-rank dry run (the counterpart of
__graft_entry__.dryrun_multichip), and the parallel package without jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bnv_fusion_tpu_torch import checkpoint, mesh as tmesh, run_e2e
from bnv_fusion_tpu_torch.parallel import dryrun, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import torch
import torch.distributed as dist
from bnv_fusion_tpu_torch.parallel import launch

pid, url = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
launch.initialize(coordinator_address=url, num_processes=2, process_id=pid,
                  device="cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
mesh = launch.global_mesh(("dp",))
assert mesh.size == 2 and mesh.rank == pid
try:
    launch.global_mesh(("dp", "mp"))
    raise SystemExit("a 2-D mesh was accepted")
except ValueError:
    pass
sl = launch.process_local_slice(8)
assert sl == slice(pid * 4, pid * 4 + 4), sl
local = torch.arange(8, dtype=torch.float32)[sl]
total = float(mesh.all_reduce(local.sum()))
assert total == 28.0, total
launch.shutdown()
print(f"WORKER{pid} OK {total}", flush=True)
"""

# the SKILL.md CPU smoke's sizes
SMOKE = ["device_type=cpu", "dataset.img_res=[60,80]", "dataset.num_images=4",
         "model.voxel_size=0.05", "model.integrate_batch_size=2",
         "dataset.num_pixels=200", "model.train_ray_splits=100",
         "trainer.global_steps=2", "model.min_pts_in_grid=0"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_two_process_initialize_all_reduce(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    url = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen([sys.executable, str(script), str(i), url],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER{i} OK 28.0" in out, out


def _volume(path):
    d = checkpoint.load_state(path)
    k = np.asarray(d["active_coordinates"])
    o = np.lexsort(k.T)
    return (k[o], np.asarray(d["features"])[o], np.asarray(d["weights"])[o],
            np.asarray(d["num_hits"])[o])


def test_torchrun_run_e2e_two_ranks(tmp_path):
    """run_e2e under torchrun on 2 gloo ranks with trainer.fuse_devices=all
    and optimize_devices=all: rank 0 alone reports and writes (one speed
    report in the ranks' joint output, a non-empty final.ply), and the map
    equals a single-process run's by key: keys, weights and hits exact;
    latents within the cumsum front's 2e-3 (tests/test_torch_fusion.py)
    plus what the 2 Adam steps of lr 1e-3 can add where the two runs'
    gradients differ in sign (each step moves a latent by at most ~lr, so
    two trajectories part by at most 2 * steps * lr)."""
    dp_dir, one_dir = tmp_path / "dp", tmp_path / "one"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "bnv_fusion_tpu_torch.run_e2e",
           *SMOKE, "trainer.fuse_devices=all", "trainer.optimize_devices=all",
           f"output_dir={dp_dir}"]
    res = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-5000:]
    assert res.stdout.count("speed on global fusion") == 1, res.stdout
    wd = dp_dir / "run_e2e" / "synthetic_demo"
    m = tmesh.load_ply(str(wd / "final.ply"))
    assert len(m.vertices) > 0 and len(m.faces) > 0

    run_e2e.run(SMOKE + [f"output_dir={one_dir}"])
    dk, df, dw, dh = _volume(str(wd / "final_sparse_volume.npz"))
    sk, sf, sw, sh = _volume(str(one_dir / "run_e2e" / "synthetic_demo" /
                                 "final_sparse_volume.npz"))
    assert len(sk) > 100
    np.testing.assert_array_equal(dk, sk)
    np.testing.assert_array_equal(dw, sw)
    np.testing.assert_array_equal(dh, sh)
    np.testing.assert_allclose(df, sf, atol=2e-3 + 2 * 2 * 1e-3, rtol=0)


def test_dryrun_multichip_runs(tmp_path):
    out = dryrun.dryrun_multichip(4, workdir=str(tmp_path))
    assert out["ranks"] == 4 and out["fuse_voxels"] > 0
    assert set(out["cases"]) >= {"fuse", "optimize_iter", "optimize_step",
                                 "nm_optimize", "pretrain", "sp_fuse",
                                 "sp_decode", "sp_optimize", "sp_nm"}
    assert np.all(np.isfinite(out["optimize_iter_losses"]))


def test_parallel_runs_without_jax(tmp_path):
    """`import bnv_fusion_tpu_torch.parallel` (and its spatial module) and
    the dry run's CLI, spatial cases included, with jax, jaxlib, flax,
    optax and the JAX package unimportable (shadowed by packages that
    raise, first on the path of every rank)."""
    block = tmp_path / "blocked"
    for name in ("jax", "jaxlib", "flax", "optax", "bnv_fusion_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"raise ImportError('blocked: {name}')\n")
    env = _env()
    env["PYTHONPATH"] = str(block) + os.pathsep + REPO
    code = ("import bnv_fusion_tpu_torch.parallel as p, sys\n"
            "from bnv_fusion_tpu_torch.parallel import launch, dryrun\n"
            "from bnv_fusion_tpu_torch.parallel import spatial\n"
            "assert spatial.create_spatial_table(p.make_mesh(), (4, 4, 4), "
            "64, 8).nv_shard == 64\n"
            "assert p.make_mesh().size == 1\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'bnv_fusion_tpu')]\n"
            "assert not bad, bad\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    res = subprocess.run([sys.executable, "-m",
                          "bnv_fusion_tpu_torch.parallel.dryrun", "--ranks",
                          "4"], env=env, text=True, capture_output=True,
                         cwd=str(tmp_path), timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert '"ranks": 4' in res.stdout
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"sp_fuse", "sp_decode", "sp_optimize", "sp_nm"} <= \
        set(out["cases"])
    assert out["spatial_voxels"] > 0 and len(out["spatial_losses"]) == 2


def test_distributed_is_a_no_op_without_torchrun(monkeypatch):
    """Outside torchrun (no WORLD_SIZE above 1) the entry points' bring-up
    starts no process group, and this process is rank 0."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    import torch.distributed as dist

    with launch.distributed("cpu"):
        assert not dist.is_initialized()
        assert launch.is_main_process()
    assert launch.process_local_slice(8) == slice(0, 8)
    with pytest.raises(ValueError, match="device count"):
        launch.global_mesh(("dp",), axis_sizes=(2,))
