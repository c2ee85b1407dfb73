"""Build and load the hand-written CUDA kernels (nvcc -> shared library ->
ctypes), and count their launches.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled for
Hopper (``sm_90a``) into ``bnv_fusion_tpu_torch/_build/lib<name>.so`` at first
use; a library newer than its source and than every ``csrc/*.cuh`` header
is reused.  ``build()`` starts one nvcc
per source at once, so a fresh checkout pays the slowest compile, not the
sum.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("seg_reduce", "fused_decode", "fused_mlp")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# launches per kernel wrapper; a wrapper adds one where it launches its
# kernel and nowhere else
LAUNCHES: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc") or ""]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from bnv_fusion_tpu_torch/csrc at first use")


def _paths(name: str):
    return (os.path.join(CSRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"),
            os.path.join(BUILD_DIR, f"lib{name}.log"))


def _stale(name: str) -> bool:
    """A library is stale when its source or any shared header in csrc/
    (which a source may include) is newer than it."""
    src, lib, _ = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in deps)


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every stale kernel library, one nvcc process per source, all
    started together.  Returns {name: seconds} for the ones compiled; raises
    with the compiler's output on failure.  ``-Xptxas -v`` (registers,
    shared memory, spills) lands in ``_build/lib<name>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        src, lib, log = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc_path()] + NVCC_FLAGS + ["-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib, log, time.time())
    took = {}
    errors = []
    for name, (proc, tmp, lib, log, t0) in procs.items():
        out, _ = proc.communicate()
        with open(log, "w") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{out}")
            continue
        os.replace(tmp, lib)
        took[name] = time.time() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(_paths(name)[1])
        return _LIBS[name]


def function(name: str, entry: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``entry`` of kernel library ``name``, returning an
    int, with its argument types set once (binding it on every call costs
    host time on the launch path)."""
    key = (name, entry)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(name), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[key] = fn
    return fn


def call(fn, device, *args) -> int:
    """Run a C launcher with ``args`` and the current stream of ``device``
    (a torch.device); the launchers use the current CUDA device, so another
    device is made current around the call."""
    import torch

    def run():
        stream = torch.cuda.current_stream(device).cuda_stream
        return fn(*args, ctypes.c_void_p(stream))

    if device.index is None or device.index == torch.cuda.current_device():
        return run()
    with torch.cuda.device(device):
        return run()


def check_cuda_tensor(t, name: str, dtype, ndim: int, device) -> None:
    """Wrapper-side argument check: device, dtype, rank, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def raise_on_error(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")
