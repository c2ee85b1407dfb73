"""The kernel build's staleness rule: a library is rebuilt when its source or
any shared header in csrc/ is newer than it (no compiler needed here)."""

import os

from bnv_fusion_tpu_torch.kernels import _build


def _touch(path, mtime):
    with open(path, "w") as f:
        f.write("//\n")
    os.utime(path, (mtime, mtime))


def test_stale_follows_source_and_headers(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    assert _build._stale("k")                       # no library yet
    _touch(csrc / "k.cu", 1000)
    _touch(csrc / "shared.cuh", 1000)
    _touch(build / "libk.so", 2000)
    assert not _build._stale("k")
    _touch(csrc / "shared.cuh", 3000)               # a newer header
    assert _build._stale("k")
    _touch(build / "libk.so", 4000)
    assert not _build._stale("k")
    _touch(csrc / "k.cu", 5000)                     # a newer source
    assert _build._stale("k")
