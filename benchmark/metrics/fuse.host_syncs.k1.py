"""fuse.host_syncs.k1: fuse.host_syncs on the per-frame path, where each
``fuse`` span is one frame's table update."""

from benchmark.metrics._fuse_spans import host_syncs as read  # noqa: F401
