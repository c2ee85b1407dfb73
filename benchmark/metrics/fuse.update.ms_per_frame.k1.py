"""fuse.update.ms_per_frame.k1: fuse.update.ms_per_frame on the per-frame
path (no K-merge there)."""

from benchmark.metrics._fuse_spans import update_ms as read  # noqa: F401
