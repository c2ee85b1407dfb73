"""fuse.prior.ms_per_frame.k1: fuse.prior.ms_per_frame on the per-frame
path."""

from benchmark.metrics._fuse_spans import prior_ms as read  # noqa: F401
