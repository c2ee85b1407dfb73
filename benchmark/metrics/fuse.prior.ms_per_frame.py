"""fuse.prior.ms_per_frame: time on the profiler's clock inside the
program's TSDF-prior stage (its host ranges, waits for the card included)
per frame fused, over the traced unit, in ms."""

from benchmark.metrics._fuse_spans import prior_ms as read  # noqa: F401
