"""fuse.update.ms_per_frame: time on the profiler's clock inside the
program's table-update stages (K-merge, table, overflow check: their host
ranges, waits for the card included) per frame fused, over the traced unit,
in ms."""

from benchmark.metrics._fuse_spans import update_ms as read  # noqa: F401
