"""fuse.front.ms_per_frame: time on the profiler's clock inside the
program's front stages (staging, points, sort 1, encoder, reduce 1,
corners, sort 2, reduce 2: their host ranges, waits for the card included)
per frame fused, over the traced unit, in ms."""

from benchmark.metrics._fuse_spans import front_ms as read  # noqa: F401
