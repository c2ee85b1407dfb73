"""fuse.host_syncs: the host's waits on the card (the CUDA runtime's
``cudaStreamSynchronize`` / ``cudaEventSynchronize`` calls in the trace)
inside the program's ``fuse`` spans, per span: one table update each (K
frames on the merged path, one on the per-frame path)."""

from benchmark.metrics._fuse_spans import host_syncs as read  # noqa: F401
