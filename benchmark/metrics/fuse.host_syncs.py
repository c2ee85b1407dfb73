"""fuse.host_syncs: the host's waits on the card (the CUDA runtime's
``cudaStreamSynchronize`` / ``cudaEventSynchronize`` calls in the trace)
inside the program's ``fuse`` spans, per span: one K=16 table update
each."""

from benchmark.metrics._fuse_spans import host_syncs as read  # noqa: F401
