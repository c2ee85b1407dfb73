"""fuse.prior.budget: the bricks of 4^3 voxels that the block-major
prior's update runs over per prior frame (the compaction width, pads
included), the mean over the traced unit.  bnv_fusion_tpu_torch's
``tsdf.integrate_blocks`` records it as the count ``fuse.prior.budget``
(``utils/profiling.count``: a host range named ``<name>=<value>``); None
where the program makes no such count (a dense prior, or a program without
it)."""

HEAD = "fuse.prior.budget="


def read(ctx):
    t = ctx.timeline
    if t is None:
        return None
    values = [float(n[len(HEAD):]) for n, _, _ in t.host
              if n.startswith(HEAD)]
    return sum(values) / len(values) if values else None
