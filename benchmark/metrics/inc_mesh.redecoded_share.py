"""inc_mesh.redecoded_share: voxels the incremental mesher decoded again
over the voxels eligible to mesh (IncrementalMesher.last_stats), summed
over the traced events, in %."""


def read(ctx):
    e = ctx.counters.get("eligible")
    if not e:
        return None
    return 100.0 * ctx.counters.get("redecoded", 0) / e
