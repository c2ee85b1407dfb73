"""seg_reduce.roofline: kernels.seg_reduce_sorted's least time on the card
(the bytes its inputs need at HBM bandwidth: every row's keys, the payload
of the valid rows, the segments the frames produce) over its device time in
the trace (its four kernels), in %.  Both stages of every frame of the
traced scan; the segments are counted from the frames by the reference."""

KERNELS = ("count_ends_kernel", "scan_tiles_kernel", "tile_sums_kernel",
           "finish_kernel")


def read(ctx):
    stats = ctx.counters.get("frame_stats")
    if ctx.timeline is None or not stats:
        return None
    dev_s, launches = ctx.timeline.device_time(KERNELS)
    if not launches or dev_s <= 0:
        return None
    r = ctx.rooflines
    m = ctx.run.cfg.model
    h, w = ctx.run.img_res
    fdim = int(ctx.run.config["network"]["feature_dims"])
    u_cell = min(int(m.max_unique_cells_per_frame), h * w)
    u = min(int(m.max_unique_per_frame), 8 * u_cell)
    nbytes = sum(r.fuse_seg_reduce_bytes(h * w, s["inside"], s["groups"],
                                         s["voxels"], u_cell, u, fdim)
                 for s in stats)
    return 100.0 * r.bound_s(0.0, nbytes) / dev_s
