"""fused_decode.roofline: kernels.fused_corner_decode's least time on the
card (the larger of its operations at the dense TF32 peak and its bytes at
HBM bandwidth, for model.mesh_decode_batch points per launch) over its
device time in the trace, in %."""


def read(ctx):
    if ctx.timeline is None:
        return None
    dev_s, launches = ctx.timeline.device_time(("fused_corner_decode_kernel",))
    if not launches or dev_s <= 0:
        return None
    r = ctx.rooflines
    net = ctx.run.config["network"]
    dims = r.layer_dims(net)["decoder"]
    n = int(getattr(ctx.run.cfg.model, "mesh_decode_batch", 1 << 18))
    one = r.bound_s(r.decoder_flops(n, dims),
                    r.decode_bytes(n, int(net["feature_dims"]), dims))
    return 100.0 * launches * one / dev_s
