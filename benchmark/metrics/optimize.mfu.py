"""optimize.mfu: the decoder's operations on the samples the optimize step
decodes (rays x samples per ray x 8 corners x 2 x the MLP's multiply-adds,
forward and the backward to its inputs: the weights are frozen) over the
traced optimize time, as a share of the card's dense TF32 peak, in %."""


def read(ctx):
    spans, n = ctx.spans.get("optimize"), ctx.counters.get("iterations")
    if not spans or not n:
        return None
    r = ctx.rooflines
    m = ctx.run.cfg.model
    dims = r.layer_dims(ctx.run.config["network"])["decoder"]
    tu = int(m.ray_tracer.truncated_units)
    per_ray = ((int(getattr(m.ray_tracer, "n_fine", 0) or 0) or 2 * tu) +
               (int(getattr(m.ray_tracer, "n_coarse", 0) or 0) or
                int(ctx.run.ray_max * 5)))
    samples = int(ctx.run.cfg.dataset.num_pixels) * per_ray
    flops = n * r.decoder_flops(samples, dims, backward_to_inputs=True)
    return 100.0 * flops / sum(spans) / r.PEAK_FLOPS
