"""Lineage attention (K1) against its roofline in the traced window (``%``):
the least time the card needs for what the served reports ask of K1 (every
layer's attention at every step of every traced study, over the fewest cache
rows its beams can attend) over the device time of the kernels named here."""

from pb import shapes

KERNELS = ("lineage_kernel",)


def read(ctx):
    t = ctx.traced
    if not t or t.trace is None:
        return None
    seconds, count = t.trace.kernels(KERNELS)
    if count == 0 or seconds <= 0:
        return None
    m = ctx.cfg["model"]
    beam = ctx.cfg["decode"]["beam_size"]
    bound = 0.0
    for s in t.studies:
        length = len(s.tokens)
        bound += shapes.bound_s(shapes.k1_study_bytes(m, length, beam),
                                shapes.k1_study_flops(m, length, beam))
    return 100.0 * bound / seconds
