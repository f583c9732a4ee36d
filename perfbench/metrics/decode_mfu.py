"""The served reports' share of the card's bf16 peak over the measured window
(``%``): the operations the returned reports need (each study's encoder over
its images and indication, and its decoder steps for every beam row up to its
served length), counted from the configuration's shapes, over the window's
seconds times 989 TFLOP/s."""

from pb import shapes


def read(ctx):
    w, gen = ctx.window, ctx.extra.get("gen")
    if not w or not w.studies or gen is None:
        return None
    m, size = ctx.cfg["model"], ctx.cfg["image_size"]
    beam = ctx.cfg["decode"]["beam_size"]
    n = gen.n
    views = {r: int((gen.pids[n:] == r).sum()) for r in range(n)}
    inc = [bt["inc_mask"].sum(1) for bt in gen.pool]
    enc, dec = {}, {}
    flops = 0.0
    for s in w.studies:
        key = (s.pool, s.row)
        if key not in enc:
            enc[key] = shapes.study_encoder_flops(m, size, 1 + views[s.row], views[s.row],
                                                  int(inc[s.pool][s.row]))
        length = len(s.tokens)
        if length not in dec:
            dec[length] = shapes.report_decode_flops(m, length, beam, size)
        flops += enc[key] + dec[length]
    return 100.0 * flops / (w.seconds * shapes.PEAK_BF16_FLOPS)
