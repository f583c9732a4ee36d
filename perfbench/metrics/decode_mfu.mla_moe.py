"""The served reports' share of the card's bf16 peak over the measured window
(``%``), for a configuration whose report decoder is the ``mla_moe`` language
model: the operations the returned reports need (each study's encoder over
its images and indication and the projector, the prefill of its prefix, and
its decoder steps for every beam row up to its served length: active
parameters and attention), counted from the configuration's shapes
(``pb/shapes_mla_moe.py``), over the window's seconds times 989 TFLOP/s."""

from pb import shapes, shapes_mla_moe


def read(ctx):
    w, gen = ctx.window, ctx.extra.get("gen")
    if not w or not w.studies or gen is None:
        return None
    cfg = ctx.cfg
    beam = cfg["decode"]["beam_size"]
    p = shapes.image_tokens(cfg["model"], cfg["image_size"]) - 1
    n = gen.n
    views = {r: int((gen.pids[n:] == r).sum()) for r in range(n)}
    inc = [bt["inc_mask"].sum(1) for bt in gen.pool]
    enc, dec = {}, {}
    prefill = shapes_mla_moe.prefill_flops(cfg, p)
    flops = 0.0
    for s in w.studies:
        key = (s.pool, s.row)
        if key not in enc:
            enc[key] = shapes_mla_moe.study_encoder_flops(cfg, 1 + views[s.row], views[s.row],
                                                          int(inc[s.pool][s.row]))
        length = len(s.tokens)
        if length not in dec:
            dec[length] = shapes_mla_moe.report_flops(cfg, p, length, beam)
        flops += enc[key] + prefill + dec[length]
    return 100.0 * flops / (w.seconds * shapes.PEAK_BF16_FLOPS)
