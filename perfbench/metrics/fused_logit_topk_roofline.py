"""The fused logit + top-k tail (K2) against its roofline in the traced window
(``%``): each call's least time at its rows (the step's beam rows: h, the
whole [V, D] weight and the bias read once, k candidates and the log-sum-exp
written, 2 N D V operations), summed over the calls, over the device time of
the kernels named here."""

from pb import shapes

KERNELS = ("tile_kernel_bf16", "merge_kernel_warp")
FIRST = "tile_kernel_bf16"     # one of these a call


def read(ctx):
    t = ctx.traced
    if not t or t.trace is None:
        return None
    seconds, _ = t.trace.kernels(KERNELS)
    _, calls = t.trace.kernels((FIRST,))
    if calls == 0 or seconds <= 0:
        return None
    m = ctx.cfg["model"]
    k = ctx.cfg["decode"]["beam_size"]
    rows = k * ctx.cell["engine_settings"].get("slots", ctx.traffic["studies_per_batch"])
    per_call = shapes.bound_s(shapes.k2_call_bytes(m, rows, k), shapes.k2_call_flops(m, rows))
    return 100.0 * calls * per_call / seconds
