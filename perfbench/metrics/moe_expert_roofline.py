"""The routed experts' grouped GEMMs against their roofline in the traced
window (``%``): the least time of what the window's MoE calls need, over the
device time of the kernels named here. The language model's expert ledger
(read after the traced window) gives, per MoE layer and per kind of call
(prefill, decode step), the rows routed to the experts and the experts each
call touched: each touched expert's three matrices are read once per call,
each assignment's row is read in and written out (bf16), and each assignment
costs 2 x 3 x hidden x expert width operations. The least time is the larger
of bytes over 3.35 TB/s and operations over 989 TFLOP/s, per kind of call
(every call of a kind routes the same number of rows)."""

from pb import shapes, shapes_mla_moe
from pb.ref_mla_moe import lm_config

# torch._grouped_mm's CUTLASS 3.x kernels on sm90 (gate-up and down, every size)
KERNELS = ("GroupProblemShape",)


def read(ctx):
    t, led = ctx.traced, ctx.extra.get("expert_ledger")
    if not t or t.trace is None or led is None:
        return None
    seconds, calls = t.trace.kernels(KERNELS)
    if calls == 0 or seconds <= 0:
        return None
    c = lm_config(ctx.cfg)
    least = 0.0
    for kind in range(led["rows"].shape[0]):
        rows, touched = float(led["rows"][kind].sum()), float(led["touched"][kind].sum())
        least += shapes.bound_s(shapes_mla_moe.expert_bytes(c, touched, rows),
                                shapes_mla_moe.expert_flops(c, rows))
    return 100.0 * least / seconds
