"""Useful decode steps: the steps the served reports need, over the steps the
server issued in the measured window (``%``).

Needed: the forced lengths of the studies returned, summed, over the rows a
step carries (the batch's studies, or the engine's slots). Issued: the
program's count of decode steps. Unforced traffic has no length to read.
"""


def read(ctx):
    w = ctx.window
    if not w or not w.steps_issued or any(s.target is None for s in w.studies):
        return None
    per_step = ctx.cell["engine_settings"].get("slots", ctx.traffic["studies_per_batch"])
    needed = sum(s.target for s in w.studies) / per_step
    return 100.0 * needed / w.steps_issued
