"""The control: the reference in float8 put in the program's place, serving
each checked study by its own beam search, comes out as not correct through
the same checks that the program passes.

At this small size the program runs in float32 and serves the reference's
own tokens (a gap of 0.0), and the float8 control's gap reads 0.04-0.35
(vocabulary 4000, 12 studies checked), so the limit here is 0.01;
``calibrate.py`` reads both at the cell's own size on the card, where the
cell's limit lies between them."""

import pytest

import small
from small import run_small

SERVING = ["r2gen224.batch.lenmix", "cmn224.batch.full100", "r2gen224.continuous.lenmix"]
SMALL_LIMIT = 0.01


@pytest.mark.parametrize("cell", SERVING)
def test_serving_control_fails_the_limit(cell, monkeypatch):
    monkeypatch.setitem(small.SMALL_MODEL, "vocab_size", 4000)

    def with_control(ctx):
        ctx.extra["control"] = True
        ctx.cell["limits"]["served_gap"] = SMALL_LIMIT
        ctx.traffic["check_studies"] = 12
    ctx, out = run_small(cell, seconds=0.5, patch=with_control)
    assert out.correct, out.checks
    control = {name: (value, ok) for name, value, _, ok in ctx.extra["control_checks"]}
    assert not control["served_gap"][1], control
    assert control["tokens_compared"][0] == ctx.extra["gaps"]["tokens_compared"]
