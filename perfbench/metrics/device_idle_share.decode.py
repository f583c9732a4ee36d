"""The share of the spans window (``pb/spans.py``) in which nothing ran on the
card while the server was issuing the decode steps and reading the early-
stop flag (``generate.decode`` and its children, ``continuous.dispatch``)
(``%``)."""

from pb import spans


def read(ctx):
    return spans.idle_share(ctx, "decode")
