"""The share of the spans window (``pb/spans.py``) in which nothing ran on the
card while the server was issuing the encoder (``generate.encode``,
``continuous.encode``) (``%``)."""

from pb import spans


def read(ctx):
    return spans.idle_share(ctx, "encode")
