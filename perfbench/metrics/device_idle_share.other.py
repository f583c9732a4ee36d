"""The share of the spans window (``pb/spans.py``) in which nothing ran on the
card while the server was under no span of its own (the root ``serve``'s
self time, or outside it) (``%``)."""

from pb import spans


def read(ctx):
    return spans.idle_share(ctx, "other")
