"""The share of the spans window (``pb/spans.py``) in which nothing ran on the
card while the server was blocked on its loader's queue
(``serve.loader_wait``) (``%``)."""

from pb import spans


def read(ctx):
    return spans.idle_share(ctx, "loader")
