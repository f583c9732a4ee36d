"""The share of the spans window (``pb/spans.py``) in which nothing ran on the
card while the server was reading results back and making the records
(``serve.read``, ``serve.records``, ``continuous.wait``,
``continuous.harvest``) (``%``)."""

from pb import spans


def read(ctx):
    return spans.idle_share(ctx, "records")
