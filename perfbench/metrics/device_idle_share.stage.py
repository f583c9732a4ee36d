"""The share of the spans window (``pb/spans.py``) in which nothing ran on the
card while the server was staging batches: host copies, checks, pinning and
issuing the copy (``serve.stage``), fusing and loading the continuous
engine's packs (``%``)."""

from pb import spans


def read(ctx):
    return spans.idle_share(ctx, "stage")
