"""The batch engine's queue wait in the spans window (``pb/spans.py``,
``ms``): the median over the window's studies of the time from the server
taking a study's batch from its loader (the start of its ``serve.stage``) to
the start of its ``generate.encode``. A median: every study of a batch
shares its wait, and the window holds 16 batches."""

from pb import spans


def read(ctx):
    return spans.queue_wait_ms(ctx)
