"""The continuous engine's admission wait in the spans window
(``pb/spans.py``, ``ms``): the 90th percentile over the window's studies of
``study.queued``, from its batch encoded to the dispatch that admits it."""

from pb import spans


def read(ctx):
    return spans.admission_wait_p90_ms(ctx)
