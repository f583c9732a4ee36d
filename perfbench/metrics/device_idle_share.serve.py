"""The share of the traced serving window in which nothing ran on the card
(``%``): 1 - (union of the device operations' intervals) / window."""


def read(ctx):
    t = ctx.traced
    if not t or t.trace is None or t.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.trace.busy_s / t.trace.window_s)
