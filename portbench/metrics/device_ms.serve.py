"""Device busy milliseconds per request: the union of a card's kernel, copy
and set intervals over the traced requests, averaged over the cell's
cards, divided by their count."""


def read(ctx):
    s = ctx.summary
    if s is None or s.device_events == 0:
        return None
    return 1e3 * s.busy_s / s.units
