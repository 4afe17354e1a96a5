"""The least time a request needs over its device time, in %: the staged
features read once (files × channels × frames × 4 bytes, from the
configuration's own sizes) at the memory rate of the cell's cards
together, over ``device_ms.serve`` (a card's on average): the bytes set
against the card-seconds busy.  The same work whatever implements the
request."""

from portbench.roofline import share_pct


def read(ctx):
    s = ctx.summary
    if s is None or s.device_events == 0:
        return None
    c = ctx.config
    moved = c["files"] * c["channels"] * c["frames"] * 4
    return share_pct(ctx, moved, s.busy_s / s.units)
