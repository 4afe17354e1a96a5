"""95th percentile (nearest rank) of the client-side wall latency of every
request completed in the window, in ms."""

import math


def read(ctx):
    lat = sorted(t1 - t0 for t0, t1, ok in ctx.units if ok)
    if not lat:
        return None
    return 1e3 * lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
