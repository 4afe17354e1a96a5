"""Window wall milliseconds per completed one-off analysis."""


def read(ctx):
    n = sum(1 for u in ctx.units if u[2])
    wall = ctx.window[1] - ctx.window[0]
    if not n or wall <= 0:
        return None
    return 1e3 * wall / n
