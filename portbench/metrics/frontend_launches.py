"""Device kernels, copies and sets per ``-f`` pass, counted in the trace."""


def read(ctx):
    s = ctx.summary
    if s is None or s.device_events == 0:
        return None
    return s.device_events / s.units
