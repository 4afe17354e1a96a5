"""Seconds of audio extracted per wall second, over every whole pass of
the window (from its start to the end of its last pass)."""


def read(ctx):
    n = sum(1 for u in ctx.units if u[2])
    wall = ctx.window[1] - ctx.window[0]
    if not n or wall <= 0:
        return None
    return n * ctx.facts["audio_s_per_unit"] / wall
