"""The prep kernel's share of its memory roofline per ``-c`` search, in %:
the valid frames of the searched files read once and written once (2 × 4
bytes × channels × Σ frames, from the generated files' lengths) at the
memory rate of the cell's cards together, over the device time of the
``prep_long`` kernels per search (a card's on average)."""

from portbench.roofline import share_pct


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    kernel_s = s.kernel_seconds("prep_long") / s.units
    if kernel_s <= 0:
        return None
    moved = 2 * 4 * ctx.facts["channels"] * ctx.facts["searched_frames"]
    return share_pct(ctx, moved, kernel_s)
