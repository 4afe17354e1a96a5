"""torch.cuda.max_memory_allocated() over set-up and window, in GB, of the
fullest of the cell's cards."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
