"""Set-up seconds: process start to the first timed unit (imports, CUDA,
data from the seed, staging or folder writing, warm-up)."""


def read(ctx):
    return ctx.setup_s
