"""Milliseconds per ``-f`` pass in the front-end (each group's batched
extraction and its fetch to the host): the program's ``f.frontend`` spans
over the traced passes, divided by their count."""

#: the program's root spans, one per unit
ROOTS = ("f.pass",)


def read(ctx):
    # the recorder is on while the traced stretch is profiled, and at DEBUG
    # too, when it holds the whole run: its totals are read only where its
    # root spans number the stretch's units; a program without the
    # recorder, or without these spans, reads nothing
    from strugatzki_tpu_torch.runtime import logging as recorder

    snapshot = getattr(recorder, "snapshot", None)
    if ctx.summary is None or snapshot is None:
        return None
    snap = snapshot()
    spans, units = snap["spans"], ctx.summary.units
    if sum(spans[r]["count"] for r in ROOTS if r in spans) != units:
        return None
    span = spans.get("f.frontend")
    if span is None:
        return None
    return 1e3 * span["total_s"] / units
