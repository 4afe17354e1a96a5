"""Milliseconds per ``-c`` search that read sidecars, norms and features:
the program's ``c.meta`` and ``c.read`` spans (on the search's own
thread) over the traced searches, divided by their count."""

#: the program's root spans, one per unit
ROOTS = ("c.search",)


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
    found = [spans[n]["total_s"] for n in ("c.meta", "c.read") if n in spans]
    if not found:
        return None
    return 1e3 * sum(found) / units
