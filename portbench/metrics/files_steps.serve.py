"""Files steps per request: the program's ``db.files_steps`` counter over
the traced requests, divided by their count; set by the database's shape,
the same in every run."""

#: the program's root spans, one per unit
ROOTS = ("db.query", "db.punch")


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
    steps = snap["counters"].get("db.files_steps")
    if steps is None:
        return None
    return steps / units
