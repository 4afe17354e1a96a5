"""Tiny copies of the benchmark's cells, for runs on the CPU: the same
drivers, references and metric readers, at sizes a test can hold.

Every cell of ``BENCHMARK.json`` gets a stand-in from its own files: the
``tiny`` group of its configuration and of its traffic mix holds the keys
that replace theirs.  A cell whose files lack the group has no stand-in;
``MISSING`` names it, and one test fails for it."""

from __future__ import annotations

import copy
import json
import os
import shutil

from portbench import harness

ROOT = os.path.dirname(harness.BASE)


def _load(base, *parts):
    with open(os.path.join(base, *parts)) as f:
        return json.load(f)


def _dump(base, obj, *parts):
    with open(os.path.join(base, *parts), "w") as f:
        json.dump(obj, f)


def _spec(root: str = ROOT) -> dict:
    return _load(root, "BENCHMARK.json")


def stand_in(cell: dict) -> str:
    """The tiny stand-in's name of a real cell."""
    return "tiny_" + cell["name"]


def _has_tiny(base: str, cell: dict) -> bool:
    return ("tiny" in _load(base, "configs", f"{cell['config']}.json")
            and "tiny" in _load(base, "workloads", f"{cell['traffic']}.json"))


def _cells(root: str = ROOT):
    """``({real cell: stand-in}, [cells whose files lack a tiny group])``."""
    base = os.path.join(root, "portbench")
    have, missing = {}, []
    for w in _spec(root)["workloads"]:
        if _has_tiny(base, w):
            have[w["name"]] = stand_in(w)
        else:
            missing.append(w["name"])
    return have, missing


#: each benchmark cell with a tiny stand-in → the stand-in's name
CELLS, MISSING = _cells()


def make(tmp: str, root: str = ROOT):
    """A copy of ``portbench/`` under ``tmp`` holding the tiny
    configurations and mixes (``tiny_<name>.json``) beside the real ones,
    and a benchmark spec whose cells are the stand-ins, each on the real
    cell's chips and under the real cell's metrics.  Returns ``(base,
    bench, names)`` with ``names`` mapping real cell → stand-in."""
    base = os.path.join(tmp, "portbench")
    shutil.copytree(os.path.join(root, "portbench"), base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = copy.deepcopy(_spec(root))
    cells = [w for w in bench["workloads"] if _has_tiny(base, w)]
    for kind, key in (("configs", "config"), ("workloads", "traffic")):
        for name in {w[key] for w in cells}:
            part = _load(base, kind, f"{name}.json")
            part.update(part.pop("tiny"))
            _dump(base, part, kind, f"tiny_{name}.json")
    names = {w["name"]: stand_in(w) for w in cells}
    bench["workloads"] = [
        dict(w, name=names[w["name"]], config="tiny_" + w["config"],
             traffic="tiny_" + w["traffic"]) for w in cells]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"] = [names[w] for w in m["workloads"]
                                  if w in names]
    return base, bench, names


def run(base, bench, cell, seed=2**31 + 7, seconds=0.3, trace=False,
        variant=None, devices=None):
    import time
    return harness.run_cell(bench, cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), variant=variant, base=base,
                            devices=devices)
