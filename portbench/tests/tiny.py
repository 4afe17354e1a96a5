"""Tiny copies of the benchmark's cells, for runs on the CPU: the same
drivers, references and metric readers, at sizes a test can hold."""

from __future__ import annotations

import copy
import json
import os
import shutil

from portbench import harness

#: each benchmark cell → its tiny stand-in (configuration, traffic)
CELLS = {"serve10k.punch": ("tiny_db", "tiny_punch"),
         "serve10k.query": ("tiny_db", "tiny_query"),
         "slice20.extract": ("tiny_folder", "tiny_extract"),
         "slice20.correlate": ("tiny_folder", "tiny_correlate")}


def _load(base, *parts):
    with open(os.path.join(base, *parts)) as f:
        return json.load(f)


def _dump(base, obj, *parts):
    with open(os.path.join(base, *parts), "w") as f:
        json.dump(obj, f)


def make(tmp: str):
    """A copy of ``portbench/`` under ``tmp`` holding tiny configurations
    and mixes beside the real ones, and a benchmark spec whose cells are
    the tiny ones under the real cells' metrics.  Returns ``(base,
    bench, names)`` with ``names`` mapping real cell → tiny cell name."""
    base = os.path.join(tmp, "portbench")
    shutil.copytree(harness.BASE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    db = _load(base, "configs", "serve10k.json")
    db.update(files=40, frames=3000)
    _dump(base, db, "configs", "tiny_db.json")
    folder = _load(base, "configs", "slice20.json")
    # long enough for the real search's 10 s punch-in, 5 s punch-out and
    # 12-20 s punches, whose limits hold at this size too
    folder.update(files=3, seconds=40, planted={
        "in_s": [5.0, 15.0], "out_s": [25.0, 30.0], "shift_in": 400,
        "shift_out": 200, "margin": 1024})
    _dump(base, folder, "configs", "tiny_folder.json")
    for name in ("punch", "query"):
        mix = _load(base, "workloads", f"{name}.json")
        mix.update(in_frames=100, out_frames=50, min_punch=120, max_punch=180,
                   pool=64, warmup=1, sample=2, reference_block=16,
                   profile_units=2)
        _dump(base, mix, "workloads", f"tiny_{name}.json")
    mix = _load(base, "workloads", "correlate.json")
    mix.update(num_matches=3, pool=16, profile_units=2)
    _dump(base, mix, "workloads", "tiny_correlate.json")
    mix = _load(base, "workloads", "extract.json")
    mix.update(profile_units=1)
    _dump(base, mix, "workloads", "tiny_extract.json")

    bench = copy.deepcopy(_load(os.path.dirname(harness.BASE),
                                "BENCHMARK.json"))
    names = {real: f"{c}.{t}" for real, (c, t) in CELLS.items()}
    bench["workloads"] = [
        {"name": names[w["name"]], "config": CELLS[w["name"]][0],
         "traffic": CELLS[w["name"]][1], "chips": 1, "why": w["why"]}
        for w in bench["workloads"]]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"] = [names[w] for w in m["workloads"]]
    return base, bench, names


def run(base, bench, cell, seed=2**31 + 7, seconds=0.3, trace=False,
        variant=None):
    import time
    return harness.run_cell(bench, cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), variant=variant, base=base)
