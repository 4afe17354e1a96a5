"""The readers of the program's spans and counters: on synthetic
snapshots of its recorder, against a program that has no recorder, and in
traced tiny runs of every cell on the CPU."""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

from portbench import harness, traces
from portbench.tests import tiny

#: each reader → (its cells, what it reads, the value on ``SNAP``)
READERS = {
    "step_loop_ms.serve": (["serve10k.punch", "serve10k.query"],
                           "self time of db.steps", 1e3 * 0.4 / 4),
    "gather_ms.serve": (["serve10k.punch", "serve10k.query"],
                        "db.gather", 1e3 * 0.2 / 4),
    "files_steps.serve": (["serve10k.punch", "serve10k.query"],
                          "counter db.files_steps", 88 / 4),
    "read_ms.extract": (["slice20.extract"], "f.read", 1e3 * 1.2 / 4),
    "frontend_ms.extract": (["slice20.extract"], "f.frontend",
                            1e3 * 0.6 / 4),
    "write_ms.extract": (["slice20.extract"], "f.write", 1e3 * 0.3 / 4),
    "feature_read_ms.analysis": (["slice20.correlate"], "c.meta + c.read",
                                 1e3 * (0.05 + 0.25) / 4),
    "replay_ms.analysis": (["slice20.correlate"], "self time of c.correlate",
                           1e3 * 0.5 / 4),
}

SNAP = {"spans": {
    "db.punch": {"count": 4, "total_s": 0.8, "self_s": 0.05},
    "f.pass": {"count": 4, "total_s": 2.2, "self_s": 0.1},
    "c.search": {"count": 4, "total_s": 1.0, "self_s": 0.05},
    "db.steps": {"count": 4, "total_s": 0.5, "self_s": 0.4},
    "db.gather": {"count": 4, "total_s": 0.2, "self_s": 0.15},
    "f.read": {"count": 84, "total_s": 1.2, "self_s": 1.2},
    "f.frontend": {"count": 4, "total_s": 0.6, "self_s": 0.6},
    "f.write": {"count": 84, "total_s": 0.3, "self_s": 0.3},
    "c.meta": {"count": 4, "total_s": 0.05, "self_s": 0.05},
    "c.read": {"count": 8, "total_s": 0.25, "self_s": 0.25},
    "c.correlate": {"count": 4, "total_s": 0.9, "self_s": 0.5}},
    "counters": {"db.files_steps": 88}}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "s_" + name.replace(".", "_"),
        os.path.join(harness.BASE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(units=4):
    return SimpleNamespace(summary=traces.Summary(
        units=units, window_s=1.0, busy_s=0.1, device_events=10))


@pytest.fixture
def recorder():
    from strugatzki_tpu_torch.runtime import logging as rec
    return rec


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_divides_the_recorders_totals_by_the_units(
        name, recorder, monkeypatch):
    monkeypatch.setattr(recorder, "snapshot", lambda: SNAP)
    assert reader(name)(_ctx()) == pytest.approx(READERS[name][2])
    # no traced stretch: nothing to divide by
    assert reader(name)(SimpleNamespace(summary=None)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_where_its_span_is_missing(
        name, recorder, monkeypatch):
    monkeypatch.setattr(recorder, "snapshot",
                        lambda: {"spans": {}, "counters": {}})
    assert reader(name)(_ctx()) is None
    # a program whose logging module has no recorder (the one before it)
    monkeypatch.delattr(recorder, "snapshot")
    assert reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_unless_its_roots_number_the_units(
        name, recorder, monkeypatch):
    """At DEBUG the recorder holds the whole run, not only the traced
    stretch: totals whose root spans do not number the stretch's units are
    not divided by them."""
    monkeypatch.setattr(recorder, "snapshot", lambda: SNAP)
    assert reader(name)(_ctx(units=3)) is None
    assert reader(name)(_ctx(units=5)) is None
    # the query's root counts as well as the punch's
    both = {"spans": dict(SNAP["spans"]), "counters": SNAP["counters"]}
    both["spans"]["db.query"] = {"count": 2, "total_s": 0.1, "self_s": 0.0}
    monkeypatch.setattr(recorder, "snapshot", lambda: both)
    serve = name.endswith(".serve")
    assert (reader(name)(_ctx(units=6)) is None) != serve


def test_the_entries_name_the_readers_cells():
    with open(os.path.join(os.path.dirname(harness.BASE),
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, (cells, _, _) in READERS.items():
        m = per_layer[name]
        # a cell added later may join the list
        assert set(cells) <= set(m["workloads"])
        assert m["source"] == "device_trace" and m["better"] == "lower"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("tiny_spans")))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_traced_tiny_run_reports_its_span_metrics(setup, cell, recorder):
    base, bench, names = setup
    recorder.reset()
    line, _ = tiny.run(base, bench, names[cell], trace=True)
    assert line["correct"], line["checks"]
    want = {m["name"] for m in bench["per_layer"]
            if names[cell] in m["workloads"] and m["name"] in READERS}
    assert want <= set(line["metrics"])
    for n in want:
        assert line["metrics"][n]["value"] > 0, n
    if "files_steps.serve" in want:
        # the tiny database takes one files step a request and shard
        chips = line["device"]["count"]
        assert line["metrics"]["files_steps.serve"]["value"] == chips
