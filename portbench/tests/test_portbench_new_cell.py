"""A new cell arrives as new files and entries alone.

In a copy of the benchmark, a cell whose configuration and traffic mix are
new files, each with its ``tiny`` group, is added to the spec itself, on
one card and on four: the tiny stand-ins and every test parametrised by
cell take it, and no byte of a file that was there changes.  A cell whose
files lack the group fails one test and leaves the others running."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

from portbench import harness
from portbench.tests import tiny

ROOT = os.path.dirname(harness.BASE)
PROGRAM = "strugatzki_tpu_torch"
CELL = "fresh.query"
#: the tests parametrised by cell → the cases each has for one cell
BY_CELL = {"test_a_sound_run_is_correct": 2,
           "test_a_traced_tiny_run_reports_its_span_metrics": 1,
           "test_the_program_is_correct_and_the_control_is_not": 3}
#: tests that judge the spec as a whole
WHOLE = ("test_benchmark_json_keeps_its_format",
         "test_every_cell_has_a_tiny_stand_in")


def _copy(tmp):
    """The benchmark and a link to the program, as a checkout holds them."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(harness.BASE, os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, PROGRAM), os.path.join(tmp, PROGRAM))


def _digests(base):
    out = {}
    for dirpath, _, files in os.walk(base):
        for name in files:
            path = os.path.join(dirpath, name)
            if "__pycache__" not in path:
                with open(path, "rb") as f:
                    out[os.path.relpath(path, base)] = \
                        hashlib.sha256(f.read()).hexdigest()
    return out


def _add_cell(tmp, chips, with_tiny=True):
    """New configuration and mix files beside the real ones, and the cell's
    entries in the spec, under every metric the real query cell reports."""
    base = os.path.join(tmp, "portbench")
    with open(os.path.join(base, "configs", "serve10k.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(base, "workloads", "query.json")) as f:
        mix = json.load(f)
    cfg.update(files=20_000, about="a library twice the north star's")
    cfg["tiny"] = dict(cfg["tiny"], files=48)
    mix["k"] = 2
    if not with_tiny:
        del cfg["tiny"], mix["tiny"]
    for obj, part in ((cfg, "configs/fresh.json"),
                      (mix, "workloads/fresh_query.json")):
        with open(os.path.join(base, part), "w") as f:
            json.dump(obj, f, indent=1)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "fresh", "source": "test",
                         "file": "portbench/configs/fresh.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": CELL, "config": "fresh",
                           "traffic": "fresh_query", "chips": chips,
                           "why": "test"})
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            if "serve10k.query" in m.get("workloads", []):
                m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(b, f, indent=1)


def _pytest(tmp, junit):
    """The suite in the copy, cut to the new cell's cases and the tests of
    the whole spec → ``{test id: outcome}``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "portbench/tests", "--junitxml", junit, "-k",
         " or ".join(("fresh",) + WHOLE)],
        cwd=tmp, capture_output=True, text=True, env=env, timeout=900)
    out = {}
    for case in ET.parse(junit).getroot().iter("testcase"):
        kinds = {c.tag for c in case}
        out[case.get("name")] = ("failed" if kinds & {"failure", "error"}
                                 else "skipped" if "skipped" in kinds
                                 else "passed")
    return r, out


@pytest.mark.parametrize("chips", [1, 4])
def test_a_new_cell_needs_only_new_files_and_entries(tmp_path, chips):
    tmp = str(tmp_path / "checkout")
    os.mkdir(tmp)
    _copy(tmp)
    before = _digests(os.path.join(tmp, "portbench"))
    _add_cell(tmp, chips)

    # the stand-ins take it, on the cell's cards
    base, bench, names = tiny.make(str(tmp_path / "tiny"), root=tmp)
    w = next(w for w in bench["workloads"] if w["name"] == names[CELL])
    assert w["chips"] == chips and w["config"] == "tiny_fresh"
    with open(os.path.join(base, "configs", "tiny_fresh.json")) as f:
        assert json.load(f)["files"] == 48

    r, cases = _pytest(tmp, str(tmp_path / "junit.xml"))
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    for name in WHOLE:
        assert cases[name] == "passed", name
    for name, n in BY_CELL.items():
        mine = [c for c in cases if c.startswith(name + "[") and CELL in c]
        assert len(mine) == n, (name, sorted(cases))
    # the program's tests skip here without a card; the others pass
    assert all(v == "passed" for c, v in cases.items()
               if not c.startswith("test_the_program_is_correct")), cases

    after = _digests(os.path.join(tmp, "portbench"))
    assert {p: after[p] for p in before} == before
    assert set(after) - set(before) == {"configs/fresh.json",
                                        "workloads/fresh_query.json"}


def test_a_cell_without_tiny_groups_fails_one_test(tmp_path):
    tmp = str(tmp_path / "checkout")
    os.mkdir(tmp)
    _copy(tmp)
    _add_cell(tmp, 1, with_tiny=False)
    r, cases = _pytest(tmp, str(tmp_path / "junit.xml"))
    assert r.returncode != 0
    assert cases == {"test_benchmark_json_keeps_its_format": "passed",
                     "test_every_cell_has_a_tiny_stand_in": "failed"}
