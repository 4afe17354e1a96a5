"""``BENCHMARK.json`` against the benchmark's format, the entry point's
refusals, the import check, and discovery of new parts by name."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.BASE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_its_format():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(harness.BASE, "workloads",
                                           f"{w['traffic']}.json"))
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in names
            names.add(m["name"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", [])) <= set(cells)
            assert os.path.isfile(os.path.join(harness.BASE, "metrics",
                                               f"{m['name']}.py"))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        # every cell a per-layer metric lists reports what it moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    # a quarter of the cells, rounded down, may ask for four cards; one
    # always may
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for cell in cells:
        reported = [m for m in b["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_has_a_tiny_stand_in():
    """Each cell's configuration and traffic mix hold a ``tiny`` group, from
    which the CPU tests build its stand-in."""
    from portbench.tests import tiny

    assert not tiny.MISSING, f"no tiny group in the files of {tiny.MISSING}"
    assert sorted(tiny.CELLS) == sorted(w["name"] for w in bench()["workloads"])


def test_the_result_line_has_the_keys():
    ctx = harness.Ctx("c", {}, {}, 1, 1.0, True, "cpu", platform="gpu",
                      card="NVIDIA H100 80GB HBM3", peak_bytes=5,
                      units=[(0.0, 1.0, True)])
    line = harness.result_line(ctx, {"m": {"value": 1.0, "unit": "ms"}},
                               [("sim_err", 1e-7, 1e-5)])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["device"]["memory_peak_bytes"] == 5
    assert line["device"]["count"] == 1
    bad = harness.result_line(ctx, {}, [("sim_err", float("nan"), 1e-5)])
    assert not bad["correct"] and bad["checks"]["sim_err"]["value"] == "nan"
    json.dumps(bad, allow_nan=False)


def _run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=300)


@pytest.mark.parametrize("chips", [1, 4])
def test_the_peak_is_the_fullest_cards_and_the_count_the_cells(
        monkeypatch, chips):
    """``memory_peak_bytes`` (and so ``peak_device_gb``) reads the fullest
    of the cell's cards, each reset before set-up; ``device.count`` is the
    cell's cards."""
    import torch

    peaks = {"cuda": 3 * 10**9} if chips == 1 else {
        f"cuda:{i}": gb * 10**9 for i, gb in enumerate([2, 5, 3, 4])}
    reset = []
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[d])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset.append)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    monkeypatch.setattr(harness, "_device_info",
                        lambda d: ("gpu", "NVIDIA H100 80GB HBM3"))
    b = bench()
    b["workloads"] = [{"name": "one", "config": "c", "traffic": "t",
                       "chips": chips, "why": "test"}]
    b["end_to_end"] = [m for m in b["end_to_end"]
                       if m["name"] == "peak_device_gb"]
    b["per_layer"] = []

    seen = []

    class Driver:
        def setup(ctx):
            seen.append(ctx)
            return types.SimpleNamespace()
        unit = facts = release = close = staticmethod(lambda *a: {})
        check = staticmethod(lambda *a: [])

    def parts(bench, name, base):
        cell = bench["workloads"][0]
        return cell, {}, {"span": "request"}, Driver, {
            "peak_device_gb": ("end_to_end", b["end_to_end"][0],
                               harness._module(os.path.join(
                                   harness.BASE, "metrics",
                                   "peak_device_gb.py"), "peak_reader"))}
    monkeypatch.setattr(harness, "load_parts", parts)
    line, _ = harness.run_cell(b, "one", 1, 0.0, False, "cuda", 0.0)
    assert seen[0].devices == tuple(peaks) and seen[0].chips == chips
    assert reset == list(peaks)
    assert line["device"]["count"] == chips
    assert line["device"]["memory_peak_bytes"] == max(peaks.values())
    assert line["metrics"]["peak_device_gb"]["value"] == \
        max(peaks.values()) / 1e9
    if chips == 4:
        # a test's repeated device is one card, reset and read once
        reset.clear()
        line, _ = harness.run_cell(b, "one", 1, 0.0, False, "cuda", 0.0,
                                   devices=["cuda:0"] * 4)
        assert reset == ["cuda:0"] and line["device"]["count"] == 4
        assert line["device"]["memory_peak_bytes"] == 2 * 10**9


def test_run_refuses_without_a_card():
    r = _run(ROOT, "--workload", "serve10k.punch", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BASE, tmp_path / "portbench")
    r = _run(tmp_path, "--workload", "serve10k.punch", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout.strip() == ""


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(harness.BASE):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            for mod in _imports(path):
                top = mod.split(".")[0]
                assert top not in harness.BANNED, (path, mod)
                if os.sep + "reference" + os.sep in path:
                    assert top != "strugatzki_tpu_torch", (path, mod)


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "strugatzki_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibx", sys)
    assert "strugatzki_tpu" not in harness.banned_modules()
    assert "jaxlib" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "strugatzki_tpu.kernels", sys)
    assert "strugatzki_tpu" in harness.banned_modules()


def test_new_parts_are_found_by_name(tmp_path):
    """A throwaway configuration, traffic mix and metric, added as new files
    in a copy, are found and run with no edit of any existing file."""
    from portbench.tests import tiny

    base, b, names = tiny.make(str(tmp_path))
    before = {p: open(os.path.join(base, p), "rb").read()
              for p in ("harness.py", "traffic/database.py",
                        "configs/serve10k.json")}
    cfg = json.load(open(os.path.join(base, "configs",
                                      "tiny_serve10k.json")))
    cfg["files"] = 20
    json.dump(cfg, open(os.path.join(base, "configs", "throwaway.json"), "w"))
    mix = json.load(open(os.path.join(base, "workloads", "tiny_query.json")))
    mix["k"] = 2
    json.dump(mix, open(os.path.join(base, "workloads", "k2.json"), "w"))
    with open(os.path.join(base, "metrics", "units_done.py"), "w") as f:
        f.write("def read(ctx):\n    return sum(u[2] for u in ctx.units)\n")
    b["configs"].append({"name": "throwaway", "source": "test",
                         "file": "portbench/configs/throwaway.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "throwaway.k2", "config": "throwaway",
                           "traffic": "k2", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "units_done", "unit": "units",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["throwaway.k2"]})
    line, _ = tiny.run(base, b, "throwaway.k2")
    assert line["correct"] and line["metrics"]["units_done"]["value"] >= 1
    assert "units_done" not in tiny.run(base, b, names["serve10k.query"])[0][
        "metrics"]
    for p, data in before.items():
        assert open(os.path.join(base, p), "rb").read() == data
