"""Whole runs of every cell at a tiny size on the CPU (the harness's look
for a card skipped), sound and with the timed path broken underneath."""

import copy

import numpy as np
import pytest

from portbench.tests import tiny


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_sound_run_is_correct(setup, cell, trace):
    base, bench, names = setup
    line, checks = tiny.run(base, bench, names[cell], trace=trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e = {m["name"] for m in bench["end_to_end"]
           if names[cell] in m.get("workloads", [names[cell]])}
    if trace:
        assert "breakdown" in line
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        # the CPU has no device peak: peak_device_gb is left out
        assert set(line["metrics"]) == e2e - {"peak_device_gb"}
    assert list(line)[-1] == "checks"


def _alter(monkeypatch, cls, name, change):
    real = getattr(cls, name)

    def broken(self, *a, **kw):
        return change(real(self, *a, **kw))
    monkeypatch.setattr(cls, name, broken)


def _half_left_out(res):
    half = res.sims.shape[0] // 2
    res.sims = res.sims.copy()
    res.sims[half:] = -np.inf
    return res


def _frame_moved(res):
    res.frames = res.frames.copy()
    res.frames[3, 1] += 1
    return res


def _sim_altered(res):
    res.sims = res.sims.copy()
    res.sims[5, 0] += 1e-3
    return res


@pytest.mark.parametrize("fault", [_half_left_out, _frame_moved,
                                   _sim_altered])
@pytest.mark.parametrize("cell,call", [("serve10k.punch", "query_punch"),
                                       ("serve10k.query", "query")])
def test_a_broken_serving_path_is_not_correct(setup, monkeypatch, cell, call,
                                              fault):
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    base, bench, names = setup
    _alter(monkeypatch, FeatureDatabase, call, fault)
    line, _ = tiny.run(base, bench, names[cell])
    assert not line["correct"], line["checks"]


def _shard_left_out(res):
    """The second of four shards' rows never gathered."""
    n = res.sims.shape[0] // 4
    res.sims = res.sims.copy()
    res.sims[n:2 * n] = -np.inf
    return res


def _on_four(bench, names, cell):
    """``bench`` with the stand-in of ``cell`` also on four shards, under
    the same metrics; returns the spec and that cell's name."""
    x4 = names[cell] + ".x4"
    b = copy.deepcopy(bench)
    w = next(w for w in b["workloads"] if w["name"] == names[cell])
    b["workloads"].append(dict(w, name=x4, chips=4))
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            if names[cell] in m.get("workloads", []):
                m["workloads"].append(x4)
    return b, x4


@pytest.fixture
def meshes(monkeypatch):
    """The mesh each ``FeatureDatabase`` of the test is staged over."""
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    seen, real = [], FeatureDatabase.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("mesh"))
        real(self, *a, **kw)
    monkeypatch.setattr(FeatureDatabase, "__init__", spy)
    return seen


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["serve10k.punch", "serve10k.query"])
def test_a_sound_run_on_four_shards_is_correct(setup, meshes, cell, trace):
    """A serving cell on four cards stages its database over a files mesh
    of four shards (four ``cpu`` devices here) and is correct."""
    base, bench, names = setup
    b, x4 = _on_four(bench, names, cell)
    line, _ = tiny.run(base, b, x4, trace=trace)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4 and line["failed"] == 0
    assert [m.size for m in meshes] == [4]
    assert [str(d) for d in meshes[0].devices] == ["cpu"] * 4
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    # the same cell on one card takes no mesh
    tiny.run(base, bench, names[cell])
    assert meshes[1:] == [None]


@pytest.mark.parametrize("fault", [_half_left_out, _frame_moved,
                                   _sim_altered, _shard_left_out])
@pytest.mark.parametrize("cell,call", [("serve10k.punch", "query_punch"),
                                       ("serve10k.query", "query")])
def test_a_broken_serving_path_on_four_shards_is_not_correct(
        setup, monkeypatch, cell, call, fault):
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    base, bench, names = setup
    b, x4 = _on_four(bench, names, cell)
    _alter(monkeypatch, FeatureDatabase, call, fault)
    line, _ = tiny.run(base, b, x4)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("stage", [
    lambda norm: np.tile(np.float32([0.0, 1.0]), (len(norm), 1)),
    lambda norm: np.ascontiguousarray(norm[:, ::-1])],
    ids=["norms_ignored", "min_max_swapped"])
@pytest.mark.parametrize("cell", ["serve10k.punch", "serve10k.query"])
def test_a_serving_path_that_misreads_the_norms_is_not_correct(
        setup, monkeypatch, cell, stage):
    """Staging that ignores the norm rows, or swaps min and max, while the
    templates are normalised as they should be."""
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    real = FeatureDatabase.__init__

    def broken(self, entries, norm, *a, **kw):
        real(self, entries, stage(np.asarray(norm)), *a, **kw)
    monkeypatch.setattr(FeatureDatabase, "__init__", broken)
    base, bench, names = setup
    line, _ = tiny.run(base, bench, names[cell])
    assert not line["correct"], line["checks"]


def test_a_broken_front_end_is_not_correct(setup, monkeypatch):
    from strugatzki_tpu_torch.dsp import frontend

    real = frontend._block_pipeline

    def broken(*a, **kw):
        feats, carry = real(*a, **kw)
        feats = feats.clone()
        feats[..., 3, :] += 1e-3
        return feats, carry
    monkeypatch.setattr(frontend, "_block_pipeline", broken)
    base, bench, names = setup
    line, _ = tiny.run(base, bench, names["slice20.extract"])
    assert not line["correct"], line["checks"]


def test_a_broken_search_is_not_correct(setup, monkeypatch):
    import dataclasses

    from strugatzki_tpu_torch.analysis import correlation

    real = correlation.correlate_database

    def broken(*a, **kw):
        matches = real(*a, **kw)
        m = matches[-1]
        matches[-1] = dataclasses.replace(m, sim=m.sim + 1e-3)
        return matches
    monkeypatch.setattr(correlation, "correlate_database", broken)
    base, bench, names = setup
    line, _ = tiny.run(base, bench, names["slice20.correlate"])
    assert not line["correct"], line["checks"]
