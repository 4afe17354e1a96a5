"""The port's span and counter recorder (``runtime/logging.py``) on the
CPU: off it records nothing and enters no ``record_function``; under
``torch.profiler`` (or the logger at DEBUG) the layer boundaries of ``-f``,
``-c``, ``query``, ``query_punch`` and the streamed ``-x`` render record
their spans and counters, with parents that form one tree per unit, the
``-c`` search's thread inheriting its caller's span, self times exact on a
synthetic clock, and ``db.files_steps`` equal to the steps the
step budget implies; ``STRUGATZKI_PROFILE`` makes the CLI write a
trace that holds every thread's spans."""

import contextvars
import glob
import json
import logging
import math
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strugatzki_tpu_torch import CorrelationConfig, Punch, Span
from strugatzki_tpu_torch.analysis import self_similarity as PS
from strugatzki_tpu_torch.analysis.correlation import FeatureCorrelation
from strugatzki_tpu_torch.analysis.correlation import InputTemplate
from strugatzki_tpu_torch.cli import main as port_main
from strugatzki_tpu_torch.io import AIFF, AudioFileSpec, SampleFormat
from strugatzki_tpu_torch.io import audiofile as af
from strugatzki_tpu_torch.kernels import corr as K
from strugatzki_tpu_torch.parallel import database as PD
from strugatzki_tpu_torch.runtime import logging as L

SR = 44100
SECONDS = 3


@pytest.fixture(autouse=True)
def quiet_recorder():
    """Each test starts with an empty recorder and the logger above
    DEBUG, and leaves the logger's level as it found it."""
    old = L.logger.level
    L.logger.setLevel(logging.WARNING)
    L.reset()
    yield
    L.logger.setLevel(old)
    L.reset()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Five 3 s PCM16 recordings (``tgt`` holds ``src``'s punches) through
    the port's ``-f`` and ``--stats`` on the CPU."""
    root = tmp_path_factory.mktemp("tracing")
    snd, db = root / "snd", root / "db"
    snd.mkdir()
    db.mkdir()
    rng = np.random.default_rng(5)
    n = SECONDS * SR
    src = (0.2 * rng.standard_normal(n)).astype(np.float32)
    sounds = {"src": src, "tgt": src[::-1].copy()}
    sounds["tgt"][SR // 2:SR] = src[SR // 2:SR]
    for k in range(3):
        sounds[f"other{k}"] = (rng.uniform(0.05, 0.3)
                               * rng.standard_normal(n)).astype(np.float32)
    for name, x in sounds.items():
        af.write(snd / f"{name}.aif", x[None],
                 AudioFileSpec(AIFF, SampleFormat.INT16, 1, float(SR)))
    assert port_main(["-f", "-d", str(db), "--device", "cpu", str(snd)]) == 0
    assert port_main(["--stats", "-d", str(db)]) == 0
    return SimpleNamespace(root=root, snd=snd, db=db, files=len(sounds))


def _corr_config(db):
    def fr(s):
        return int(s * SR + 0.5)
    return CorrelationConfig(
        database_folder=str(db), meta_input=str(db / "src_feat.xml"),
        punch_in=Punch(Span(fr(0.5), fr(1.0)), 0.5),
        punch_out=Punch(Span(fr(1.5), fr(2.0)), 0.5),
        min_punch=fr(0.6), max_punch=fr(1.2), num_matches=3)


def _entries(n=12, C=14, T=150, grow=13, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"file{i}.aif", np.abs(
        rng.uniform(0.3, 0.7, (C, 1))
        + 0.1 * rng.standard_normal((C, T + grow * i))).astype(np.float32))
        for i in range(n)]


def _norm(entries):
    allf = np.concatenate([f for _, f in entries], axis=1)
    return np.stack([allf.min(axis=1) - 1e-3, allf.max(axis=1) + 1e-3],
                    axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def database():
    entries = _entries()
    norm = _norm(entries)
    return (PD.FeatureDatabase(entries, norm, device="cpu",
                               cache_spectra=True), entries, norm)


def _unit(kind, folder, database, capsys, tmp_path, monkeypatch):
    """A function that runs one unit of ``kind`` on the CPU."""
    if kind == "f":
        out = [0]

        def run():
            out[0] += 1
            d = tmp_path / f"f{out[0]}"
            d.mkdir()
            assert port_main(["-f", "-d", str(d), "--device", "cpu",
                              str(folder.snd)]) == 0
            capsys.readouterr()
        return run
    if kind == "c":
        monkeypatch.setattr(FeatureCorrelation, "device", "cpu")
        cfg = _corr_config(folder.db)
        return lambda: FeatureCorrelation.run(cfg).result()
    db, entries, norm = database
    x = entries[5][1]
    if kind == "query":
        return lambda: db.query(InputTemplate.from_features(x, norm, 40, 90),
                                k=2)
    return lambda: db.query_punch(
        InputTemplate.from_features(x, norm, 40, 70),
        InputTemplate.from_features(x, norm, 110, 130), 60, 80, k=2)


#: each unit's spans and counters (``corr.template``: the templates)
EXPECTED = {
    "f": ({"f.pass", "f.read", "f.frontend", "f.write"}, {}),
    "c": ({"c.search", "c.meta", "c.read", "c.device", "c.correlate",
           "corr.template"}, {}),
    "query": ({"db.query", "db.steps", "db.gather", "corr.template"},
              {"db.files_steps": 1}),
    "punch": ({"db.punch", "db.steps", "db.gather", "corr.template"},
              {"db.files_steps": 1}),
}
KINDS = sorted(EXPECTED)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


@pytest.mark.parametrize("kind", KINDS)
def test_off_the_recorder_records_nothing(kind, folder, database, capsys,
                                          tmp_path, monkeypatch):
    """No profiler and the logger above DEBUG: no span, no counter, and
    ``record_function`` is never entered."""
    run = _unit(kind, folder, database, capsys, tmp_path, monkeypatch)

    def refused(*a, **kw):
        raise AssertionError("record_function entered with tracing off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    run()
    with L.trace("outside"):
        L.count("outside")
    assert L.snapshot() == {"spans": {}, "counters": {}}
    assert L.records() == []


@pytest.mark.parametrize("kind", KINDS)
def test_under_the_profiler_the_layer_spans_appear(kind, folder, database,
                                                   capsys, tmp_path,
                                                   monkeypatch):
    run = _unit(kind, folder, database, capsys, tmp_path, monkeypatch)
    _profiled(run)
    names, counters = EXPECTED[kind]
    snap = L.snapshot()
    assert set(snap["spans"]) == names
    assert snap["counters"] == counters
    for s in snap["spans"].values():
        assert s["count"] >= 1
        assert 0 <= s["self_s"] <= s["total_s"] + 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_parents_form_one_tree_per_unit(kind, folder, database, capsys,
                                        tmp_path, monkeypatch):
    """Three units, each under a caller's span: every record names its
    unit's root as the request, its parent is a span of that request that
    encloses it in time, and each request has the one root."""
    run = _unit(kind, folder, database, capsys, tmp_path, monkeypatch)

    def three():
        for _ in range(3):
            with L.trace("unit"):
                run()
    _profiled(three)
    recs = L.records()
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["unit"] * 3
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.start <= r.end
        if r.parent:
            p = by_id[r.parent]
            assert r.request == p.request
            assert p.start <= r.start and r.end <= p.end
        else:
            assert r.request == r.id
    assert {r.request for r in recs} == {r.id for r in roots}
    assert len(recs) == len(by_id)


def test_the_search_thread_carries_the_callers_request(folder, database,
                                                       capsys, tmp_path,
                                                       monkeypatch):
    run = _unit("c", folder, database, capsys, tmp_path, monkeypatch)

    def called():
        with L.trace("caller"):
            run()
    _profiled(called)
    recs = L.records()
    caller = next(r for r in recs if r.name == "caller")
    search = next(r for r in recs if r.name == "c.search")
    assert search.parent == caller.id
    assert search.thread != caller.thread == threading.get_ident()
    inside = [r for r in recs if r.name != "caller"]
    assert inside and all(r.request == caller.id for r in inside)
    assert all(r.thread == search.thread for r in inside)


@pytest.mark.parametrize("kind", ["f", "query", "punch"])
def test_spans_are_user_annotations_in_the_chrome_trace(
        kind, folder, database, capsys, tmp_path, monkeypatch):
    run = _unit(kind, folder, database, capsys, tmp_path, monkeypatch)
    prof = _profiled(run)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"] for e in events
           if e.get("cat") == "user_annotation"
           and e.get("name", "").startswith(L.PREFIX)}
    assert got == {L.PREFIX + n for n in EXPECTED[kind][0]}
    assert not any(e.get("name", "").startswith("portbench.")
                   for e in events)


class _Clock:
    t = 0.0

    def perf_counter(self):
        return self.t


def _play(intervals, monkeypatch):
    """Open and close spans ``(name, thread, start, end)`` on a synthetic
    clock; each thread label other than ``main`` runs in its own copy of
    the main context, taken when it first opens a span."""
    clock = _Clock()
    monkeypatch.setattr(L, "time", clock)
    L.logger.setLevel(logging.DEBUG)
    ctxs = {"main": contextvars.copy_context()}
    events = sorted([(t0, 1, n, th) for n, th, t0, _ in intervals]
                    + [(t1, 0, n, th) for n, th, _, t1 in intervals])
    spans = {}
    for t, enter, name, th in events:
        clock.t = t
        ctx = ctxs.get(th)
        if ctx is None:
            ctx = ctxs[th] = ctxs["main"].copy()
        if enter:
            spans[name] = L.trace(name)
            ctx.run(spans[name].__enter__)
        else:
            ctx.run(spans[name].__exit__, None, None, None)
    return L.snapshot()["spans"]


@pytest.mark.parametrize("intervals,self_s", [
    ([("p", "main", 0, 10)], {"p": 10}),
    ([("p", "main", 0, 10), ("a", "main", 2, 8), ("g", "main", 3, 5)],
     {"p": 4, "a": 4, "g": 2}),
    ([("p", "main", 0, 10), ("a", "main", 1, 3), ("b", "main", 5, 9)],
     {"p": 4, "a": 2, "b": 4}),
    ([("p", "main", 0, 10), ("a", "t1", 1, 4), ("b", "t2", 3, 6),
      ("g", "t1", 1.5, 2)], {"p": 5, "a": 2.5, "b": 3, "g": 0.5}),
    ([("p", "main", 0, 10), ("a", "t1", 2, 7), ("b", "t2", 2, 7),
      ("c", "t3", 6.5, 9.5)], {"p": 2.5, "a": 5, "b": 5, "c": 3}),
], ids=["alone", "nested", "disjoint", "overlapping", "equal"])
def test_self_time_is_less_the_union_of_the_children(intervals, self_s,
                                                     monkeypatch):
    spans = _play(intervals, monkeypatch)
    for name, th, t0, t1 in intervals:
        assert spans[name]["count"] == 1
        assert spans[name]["total_s"] == t1 - t0
        assert spans[name]["self_s"] == self_s[name], name
    parents = {r.name: r.parent for r in L.records()}
    ids = {r.name: r.id for r in L.records()}
    assert parents["p"] == 0
    for name in self_s:
        if name != "p" and name != "g":
            assert parents[name] == ids["p"]
    if "g" in parents:
        assert parents["g"] == ids["a"]


def _expected_steps(db, lanes):
    """Files steps of one pass over ``db``, from the step budget and the
    bytes a file holds in a step."""
    C, T = db._raw.shape[1], db._raw.shape[2]
    step = max(1, PD._STEP_BYTES // K._step_bytes(
        C, T, lanes, db._spectra_reduced, db._num_temporal))
    return sum(math.ceil((r.stop - r.start) / step)
               for _, r in db._chunks())


@pytest.mark.parametrize("call", ["query", "punch", "query_batch",
                                  "punch_batch"])
@pytest.mark.parametrize("cache", [True, False, "bf16"])
def test_files_steps_are_the_steps_of_files_step(cache, call, monkeypatch):
    """With the step budget cut to about three files of a query lane, a
    pass takes several steps; a batch of two same-shape requests shares
    one pass."""
    entries = _entries()
    norm = _norm(entries)
    db = PD.FeatureDatabase(entries, norm, device="cpu",
                            cache_spectra=cache)
    bins = K._fft_len(db._raw.shape[2]) // 2 + 1
    monkeypatch.setattr(PD, "_STEP_BYTES", 3 * 8 * bins * (2 * 14 + 8))
    lanes = 2 if "punch" in call else 1
    want = _expected_steps(db, lanes)
    assert want > 1
    _profiled(_db_calls(db, entries, norm)[call])
    assert L.snapshot()["counters"]["db.files_steps"] == want


def _db_calls(db, entries, norm):
    """Each public request of ``db`` as a function, its templates built."""
    x = entries[5][1]

    def tmpl(a, b):
        return InputTemplate.from_features(x, norm, a, b)
    query, other = tmpl(40, 90), tmpl(10, 60)
    pair = (tmpl(40, 70), tmpl(110, 130), 60, 80)
    return {
        "query": lambda: db.query(query, k=2),
        "punch": lambda: db.query_punch(*pair, k=2),
        "query_batch": lambda: db.query_batch([query, other], k=2),
        "punch_batch": lambda: db.query_punch_batch([pair, pair], k=2),
    }


#: each public request's root span
ROOTS = {"query": "db.query", "punch": "db.punch",
         "query_batch": "db.query_batch", "punch_batch": "db.punch_batch"}


@pytest.mark.parametrize("call", sorted(ROOTS))
@pytest.mark.parametrize("cache", [True, "bf16"])
def test_a_request_records_one_root(cache, call):
    """A public request records its own root span once and no request span
    inside it (the benchmark counts ``db.query`` + ``db.punch`` roots as
    its units), with the complex64 cache and with the compact one, whose
    exact re-rank nests ``db.rerank``."""
    entries = _entries()
    norm = _norm(entries)
    db = PD.FeatureDatabase(entries, norm, device="cpu", cache_spectra=cache)
    run = _db_calls(db, entries, norm)[call]
    _profiled(run)
    recs = L.records()
    assert [r.name for r in recs if r.parent == 0] == [ROOTS[call]]
    assert [r.name for r in recs if r.name in ROOTS.values()] \
        == [ROOTS[call]]
    assert ("db.rerank" in {r.name for r in recs}) == (cache == "bf16")


def test_the_ring_keeps_the_newest_records(monkeypatch):
    assert L._RECORDER._ring.maxlen == L.RING
    monkeypatch.setattr(L, "_RECORDER", L._Recorder(capacity=16))
    L.logger.setLevel(logging.DEBUG)
    for i in range(100):
        with L.trace(f"s{i % 3}"):
            L.count("n")
    recs = L.records()
    assert len(recs) == 16
    assert [r.id for r in recs] == sorted(r.id for r in recs)
    assert recs[-1].name == "s0"                         # the 100th, i = 99
    snap = L.snapshot()
    assert sum(s["count"] for s in snap["spans"].values()) == 100
    assert snap["counters"] == {"n": 100}


def test_threads_lose_no_count_and_no_span(monkeypatch):
    """More threads than cores, each in a copy of one caller's context,
    counting and opening spans with a short switch interval: the totals
    are exact and every span names the caller's span as its parent."""
    import sys
    monkeypatch.setattr(L.logger, "handlers", [logging.NullHandler()])
    L.logger.setLevel(logging.DEBUG)
    workers, n = 4 * (os.cpu_count() or 1), 200

    def work():
        for _ in range(n):
            with L.trace("w"):
                for _ in range(10):
                    L.count("n")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with L.trace("caller"):
            threads = [threading.Thread(target=contextvars.copy_context().run,
                                        args=(work,))
                       for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = L.snapshot()
    assert snap["counters"] == {"n": workers * n * 10}
    assert snap["spans"]["w"]["count"] == workers * n
    caller = next(r for r in L.records() if r.name == "caller")
    assert all(r.parent == caller.id and r.request == caller.id
               for r in L.records() if r.name == "w")


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("raises", [False, True])
def test_a_traced_call_is_one_span(on, raises, monkeypatch):
    """``traced``: the call's result or error passes through, its name and
    docstring stay; off it enters no ``record_function``, on its whole
    call is one span under the caller's."""
    def refused(*a, **kw):
        raise AssertionError("record_function entered with tracing off")
    if not on:
        monkeypatch.setattr(torch.autograd.profiler, "record_function",
                            refused)
    else:
        monkeypatch.setattr(L.logger, "handlers", [logging.NullHandler()])
        L.logger.setLevel(logging.DEBUG)

    @L.traced("t.call")
    def work(x, *, y=1):
        """Work."""
        with L.trace("t.inner"):
            if raises:
                raise ValueError(x)
            return x + y
    assert (work.__name__, work.__doc__) == ("work", "Work.")
    with L.trace("caller"):
        if raises:
            with pytest.raises(ValueError):
                work(2, y=3)
        else:
            assert work(2, y=3) == 5
    if not on:
        assert L.snapshot() == {"spans": {}, "counters": {}}
        return
    recs = {r.name: r for r in L.records()}
    assert set(recs) == {"caller", "t.call", "t.inner"}
    assert recs["t.call"].parent == recs["caller"].id
    assert recs["t.inner"].parent == recs["t.call"].id


def test_debug_alone_turns_the_recorder_on(monkeypatch):
    records = []

    class H(logging.Handler):
        def emit(self, r):
            records.append(r.getMessage())
    h = H()
    L.logger.addHandler(h)
    try:
        with L.trace("off"):
            pass
        L.logger.setLevel(logging.DEBUG)
        with L.trace("on", file="x.aif"):
            L.count("on", 3)
    finally:
        L.logger.removeHandler(h)
    assert set(L.snapshot()["spans"]) == {"on"}
    assert L.snapshot()["counters"] == {"on": 3}
    assert len(records) == 1 and records[0].startswith("on took ")
    assert records[0].endswith("file=x.aif")


@pytest.mark.parametrize("switch,names", [
    ("-c", {"c.search", "c.meta", "c.read", "c.device", "c.correlate",
            "corr.template"}),
    ("-f", {"f.pass", "f.read", "f.frontend", "f.write"})])
def test_the_cli_writes_a_trace_of_every_thread(switch, names, folder,
                                                capsys, tmp_path,
                                                monkeypatch):
    """``STRUGATZKI_PROFILE``: each CLI call writes its own trace, and a
    ``-c`` trace holds the spans of the search's thread."""
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv("STRUGATZKI_PROFILE", str(prof_dir))
    if switch == "-c":
        args = ["-c", "-d", str(folder.db), "--in-start", "0.5",
                "--in-stop", "1.0", "--out-start", "1.5", "--out-stop",
                "2.0", "--dur-min", "0.6", "--dur-max", "1.2", "-m", "2",
                "--device", "cpu", str(folder.db / "src_feat.xml")]
        stem = "feature_corr"
    else:
        args = ["-f", "-d", str(tmp_path / "out"), "--device", "cpu",
                str(folder.snd)]
        stem = "feature_pre"
        (tmp_path / "out").mkdir()
    for _ in range(2):
        assert port_main(args) == 0
    capsys.readouterr()
    written = sorted(os.path.basename(p)
                     for p in glob.glob(str(prof_dir / "*.json")))
    assert written == [f"{stem}-1.json", f"{stem}.json"]
    events = json.loads((prof_dir / f"{stem}.json").read_text())[
        "traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(L.PREFIX)]
    assert {e["name"][len(L.PREFIX):] for e in spans} == names
    tids = {e["tid"] for e in spans}
    if switch == "-f":
        assert tids == {threading.get_native_id()}
    else:
        assert threading.get_native_id() not in tids


def _x(seed, c, t):
    rng = np.random.default_rng(seed)
    x = np.abs(0.5 + 0.15 * rng.standard_normal((c, t))).astype(np.float32)
    return K.shift_per_group(x)[0]


@pytest.mark.parametrize("colors,inv", [("psycho", False), ("gray", True)])
def test_the_render_stages_add_up_to_the_render(colors, inv, tmp_path):
    """Three column stripes: ``x.render`` is its own time (the PNG) plus
    the dispatch, fetch and raster stages, each a child of it."""
    x1, x2 = _x(8, 5, 1400), _x(9, 5, 1300)

    def render():
        return PS.self_similarity_to_png(x1, x2, 10, 1, 0.5,
                                         tmp_path / "s.png", colors, 1.0,
                                         1.0, inv, device="cpu")
    _profiled(render)
    spans = L.snapshot()["spans"]
    assert set(spans) == {"x.render", "x.dispatch", "x.fetch", "x.raster"}
    stripes = math.ceil(1281 / PS._BLOCK)
    assert spans["x.render"]["count"] == 1
    assert spans["x.dispatch"]["count"] == spans["x.raster"]["count"] \
        == stripes
    assert spans["x.fetch"]["count"] >= stripes
    stages = sum(spans[n]["total_s"]
                 for n in ("x.dispatch", "x.fetch", "x.raster"))
    total = spans["x.render"]["total_s"]
    assert spans["x.render"]["self_s"] + stages == pytest.approx(total,
                                                                  rel=1e-9)
    assert 0 < spans["x.render"]["self_s"] < total
    render_id = next(r.id for r in L.records() if r.name == "x.render")
    assert all(r.parent == render_id for r in L.records()
               if r.name != "x.render")
