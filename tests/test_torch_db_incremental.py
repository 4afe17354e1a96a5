"""The port's FeatureDatabase beyond one query: incremental add/remove,
all-or-nothing commits, save/load (archives shared with the JAX package),
the staging observer protocol, ``from_folder`` and concurrent queries — on
the CPU.

An updated database must answer exactly like a freshly built one over the
same live entries (match for match, sims to 6 decimals), and like the JAX
package's database after the same updates (``assert_query_equal`` of
tests/test_torch_database.py).
"""

import os
import threading

import numpy as np
import pytest

from strugatzki_tpu.parallel import database as JD
from strugatzki_tpu_torch.analysis.correlation import InputTemplate as PT
from strugatzki_tpu_torch.parallel import database as PD
from strugatzki_tpu_torch.runtime.processor import Aborted, Progress, Result
from test_torch_database import _tmpls, assert_query_equal


def _feats(rng, T=200, C=14):
    return np.abs(0.5 + 0.2 * rng.standard_normal((C, T))).astype(np.float32)


def _entries(seed, n, T=200, C=14):
    rng = np.random.default_rng(seed)
    return [(f"f{seed}_{i}.aif", _feats(rng, T + 7 * i, C))
            for i in range(n)]


def _pdb(entries, **kw):
    return PD.FeatureDatabase(entries, None, device="cpu", **kw)


def _tmpl(entries, i=0, start=20, L=60):
    return PT(entries[i][1][:, start:start + L].copy())


def _match_tuples(res, k=6, punch_len=60, step=512):
    return [(m.file, m.punch.start, round(m.sim, 6), round(m.boost_in, 6))
            for m in res.matches(punch_len, step, k)]


def _assert_equiv(db, fresh_entries, tmpl, **kw):
    fresh = _pdb(fresh_entries, **kw)
    assert _match_tuples(db.query(tmpl, k=3)) == \
        _match_tuples(fresh.query(tmpl, k=3))


@pytest.mark.parametrize("cache_spectra", [False, True])
def test_add_remove_reuse_match_fresh_and_jax(cache_spectra):
    ents = _entries(4, 5)
    kw = dict(cache_spectra=cache_spectra)
    db = _pdb(ents, **kw)
    jdb = JD.FeatureDatabase(ents, None, **kw)
    rows_before = db._xs.shape[0]
    for d in (db, jdb):
        d.remove_files([ents[0][0], ents[2][0]])
    assert db.num_files == 3
    extra = _entries(5, 2, T=120)
    for d in (db, jdb):
        d.add_files(extra)
    assert db._xs.shape[0] == rows_before          # tombstones reused
    assert db.files == jdb.files and db.num_files == 5
    live = [e for i, e in enumerate(ents) if i not in (0, 2)] + extra
    _assert_equiv(db, live, _tmpl(extra, 0), **kw)
    jt, pt = _tmpls(extra[1][1][:, 10:70])
    assert_query_equal(db.query(pt, k=3), jdb.query(jt, k=3))
    # the punch combine reads the updated rows (and spectra cache rows)
    t_in, t_out = _tmpl(extra, 1, 10, 40), _tmpl(extra, 1, 90, 30)
    fresh = _pdb(live, **kw)
    got = db.query_punch(t_in, t_out, min_punch=60, max_punch=100, k=2)
    want = fresh.query_punch(t_in, t_out, min_punch=60, max_punch=100, k=2)
    assert [(m.file, m.punch.start, round(m.sim, 6))
            for m in got.matches(512, 3)] == \
        [(m.file, m.punch.start, round(m.sim, 6))
         for m in want.matches(512, 3)]


def test_remove_tombstones_then_query():
    ents = _entries(3, 5)
    db = _pdb(ents)
    db.remove_files([ents[1][0], ents[3][0]])
    assert db.num_files == 3 and db.files[1] is None
    live = [e for i, e in enumerate(ents) if i not in (1, 3)]
    # the removed file's own template must no longer hit it
    _assert_equiv(db, live, _tmpl(ents, 1))
    assert not np.isfinite(db.query(_tmpl(ents, 1), k=3).sims[[1, 3]]).any()
    with pytest.raises(KeyError):
        db.remove_files([ents[1][0]])


@pytest.mark.parametrize("trigger", ["longer_file", "no_free_slot"])
def test_add_restages(trigger):
    ents = _entries(6, 3, T=100)
    db = _pdb(ents)
    if trigger == "longer_file":
        extra = [("long.aif", _feats(np.random.default_rng(9), T=900))]
    else:
        extra = _entries(8, 4, T=150)
    assert db._raw.shape[0] == 3                   # no padding rows free
    db.add_files(extra)
    assert db.num_files == 3 + len(extra)
    if trigger == "longer_file":
        assert db._raw.shape[2] >= 900
    _assert_equiv(db, ents + extra, _tmpl(extra, 0))


def test_duplicates_rejected():
    ents = _entries(10, 3)
    db = _pdb(ents)
    with pytest.raises(ValueError, match="already in the database"):
        db.add_files([ents[0]])
    new = _entries(11, 1)
    with pytest.raises(ValueError, match="twice in this add batch"):
        db.add_files(new + new)
    assert db.num_files == 3


def test_failure_before_commit_leaves_db_usable(monkeypatch):
    """A device failure in the add batch surfaces at the pre-commit
    synchronization — before anything mutates (the all-or-nothing commit
    contract); simulated by making that synchronization raise, the way a
    deferred CUDA error would.  An abort at the last abort point and an
    aborted restage leave the database untouched as well."""
    ents = _entries(20, 4)
    kw = dict(cache_spectra=True)
    db = _pdb(ents, **kw)
    db.remove_files([ents[3][0]])
    state = (list(db.files), db._lens.copy(), db._raw.copy(),
             db._xs.clone(), db._shifts.clone(),
             tuple(s.clone() for s in db._spectra))

    def unchanged():
        files, lens, raw, xs, shifts, spectra = state
        assert db.files == files
        np.testing.assert_array_equal(db._lens, lens)
        np.testing.assert_array_equal(db._raw, raw)
        assert db._xs.equal(xs) and db._shifts.equal(shifts)
        assert all(a.equal(b) for a, b in zip(db._spectra, spectra))
        _assert_equiv(db, ents[:3], _tmpl(ents, 1), **kw)

    def boom(device):
        raise RuntimeError("simulated deferred device failure")

    monkeypatch.setattr(PD, "_sync", boom)
    with pytest.raises(RuntimeError, match="simulated deferred"):
        db.add_files(_entries(21, 1, T=150))
    monkeypatch.undo()
    unchanged()

    calls = []

    def abort_second():
        calls.append(1)
        if len(calls) == 2:                         # the last abort point
            raise Aborted()

    with pytest.raises(Aborted):
        db.add_files(_entries(22, 1, T=150), check_aborted=abort_second)
    unchanged()

    big = [("big.aif", _feats(np.random.default_rng(9), T=2000))]

    def abort_in_restage():
        calls.append(1)
        if len(calls) > 3:                          # inside the new staging
            raise Aborted()

    with pytest.raises(Aborted):
        db.add_files(big, check_aborted=abort_in_restage)
    unchanged()


def test_save_compacts_tombstones(tmp_path):
    ents = _entries(13, 4)
    db = _pdb(ents)
    db.remove_files([ents[1][0]])
    extra = _entries(14, 1, T=160)
    db.add_files(extra)                            # fills the tombstone
    db.remove_files([ents[2][0]])
    p = tmp_path / "db.npz"
    db.save(p)
    z = np.load(p, allow_pickle=False)
    assert set(z.files) == {"raw", "lens", "norm", "files", "step_size",
                            "num_temporal"}
    assert z["raw"].shape[0] == 3
    db2 = PD.FeatureDatabase.load(p, device="cpu")
    live = [ents[0], extra[0], ents[3]]
    assert db2.files == [n for n, _ in live]
    _assert_equiv(db2, live, _tmpl(extra, 0))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archives_load_in_the_other_package(tmp_path, writer):
    """An archive either package writes loads in the other with the same
    members, the same raw rows and equal query results."""
    ents = _entries(15, 5)
    norm = np.stack([np.zeros(14), np.full(14, 1.5)], 1).astype(np.float32)
    kw = dict(num_temporal=2, step_size=256)
    jdb = JD.FeatureDatabase(ents, norm, **kw)
    pdb = PD.FeatureDatabase(ents, norm, device="cpu", **kw)
    for d in (jdb, pdb):
        d.remove_files([ents[2][0]])
    p = tmp_path / "db.npz"
    (jdb if writer == "jax" else pdb).save(p)
    jl = JD.FeatureDatabase.load(p)
    pl = PD.FeatureDatabase.load(p, device="cpu", cache_spectra=True)
    for d in (jl, pl):
        assert d.files == [n for i, (n, _) in enumerate(ents) if i != 2]
        assert d.step_size == 256 and d._num_temporal == 2
        np.testing.assert_array_equal(d.norm, norm)
    np.testing.assert_array_equal(jl._raw, pl._raw)
    block = ents[3][1][:, 30:80].copy()
    jt, pt = _tmpls(block, norm, nt=2)
    assert_query_equal(pl.query(pt, k=3), jl.query(jt, k=3))
    assert pl.query(pt, k=1).frames[2, 0] == 30


def test_staging_progress_and_abort(monkeypatch):
    """Slab-wise staging reports monotone progress ending at 1.0, with
    fractions per feature slab (< 0.7) and per spectra chunk (≥ 0.7); an
    abort between slabs fails construction cleanly."""
    monkeypatch.setattr(PD, "_QUERY_CHUNK", 3)
    monkeypatch.setattr(PD, "_SPECTRA_CHUNK", 3)
    fracs = []
    db = _pdb(_entries(16, 8), cache_spectra=True, progress=fracs.append)
    assert db.num_files == 8 and fracs[-1] == 1.0
    assert all(b >= a for a, b in zip(fracs, fracs[1:]))
    assert any(0.0 < f < 0.7 for f in fracs)
    assert any(0.7 <= f < 1.0 for f in fracs)
    calls = []

    def check():
        calls.append(1)
        if len(calls) >= 2:
            raise Aborted()

    with pytest.raises(Aborted):
        _pdb(_entries(16, 9), check_aborted=check)
    assert len(calls) == 2


def test_stage_processor_result_and_abort(monkeypatch):
    """``stage`` drives the Processor surface: Progress events then one
    successful Result carrying the database; aborting from the first
    progress event yields an aborted failure."""
    events = []
    ents = _entries(17, 5)
    proc = PD.FeatureDatabase.stage(ents, None, observer=events.append,
                                    device="cpu")
    db = proc.result(timeout=120)
    assert db.num_files == 5
    assert db.query(_tmpl(ents, 2, 20, 40), k=1).frames[2, 0] == 20
    assert any(isinstance(e, Progress) for e in events)
    res = [e for e in events if isinstance(e, Result)]
    assert len(res) == 1 and res[0].is_success

    monkeypatch.setattr(PD, "_QUERY_CHUNK", 2)

    def observer(e):
        if isinstance(e, Progress) and e.fraction < 1.0:
            e.processor.abort()

    proc = PD.FeatureDatabase.stage(_entries(18, 10), None,
                                    observer=observer, device="cpu")
    res = proc.ready(timeout=120)
    assert res.failure is not None and res.is_aborted


def test_save_observer_and_abort_leave_no_torn_file(tmp_path):
    db = _pdb(_entries(19, 3))
    fracs = []
    db.save(tmp_path / "db.npz", progress=fracs.append)
    assert fracs == [0.0, 1.0]
    before = (tmp_path / "db.npz").read_bytes()
    calls = []

    def check():
        calls.append(1)
        if len(calls) == 3:          # top-of-save + two rows, then abort
            raise Aborted()

    with pytest.raises(Aborted):
        db.save(tmp_path / "db.npz", check_aborted=check)
    assert len(calls) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["db.npz"]
    assert (tmp_path / "db.npz").read_bytes() == before


def test_from_folder_over_port_extraction(tmp_path):
    """``-f`` and ``--stats`` through the port's CLI, then ``from_folder``
    in both packages over that folder: the same files and equal query
    results, the planted passage first."""
    from strugatzki_tpu_torch.cli import main
    from strugatzki_tpu_torch.io import AIFF, AudioFileSpec, SampleFormat
    from strugatzki_tpu_torch.io import audiofile as af

    snd, folder = tmp_path / "snd", tmp_path / "db"
    snd.mkdir()
    folder.mkdir()
    rng = np.random.default_rng(0)
    spec = AudioFileSpec(AIFF, SampleFormat.INT16, 1, 44100.0)
    src = (0.2 * rng.standard_normal(66150)).astype(np.float32)
    for name in ("a", "b", "c"):
        x = (0.2 * rng.standard_normal(66150)).astype(np.float32)
        if name == "b":
            x[22050:44100] = src[22050:44100]
        af.write(snd / f"{name}.aif", x[None], spec)
    assert main(["-f", "-d", str(folder), "--device", "cpu", str(snd)]) == 0
    assert main(["--stats", "-d", str(folder)]) == 0
    pdb = PD.FeatureDatabase.from_folder(str(folder), device="cpu")
    jdb = JD.FeatureDatabase.from_folder(str(folder))
    assert pdb.files == jdb.files and pdb.num_files == 3
    np.testing.assert_array_equal(pdb.norm, jdb.norm)
    feats, _ = af.read(os.path.join(folder, "b_feat.aif"))
    block = feats[:, 50:80].copy()
    jt, pt = _tmpls(block, pdb.norm)
    p = pdb.query(pt, k=2)
    assert_query_equal(p, jdb.query(jt, k=2))
    top = p.matches(30, 512, 1)[0]
    assert top.file.endswith("b.aif") and top.punch.start == 50 * 512


def test_concurrent_queries_thread_safe():
    """Serving reads are side-effect-free: many threads querying one
    resident database concurrently get identical results."""
    ents = _entries(30, 6)
    db = _pdb(ents, cache_spectra=True)
    tmpl, t_out = _tmpl(ents, 2), _tmpl(ents, 2, 120, 30)
    want = (_match_tuples(db.query(tmpl, k=3)),
            db.query_punch(tmpl, t_out, 60, 90, k=2).sims.tolist())
    results, errors = [None] * 8, []

    def worker(j):
        try:
            results[j] = (_match_tuples(db.query(tmpl, k=3)),
                          db.query_punch(tmpl, t_out, 60, 90,
                                         k=2).sims.tolist())
        except Exception as e:  # noqa: BLE001 - surface in the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert all(r == want for r in results)
