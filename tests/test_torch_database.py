"""The port's resident FeatureDatabase against the JAX package's, on the CPU.

The same numpy-seeded entries and templates go through both packages'
``FeatureDatabase`` (the port on ``device="cpu"``, where the prep kernel's
plain version runs).  Tolerances: sims 3e-5 (docs/PARITY.md), ``in_sims``
3e-5; boosts rtol 1e-4 where they pass the ``max_boost`` gate (a gated
window's loudness mean is a near-cancellation of the file's shift, so its
huge boost carries the FFT's relative noise; it must stay gated in both);
frames and ``punch_lens`` exactly wherever a candidate is decided — more
than 3e-5 from every other candidate of its file, or exactly tied with it
(gated 0.0, masked −inf, NaN), where the tie order itself is under test.
"""

import numpy as np
import pytest
import torch

import jax

from strugatzki_tpu.analysis.correlation import InputTemplate as JT
from strugatzki_tpu.kernels import mathref as M
from strugatzki_tpu.parallel import database as JD
from strugatzki_tpu_torch.analysis.correlation import InputTemplate as PT
from strugatzki_tpu_torch.parallel import database as PD

SIM_TOL = 3e-5
BOOST_RTOL = 1e-4


def _entries(n=12, C=14, T=150, grow=13, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        base = rng.uniform(0.3, 0.7, size=(C, 1))
        x = np.abs(base + 0.1 * rng.standard_normal((C, T + grow * i)))
        out.append((f"file{i}.aif", x.astype(np.float32)))
    return out


def _norm_of(entries):
    allf = np.concatenate([f for _, f in entries], axis=1)
    return np.stack([allf.min(axis=1) - 1e-3, allf.max(axis=1) + 1e-3],
                    axis=1).astype(np.float32)


def _tmpls(block, norm=None, nt=1):
    """The same normalized block as a JAX and a port template."""
    block = np.asarray(block, np.float32).copy()
    if norm is not None:
        M.normalize(norm, block, 0, block.shape[1])
    return JT(block, num_temporal=nt), PT(block, num_temporal=nt)


def _dbs(entries, norm=None, **kw):
    return (JD.FeatureDatabase(entries, norm, **kw),
            PD.FeatureDatabase(entries, norm, device="cpu", **kw))


def _same(a, b):
    return (a == b) | (np.isnan(a) & np.isnan(b))


def _decided(s, tol=SIM_TOL):
    """Candidates whose rank in their row no sub-tolerance difference can
    change: every other candidate is more than ``tol`` away or exactly
    tied with it."""
    s = np.asarray(s, np.float64)
    a, b = s[:, :, None], s[:, None, :]
    with np.errstate(invalid="ignore"):
        ok = (np.abs(a - b) > tol) | _same(a, b)
    return ok.all(axis=2)


def _assert_sims(got, want, tol=SIM_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=tol)


def _assert_boosts(got, want, where, max_boost=8.0):
    got, want = np.asarray(got)[where], np.asarray(want)[where]
    with np.errstate(invalid="ignore"):
        gated = ~(want <= max_boost)
        np.testing.assert_array_equal(~(got <= max_boost), gated)
    np.testing.assert_allclose(got[~gated], want[~gated], rtol=BOOST_RTOL)


def assert_query_equal(p, j):
    _assert_sims(p.sims, j.sims)
    dec = _decided(j.sims)
    np.testing.assert_array_equal(p.frames[dec], j.frames[dec])
    assert p.frames.dtype == np.int32
    _assert_boosts(p.boosts, j.boosts, np.isfinite(j.sims))
    assert p.files == j.files


def assert_punch_equal(p, j):
    _assert_sims(p.sims, j.sims)
    dec = _decided(j.sims) & np.isfinite(j.sims)
    np.testing.assert_array_equal(p.frames[dec], j.frames[dec])
    np.testing.assert_array_equal(p.punch_lens[dec], j.punch_lens[dec])
    _assert_boosts(p.boosts_in, j.boosts_in, dec)
    _assert_boosts(p.boosts_out, j.boosts_out, dec)
    np.testing.assert_allclose(p.in_sims[dec], j.in_sims[dec], atol=SIM_TOL)
    assert p.files == j.files and p.min_punch == j.min_punch


@pytest.fixture(scope="module")
def entries():
    return _entries()


def _plant_pair(entries):
    """File 5 holds file 3's frames 10:40 at 30 and 100:120 at 110."""
    ents = [(n, f.copy()) for n, f in entries]
    ents[5][1][:, 30:60] = ents[3][1][:, 10:40]
    ents[5][1][:, 110:130] = ents[3][1][:, 100:120]
    return ents


@pytest.mark.parametrize("cache_spectra,nt,with_norm", [
    (False, 1, False), (True, 1, True), (False, 2, True), (True, 2, False)])
def test_query_matches_jax(entries, cache_spectra, nt, with_norm):
    norm = _norm_of(entries) if with_norm else None
    jdb, pdb = _dbs(entries, norm, pad_multiple=64, num_temporal=nt,
                    cache_spectra=cache_spectra)
    jt, pt = _tmpls(entries[5][1][:, 40:90], norm, nt)
    p, j = pdb.query(pt, k=3), jdb.query(jt, k=3)
    assert_query_equal(p, j)
    assert p.frames[5, 0] == 40 and abs(p.sims[5, 0] - 1.0) < 1e-4
    (p2, (ps, pb, pl)), (j2, (js, jb, jl)) = (
        pdb.query(pt, k=3, with_traces=True),
        jdb.query(jt, k=3, with_traces=True))
    assert_query_equal(p2, j2)
    np.testing.assert_array_equal(pl, jl)
    assert ps.shape == js.shape == (12, pdb._xs.shape[2] - 50 + 1)
    for i, n in enumerate(jl):          # each file's valid windows
        w = n - 50 + 1
        _assert_sims(ps[i:i + 1, :w], js[i:i + 1, :w])
        _assert_boosts(pb[i, :w], jb[i, :w], np.isfinite(js[i, :w]))
    assert [(m.file, m.punch, round(m.sim, 4)) for m in p.matches(50, 512)] \
        == [(m.file, m.punch, round(m.sim, 4)) for m in j.matches(50, 512)]


def test_query_batch_mixed_lengths_matches_jax(entries):
    jdb, pdb = _dbs(entries, pad_multiple=64)
    blocks = [entries[0][1][:, 10:50], entries[2][1][:, 30:85],
              entries[4][1][:, 60:100]]                 # 40, 55, 40 frames
    jts, pts = zip(*(_tmpls(b) for b in blocks))
    pr, jr = pdb.query_batch(list(pts), k=3), jdb.query_batch(list(jts), k=3)
    assert len(pr) == 3
    for q, (p, j) in enumerate(zip(pr, jr)):
        assert_query_equal(p, j)
        single = pdb.query(pts[q], k=3)
        np.testing.assert_array_equal(p.sims, single.sims)
        np.testing.assert_array_equal(p.frames, single.frames)
    for q, (i, off) in enumerate(((0, 10), (2, 30), (4, 60))):
        assert pr[q].frames[i, 0] == off


@pytest.mark.parametrize("cache_spectra", [False, True])
def test_query_punch_matches_jax(entries, cache_spectra):
    ents = _plant_pair(entries)
    norm = _norm_of(ents)
    jdb, pdb = _dbs(ents, norm, pad_multiple=64, cache_spectra=cache_spectra)
    ji, pi = _tmpls(ents[3][1][:, 10:40], norm)
    jo, po = _tmpls(ents[3][1][:, 100:120], norm)
    for band in ((70, 85), (40, 200), (80, 80)):
        p = pdb.query_punch(pi, po, *band, k=3)
        j = jdb.query_punch(ji, jo, *band, k=3)
        assert_punch_equal(p, j)
    p = pdb.query_punch(pi, po, 70, 85, k=2)
    m = p.matches(step_size=512, k_total=1)[0]
    assert m.file == ents[5][0]
    assert m.punch.start == 30 * 512 and m.punch.stop == 110 * 512


def test_query_punch_batch_matches_jax(entries):
    ents = _plant_pair(entries)
    jdb, pdb = _dbs(ents, pad_multiple=64)
    specs = [((3, 10, 40), (3, 100, 120), 70, 85),
             ((2, 5, 35), (6, 50, 70), 40, 90),
             ((1, 0, 30), (1, 60, 80), 20, 30),
             ((4, 20, 60), (4, 90, 115), 30, 64)]
    jp, pp = [], []
    for (fi, a, b), (fo, c, d), lo, hi in specs:
        ji, pi = _tmpls(ents[fi][1][:, a:b])
        jo, po = _tmpls(ents[fo][1][:, c:d])
        jp.append((ji, jo, lo, hi))
        pp.append((pi, po, lo, hi))
    pr, jr = pdb.query_punch_batch(pp, k=3), jdb.query_punch_batch(jp, k=3)
    for (pi, po, lo, hi), p, j in zip(pp, pr, jr):
        assert_punch_equal(p, j)
        single = pdb.query_punch(pi, po, lo, hi, k=3)
        for name in ("sims", "frames", "punch_lens", "boosts_in",
                     "boosts_out", "in_sims"):
            np.testing.assert_array_equal(getattr(p, name),
                                          getattr(single, name))
    with pytest.raises(ValueError, match="min_punch"):
        pdb.query_punch_batch([(pp[0][0], pp[0][1], 9, 8)])


@pytest.mark.parametrize("rerank_device", [True, False])
def test_exact_rerank_matches_jax(entries, rerank_device):
    ents = _plant_pair(entries)
    norm = _norm_of(ents)
    jdb = JD.FeatureDatabase(ents, norm, pad_multiple=64)
    pdb = PD.FeatureDatabase(ents, norm, pad_multiple=64, device="cpu",
                             rerank_device=rerank_device)
    assert pdb._rerank_device is rerank_device
    jt, pt = _tmpls(ents[3][1][:, 10:40], norm)
    jo, po = _tmpls(ents[3][1][:, 100:120], norm)
    p = pdb.query(pt, k=3, exact_rerank=True)
    j = jdb.query(jt, k=3, exact_rerank=True)
    assert_query_equal(p, j)
    for a, b in zip(pdb.query_batch([pt, po], k=2, exact_rerank=True),
                    jdb.query_batch([jt, jo], k=2, exact_rerank=True)):
        assert_query_equal(a, b)
    p = pdb.query_punch(pt, po, 70, 85, k=2, exact_rerank=True)
    j = jdb.query_punch(jt, jo, 70, 85, k=2, exact_rerank=True)
    assert_punch_equal(p, j)


@pytest.mark.parametrize("with_norm", [False, True])
def test_device_rerank_matches_host_oracle(entries, with_norm):
    """The device re-rank reproduces the host f64 mirror's window scores on
    every candidate (the tolerance of the JAX package's own test,
    tests/test_database.py::test_device_rerank_matches_host_oracle)."""
    norm = _norm_of(entries) if with_norm else None
    jdb, pdb = _dbs(entries, norm, pad_multiple=64)
    jt, pt = _tmpls(entries[5][1][:, 40:90], norm)
    res = pdb.query(pt, k=3, exact_rerank=True)
    assert res.frames[5, 0] == 40 and abs(res.sims[5, 0] - 1.0) < 3e-5
    finite = np.argwhere(np.isfinite(res.sims))
    fi, fr = finite[:, 0], res.frames[finite[:, 0], finite[:, 1]]
    for tw in (0.0, 0.5, 1.0):
        d_sims, d_boosts = pdb._device_window_scores(fi, fr, pt, tw, 8.0)
        h_sims, h_boosts = pdb._exact_window_scores(fi, fr, pt, tw, 8.0)
        np.testing.assert_allclose(d_sims, h_sims, atol=1e-5)
        np.testing.assert_allclose(d_boosts, h_boosts, rtol=1e-5)
        # the copied host oracle is the JAX package's, value for value
        j_sims, j_boosts = jdb._exact_window_scores(fi, fr, jt, tw, 8.0)
        np.testing.assert_array_equal(h_sims, j_sims)
        np.testing.assert_array_equal(h_boosts, j_boosts)


# -- capacity cases of tests/test_query_capacity.py -------------------------

def _cap_db(n=3, T=100, C=4, seed=0):
    rng = np.random.default_rng(seed)
    ents = [(f"f{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((C, T))).astype(
                 np.float32)) for i in range(n)]
    return ents, _dbs(ents)


def _cap_tmpls(L, C=4, seed=9):
    rng = np.random.default_rng(seed)
    return _tmpls(np.abs(0.5 + 0.2 * rng.standard_normal((C, L))))


def test_capacity_query_cases():
    ents, (jdb, pdb) = _cap_db()
    assert pdb._xs.shape[2] == jdb._xs.shape[2] == 512
    for L, k in ((510, 4), (600, 4), (480, 40)):
        jt, pt = _cap_tmpls(L)
        p, j = pdb.query(pt, k=k), jdb.query(jt, k=k)
        assert p.sims.shape == (3, k)
        assert_query_equal(p, j)
    with pytest.raises(ValueError, match="padded time capacity"):
        pdb.query(_cap_tmpls(600)[1], k=4, with_traces=True)
    # one file fills the capacity: 3 real windows, k=4 → a padded column
    rng = np.random.default_rng(3)
    full = np.abs(0.5 + 0.2 * rng.standard_normal((4, 512))).astype(
        np.float32)
    short = np.abs(0.5 + 0.2 * rng.standard_normal((4, 100))).astype(
        np.float32)
    jdb, pdb = _dbs([("full.aif", full), ("short.aif", short)])
    jt, pt = _tmpls(full[:, 1:511])
    p, j = pdb.query(pt, k=4), jdb.query(jt, k=4)
    assert_query_equal(p, j)
    assert p.matches(510, 512, 1)[0].file == "full.aif"
    assert not np.isfinite(p.sims[:, 3]).any()


def test_capacity_punch_and_batch_cases():
    ents, (jdb, pdb) = _cap_db(n=4)
    (ji, pi), (jo, po) = _cap_tmpls(505), _cap_tmpls(20, seed=11)
    assert_punch_equal(pdb.query_punch(pi, po, 2, 5, k=4),
                       jdb.query_punch(ji, jo, 2, 5, k=4))
    jb, pb = _cap_tmpls(600, seed=12)
    p = pdb.query_punch(pi, pb, 2, 5, k=4)
    assert_punch_equal(p, jdb.query_punch(ji, jb, 2, 5, k=4))
    assert p.matches(512, 10) == []
    jn, pn = _tmpls(ents[1][1][:, 10:70])
    ja, pa = _cap_tmpls(510)
    for p, j in zip(pdb.query_batch([pn, pa, pb], k=4),
                    jdb.query_batch([jn, ja, jb], k=4)):
        assert p.sims.shape == (4, 4)
        assert_query_equal(p, j)
    (j1, p1), (j2, p2) = (_tmpls(ents[2][1][:, 5:45]),
                          _tmpls(ents[2][1][:, 60:80]))
    (j3, p3) = _cap_tmpls(40, seed=13)
    pp = [(p1, p2, 10, 20), (pi, po, 2, 5), (p3, pb, 2, 5)]
    jp = [(j1, j2, 10, 20), (ji, jo, 2, 5), (j3, jb, 2, 5)]
    for p, j in zip(pdb.query_punch_batch(pp, k=4),
                    jdb.query_punch_batch(jp, k=4)):
        assert p.sims.shape == (4, 4)
        assert_punch_equal(p, j)


def test_check_template_errors(entries):
    pdb = PD.FeatureDatabase(entries[:3], None, pad_multiple=64,
                             device="cpu")
    with pytest.raises(ValueError, match="template has 10 channels"):
        pdb.query(PT(entries[0][1][:10, :30].copy()))
    with pytest.raises(ValueError, match="num_temporal 2 != database"):
        pdb.query(PT(entries[0][1][:, :30].copy(), num_temporal=2))
    ok, bad = PT(entries[0][1][:, :30].copy()), PT(entries[0][1][:4, :30])
    with pytest.raises(ValueError, match="channels"):
        pdb.query_batch([ok, bad])
    with pytest.raises(ValueError, match="channels"):
        pdb.query_punch(ok, bad, 40, 50)
    with pytest.raises(ValueError, match="min_punch 50 > max_punch 40"):
        pdb.query_punch(ok, ok, 50, 40)


def test_ties_keep_jax_order():
    """Exact ties in every form the serving path makes them: duplicated
    files, boost-gated windows (sim exactly 0.0) and masked windows
    (−inf) — per-file frames and the flat match order equal the JAX
    package's, which takes ``lax.top_k``'s order (earliest index first)."""
    ents = _entries(n=6, T=300, grow=0, seed=4)
    ents[1] = ("dup.aif", ents[0][1].copy())            # duplicate of file 0
    quiet = ents[2][1].copy()
    quiet[0, 120:220] *= 1e-3          # loudness drops: boost ≫ 8, sim 0.0
    ents[2] = ("quiet.aif", quiet)
    ents[3] = ("short.aif", ents[3][1][:, :90].copy())  # 51 windows < k
    jdb, pdb = _dbs(ents, pad_multiple=64)
    jt, pt = _tmpls(ents[0][1][:, 30:70])
    k = 200
    p, j = pdb.query(pt, k=k), jdb.query(jt, k=k)
    assert_query_equal(p, j)
    zeros = j.sims[2] == 0.0
    assert zeros.sum() > 50 and _decided(j.sims)[2][zeros].all()
    np.testing.assert_array_equal(p.frames[2][zeros], j.frames[2][zeros])
    assert (np.diff(p.frames[2][zeros]) > 0).all()      # earliest first
    masked = np.isneginf(j.sims[3])
    assert masked.sum() == k - 51
    np.testing.assert_array_equal(p.frames[3][masked], np.arange(51, k))
    np.testing.assert_array_equal(p.sims[0], p.sims[1])
    np.testing.assert_array_equal(p.frames[0], p.frames[1])
    pm, jm = p.matches(40, 512, 12), j.matches(40, 512, 12)
    assert [(m.file, m.punch.start) for m in pm] == \
        [(m.file, m.punch.start) for m in jm]
    assert [m.file for m in pm[:2]] == [ents[0][0], "dup.aif"]
    jo, po = _tmpls(ents[0][1][:, 150:180])
    assert_punch_equal(pdb.query_punch(pt, po, 60, 140, k=8),
                       jdb.query_punch(jt, jo, 60, 140, k=8))


def test_topk_epilogue_matches_lax_top_k():
    """The tie-stable top-k against ``jax.lax.top_k`` on rows full of
    exact ties, signed zeros, ±inf and x86's arithmetic NaN (−NaN, which
    ``lax.top_k`` ranks after −inf), through both packages' epilogues.
    A +NaN ranks there too in the port (``_topk``'s docstring)."""
    rng = np.random.default_rng(2)
    neg_nan = -np.float32(np.nan)
    assert np.signbit(neg_nan)
    sims = rng.choice(np.array([0.0, -0.0, 0.5, -0.25, 1.0, neg_nan,
                                np.inf, -np.inf], np.float32), size=(16, 64))
    boosts = rng.uniform(0.5, 2.0, size=(16, 64)).astype(np.float32)
    lens = rng.integers(0, 80, size=16).astype(np.int32)
    for L, k in ((1, 64), (10, 20), (30, 5)):
        jv, ji, jb = JD._topk_epilogue(jax.numpy.asarray(sims),
                                       jax.numpy.asarray(boosts),
                                       jax.numpy.asarray(lens), L, k)
        pv, pi, pb = PD._topk_epilogue(torch.from_numpy(sims),
                                       torch.from_numpy(boosts),
                                       torch.from_numpy(lens), L, k)
        np.testing.assert_array_equal(pv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    x = torch.tensor([1, -np.inf, 2, 2, np.nan, 2, -np.nan, 0.0])
    assert PD._topk(x, 8)[1].tolist() == [2, 3, 5, 0, 7, 1, 4, 6]


def test_nan_file_ranks_after_masked_windows(entries):
    """A degenerate file (a NaN feature frame poisons its group's shift
    and so every window of its trace): its NaN sims rank after the masked
    −inf windows, in index order, in both packages, and ``matches`` drops
    them; the punch combine's ``inSim > 0`` gate masks them to −inf."""
    ents = [(n, f.copy()) for n, f in entries[:6]]
    ents[4][1][3, 77] = np.nan
    jdb, pdb = _dbs(ents, pad_multiple=64)
    jt, pt = _tmpls(ents[1][1][:, 20:60])
    n_masked = pdb._xs.shape[2] - ents[4][1].shape[1]    # 54 −inf windows
    p, j = pdb.query(pt, k=n_masked + 6), jdb.query(jt, k=n_masked + 6)
    assert np.isneginf(p.sims[4, :n_masked]).all()
    assert np.isnan(p.sims[4, n_masked:]).all()
    np.testing.assert_array_equal(p.frames[4, n_masked:], np.arange(6))
    assert_query_equal(p, j)
    assert all(m.file != ents[4][0] for m in p.matches(40, 512, 20))
    jo, po = _tmpls(ents[1][1][:, 100:120])
    pp = pdb.query_punch(pt, po, 50, 90, k=3)
    assert np.isneginf(pp.sims[4]).all()
    assert_punch_equal(pp, jdb.query_punch(jt, jo, 50, 90, k=3))


def test_chunked_files_axis_matches(entries, monkeypatch):
    """Past ``_QUERY_CHUNK`` files the axis pads to a multiple and queries
    run range by range; with a tiny step budget each range splits into
    several files steps too.  Results equal the one-range database."""
    ents = _plant_pair(entries)
    ref = PD.FeatureDatabase(ents, None, pad_multiple=64, device="cpu")
    pi, po = PT(ents[3][1][:, 10:40].copy()), PT(ents[3][1][:, 100:120])
    want = (ref.query(pi, k=3), ref.query_punch(pi, po, 70, 85, k=2),
            *ref.query_batch([pi, po], k=2))
    monkeypatch.setattr(PD, "_QUERY_CHUNK", 5)
    monkeypatch.setattr(PD, "_STEP_BYTES", 1)            # one file a step
    for cache in (False, True):
        db = PD.FeatureDatabase(ents, None, pad_multiple=64, device="cpu",
                                cache_spectra=cache)
        assert db._xs.shape[0] == 15 and db.num_files == 12
        assert len(db._chunks()) == 3
        got = (db.query(pi, k=3), db.query_punch(pi, po, 70, 85, k=2),
               *db.query_batch([pi, po], k=2))
        for r, w in zip(got, want):
            np.testing.assert_array_equal(r.sims, w.sims)
            np.testing.assert_array_equal(r.frames, w.frames)


def test_pad_rows_and_steps_follow_the_jax_package():
    for n in (1, 7, 2048, 2049, 4095, 10000, 10240):
        assert PD._pad_rows_of(n) == JD._pad_rows_of(n, None)
    assert PD._QUERY_CHUNK == JD._QUERY_CHUNK
    # a two-minute file: ~880 files per query step, ~440 per punch step
    assert 800 <= PD._files_step(14, 10752, 1) <= 1000
    assert PD._files_step(14, 10752, 2) == PD._files_step(14, 10752, 1) // 2


@pytest.mark.parametrize("kw,exc,what", [
    (dict(mesh=object()), NotImplementedError, "mesh"),
    (dict(cache_spectra="complex64"), ValueError, "complex64")])
def test_unported_modes_raise(entries, kw, exc, what):
    """``mesh`` is the one mode not ported; a complex compact-cache dtype
    is refused rather than read back as a full complex64 cache."""
    with pytest.raises(exc, match=what):
        PD.FeatureDatabase(entries[:2], None, device="cpu", **kw)


def test_bad_options_and_missing_card_raise(entries, monkeypatch):
    with pytest.raises(ValueError, match="complex64"):
        PD.FeatureDatabase(entries[:2], None, device="cpu",
                           cache_spectra="complex64")
    with pytest.raises(ValueError, match="raw_store"):
        PD.FeatureDatabase(entries[:2], None, device="cpu", raw_store="x")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PD.FeatureDatabase(entries[:2], None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PD.FeatureDatabase(entries[:2], None, device="cuda:0")
