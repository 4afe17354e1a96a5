"""The port's FeatureDatabase capacity modes against the JAX package's, on
the CPU: bf16 feature storage (``storage_dtype``), the compact spectra cache
(``cache_spectra="bf16"``: planar bf16 forward spectra and window-sum
tables) and the memmap raw store (``raw_store="memmap"``).

The same numpy-seeded entries go through both packages (the port on
``device="cpu"``).  Tolerances:

* re-ranked sims 2e-5 (query and batches); re-ranked punch sims 1e-4 with
  the top-1 frames equal (a near-tie between punch lengths may resolve to
  another length under reduced spectra, as tests/test_database.py allows);
* raw sims with the re-rank off: 4e-3 for the compact cache (bf16
  quantization of the spectra, ~1e-3), 2e-2 for bf16 features (the JAX
  package's own bound against f32, tests/test_database.py); frames equal
  wherever a candidate is decided at that tolerance;
* the memmap store bit for bit equal to the in-memory one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strugatzki_tpu.parallel import database as JD
from strugatzki_tpu_torch.analysis.correlation import InputTemplate as PT
from strugatzki_tpu_torch.parallel import database as PD
from test_torch_database import (_assert_sims, _decided, _entries, _norm_of,
                                 _plant_pair, _tmpls)

RERANK_TOL = 2e-5
PUNCH_TOL = 1e-4
RAW_TOL = {"compact": 4e-3, "bf16": 2e-2, "bf16+compact": 2e-2}

#: each mode as (JAX package kwargs, port kwargs)
MODES = {
    "compact": (dict(cache_spectra="bf16"), dict(cache_spectra="bf16")),
    "bf16": (dict(storage_dtype=jnp.bfloat16),
             dict(storage_dtype=torch.bfloat16)),
    "bf16+compact": (dict(storage_dtype=jnp.bfloat16, cache_spectra="bf16"),
                     dict(storage_dtype="bf16", cache_spectra="bfloat16")),
    "memmap": (dict(raw_store="memmap"), dict(raw_store="memmap")),
    "memmap+compact": (dict(raw_store="memmap", cache_spectra="bf16"),
                       dict(raw_store="memmap", cache_spectra="bf16")),
    "f32": ({}, {}),
    "f32+cache": (dict(cache_spectra=True), dict(cache_spectra=True)),
}
REDUCED = ["compact", "bf16", "bf16+compact"]


def _mode_dbs(entries, mode, norm=None, **kw):
    jk, pk = MODES[mode]
    return (JD.FeatureDatabase(entries, norm, **jk, **kw),
            PD.FeatureDatabase(entries, norm, device="cpu", **pk, **kw))


def _assert_result(p, j, tol, frames="decided"):
    """A port result against the JAX package's: sims within ``tol`` (NaN
    and inf where the JAX package has them); frames (and punch lengths)
    equal wherever decided at ``tol``, or in the top column only."""
    _assert_sims(p.sims, j.sims, tol)
    if frames == "top":
        dec = np.zeros(j.sims.shape, bool)
        dec[:, 0] = np.isfinite(j.sims[:, 0])
    else:
        dec = _decided(j.sims, tol) & np.isfinite(j.sims)
    np.testing.assert_array_equal(p.frames[dec], j.frames[dec])
    if hasattr(j, "punch_lens"):
        np.testing.assert_array_equal(p.punch_lens[dec], j.punch_lens[dec])
    assert p.files == j.files


@pytest.fixture(scope="module")
def entries():
    return _entries()


# -- reduced precision: tests/test_database.py and test_query_punch.py ------

@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("mode", REDUCED)
def test_reduced_query_matches_jax(entries, mode, with_norm):
    """Re-ranked (the default) and raw queries against the JAX package's
    database of the same mode, and the re-ranked result against the f32
    database's exact one (tests/test_database.py, bf16 storage and
    compact-cache cases)."""
    norm = _norm_of(entries) if with_norm else None
    jdb, pdb = _mode_dbs(entries, mode, norm, pad_multiple=64)
    assert pdb._reduced and jdb._xs.shape == tuple(pdb._xs.shape)
    assert pdb._rerank_device == (mode == "compact")
    jt, pt = _tmpls(entries[5][1][:, 40:90], norm)
    p, j = pdb.query(pt, k=3), jdb.query(jt, k=3)
    _assert_result(p, j, RERANK_TOL)
    assert p.frames[5, 0] == 40 and abs(p.sims[5, 0] - 1.0) < 3e-5
    np.testing.assert_allclose(p.boosts[5, 0], 1.0, atol=1e-3)
    ref = JD.FeatureDatabase(entries, norm, pad_multiple=64).query(
        jt, k=3, exact_rerank=True)
    _assert_result(p, ref, RERANK_TOL)
    tol = RAW_TOL[mode]
    pr, jr = (pdb.query(pt, k=3, exact_rerank=False),
              jdb.query(jt, k=3, exact_rerank=False))
    _assert_result(pr, jr, tol)
    _assert_sims(pr.sims, ref.sims, tol)
    assert pr.frames[5, 0] == 40


@pytest.mark.parametrize("mode", REDUCED)
def test_reduced_punch_matches_jax(entries, mode):
    """query_punch re-ranks both windows of each candidate (on the device
    for the compact cache, through the host f64 mirror for bf16 features);
    top-1 equal to the f32 database's exact result, every sim within
    tolerance (tests/test_database.py punch cases)."""
    ents = _plant_pair(entries)
    jdb, pdb = _mode_dbs(ents, mode, pad_multiple=64)
    ji, pi = _tmpls(ents[3][1][:, 10:40])
    jo, po = _tmpls(ents[3][1][:, 100:120])
    ref = JD.FeatureDatabase(ents, None, pad_multiple=64).query_punch(
        ji, jo, 70, 85, k=2, exact_rerank=True)
    p = pdb.query_punch(pi, po, 70, 85, k=2)
    j = jdb.query_punch(ji, jo, 70, 85, k=2)
    for want in (ref, j):
        _assert_result(p, want, PUNCH_TOL, frames="top")
        for name in ("boosts_in", "boosts_out", "in_sims"):
            np.testing.assert_allclose(getattr(p, name)[:, 0],
                                       getattr(want, name)[:, 0], atol=1e-4)
    m = p.matches(step_size=512, k_total=1)[0]
    assert m.file == ents[5][0]
    assert m.punch.start == 30 * 512 and m.punch.stop == 110 * 512
    _assert_result(pdb.query_punch(pi, po, 70, 85, k=2, exact_rerank=False),
                   jdb.query_punch(ji, jo, 70, 85, k=2, exact_rerank=False),
                   RAW_TOL[mode], frames="top")


def _assert_same_bits(a, b):
    """Two results alike in every field: arrays of one dtype and shape with
    the same bytes, every other field equal."""
    assert type(a) is type(b)
    for name, x in vars(a).items():
        y = getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name
        else:
            assert x == y, name


@pytest.mark.parametrize("mode", REDUCED + ["f32", "f32+cache"])
def test_reduced_batches_match_single_and_jax(entries, mode):
    """query_batch and query_punch_batch equal their single queries bit for
    bit in every field (the automatic re-rank and k-inflation of the
    reduced modes included; float32 features without a cache and with
    the complex64 one) and the JAX package's batches
    (tests/test_query_punch.py bf16 re-rank and compact loops)."""
    ents = _plant_pair(entries)
    jdb, pdb = _mode_dbs(ents, mode, pad_multiple=64)
    blocks = [ents[0][1][:, 10:50], ents[2][1][:, 30:85],
              ents[4][1][:, 60:100]]                 # 40, 55, 40 frames
    jts, pts = zip(*(_tmpls(b) for b in blocks))
    pb, jb = pdb.query_batch(list(pts), k=3), jdb.query_batch(list(jts), k=3)
    for q, (p, j) in enumerate(zip(pb, jb)):
        assert p.boosts is not None
        _assert_result(p, j, RERANK_TOL)
        _assert_same_bits(p, pdb.query(pts[q], k=3))
    specs = [((3, 10, 40), (3, 100, 120), 70, 85),
             ((1, 50, 90), (4, 100, 125), 60, 90),
             ((3, 10, 40), (4, 100, 125), 70, 120)]
    jp, pp = [], []
    for (fi, a, b), (fo, c, d), lo, hi in specs:
        (ji, pi), (jo, po) = _tmpls(ents[fi][1][:, a:b]), \
            _tmpls(ents[fo][1][:, c:d])
        jp.append((ji, jo, lo, hi))
        pp.append((pi, po, lo, hi))
    for (pi, po, lo, hi), p, j in zip(pp, pdb.query_punch_batch(pp, k=3),
                                      jdb.query_punch_batch(jp, k=3)):
        _assert_result(p, j, PUNCH_TOL, frames="top")
        _assert_same_bits(p, pdb.query_punch(pi, po, lo, hi, k=3))
        assert p.min_punch == lo


@pytest.mark.parametrize("mode", REDUCED + ["memmap+compact"])
def test_chunked_staging_and_steps_match(entries, mode, monkeypatch):
    """Slab-wise staging into the preallocated reduced buffers and files
    steps of one file each (compact tables computed per step) give the
    one-range database's results exactly (tests/test_query_punch.py
    chunked bf16 staging and chunked compact files path)."""
    ents = _plant_pair(entries)
    pk = MODES[mode][1]
    ref = PD.FeatureDatabase(ents, None, pad_multiple=64, device="cpu", **pk)
    pi, po = PT(ents[3][1][:, 10:40].copy()), PT(ents[3][1][:, 100:120])
    calls = (lambda d: d.query(pi, k=3),
             lambda d: d.query(pi, k=3, exact_rerank=False),
             lambda d: d.query_punch(pi, po, 70, 85, k=2),
             lambda d: d.query_batch([pi, po], k=2)[1],
             lambda d: d.query_punch_batch([(pi, po, 70, 85)], k=2)[0])
    want = [c(ref) for c in calls]
    monkeypatch.setattr(PD, "_QUERY_CHUNK", 5)
    monkeypatch.setattr(PD, "_SPECTRA_CHUNK", 4)
    monkeypatch.setattr(PD, "_STEP_BYTES", 1)            # one file a step
    db = PD.FeatureDatabase(ents, None, pad_multiple=64, device="cpu", **pk)
    assert db._xs.shape[0] == 15 and db.num_files == 12
    assert db._xs.dtype == ref._xs.dtype
    for c, w in zip(calls, want):
        r = c(db)
        np.testing.assert_array_equal(r.sims, w.sims)
        np.testing.assert_array_equal(r.frames, w.frames)


@pytest.mark.parametrize("with_norm", [False, True])
def test_compact_device_rerank_matches_host_oracle(entries, with_norm):
    """The compact mode keeps f32 features and re-ranks on the device; its
    window scores hold the host f64 mirror to 1e-5, and the mirror is the
    JAX package's value for value (tests/test_database.py)."""
    norm = _norm_of(entries) if with_norm else None
    jdb, pdb = _mode_dbs(entries, "compact", norm, pad_multiple=64)
    assert pdb._rerank_device and pdb._spectra_reduced
    assert pdb._xs.dtype == torch.float32 and len(pdb._spectra) == 2
    assert all(s.dtype == torch.bfloat16 for s in pdb._spectra)
    assert pdb._spectra[0].shape == pdb._spectra[1].shape
    jt, pt = _tmpls(entries[5][1][:, 40:90], norm)
    res = pdb.query(pt, k=3)
    assert res.frames[5, 0] == 40 and abs(res.sims[5, 0] - 1.0) < 3e-5
    fin = np.argwhere(np.isfinite(res.sims))
    fi, fr = fin[:, 0], res.frames[fin[:, 0], fin[:, 1]]
    d_sims, d_boosts = pdb._device_window_scores(fi, fr, pt, 0.5, 8.0)
    h_sims, h_boosts = pdb._exact_window_scores(fi, fr, pt, 0.5, 8.0)
    np.testing.assert_allclose(d_sims, h_sims, atol=1e-5)
    np.testing.assert_allclose(d_boosts, h_boosts, rtol=1e-5)
    j_sims, j_boosts = jdb._exact_window_scores(fi, fr, jt, 0.5, 8.0)
    np.testing.assert_array_equal(h_sims, j_sims)
    np.testing.assert_array_equal(h_boosts, j_boosts)


def test_compact_punch_device_rerank_matches_host(entries):
    ents = _plant_pair(entries)
    pi, po = PT(ents[3][1][:, 10:40].copy()), PT(ents[3][1][:, 100:120])
    dbd = PD.FeatureDatabase(ents, None, pad_multiple=64, device="cpu",
                             cache_spectra="bf16")
    dbh = PD.FeatureDatabase(ents, None, pad_multiple=64, device="cpu",
                             cache_spectra="bf16", rerank_device=False)
    assert dbd._rerank_device and not dbh._rerank_device
    pd_, ph = (d.query_punch(pi, po, 70, 85, k=2) for d in (dbd, dbh))
    np.testing.assert_array_equal(pd_.frames[:, 0], ph.frames[:, 0])
    np.testing.assert_allclose(pd_.sims, ph.sims, atol=1e-5)
    np.testing.assert_allclose(pd_.boosts_in[:, 0], ph.boosts_in[:, 0],
                               rtol=1e-5)
    assert pd_.matches(step_size=512, k_total=1)[0].file == ents[5][0]


def test_rerank_device_flag_validation(entries):
    """bf16 features cannot re-rank exactly on the device: asking for it
    raises, and the default takes the host mirror."""
    with pytest.raises(ValueError, match="float32 features"):
        PD.FeatureDatabase(entries[:2], None, pad_multiple=64, device="cpu",
                           storage_dtype=torch.bfloat16, rerank_device=True)
    db = PD.FeatureDatabase(entries[:2], None, pad_multiple=64, device="cpu",
                            storage_dtype=torch.bfloat16)
    assert not db._rerank_device and db._xs.dtype == torch.bfloat16


@pytest.mark.parametrize("name,want", [
    ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16),
    ("torch.bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (jnp.bfloat16, torch.bfloat16), ("float16", torch.float16),
    (np.float32, torch.float32), ("complex64", None), ("int8", None),
    ("bf17", None)])
def test_dtype_names(entries, name, want):
    """Storage and compact-cache dtypes are any real floating dtype or its
    name; a complex, integer or unknown one raises ``ValueError``."""
    for kw in (dict(storage_dtype=name), dict(cache_spectra=name)):
        if want is None:
            with pytest.raises(ValueError, match="not a real floating"):
                PD.FeatureDatabase(entries[:2], None, device="cpu", **kw)
            continue
        db = PD.FeatureDatabase(entries[:2], None, device="cpu", **kw)
        got = db._xs.dtype if "storage_dtype" in kw else db._spectra[0].dtype
        assert got == want and db._reduced == (want != torch.float32
                                               or "cache_spectra" in kw)


def _plant_graded(base, tmpl_mat, off, deficit, rng):
    """A copy of ``tmpl_mat`` at ``off`` whose exact sim is 1 − ``deficit``
    (tests/test_query_punch.py's construction, copied)."""
    C, L = tmpl_mat.shape
    t0 = tmpl_mat[0] - tmpl_mat[0].mean()
    ts = (tmpl_mat[1:] - tmpl_mat[1:].mean()).ravel()
    e0, es = float((t0 ** 2).sum()), float((ts ** 2).sum())
    n0 = rng.standard_normal(L)
    n0 -= n0.mean()
    n0 -= (n0 @ t0) / e0 * t0
    n0 /= np.linalg.norm(n0)
    ns = rng.standard_normal((C - 1) * L)
    ns -= ns.mean()
    ns -= (ns @ ts) / es * ts
    ns /= np.linalg.norm(ns)
    p = tmpl_mat.copy()
    p[0] += np.sqrt(2 * e0 * deficit) * n0
    p[1:] += (np.sqrt(2 * es * deficit) * ns).reshape(C - 1, L)
    base[:, off:off + L] = p.astype(np.float32)


def test_bf16_k_inflation_recovers_misordered_topk():
    """Candidates 1.5e-6 apart in exact sim are misordered by the bf16
    device sims; the 4× device-k inflation and exact re-rank recover the
    f32 database's top-k on every seed, as in the JAX package
    (tests/test_query_punch.py)."""
    misordered = 0
    for seed in range(12):
        rng = np.random.default_rng(seed)
        C, T = 14, 420
        base = np.abs(0.5 + 5.0 * rng.standard_normal((C, T))).astype(
            np.float32)
        tmpl_mat = np.abs(0.5 + 5.0 * rng.standard_normal((C, 30))).astype(
            np.float32)
        for i, off in enumerate((100, 200, 300)):
            _plant_graded(base, tmpl_mat, off, 1e-3 + i * 1.5e-6, rng)
        files = [("probe.aif", base)]
        tmpl = PT(tmpl_mat)
        db32 = PD.FeatureDatabase(files, None, pad_multiple=64, device="cpu")
        db16 = PD.FeatureDatabase(files, None, pad_multiple=64, device="cpu",
                                  storage_dtype=torch.bfloat16)
        r32 = db32.query(tmpl, k=2, exact_rerank=True)
        r16 = db16.query(tmpl, k=2)
        raw16 = db16.query(tmpl, k=2, exact_rerank=False)
        assert r16.sims.shape == (1, 2)
        np.testing.assert_array_equal(r32.frames, [[100, 200]])
        np.testing.assert_array_equal(r16.frames, r32.frames,
                                      err_msg=str(seed))
        np.testing.assert_allclose(r16.sims, r32.sims, atol=RERANK_TOL,
                                   err_msg=str(seed))
        misordered += not np.array_equal(raw16.frames, r32.frames)
    assert misordered >= 3, misordered


@pytest.mark.parametrize("mode", ["bf16", "compact"])
def test_capacity_with_k_inflation(mode):
    """The 4× k-inflation clamps at the window count too: a 511-frame
    template against a 512-frame capacity (tests/test_query_capacity.py)."""
    rng = np.random.default_rng(0)
    ents = [(f"f{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((4, 100))).astype(
                 np.float32)) for i in range(3)]
    jdb, pdb = _mode_dbs(ents, mode)
    jt, pt = _tmpls(np.abs(0.5 + 0.2 * np.random.default_rng(9)
                           .standard_normal((4, 511))))
    p, j = pdb.query(pt, k=4), jdb.query(jt, k=4)
    assert p.sims.shape == j.sims.shape == (3, 4)
    assert p.matches(511, 512, 10) == [] == j.matches(511, 512, 10)
    assert not np.isfinite(p.sims).any()


def test_compact_nt2_matches_plain_and_jax():
    """num_temporal = 2 through the compact path (its window-sum table
    grows the channel-0 row): results equal the f32 database's and the JAX
    package's compact database (tests/test_num_temporal.py)."""
    rng = np.random.default_rng(11)
    ents = [(f"f{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((8, 200 + 11 * i))
                    ).astype(np.float32)) for i in range(6)]
    kw = dict(pad_multiple=64, num_temporal=2)
    plain = PD.FeatureDatabase(ents, None, device="cpu", **kw)
    jdb, pdb = _mode_dbs(ents, "compact", **kw)
    assert pdb._spectra_reduced and pdb._rerank_device
    jt, pt = _tmpls(ents[4][1][:, 25:75], nt=2)
    ji, pi = _tmpls(ents[2][1][:, 5:45], nt=2)
    jo, po = _tmpls(ents[2][1][:, 70:100], nt=2)
    for p, w in ((pdb.query(pt, k=3), plain.query(pt, k=3)),
                 *zip(pdb.query_batch([pt, pi], k=2),
                      plain.query_batch([pt, pi], k=2))):
        np.testing.assert_array_equal(p.frames, w.frames)
        np.testing.assert_allclose(p.sims, w.sims, atol=1e-5)
    gp = pdb.query_punch(pi, po, 30, 80, k=2)
    wp = plain.query_punch(pi, po, 30, 80, k=2)
    np.testing.assert_array_equal(gp.frames[:, 0], wp.frames[:, 0])
    np.testing.assert_allclose(gp.sims, wp.sims, atol=1e-5)
    _assert_result(pdb.query(pt, k=3), jdb.query(jt, k=3), RERANK_TOL)
    _assert_result(pdb.query(pt, k=3, exact_rerank=False),
                   jdb.query(jt, k=3, exact_rerank=False), RAW_TOL["compact"])


# -- incremental updates: tests/test_db_incremental.py ----------------------

def _inc_entries(seed, n, T=200, C=14):
    rng = np.random.default_rng(seed)
    return [(f"f{seed}_{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((C, T + 7 * i))).astype(
                 np.float32)) for i in range(n)]


def _match_tuples(res, k=6, punch_len=60):
    return [(m.file, m.punch.start, round(m.sim, 6), round(m.boost_in, 6))
            for m in res.matches(punch_len, 512, k)]


@pytest.mark.parametrize("mode", ["compact", "bf16+compact", "bf16",
                                  "memmap+compact"])
def test_incremental_updates_in_every_mode(mode):
    """Remove, add into the tombstones and the padding, then outgrow the
    capacity (restage): each step answers like a fresh database of the live
    entries, and after the incremental step like the JAX package's database
    after the same updates; the restage keeps every mode."""
    ents = _inc_entries(21, 9)
    jk, pk = MODES[mode]
    db = PD.FeatureDatabase(ents, None, device="cpu", **pk)
    jdb = JD.FeatureDatabase(ents, None, **jk)
    rows, sp = db._xs.shape[0], [s.dtype for s in db._spectra or ()]
    for d in (db, jdb):
        d.remove_files([ents[4][0], ents[6][0]])
    extra = _inc_entries(22, 2, T=170)
    for d in (db, jdb):
        d.add_files(extra)
    assert db._xs.shape[0] == rows and db.files == jdb.files
    live = [e for i, e in enumerate(ents) if i not in (4, 6)] + extra
    fresh = PD.FeatureDatabase(live, None, device="cpu", **pk)
    jt, pt = _tmpls(extra[1][1][:, 20:80])
    assert _match_tuples(db.query(pt, k=3)) == \
        _match_tuples(fresh.query(pt, k=3))
    _assert_result(db.query(pt, k=3), jdb.query(jt, k=3), RERANK_TOL)
    t_in = PT(extra[1][1][:, 10:50].copy())
    t_out = PT(extra[1][1][:, 90:120].copy())
    got, want = (d.query_punch(t_in, t_out, min_punch=60, max_punch=100,
                               k=2) for d in (db, fresh))
    assert [(m.file, m.punch.start, round(m.sim, 6))
            for m in got.matches(512, 3)] == \
        [(m.file, m.punch.start, round(m.sim, 6))
         for m in want.matches(512, 3)]
    big = [("big.aif", _inc_entries(23, 1, T=900)[0][1])]
    db.add_files(big)                              # longer: a restage
    assert db._raw.shape[2] >= 900 and db._raw_store == pk.get(
        "raw_store", "memory")
    assert isinstance(db._raw, np.memmap) == (db._raw_store == "memmap")
    assert db._xs.dtype == fresh._xs.dtype
    assert [s.dtype for s in db._spectra or ()] == sp
    tb = PT(big[0][1][:, 500:560].copy())
    fresh = PD.FeatureDatabase(live + big, None, device="cpu", **pk)
    assert _match_tuples(db.query(tb, k=3)) == \
        _match_tuples(fresh.query(tb, k=3))


def test_rerank_limit_preserves_top_matches(monkeypatch):
    """Past RERANK_LIMIT finite candidates the capped host re-rank of a
    bf16 database returns the same top matches as an unlimited one."""
    rng = np.random.default_rng(99)
    ents = [(f"r{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((4, 60))).astype(
                 np.float32)) for i in range(600)]
    tmpl = PT(ents[123][1][:, 10:40].copy())
    db = PD.FeatureDatabase(ents, None, device="cpu",
                            storage_dtype=torch.bfloat16)
    monkeypatch.setattr(PD.FeatureDatabase, "RERANK_LIMIT", 100)
    capped = db.query(tmpl, k=2)
    assert np.isfinite(capped.sims).sum() > 100
    monkeypatch.setattr(PD.FeatureDatabase, "RERANK_LIMIT", 10**9)
    full = db.query(tmpl, k=2)
    assert [(m.file, m.punch.start, round(m.sim, 6))
            for m in capped.matches(30, 512, 10)] == \
        [(m.file, m.punch.start, round(m.sim, 6))
         for m in full.matches(30, 512, 10)]


def test_host_rerank_blocks_are_bit_exact(entries, monkeypatch):
    """The host f64 re-rank runs in candidate blocks: any block size gives
    the same bits as the JAX package's one-block mirror."""
    norm = _norm_of(entries)
    jdb, pdb = _mode_dbs(entries, "bf16", norm, pad_multiple=64)
    jt, pt = _tmpls(entries[7][1][:, 30:95], norm)
    rng = np.random.default_rng(1)
    fi = rng.integers(0, 12, 300)
    fr = rng.integers(0, 130, 300)
    want = jdb._exact_window_scores(fi, fr, jt, 0.5, 8.0)
    for block in (1, 7, 128, 1000):
        monkeypatch.setattr(PD.FeatureDatabase, "_EXACT_BLOCK", block)
        got = pdb._exact_window_scores(fi, fr, pt, 0.5, 8.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# -- the memmap raw store: tests/test_raw_store.py --------------------------

def _rs_entries(n=6, seed=0, T=180):
    rng = np.random.default_rng(seed)
    return [(f"f{i}.aif",
             np.abs(0.5 + 0.1 * rng.standard_normal((14, T + 9 * i))
                    ).astype(np.float32)) for i in range(n)]


def _pdb(entries, **kw):
    return PD.FeatureDatabase(entries, kw.pop("norm", None), device="cpu",
                              pad_multiple=32, **kw)


def _assert_bit_equal(a, b):
    for name in ("sims", "frames", "boosts", "punch_lens", "boosts_in",
                 "boosts_out", "in_sims"):
        if hasattr(a, name):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("cache_spectra", [False, "bf16"])
def test_memmap_matches_memory(cache_spectra):
    entries = _rs_entries()
    db_m = _pdb(entries, cache_spectra=cache_spectra)
    db_f = _pdb(entries, cache_spectra=cache_spectra, raw_store="memmap")
    assert isinstance(db_f._raw, np.memmap) and db_f._raw_store == "memmap"
    np.testing.assert_array_equal(np.asarray(db_f._raw), db_m._raw)
    t, o = PT(entries[3][1][:, 40:90].copy()), PT(entries[3][1][:, 120:140])
    for er in (True, False):
        _assert_bit_equal(db_f.query(t, k=2, exact_rerank=er),
                          db_m.query(t, k=2, exact_rerank=er))
        _assert_bit_equal(db_f.query_punch(t, o, 50, 90, k=2,
                                           exact_rerank=er),
                          db_m.query_punch(t, o, 50, 90, k=2,
                                           exact_rerank=er))
    # the host exact re-rank gathers windows from the memmap
    for a, b in zip(db_f._exact_window_scores(np.array([3]), np.array([40]),
                                              t, 0.5, 8.0),
                    db_m._exact_window_scores(np.array([3]), np.array([40]),
                                              t, 0.5, 8.0)):
        np.testing.assert_array_equal(a, b)


def test_memmap_generator_entries_with_capacity():
    """A one-shot generator stages when time_capacity bounds the frames."""
    entries = _rs_entries(5)
    db = _pdb((e for e in entries), raw_store="memmap", time_capacity=250)
    assert db.files == [n for n, _ in entries]
    assert db._raw.shape[2] == 256                  # 250 up to 32 frames
    t = PT(entries[2][1][:, 10:60].copy())
    assert db.query(t, k=1).frames[2, 0] == 10
    # the in-memory store pads to 224 frames: another FFT input, so only
    # rounding apart
    got, want = db.query(t, k=2), _pdb(entries).query(t, k=2)
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_allclose(got.sims, want.sims, atol=1e-6)


def test_memmap_capacity_validation():
    entries = _rs_entries(3)
    with pytest.raises(ValueError, match="capacity"):
        _pdb(iter(entries), raw_store="memmap", time_capacity=64)
    with pytest.raises(ValueError, match="raw_store"):
        _pdb(entries, raw_store="mmap")
    with pytest.raises(ValueError, match="empty database"):
        _pdb(iter([]), raw_store="memmap", time_capacity=64)


def test_memmap_incremental_and_restage():
    entries = _rs_entries(5)
    db = _pdb(entries, raw_store="memmap")
    ref = _pdb(entries)
    rng = np.random.default_rng(7)
    new = np.abs(0.5 + 0.1 * rng.standard_normal((14, 150))).astype(
        np.float32)
    big = np.abs(0.5 + 0.1 * rng.standard_normal((14, 1200))).astype(
        np.float32)
    for d in (db, ref):
        d.remove_files(["f1.aif"])
        d.add_files([("new.aif", new)])           # fills the tombstone
    assert db.files[1] == "new.aif"
    t = PT(new[:, 30:70].copy())
    assert db.query(t, k=1).frames[1, 0] == 30
    _assert_bit_equal(db.query(t, k=2), ref.query(t, k=2))
    for d in (db, ref):
        d.add_files([("big.aif", big)])           # longer: a restage
    assert db._raw_store == "memmap" and isinstance(db._raw, np.memmap)
    assert db.files == ref.files and "big.aif" in db.files
    tb = PT(big[:, 500:560].copy())
    res = db.query(tb, k=1)
    assert res.frames[db.files.index("big.aif"), 0] == 500
    _assert_bit_equal(db.query(tb, k=2), ref.query(tb, k=2))


def test_memmap_save_load(tmp_path):
    entries = _rs_entries(4)
    db = _pdb(entries, raw_store="memmap")
    db.save(tmp_path / "db.npz", compresslevel=1)
    db2 = PD.FeatureDatabase.load(tmp_path / "db.npz", device="cpu")
    assert db2.files == db.files and not isinstance(db2._raw, np.memmap)
    np.testing.assert_array_equal(db2._raw, np.asarray(db._raw))
    t = PT(entries[1][1][:, 20:60].copy())
    _assert_bit_equal(db.query(t, k=1), db2.query(t, k=1))


def test_memmap_streamed_load(tmp_path):
    """load(raw_store="memmap") streams the archive row by row into the
    disk-backed store: raw bytes, lens, norm, files and query results all
    equal the materializing load."""
    entries = _rs_entries(5, seed=3)
    norm = np.stack([np.full(14, 0.1, np.float32),
                     np.full(14, 1.2, np.float32)], axis=1)
    _pdb(entries, norm=norm).save(tmp_path / "db.npz")
    db_mem = PD.FeatureDatabase.load(tmp_path / "db.npz", device="cpu")
    db_mm = PD.FeatureDatabase.load(tmp_path / "db.npz", device="cpu",
                                    raw_store="memmap")
    assert isinstance(db_mm._raw, np.memmap) and db_mm._raw_store == "memmap"
    assert db_mm.files == db_mem.files == [n for n, _ in entries]
    assert db_mm.step_size == db_mem.step_size
    np.testing.assert_array_equal(db_mm._lens, db_mem._lens)
    np.testing.assert_array_equal(np.asarray(db_mm._raw), db_mem._raw)
    np.testing.assert_array_equal(db_mm.norm, norm)
    t = PT(entries[2][1][:, 15:65].copy())
    _assert_bit_equal(db_mem.query(t, k=2), db_mm.query(t, k=2))


def test_memmap_streamed_load_reads_plain_savez(tmp_path):
    entries = _rs_entries(3, seed=9)
    db = _pdb(entries)
    np.savez_compressed(
        tmp_path / "old.npz", raw=db._raw, lens=db._lens,
        norm=np.zeros((0, 2), np.float32),
        files=np.array(db.files), step_size=db.step_size)
    db2 = PD.FeatureDatabase.load(tmp_path / "old.npz", device="cpu",
                                  raw_store="memmap")
    assert isinstance(db2._raw, np.memmap) and db2.files == db.files
    assert db2.norm is None and db2._num_temporal == 1
    np.testing.assert_array_equal(np.asarray(db2._raw), db._raw)


def test_memmap_streamed_load_pads_and_aborts(tmp_path, monkeypatch):
    """The streamed load pre-pads the files axis to the chunk multiple (so
    the constructor adopts the memmap without a concatenate) and honors an
    abort mid-stream."""
    entries = _rs_entries(6, seed=1)
    _pdb(entries).save(tmp_path / "db.npz")
    monkeypatch.setattr(PD, "_QUERY_CHUNK", 4)
    db = PD.FeatureDatabase.load(tmp_path / "db.npz", device="cpu",
                                 raw_store="memmap")
    assert isinstance(db._raw, np.memmap)
    assert db._raw.shape[0] == 8 and len(db.files) == 6
    assert list(db._lens[6:]) == [0, 0]
    t = PT(entries[4][1][:, 30:80].copy())
    assert db.query(t, k=1).frames[4, 0] == 30
    calls = []

    def abort():
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("aborted")

    with pytest.raises(RuntimeError, match="aborted"):
        PD.FeatureDatabase.load(tmp_path / "db.npz", device="cpu",
                                raw_store="memmap", check_aborted=abort)


def test_memmap_chunked_staging_drops_pages(monkeypatch):
    """Slab-wise staging from a memmap store equals the in-memory store
    and drops the mapping's pages after every slab."""
    entries = _rs_entries(9)
    monkeypatch.setattr(PD, "_QUERY_CHUNK", 4)
    drops = []
    orig = PD._drop_memmap_pages
    monkeypatch.setattr(PD, "_drop_memmap_pages",
                        lambda raw: (drops.append(type(raw)), orig(raw)))
    db_m = _pdb(entries)
    assert drops == [np.ndarray] * 3
    db_f = _pdb(entries, raw_store="memmap")
    assert drops[3:] == [np.memmap] * 3            # 12 rows, 3 slabs
    t = PT(entries[6][1][:, 40:90].copy())
    _assert_bit_equal(db_f.query(t, k=2), db_m.query(t, k=2))


# -- archives across packages, every mode -----------------------------------

@pytest.mark.parametrize("mode", ["f32", "compact", "bf16", "memmap",
                                  "memmap+compact"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archives_load_across_packages_in_every_mode(tmp_path, writer, mode):
    """An archive either package saves from a database in ``mode`` loads in
    the other package in the same mode (the memmap mode streaming it): the
    same raw rows and files, and results within the mode's tolerance."""
    ents = _entries(n=5, seed=15)
    norm = np.stack([np.zeros(14), np.full(14, 1.5)], 1).astype(np.float32)
    jk, pk = MODES.get(mode, ({}, {}))
    src = (JD.FeatureDatabase(ents, norm, step_size=256, **jk)
           if writer == "jax" else
           PD.FeatureDatabase(ents, norm, step_size=256, device="cpu", **pk))
    src.remove_files([ents[2][0]])
    p = tmp_path / "db.npz"
    src.save(p)
    jl = JD.FeatureDatabase.load(p, **jk)
    pl = PD.FeatureDatabase.load(p, device="cpu", **pk)
    live = [n for i, (n, _) in enumerate(ents) if i != 2]
    for d in (jl, pl):
        assert d.files == live and d.step_size == 256
        np.testing.assert_array_equal(d.norm, norm)
    assert isinstance(pl._raw, np.memmap) == mode.startswith("memmap")
    np.testing.assert_array_equal(np.asarray(jl._raw), np.asarray(pl._raw))
    jt, pt = _tmpls(ents[3][1][:, 30:80], norm)
    _assert_result(pl.query(pt, k=3), jl.query(jt, k=3), RERANK_TOL)
    assert pl.query(pt, k=1).frames[2, 0] == 30
