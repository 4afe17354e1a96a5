"""The port's sharded ``FeatureDatabase`` on the CPU, against the JAX
package's mesh database and the port's single-device database: the mirror
of tests/test_mesh_rerank.py, test_db_incremental_mesh.py and
test_multihost.py::test_save_on_one_topology_load_on_another.

The port's meshes repeat the CPU (4 or 8 shards); the JAX side runs on the
virtual CPU devices of tests/conftest.py.  Tolerances as in
tests/test_torch_database.py: sims within 3e-5, boosts 1e-4 relative,
frames equal where the candidate is decided; the exact re-rank within 2e-5
of the host f64 mirror and of the single device.
"""

import jax
import numpy as np
import pytest
import torch

from strugatzki_tpu.parallel import database as JD
from strugatzki_tpu.parallel import sweep as JW
from strugatzki_tpu_torch.parallel import database as PD
from strugatzki_tpu_torch.parallel import sweep as PW
from test_torch_database import (_entries, _norm_of, _plant_pair, _tmpls,
                                 assert_punch_equal, assert_query_equal)

RERANK_TOL = 2e-5


def _pmesh(n):
    return PW.make_files_mesh(["cpu"] * n)


def _jmesh(n):
    return JW.make_files_mesh(jax.devices()[:n])


@pytest.fixture(scope="module")
def planted():
    """13 files (no shard count divides it) with a planted pair, and the
    norm."""
    ents = _plant_pair(_entries(n=13))
    return ents, _norm_of(ents)


def _families(db, t_in, t_out, batch, pairs, k=3, batch_as_queries=False):
    """The four families; ``batch_as_queries`` answers the template batch
    with one ``query`` each, which ``query_batch`` equals (the JAX package's
    mesh ``query_batch`` fails an XLA layout check on the virtual CPU
    devices)."""
    qb = [db.query(t, k=k) for t in batch] if batch_as_queries \
        else db.query_batch(batch, k=k)
    return (db.query(t_in, k=k), db.query_punch(t_in, t_out, 60, 100, k=k),
            qb, db.query_punch_batch(pairs, k=k))


def _same_families(got, want):
    q, p, qb, pb = got
    wq, wp, wqb, wpb = want
    assert_query_equal(q, wq)
    assert_punch_equal(p, wp)
    for a, b in zip(qb, wqb):
        assert_query_equal(a, b)
    for a, b in zip(pb, wpb):
        assert_punch_equal(a, b)


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("cache_spectra", [False, True])
def test_four_families_match(planted, shards, cache_spectra):
    """All four query families of a 4- and an 8-shard database against the
    JAX package's database on as many devices and against the port's
    single device; the planted pair first.  (With the spectra cache the JAX
    side runs on one device: its mesh program with the complex64 cache
    fails an XLA layout check on the virtual CPU devices.)"""
    ents, norm = planted
    kw = dict(pad_multiple=64, cache_spectra=cache_spectra)
    pdb = PD.FeatureDatabase(ents, norm, mesh=_pmesh(shards), **kw)
    one = PD.FeatureDatabase(ents, norm, device="cpu", **kw)
    jdb = JD.FeatureDatabase(
        ents, norm, mesh=None if cache_spectra else _jmesh(shards), **kw)
    assert pdb._num_shards == shards and one._num_shards == 1
    assert pdb._raw.shape[0] == 16
    jt_in, pt_in = _tmpls(ents[3][1][:, 10:40], norm)
    jt_out, pt_out = _tmpls(ents[3][1][:, 100:120], norm)
    jt_b, pt_b = _tmpls(ents[7][1][:, 5:45], norm)
    got = _families(pdb, pt_in, pt_out, [pt_in, pt_b],
                    [(pt_in, pt_out, 60, 100), (pt_b, pt_out, 50, 90)])
    _same_families(got, _families(
        one, pt_in, pt_out, [pt_in, pt_b],
        [(pt_in, pt_out, 60, 100), (pt_b, pt_out, 50, 90)]))
    _same_families(got, _families(
        jdb, jt_in, jt_out, [jt_in, jt_b],
        [(jt_in, jt_out, 60, 100), (jt_b, jt_out, 50, 90)],
        batch_as_queries=not cache_spectra))
    assert got[1].frames[5, 0] == 30 and got[1].sims[5, 0] > 0.9999
    assert got[0].sims.shape == (13, 3)


def test_sharded_tensors_live_per_shard(planted):
    ents, norm = planted
    db = PD.FeatureDatabase(ents, norm, pad_multiple=64, mesh=_pmesh(4),
                            cache_spectra=True)
    assert [sh.rows for sh in db._shards] == [slice(4 * d, 4 * d + 4)
                                              for d in range(4)]
    assert all(sh.xs.shape[0] == 4 and len(sh.spectra) == 2
               for sh in db._shards)
    assert [int(sh.lens.sum()) for sh in db._shards] == [
        int(db._lens[sh.rows].sum()) for sh in db._shards]
    with pytest.raises(AttributeError, match="per shard"):
        db._xs
    single = PD.FeatureDatabase(ents, norm, pad_multiple=64, device="cpu",
                                mesh=None)
    assert single._xs.shape == (13, 14, db._raw.shape[2])


# ---------------------------------------------------------------------------
# the exact re-rank (tests/test_mesh_rerank.py)
# ---------------------------------------------------------------------------

def _rerank_entries(seed, n, T=200, C=6):
    rng = np.random.default_rng(seed)
    return [(f"r{seed}_{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((C, T))).astype(
                 np.float32)) for i in range(n)]


@pytest.fixture(scope="module")
def rerank_pair():
    ents = _rerank_entries(7, 13)
    norm = np.stack([np.full(6, 0.05, np.float32),
                     np.full(6, 1.6, np.float32)], axis=1)
    return (ents, norm,
            PD.FeatureDatabase(ents, norm, pad_multiple=32, mesh=_pmesh(8)),
            PD.FeatureDatabase(ents, norm, pad_multiple=32, device="cpu"))


def test_device_scores_match_mirror_and_single(rerank_pair):
    """Each candidate scored on the shard that owns its file, assembled by
    ownership: the host f64 mirror and the single device within 2e-5, for
    candidates from every shard in a random order."""
    ents, _, db_m, db_s = rerank_pair
    assert db_m._rerank_device and db_s._rerank_device
    _, tmpl = _tmpls(ents[9][1][:, 40:100])
    rng = np.random.default_rng(3)
    fi = rng.integers(0, len(ents), 37).astype(np.int32)
    fr = rng.integers(0, 200 - 60, 37).astype(np.int32)
    dev = db_m._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    host = db_m._exact_window_scores(fi, fr, tmpl, 0.5, 8.0)
    single = db_s._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    for other in (host, single):
        np.testing.assert_allclose(dev[0], other[0], atol=RERANK_TOL)
        np.testing.assert_allclose(dev[1], other[1], rtol=RERANK_TOL)


def test_device_scores_keep_nonfinite(rerank_pair):
    """A zero-variance window scores a non-finite sim on its shard, and
    the assembly by ownership keeps it bit for bit (a select-scatter, as
    the JAX package's psum of zeros around one real value)."""
    ents, norm, _, _ = rerank_pair
    ents = [(n, f.copy()) for n, f in ents]
    ents[10][1][:, 50:120] = 0.7                 # a constant stretch
    db = PD.FeatureDatabase(ents, norm, pad_multiple=32, mesh=_pmesh(8))
    one = PD.FeatureDatabase(ents, norm, pad_multiple=32, device="cpu")
    _, tmpl = _tmpls(ents[2][1][:, 10:70])
    fi = np.array([10, 2, 10, 12], np.int32)
    fr = np.array([55, 10, 0, 3], np.int32)
    got = db._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    want = one._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    assert not np.isfinite(want[0][0])
    bad = ~np.isfinite(want[0])
    np.testing.assert_array_equal(got[0][bad], want[0][bad])
    np.testing.assert_allclose(got[0][~bad], want[0][~bad], atol=RERANK_TOL)


def test_query_exact_rerank_matches_single(rerank_pair):
    ents, _, db_m, db_s = rerank_pair
    _, tmpl = _tmpls(ents[4][1][:, 60:140])
    rm = db_m.query(tmpl, k=3, exact_rerank=True)
    rs = db_s.query(tmpl, k=3, exact_rerank=True)
    np.testing.assert_allclose(np.nan_to_num(rm.sims, neginf=0),
                               np.nan_to_num(rs.sims, neginf=0),
                               atol=RERANK_TOL)
    assert rm.sims[4, 0] == pytest.approx(1.0, abs=1e-5)
    assert rm.frames[4, 0] == 60
    _, t_out = _tmpls(ents[4][1][:, 150:180])
    pm = db_m.query_punch(tmpl, t_out, 5, 40, k=2, exact_rerank=True)
    ps = db_s.query_punch(tmpl, t_out, 5, 40, k=2, exact_rerank=True)
    np.testing.assert_allclose(np.nan_to_num(pm.sims, neginf=0),
                               np.nan_to_num(ps.sims, neginf=0),
                               atol=RERANK_TOL)


def test_modes_under_a_mesh(rerank_pair):
    """bf16 features under a mesh take the host mirror (eligibility is the
    dtype, not the mesh) and refuse ``rerank_device=True``; the compact
    cache keeps the device re-rank; both recover the exact results of the
    single-device f32 database."""
    ents, norm, _, db_s = rerank_pair
    mesh = _pmesh(8)
    bf = PD.FeatureDatabase(ents, norm, pad_multiple=32, mesh=mesh,
                            storage_dtype=torch.bfloat16)
    assert not bf._rerank_device and bf._reduced
    with pytest.raises(ValueError):
        PD.FeatureDatabase(ents, norm, pad_multiple=32, mesh=mesh,
                           storage_dtype=torch.bfloat16, rerank_device=True)
    compact = PD.FeatureDatabase(ents, norm, pad_multiple=32, mesh=mesh,
                                 cache_spectra="bf16")
    assert compact._rerank_device and compact._reduced
    assert all(sh.spectra[0].dtype == torch.bfloat16
               for sh in compact._shards)
    _, tmpl = _tmpls(ents[6][1][:, 30:110])
    want = db_s.query(tmpl, k=2, exact_rerank=True)
    for db in (bf, compact):
        got = db.query(tmpl, k=2)              # the exact re-rank is on
        assert got.sims[6, 0] == pytest.approx(1.0, abs=1e-5)
        np.testing.assert_allclose(np.nan_to_num(got.sims, neginf=0),
                                   np.nan_to_num(want.sims, neginf=0),
                                   atol=RERANK_TOL)


def test_memmap_store_and_chunked_shards(rerank_pair, monkeypatch):
    """A memmap raw store under a mesh, and shards larger than the query
    range (the range and step gates apply inside each shard): the results
    of the single device."""
    ents, norm, _, db_s = rerank_pair
    monkeypatch.setattr(PD, "_QUERY_CHUNK", 2)
    monkeypatch.setattr(PD, "_STEP_BYTES", 1)
    db = PD.FeatureDatabase(iter(ents), norm, pad_multiple=32,
                            mesh=_pmesh(4), raw_store="memmap",
                            time_capacity=200, cache_spectra=True)
    assert isinstance(db._raw, np.memmap) and db._raw.shape[0] == 16
    assert len(db._chunks()) == 8
    _, tmpl = _tmpls(ents[8][1][:, 20:90])
    got, want = db.query(tmpl, k=3), db_s.query(tmpl, k=3)
    assert_query_equal(got, want)


# ---------------------------------------------------------------------------
# incremental updates (tests/test_db_incremental_mesh.py)
# ---------------------------------------------------------------------------

def _tuples(res, k=4):
    return [(m.file, m.punch.start, round(m.sim, 5))
            for m in res.matches(50, 512, k)]


def test_mesh_remove_then_add_matches_fresh():
    rng = np.random.default_rng(21)
    ents = [(f"m21_{i}.aif", np.abs(0.5 + 0.2 * rng.standard_normal(
        (5, 160))).astype(np.float32)) for i in range(8)]
    extra = [(f"m22_{i}.aif", np.abs(0.5 + 0.2 * rng.standard_normal(
        (5, 140))).astype(np.float32)) for i in range(2)]
    mesh = _pmesh(8)
    db = PD.FeatureDatabase(ents, None, pad_multiple=32, mesh=mesh,
                            cache_spectra=True)
    db.remove_files([ents[2][0], ents[5][0]])
    assert db.num_files == 6
    assert int(db._shards[2].lens[0]) == 0 and int(db._shards[5].lens[0]) == 0
    db.add_files(extra)                    # under a mesh: restage
    assert db.num_files == 8 and db._mesh is mesh and db._num_shards == 8
    assert db._spectra_pack is None and all(sh.spectra for sh in db._shards)

    live = [e for i, e in enumerate(ents) if i not in (2, 5)] + extra
    fresh = PD.FeatureDatabase(live, None, pad_multiple=32, device="cpu")
    _, tmpl = _tmpls(extra[1][1][:, 30:80])
    assert _tuples(db.query(tmpl, k=2)) == _tuples(fresh.query(tmpl, k=2))
    _, gone = _tmpls(ents[2][1][:, 10:60])
    hits = {m.file for m in db.query(gone, k=2).matches(50, 512, 8)}
    assert ents[2][0] not in hits


# ---------------------------------------------------------------------------
# archives across packages and topologies (tests/test_multihost.py:263)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw_store", ["memory", "memmap"])
def test_archives_across_packages_and_topologies(tmp_path, raw_store):
    """An archive saved by the JAX package under 8 devices loads in the port
    under 4 shards, one saved by the port under 4 shards loads in the JAX
    package under 8 devices and on one device, and every load answers like
    the saving database: the archive holds no padding rows."""
    rng = np.random.default_rng(5)
    ents = [(f"t{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((5, 150 + 7 * i)))
             .astype(np.float32)) for i in range(10)]
    jdb = JD.FeatureDatabase(ents, None, pad_multiple=32, mesh=_jmesh(8))
    jpath = tmp_path / "jax.npz"
    jdb.save(jpath)
    pdb = PD.FeatureDatabase.load(jpath, mesh=_pmesh(4), raw_store=raw_store)
    ppath = tmp_path / "port.npz"
    pdb.save(ppath)
    loads = [pdb, PD.FeatureDatabase.load(ppath, device="cpu"),
             JD.FeatureDatabase.load(ppath, mesh=_jmesh(8)),
             JD.FeatureDatabase.load(ppath)]
    assert pdb._raw.shape[0] == 12 and pdb._num_shards == 4
    assert isinstance(pdb._raw, np.memmap) == (raw_store == "memmap")
    jt, pt = _tmpls(ents[7][1][:, 40:100])
    ref = jdb.query(jt, k=3)
    n = len(ents)
    for db in loads:
        assert db.files[:n] == jdb.files[:n]
        np.testing.assert_array_equal(db._lens[:n], jdb._lens[:n])
        np.testing.assert_array_equal(np.asarray(db._raw)[:n],
                                      np.asarray(jdb._raw)[:n])
        res = db.query(pt if isinstance(db, PD.FeatureDatabase) else jt,
                       k=3)
        np.testing.assert_allclose(
            np.nan_to_num(np.asarray(res.sims)[:n], neginf=0),
            np.nan_to_num(np.asarray(ref.sims)[:n], neginf=0), atol=3e-5)
        np.testing.assert_array_equal(np.asarray(res.frames)[:n],
                                      np.asarray(ref.frames)[:n])
        assert float(np.asarray(res.sims)[7, 0]) == pytest.approx(1.0,
                                                                  abs=1e-5)


def test_from_folder_and_canary_under_a_mesh(tmp_path):
    from strugatzki_tpu.io import audiofile as af
    from strugatzki_tpu.config import ExtractionConfig
    from strugatzki_tpu_torch.parallel.canary import run_batch_canary

    rng = np.random.default_rng(2)
    for i in range(3):
        f = np.abs(0.5 + 0.1 * rng.standard_normal((14, 120 + 10 * i)))
        fp = tmp_path / f"f{i}_feat.aif"
        af.write(fp, f.astype(np.float32), af.feature_spec(14, 44100 / 512))
        ExtractionConfig(audio_input=str(tmp_path / f"f{i}.aif"),
                         feature_output=str(fp)).save_xml(
            tmp_path / f"f{i}_feat.xml")
    db = PD.FeatureDatabase.from_folder(str(tmp_path), normalize=False,
                                        mesh=_pmesh(2))
    assert db.num_files == 3 and db._num_shards == 2
    assert db._raw.shape[0] == 4
    report = run_batch_canary(n_files=24, file_frames=700, num_queries=3,
                              l_in=48, l_out=24, mesh=_pmesh(4))
    assert report["pass"], report
