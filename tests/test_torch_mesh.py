"""The port's files mesh on the CPU, against the JAX package's mesh and the
port's unsharded paths: the mirror of tests/test_parallel.py,
test_extract_mesh.py, test_long_file_sharding.py and
test_sharded_gram_novelty.py, case by case where a case is not about jit
keys.

The port's mesh is 8 CPU shards (``make_files_mesh(["cpu"] * 8)``: one
device named 8 times, the row split and per-shard shapes of 8 devices); the
JAX side runs on the 8 virtual CPU devices of tests/conftest.py.  Budgets
(docs/PARITY.md): features 2e-5, traces 3e-5, novelty 2e-5, gram sims 2e-5,
matches match for match, pixels bit-equal to the host quantization.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strugatzki_tpu.analysis import correlation as JC
from strugatzki_tpu.analysis import segmentation as JSG
from strugatzki_tpu.analysis import self_similarity as JSS
from strugatzki_tpu.analysis.correlation import InputTemplate as JT
from strugatzki_tpu.config import (CorrelationConfig, ExtractionConfig,
                                   Punch, SegmentationConfig)
from strugatzki_tpu.dsp import frontend as JFE
from strugatzki_tpu.kernels import corr as JK
from strugatzki_tpu.parallel import sweep as JW
from strugatzki_tpu.span import Span
from strugatzki_tpu_torch.analysis import correlation as PC
from strugatzki_tpu_torch.analysis import segmentation as PSG
from strugatzki_tpu_torch.analysis import self_similarity as PSS
from strugatzki_tpu_torch.analysis.correlation import InputTemplate as PT
from strugatzki_tpu_torch.dsp import frontend as PFE
from strugatzki_tpu_torch.kernels import corr as PK
from strugatzki_tpu_torch.parallel import sweep as PW
from test_torch_host import to_port

STEP = 512
FEAT_TOL, TRACE_TOL, NOVELTY_TOL, GRAM_TOL = 2e-5, 3e-5, 2e-5, 2e-5


@pytest.fixture(scope="module")
def pmesh():
    return PW.make_files_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return JW.make_files_mesh()


def _prepared(seed, C=14, T=900):
    rng = np.random.default_rng(seed)
    x = np.abs(0.5 + 0.1 * rng.standard_normal((C, T))).astype(np.float32)
    return PK.shift_per_group(x)[0]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_is_a_tuple_of_devices(pmesh):
    assert pmesh.size == 8 and pmesh.local == list(range(8))
    assert all(d == torch.device("cpu") for d in pmesh.devices)
    assert not pmesh.spans_processes
    assert [pmesh.pad_rows(n) for n in (0, 1, 8, 13)] == [0, 7, 0, 3]
    assert pmesh.split(16) == [slice(2 * d, 2 * d + 2) for d in range(8)]
    with pytest.raises(ValueError):
        pmesh.split(13)
    with pytest.raises(ValueError):
        PW.make_files_mesh([])
    two = PW.FilesMesh((torch.device("cpu"),) * 4, owners=(0, 0, 1, 1),
                       rank=1)
    assert two.local == [2, 3] and two.spans_processes


def test_fetch_gathers_in_shard_order():
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    got = PW.fetch(parts)
    assert got.shape == (8, 3) and (got[::2, 0] == np.arange(4)).all()
    assert np.array_equal(PW.fetch(parts[1]), parts[1].numpy())


# ---------------------------------------------------------------------------
# batched traces and the sweep step (tests/test_parallel.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_db():
    rng = np.random.default_rng(0)
    files = [np.abs(0.5 + 0.1 * rng.standard_normal((14, 80 + 16 * i)))
             .astype(np.float32) for i in range(16)]
    prepared, shifts = [], []
    for f in files:
        xs, sh, _ = PK.shift_per_group(f)
        prepared.append(xs)
        shifts.append(sh)
    xs_b, lens = PW.pad_stack(prepared)
    return files, xs_b, np.asarray(shifts, np.float32), lens


@pytest.mark.parametrize("rows", [16, 6])
def test_sharded_traces_match(sweep_db, pmesh, jmesh, rows):
    """A divisible batch (16 over 8 shards) and one that pads and trims
    (6 over 8), against the port unsharded and the JAX mesh."""
    files, xs_b, shifts, _ = sweep_db
    block = files[3][:, 20:50].copy()
    pt, jt = PT(block), JT(block)
    s0, b0 = PW.batched_correlation_traces(xs_b[:rows], shifts[:rows], pt,
                                           0.5, 8.0, device="cpu")
    s1, b1 = PW.batched_correlation_traces(xs_b[:rows], shifts[:rows], pt,
                                           0.5, 8.0, mesh=pmesh)
    sj, bj = JW.batched_correlation_traces(xs_b[:rows], shifts[:rows], jt,
                                           0.5, 8.0, mesh=jmesh)
    assert s1.shape == s0.shape == sj.shape and s1.shape[0] == rows
    np.testing.assert_allclose(s1, s0, atol=1e-6, rtol=0)
    np.testing.assert_allclose(b1, b0, rtol=1e-6)
    # against the JAX package over each file's valid windows (past a
    # file's end the windows are degenerate FFT round-off)
    for i, f in enumerate(files[:rows]):
        w = f.shape[1] - pt.num_frames + 1
        np.testing.assert_allclose(s1[i, :w], sj[i, :w], atol=TRACE_TOL,
                                   rtol=0)
        np.testing.assert_allclose(b1[i, :w], bj[i, :w], rtol=1e-4)


def test_sharded_sweep_step_topk(sweep_db, pmesh, jmesh):
    files, xs_b, shifts, lens = sweep_db
    block = files[3][:, 20:50].copy()
    pt, jt = PT(block), JT(block)
    args = (pt.temporal_centered, pt.spectral_centered, pt.temporal_std,
            pt.spectral_std, pt.ln_avg_loudness)
    vals, idx = PW.sharded_sweep_step(pmesh)(xs_b, *args, shifts, lens,
                                             0.5, 8.0)
    assert vals.shape == idx.shape == (16, 4) and idx.dtype == np.int32
    assert idx[3, 0] == 20 and abs(vals[3, 0] - 1.0) < 1e-3
    one = PW.make_files_mesh(["cpu"])
    v1, i1 = PW.sharded_sweep_step(one)(xs_b, *args, shifts, lens, 0.5, 8.0)
    np.testing.assert_array_equal(idx, i1)
    np.testing.assert_allclose(vals, v1, atol=1e-6, rtol=0)
    jv, ji = JW.sharded_sweep_step(jmesh)(
        jnp.asarray(xs_b), jnp.asarray(jt.temporal_centered),
        jnp.asarray(jt.spectral_centered), jnp.float32(jt.temporal_std),
        jnp.float32(jt.spectral_std), jnp.float32(jt.ln_avg_loudness),
        jnp.asarray(shifts), jnp.asarray(lens), jnp.float32(0.5),
        jnp.float32(8.0))
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(vals, jv, atol=TRACE_TOL, rtol=0)
    # the best window equal wherever the JAX package's is decided
    decided = (jv[:, 0] - jv[:, 1]) > TRACE_TOL
    assert decided.sum() >= 8
    np.testing.assert_array_equal(idx[decided, 0], ji[decided, 0])
    with pytest.raises(ValueError):
        PW.sharded_sweep_step(pmesh)(xs_b[:6], *args, shifts[:6], lens[:6],
                                     0.5, 8.0)


@pytest.mark.parametrize("rows", [8, 6])
def test_batched_novelty_sharded(pmesh, jmesh, rows):
    rng = np.random.default_rng(3)
    xs_b = np.abs(0.5 + 0.1 * rng.standard_normal((8, 14, 700))
                  ).astype(np.float32)[:rows]
    s0 = PW.batched_novelty_traces(xs_b, 50, 0.5, device="cpu")
    s1 = PW.batched_novelty_traces(xs_b, 50, 0.5, mesh=pmesh)
    sj = JW.batched_novelty_traces(xs_b, 50, 0.5, mesh=jmesh)
    assert s1.shape == s0.shape == (rows, 601)
    np.testing.assert_allclose(s1, s0, atol=NOVELTY_TOL, rtol=0)
    np.testing.assert_allclose(s1, sj, atol=NOVELTY_TOL, rtol=0)


# ---------------------------------------------------------------------------
# batch extraction (tests/test_extract_mesh.py)
# ---------------------------------------------------------------------------

def _audios(seed, n, int16=False):
    rng = np.random.default_rng(seed)
    if int16:
        return [rng.integers(-2000, 2000, 4096 + 777 * i).astype(np.int16)
                for i in range(n)]
    return [(0.1 * rng.standard_normal(3000 + 517 * i)).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("n,int16", [(13, False), (5, True)])
def test_mesh_batch_extraction(pmesh, jmesh, n, int16):
    """13 float rows over 8 shards pad and trim; int16 rows keep the int16
    upload (the silent pad rows adopt the batch dtype)."""
    audios = _audios(42 + n, n, int16)
    base = PFE.extract_features_batch(audios, 44100.0, block_frames=256,
                                      device="cpu")
    out = PFE.extract_features_batch(audios, 44100.0, block_frames=256,
                                     mesh=pmesh)
    jout = JFE.extract_features_batch(audios, 44100.0, block_frames=256,
                                      mesh=jmesh)
    assert out.shape == base.shape == jout.shape
    np.testing.assert_allclose(out, base, atol=FEAT_TOL, rtol=0)
    np.testing.assert_allclose(out, jout, atol=FEAT_TOL, rtol=0)


def test_mesh_as_device_keeps_padded_rows_and_real_totals(pmesh):
    audios = _audios(3, 3)
    feats, totals = PFE.extract_features_batch(
        audios, 44100.0, block_frames=256, as_device=True, mesh=pmesh)
    assert len(feats) == 8 and all(f.shape[0] == 1 for f in feats)
    assert len(totals) == 3
    host = PW.fetch(feats)
    assert host.shape[0] == 8
    want = PFE.extract_features_batch(audios, 44100.0, block_frames=256,
                                      device="cpu")
    for i, t in enumerate(totals):
        np.testing.assert_allclose(PFE.finalize_features(host[i], t),
                                   want[i, :, :t], atol=FEAT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# sequence sharding of one long file (tests/test_long_file_sharding.py)
# ---------------------------------------------------------------------------

def test_long_file_trace_matches(pmesh, jmesh):
    rng = np.random.default_rng(0)
    x = np.abs(0.5 + 0.1 * rng.standard_normal((14, 3000))).astype(np.float32)
    xs, sh, sh_s = PK.shift_per_group(x)
    pt, jt = PT(x[:, 500:620].copy()), JT(x[:, 500:620].copy())
    single = PC.sliding_traces(xs, sh, sh_s, pt, 3000, 0.5, 8.0,
                               device="cpu")
    s, b = PW.sharded_long_file_trace(xs, sh, pt, 0.5, 8.0, pmesh)
    js, jb = JW.sharded_long_file_trace(xs, sh, jt, 0.5, 8.0, jmesh)
    assert s.shape == single[0].shape == js.shape == (3000 - 120 + 1,)
    np.testing.assert_allclose(s, single[0], atol=TRACE_TOL, rtol=0)
    np.testing.assert_allclose(b, single[1], rtol=1e-5)
    np.testing.assert_allclose(s, js, atol=TRACE_TOL, rtol=0)
    assert int(np.argmax(s)) == 500


def test_long_file_trace_uneven_split(pmesh, jmesh):
    """W = 101 windows over 8 shards: 13 a shard, the last one partial."""
    rng = np.random.default_rng(1)
    x = np.abs(0.5 + 0.1 * rng.standard_normal((6, 160))).astype(np.float32)
    xs, sh, _ = PK.shift_per_group(x)
    s, _ = PW.sharded_long_file_trace(xs, sh, PT(x[:, 30:90].copy()), 0.5,
                                      8.0, pmesh)
    js, _ = JW.sharded_long_file_trace(xs, sh, JT(x[:, 30:90].copy()), 0.5,
                                       8.0, jmesh)
    assert len(s) == 160 - 60 + 1 and int(np.argmax(s)) == 30
    np.testing.assert_allclose(s, js, atol=TRACE_TOL, rtol=0)
    empty = PW.sharded_long_file_trace(xs[:, :50], sh, PT(x[:, 30:90].copy()),
                                       0.5, 8.0, pmesh)
    assert empty[0].shape == empty[1].shape == (0,)


@pytest.mark.parametrize("T", [2500, 90])
def test_long_novelty_matches(pmesh, jmesh, T):
    """The time-sharded novelty curve against the single-device curve and
    the JAX mesh; T = 90 leaves 5 windows for 8 shards."""
    xs = _prepared(2, T=2500)[:, :T]
    h = 43
    single = PK.novelty_trace(torch.from_numpy(xs), h, 0.5).numpy()
    s = PW.sharded_long_novelty_trace(xs, h, 0.5, pmesh)
    js = JW.sharded_long_novelty_trace(xs, h, 0.5, jmesh)
    assert s.shape == single.shape == js.shape == (T - 2 * h + 1,)
    np.testing.assert_allclose(s, single, atol=NOVELTY_TOL, rtol=0)
    np.testing.assert_allclose(s, js, atol=NOVELTY_TOL, rtol=0)


def test_long_novelty_keeps_the_silence_repair(pmesh):
    """A sharded curve is NaN exactly where the unsharded one is."""
    from test_torch_segmentation import _with_silence

    xs = PK.shift_per_group(_with_silence(5, 800, 400, 520))[0]
    single = PK.novelty_trace(torch.from_numpy(xs), 20, 0.5).numpy()
    s = PW.sharded_long_novelty_trace(xs, 20, 0.5, pmesh)
    np.testing.assert_array_equal(np.isnan(s), np.isnan(single))
    assert np.isnan(s).sum() == 120 - 40 + 1
    ok = ~np.isnan(single)
    np.testing.assert_allclose(s[ok], single[ok], atol=NOVELTY_TOL, rtol=0)


def test_segment_features_mesh_matches_breaks(pmesh, jmesh):
    rng = np.random.default_rng(5)
    f = np.abs(0.5 + 0.1 * rng.standard_normal((14, 1800))).astype(np.float32)
    f[:, 600:] += 0.4
    f[:, 1200:] -= 0.35
    cfg = SegmentationConfig(meta_input="x", corr_len=22050, num_breaks=4,
                             min_spacing=22050, normalize=False).build()
    pcfg = to_port(cfg)
    base = PSG.segment_features(f, None, STEP, pcfg, device="cpu")
    sharded = PSG.segment_features(f, None, STEP, pcfg, mesh=pmesh)
    jax_sharded = JSG.segment_features(f, None, STEP, cfg, mesh=jmesh)
    for other in (base, jax_sharded):
        assert [b.pos for b in sharded] == [b.pos for b in other]
        for a, b in zip(sharded, other):
            assert abs(a.sim - b.sim) < NOVELTY_TOL


def test_segment_batch_mesh_matches_per_file(pmesh, jmesh):
    rng = np.random.default_rng(4)
    cfg = SegmentationConfig(corr_len=44100, num_breaks=6,
                             min_spacing=22050, temporal_weight=0.5,
                             span=Span()).build()
    pcfg = to_port(cfg)
    feats = [np.abs(0.5 + 0.2 * rng.standard_normal((14, 900 + 7 * i))
                    ).astype(np.float32) for i in range(6)]
    got = PSG.segment_features_batch(feats, None, STEP, pcfg, mesh=pmesh)
    want = JSG.segment_features_batch(feats, None, STEP, cfg, mesh=jmesh)
    singles = [PSG.segment_features(f, None, STEP, pcfg, device="cpu")
               for f in feats]
    for g, w, s in zip(got, want, singles):
        for other in (w, s):
            assert [b.pos for b in g] == [b.pos for b in other]
            assert all(abs(a.sim - b.sim) < NOVELTY_TOL
                       for a, b in zip(g, other))


@pytest.mark.parametrize("int16", [False, True])
def test_sharded_extract_long_matches_sequential(pmesh, jmesh, int16):
    """The one-halo-frame carry: each shard's first frame equals the
    sequential pipeline's; a frame count the shards do not divide."""
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal(44100 * 3 + 777)).astype(np.float32)
    if int16:
        x = np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    got = PW.sharded_extract_long(x, 44100.0, pmesh)
    seq = PFE.extract_features(x, 44100.0, device="cpu")
    jgot = JW.sharded_extract_long(x, 44100.0, jmesh)
    assert got.shape == seq.shape == jgot.shape
    np.testing.assert_allclose(got, seq, atol=FEAT_TOL, rtol=0)
    np.testing.assert_allclose(got, jgot, atol=FEAT_TOL, rtol=0)


def test_sharded_extract_long_threads_masks_and_refuses_feedback(
        pmesh, monkeypatch):
    rng = np.random.default_rng(4)
    x = (0.3 * rng.standard_normal(44100 * 2)).astype(np.float32)
    got = PW.sharded_extract_long(x, 44100.0, pmesh, smask=0.5, tmask=0.7)
    want = PFE.extract_features(x, 44100.0, smask=0.5, tmask=0.7,
                                device="cpu")
    np.testing.assert_allclose(got, want, atol=FEAT_TOL, rtol=0)
    assert not np.allclose(got, PFE.extract_features(x, 44100.0,
                                                     device="cpu"),
                           atol=FEAT_TOL)
    assert PW.sharded_extract_long(x[:100], 44100.0, pmesh).shape == (14, 0)
    monkeypatch.setattr(PFE.C, "TMASK_FORM", "feedback")
    with pytest.raises(NotImplementedError, match="prev_frame"):
        PW.sharded_extract_long(x, 44100.0, pmesh)


# ---------------------------------------------------------------------------
# -c under a mesh (tests/test_extract_mesh.py::test_correlate_database_...)
# ---------------------------------------------------------------------------

def _corr_case(rng, C, T, n, L):
    files = []
    for i in range(n):
        base = rng.uniform(0.3, 0.7, size=(C, 1))
        files.append((f"db{i}.aif", np.abs(
            base + 0.1 * rng.standard_normal((C, T))).astype(np.float32)))
    inp = np.abs(0.5 + 0.1 * rng.standard_normal((C, 5 * L))).astype(
        np.float32)
    return files, inp


@pytest.mark.parametrize("punch_out", [False, True])
def test_correlate_database_mesh_matches(monkeypatch, pmesh, jmesh,
                                         punch_out):
    """10 files in a 32-file chunk over 8 shards (padding rows live on the
    last shards): the same matches as the port unsharded and the JAX
    mesh, sims within 3e-5, the planted file first."""
    rng = np.random.default_rng(11)
    files, inp = _corr_case(rng, 14, 400, 10, 40)
    files[3][1][:, 120:160] = inp[:, 20:60]
    files[3][1][:, 200:230] = inp[:, 100:130]
    meta = ExtractionConfig(audio_input="in.aif", feature_output="mem",
                            num_coeffs=13, fft_size=1024, fft_overlap=2)
    entries = [(ExtractionConfig(audio_input=n, feature_output=n),
                (lambda f_=f: f_)) for n, f in files]
    monkeypatch.setattr(JC, "read_features", lambda m: inp)
    monkeypatch.setattr(PC, "read_features", lambda m: inp)
    cfg = CorrelationConfig(
        database_folder="db", meta_input="in_feat.xml",
        punch_in=Punch(Span(20 * STEP, 60 * STEP), 0.5),
        punch_out=Punch(Span(100 * STEP, 130 * STEP), 0.5)
        if punch_out else None,
        min_punch=30 * STEP, max_punch=120 * STEP,
        num_matches=4, num_per_file=2, normalize=False).build()
    pcfg, pmeta = to_port(cfg), to_port(meta)
    pentries = [(to_port(e), ld) for e, ld in entries]
    base = PC.correlate_database(pmeta, pentries, None, pcfg, device="cpu")
    sharded = PC.correlate_database(pmeta, pentries, None, pcfg, mesh=pmesh)
    jax_sharded = JC.correlate_database(meta, entries, None, cfg, mesh=jmesh)
    for other in (base, jax_sharded):
        assert [(m.file, m.punch.start, m.punch.stop) for m in sharded] == \
            [(m.file, m.punch.start, m.punch.stop) for m in other]
        for a, b in zip(sharded, other):
            if np.isnan(b.sim):
                assert np.isnan(a.sim), (a, b)
            else:
                assert abs(a.sim - b.sim) < TRACE_TOL, (a, b)
    if not punch_out:
        assert sharded[0].file == "db3.aif"


# ---------------------------------------------------------------------------
# -x under a mesh (tests/test_sharded_gram_novelty.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decim", [1, 2])
def test_sharded_gram_matrix(pmesh, jmesh, decim):
    xs = _prepared(0, T=1300)
    m0 = PSS.self_similarity_matrix(xs, xs, 40, decim, 0.5, device="cpu")
    m1 = PSS.self_similarity_matrix(xs, xs, 40, decim, 0.5, mesh=pmesh)
    mj = JSS.self_similarity_matrix(xs, xs, half_win=40, decim=decim,
                                    temp_weight=0.5, mesh=jmesh)
    assert m1.shape == m0.shape == mj.shape and m1.shape[0] > 512
    np.testing.assert_allclose(m1, m0, atol=GRAM_TOL, rtol=0)
    np.testing.assert_allclose(m1, mj, atol=GRAM_TOL, rtol=0)


def test_sharded_gram_splits_a_chunk_over_the_shards(pmesh, monkeypatch):
    """A chunk of ``_PAIRS_PER_CALL × 8`` pairs goes out as one contiguous
    slice of pairs per shard, reassembled in pair order; the stacks are
    replicated once per distinct device."""
    monkeypatch.setattr(PSS, "_PAIRS_PER_CALL", 3)
    xs = _prepared(6)
    n, nb, res1, res2 = PSS._prep_resident(xs, xs, 40, 1, mesh=pmesh)
    assert len(res1) == 8 and all(r is res1[0] for r in res1)
    pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
    chunk = (pairs * 200)[:PSS._PAIRS_PER_CALL * 8]
    parts = PSS._dispatch_pairs_fast(res1, res2, chunk, 0.5, mesh=pmesh)
    assert len(parts) == 8
    assert all(p.shape[0] == PSS._PAIRS_PER_CALL for p in parts)
    _, _, r1, _ = PSS._prep_resident(xs, xs, 40, 1, device="cpu")
    want = PSS._dispatch_pairs_fast(r1, r1, chunk, 0.5).numpy()
    np.testing.assert_allclose(PW.fetch(parts), want, atol=GRAM_TOL, rtol=0)
    ragged = PSS._dispatch_pairs_fast(res1, res2, chunk[:11], 0.5,
                                      mesh=pmesh)
    assert [p.shape[0] for p in ragged] == [2, 2, 2, 2, 2, 1]
    np.testing.assert_allclose(PW.fetch(ragged), want[:11], atol=GRAM_TOL,
                               rtol=0)


def test_sharded_gram_image_and_png(pmesh, tmp_path):
    """The device colorization of the sharded sims is bit-equal to the
    host quantization of the same sims, and the stripe-streamed PNG is
    byte-equal to the in-memory image of the mesh engine."""
    from strugatzki_tpu_torch.util.png import write_png

    xs = _prepared(1, T=760)
    m = PSS.self_similarity_matrix(xs, xs, 30, 1, 0.5, mesh=pmesh)
    for colors, ceil in (("psycho", 0.9), ("gray", 1.0)):
        img = PSS.self_similarity_image(xs, xs, 30, 1, 0.5, colors=colors,
                                        color_ceil=ceil, mesh=pmesh)
        np.testing.assert_array_equal(
            img, PSS.render_image(m, colors, 1.0, ceil, False))
    img = PSS.self_similarity_image(xs, xs, 30, 1, 0.5, mesh=pmesh)
    write_png(tmp_path / "matrix.png", img)
    n = PSS.self_similarity_to_png(xs, xs, 30, 1, 0.5,
                                   tmp_path / "streamed.png", mesh=pmesh)
    assert n == img.shape[0] > 512
    assert (tmp_path / "matrix.png").read_bytes() == \
        (tmp_path / "streamed.png").read_bytes()


# ---------------------------------------------------------------------------
# the factories' classvars and the CLI's STRUGATZKI_MESH gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feature_db(tmp_path_factory):
    """Two 3 s sounds extracted by the port into a feature folder."""
    from strugatzki_tpu_torch.analysis.extraction import extract_batch_cli
    from strugatzki_tpu_torch.io import audiofile as paf
    from strugatzki_tpu_torch.io import AIFF, AudioFileSpec, SampleFormat

    root = tmp_path_factory.mktemp("mesh_db")
    rng = np.random.default_rng(5)
    paths = []
    for name, n in (("xa", 3 * 44100), ("xb", 44100)):
        x = (0.2 * rng.standard_normal(n)).astype(np.float32)
        x[n // 3:n // 3 + 8000] *= 4.0                  # a loud passage
        p = root / f"{name}.aif"
        paf.write(p, x[None], AudioFileSpec(AIFF, SampleFormat.INT16, 1,
                                            44100.0))
        paths.append(str(p))
    db = root / "db"
    db.mkdir()
    assert extract_batch_cli(paths, str(db), 0, device="cpu") == 0
    from strugatzki_tpu_torch.cli import main
    assert main(["--stats", "-d", str(db)]) == 0
    return db


def _factories():
    from strugatzki_tpu_torch import (CrossSimilarity, FeatureCorrelation,
                                      FeatureSegmentation, SelfSimilarity)
    return (FeatureCorrelation, FeatureSegmentation, SelfSimilarity,
            CrossSimilarity)


@pytest.fixture
def port_factories_on_cpu(monkeypatch):
    for f in _factories():
        monkeypatch.setattr(f, "device", "cpu")
        monkeypatch.setattr(f, "mesh", None)


@pytest.mark.parametrize("decim", [1, 2])
def test_selfsim_factory_mesh(feature_db, pmesh, port_factories_on_cpu,
                              tmp_path, decim):
    """``SelfSimilarity.mesh``: the PNG of the 8-shard render decodes to
    the unsharded render's pixels."""
    from strugatzki_tpu_torch import SelfSimilarity, SelfSimilarityConfig
    from test_torch_selfsim import decode_png

    out = {}
    for tag, mesh in (("one", None), ("mesh", pmesh)):
        SelfSimilarity.mesh = mesh
        path = tmp_path / f"{tag}.png"
        SelfSimilarity.run(SelfSimilarityConfig(
            meta_input=str(feature_db / "xa_feat.xml"),
            database_folder=str(feature_db), image_output=str(path),
            corr_len=2048, decimation=decim)).result(timeout=300)
        out[tag] = decode_png(path)
    assert out["mesh"].shape == out["one"].shape
    np.testing.assert_array_equal(out["mesh"], out["one"])


def test_cross_and_segmentation_factories_mesh(feature_db, pmesh,
                                               port_factories_on_cpu,
                                               tmp_path):
    """``CrossSimilarity.mesh`` (time-sharded trace) and
    ``FeatureSegmentation.mesh`` (time-sharded novelty) against their
    unsharded runs."""
    from strugatzki_tpu_torch import (CrossSimilarity, CrossSimilarityConfig,
                                      FeatureSegmentation)
    from strugatzki_tpu_torch.config import \
        SegmentationConfig as PSegmentationConfig
    from strugatzki_tpu_torch.io import audiofile as paf

    sims = {}
    for tag, mesh in (("one", None), ("mesh", pmesh)):
        CrossSimilarity.mesh = mesh
        cfg = CrossSimilarityConfig(
            meta_input1=str(feature_db / "xa_feat.xml"),
            meta_input2=str(feature_db / "xb_feat.xml"),
            database_folder=str(feature_db))
        cfg.set_audio_output(str(tmp_path / f"{tag}.aif"))
        CrossSimilarity.run(cfg).result(timeout=300)
        sims[tag] = paf.read(str(tmp_path / f"{tag}.aif"))[0]
    assert sims["mesh"].shape == sims["one"].shape
    np.testing.assert_allclose(sims["mesh"], sims["one"], atol=TRACE_TOL,
                               rtol=0)

    breaks = {}
    for tag, mesh in (("one", None), ("mesh", pmesh)):
        FeatureSegmentation.mesh = mesh
        breaks[tag] = FeatureSegmentation.run(PSegmentationConfig(
            meta_input=str(feature_db / "xa_feat.xml"), corr_len=4096,
            database_folder=str(feature_db),
            num_breaks=4)).result(timeout=300)
    assert [b.pos for b in breaks["mesh"]] == [b.pos for b in breaks["one"]]


@pytest.fixture
def cpu_mesh_factory(monkeypatch):
    """The mesh factory ``env_mesh`` uses, as if the host had 8 devices."""
    monkeypatch.setattr(PW, "_local_devices",
                        lambda: [torch.device("cpu")] * 8)


def test_env_mesh_off_spellings(monkeypatch, cpu_mesh_factory):
    for off in ("", "0", "false", "False", "no", "off", "  0  "):
        monkeypatch.setenv("STRUGATZKI_MESH", off)
        assert PW.env_mesh() is None, repr(off)
    monkeypatch.delenv("STRUGATZKI_MESH")
    assert PW.env_mesh() is None
    for on in ("1", "true", "2", "yes"):
        monkeypatch.setenv("STRUGATZKI_MESH", on)
        assert PW.env_mesh().size == 8, repr(on)
    monkeypatch.setattr(PW, "_local_devices",
                        lambda: [torch.device("cpu")])
    assert PW.env_mesh() is None        # one device: the single paths


def test_cli_env_gate_sets_and_clears(feature_db, monkeypatch, tmp_path,
                                      cpu_mesh_factory,
                                      port_factories_on_cpu):
    """``STRUGATZKI_MESH=1`` sets every factory's mesh on each invocation
    and the results equal the unsharded run; a run without it clears the
    previous run's mesh."""
    from strugatzki_tpu_torch import cli
    from strugatzki_tpu_torch import FeatureSegmentation

    args = ["--no-norm", "--length", "0.05", "-m", "2", "--device", "cpu",
            str(feature_db / "xa_feat.xml")]
    monkeypatch.setenv("STRUGATZKI_MESH", "1")
    assert cli.feature_segm(args) == 0
    assert FeatureSegmentation.mesh is not None
    assert FeatureSegmentation.mesh.size == 8
    png = tmp_path / "xa.png"
    assert cli.feature_self(["--no-norm", "--length", "0.05", "--device",
                             "cpu", str(feature_db / "xa_feat.xml"),
                             str(png)]) == 0
    assert png.stat().st_size > 0
    assert cli.feature_cross(["--no-norm", "--device", "cpu",
                              str(feature_db / "xa_feat.xml"),
                              str(feature_db / "xb_feat.xml"),
                              str(tmp_path / "x.aif")]) == 0
    assert all(f.mesh is not None for f in _factories()[1:])
    monkeypatch.delenv("STRUGATZKI_MESH")
    assert cli.feature_segm(args) == 0
    assert FeatureSegmentation.mesh is None


def test_cli_extraction_gate(tmp_path, monkeypatch, cpu_mesh_factory):
    """``-f`` under the gate writes the unsharded run's features."""
    from strugatzki_tpu_torch.analysis.extraction import extract_batch_cli
    from strugatzki_tpu_torch.io import audiofile as paf
    from strugatzki_tpu_torch.io import AIFF, AudioFileSpec, SampleFormat

    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        x = (0.2 * rng.standard_normal(20000 + 3000 * i)).astype(np.float32)
        p = tmp_path / f"s{i}.aif"
        paf.write(p, x[None], AudioFileSpec(AIFF, SampleFormat.INT16, 1,
                                            44100.0))
        paths.append(str(p))
    for tag, env in (("db0", None), ("db1", "1")):
        (tmp_path / tag).mkdir()
        if env is None:
            monkeypatch.delenv("STRUGATZKI_MESH", raising=False)
        else:
            monkeypatch.setenv("STRUGATZKI_MESH", env)
        assert extract_batch_cli(paths, str(tmp_path / tag), 0,
                                 device="cpu") == 0
    for i in range(3):
        a, _ = paf.read(str(tmp_path / "db0" / f"s{i}_feat.aif"))
        b, _ = paf.read(str(tmp_path / "db1" / f"s{i}_feat.aif"))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=FEAT_TOL, rtol=0)
        assert os.path.exists(tmp_path / "db1" / f"s{i}_feat.xml")
