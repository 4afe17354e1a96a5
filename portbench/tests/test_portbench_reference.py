"""The plain references against the port at a tiny size on the CPU."""

import json
import math
import os

import numpy as np
import pytest
import torch

from portbench.reference import correlate as RC
from portbench.reference import frontend as RF
from portbench.reference import serve as RS
from portbench.traffic import sound

RATE, STEP = 44100, 512
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _loudness():
    with open(os.path.join(CONFIGS, "slice20.json")) as f:
        return json.load(f)["loudness"]


def _iso():
    with open(RF._TABLES) as f:
        return json.load(f)["iso226_2003"]


def test_contours_equal_the_ports_table():
    from strugatzki_tpu_torch.dsp import ml_tables

    ref = RF.contours(_loudness(), _iso())
    port = ml_tables.contour_table(float(RATE), 1024)
    assert ref.shape == port.shape == (42, 11)
    assert np.abs(ref - port).max() < 1e-9


@pytest.mark.parametrize("key,index", [("slope_trim", 6),
                                       ("anchor_err_pct", 0)])
def test_contours_follow_the_configuration(key, index):
    """A slope setting moved by 0.01 moves the table: the reference reads
    the configuration, not a frozen copy."""
    ld = _loudness()
    before = RF.contours(ld, _iso())
    ld[key] = list(ld[key])
    ld[key][index] += 0.01
    assert np.abs(RF.contours(ld, _iso()) - before).max() > 1e-4


def test_frozen_band_edges_follow_the_erb_rule():
    """ML.cpp's eqlbandbins, frozen in the tables, are the Glasberg-Moore
    rule ``bin_k = max(prev + 1, ceil(f(E = k) / bin width))``."""
    with open(RF._TABLES) as f:
        edges = json.load(f)["erb_band_edges"]
    ea, eb = _loudness()["erb_scale"]
    prev, rule = 0, []
    for k in range(1, 43):
        b = max(math.ceil((10.0 ** (k / ea) - 1.0) / eb / (RATE / 1024)),
                prev + 1)
        rule.append(b)
        prev = b
    assert edges[:-1] == rule and edges[-1] == 1024 // 2 + 1


def test_frontend_reference_holds_the_port():
    from strugatzki_tpu_torch.analysis.extraction import fix_nans
    from strugatzki_tpu_torch.dsp.frontend import extract_features

    rng = np.random.default_rng(5)
    pcm = sound.to_pcm16(sound.noise(rng, 3, RATE))
    port = fix_nans(extract_features(pcm, float(RATE), device="cpu"))
    ref, lo, hi = RF.features(pcm, RF.Basis(RATE, 1024, 13, _loudness()),
                              STEP, "cpu")
    assert port.shape == ref.shape == (14, RF.num_frames(len(pcm), STEP))
    assert np.abs(port[1:] - ref[1:]).max() < 2e-5
    assert (lo <= ref[0] + 1e-12).all() and (ref[0] <= hi + 1e-12).all()
    assert np.maximum(port[0] - hi, lo - port[0]).max() < 2e-5


def test_percentiles_equal_the_port_stats(tmp_path):
    from strugatzki_tpu_torch.analysis.feature_stats import stats_for_file
    from strugatzki_tpu_torch.io import audiofile as af

    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 0.6, (1, 5000)),
                        rng.normal(0.5, 0.1, (13, 5000))]).astype(np.float32)
    path = str(tmp_path / "a_feat.aif")
    af.write(path, x, af.feature_spec(14, RATE / STEP))
    p01, p99 = stats_for_file(path)
    q01, q99 = RC.percentiles(x)
    assert np.array_equal(p01, q01) and np.array_equal(p99, q99)


def _db(n=24, T=1500, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 14, T), generator=g)


def _normed_db(n=24, T=1500, seed=0):
    """Features inside per-channel (min, max) rows of distinct offsets and
    widths, and those rows."""
    lo = torch.linspace(-2.0, 1.5, 14, dtype=torch.float64)
    width = torch.logspace(-0.6, 0.6, 14, dtype=torch.float64).flip(0)
    norm = torch.stack([lo, lo + width], 1).float()
    lo, width = norm[:, :1], norm[:, 1:] - norm[:, :1]
    return _db(n, T, seed) * width + lo, norm.numpy()


@pytest.mark.parametrize("punch", [False, True])
def test_serve_reference_holds_the_database(punch):
    from strugatzki_tpu_torch.analysis.correlation import InputTemplate
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    feats, norm = _normed_db()
    arr = feats.numpy()
    db = FeatureDatabase([(f"f{i}", arr[i]) for i in range(len(arr))], norm,
                         device="cpu", cache_spectra=True)
    f, a, L_in, L_out, mp, xp = 7, 200, 90, 40, 120, 170
    t_in = InputTemplate.from_features(arr[f], norm, a, a + L_in)
    x = RS.normalise(feats.double(), torch.as_tensor(norm).double())
    spec = RS.Spectra(x)
    s_in, b_in = spec.trace(x[f, :, a:a + L_in], 0.5, 8.0)
    if punch:
        o = a + mp + 13
        t_out = InputTemplate.from_features(arr[f], norm, o, o + L_out)
        res = db.query_punch(t_in, t_out, mp, xp, k=4)
        s_out, b_out = spec.trace(x[f, :, o:o + L_out], 0.5, 8.0)
        score = RS.band_best(s_in, s_out, 1500, L_in, L_out, mp, xp)
        top = RS.punch_topk(score, 4).numpy()
        at = score.gather(1, torch.as_tensor(res.frames).long()).numpy()
        assert int(res.punch_lens[f, 0]) == 13
    else:
        res = db.query(t_in, k=4)
        top = RS.query_topk(s_in, 1500, L_in, 4).numpy()
        at = s_in.gather(1, torch.as_tensor(res.frames).long()).numpy()
        assert np.allclose(res.boosts, b_in.gather(
            1, torch.as_tensor(res.frames).long()).numpy(), rtol=1e-5)
    assert int(res.frames[f, 0]) == a and res.sims[f, 0] > 0.999
    assert np.abs(res.sims - at).max() < 1e-5
    assert np.abs(top - at).max() < 1e-5


def test_direct_trace_equals_the_fft_trace():
    x = RS.normalise(_db(2, 800).double(), torch.tensor([[0.0, 1.0]] * 14,
                                                       dtype=torch.float64))
    tmpl = x[1, :, 100:160]
    s1, b1 = RS.Spectra(x).trace(tmpl, 0.5, 8.0)
    s2, b2 = RS.direct_trace(x[0], tmpl, 0.5, 8.0)
    assert torch.allclose(s1[0], s2, atol=1e-12)
    assert torch.allclose(b1[0], b2, rtol=1e-12)


@pytest.mark.parametrize("pair,n", [((86, 172), 1), ((10, 250), 3)])
def test_search_reference_holds_feature_correlation(tmp_path, pair, n):
    """-f, --stats and -c through the port on the CPU over a tiny folder;
    the reference search over the same feature files agrees.  The planted
    pair scores ~1, and the scan's gates then keep every other file out."""
    from strugatzki_tpu_torch import (CorrelationConfig, FeatureCorrelation,
                                      Punch, Span)
    from strugatzki_tpu_torch.cli import main
    from portbench import aiff

    cfg = {"files": 3, "seconds": 4, "sample_rate": RATE,
           "extraction": {"step": STEP},
           "planted": {"in_s": [1.0, 1.5], "out_s": [2.0, 2.25],
                       "shift_in": 40, "shift_out": 20, "margin": 1024}}
    snd, db = tmp_path / "snd", tmp_path / "db"
    snd.mkdir()
    db.mkdir()
    pcm, target = sound.write_folder(cfg, 11, str(snd))
    assert main(["-f", "-d", str(db), "--device", "cpu", str(snd)]) == 0
    assert main(["--stats", "-d", str(db)]) == 0
    spans = [(pair[0] * STEP, pair[0] * STEP + int(0.5 * RATE)),
             (pair[1] * STEP, pair[1] * STEP + int(0.25 * RATE))]
    FeatureCorrelation.device = "cpu"
    FeatureCorrelation.skip_nan = True
    ccfg = CorrelationConfig(
        database_folder=str(db), meta_input=str(db / "query_feat.xml"),
        punch_in=Punch(Span(*spans[0]), 0.5),
        punch_out=Punch(Span(*spans[1]), 0.5),
        min_punch=int(0.6 * RATE), max_punch=int(1.0 * RATE), num_matches=3)
    matches = FeatureCorrelation.run(ccfg).result()
    names = sorted(n for n in pcm if n != "query.aif")
    feats = {n: aiff.read(str(db / (n[:-4] + "_feat.aif")))[0] for n in pcm}
    norm = RC.norms([feats[n] for n in sorted(feats)])
    stored = aiff.read(str(db / "feat_norms.aif"))[0]
    assert np.array_equal(stored, norm)
    score_at, ranked = RC.search(
        [feats[n] for n in names], feats["query.aif"], norm, spans,
        int(0.6 * RATE), int(1.0 * RATE), STEP, 0.5, 8.0, 3, "cpu")
    assert len(matches) == len(ranked) == n
    if n == 1:
        assert os.path.basename(matches[0].file) == target
    for m, r in zip(matches, ranked):
        f = names.index(os.path.basename(m.file))
        sim, bi, bo = score_at(f, m.punch.start // STEP, m.punch.stop // STEP)
        assert (f, m.punch.start // STEP, m.punch.stop // STEP) == r[1:4]
        assert abs(m.sim - sim) < 3e-5 and abs(r[0] - sim) < 1e-12
        assert math.isclose(m.boost_in, bi, rel_tol=1e-5)
        assert math.isclose(m.boost_out, bo, rel_tol=1e-5)
