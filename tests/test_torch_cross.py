"""The port's cross-similarity (``-y``) against the JAX package on the CPU,
through both factories on the cases of tests/test_stats_selfsim_cross.py:
template detection, the swap of a longer input 1, and seeded fuzz against
the f64 mirror ``kernels/mathref.py``.

Tolerances: output sims within 3e-5 of the JAX package's and of the mirror
(the sliding-trace budget of docs/PARITY.md); lengths (``len2 − len1 + 1``)
and rates (input 1's) equal.
"""

import os

import numpy as np
import pytest
import torch

from strugatzki_tpu.analysis import cross_similarity as JX
from strugatzki_tpu.config import CrossSimilarityConfig, ExtractionConfig
from strugatzki_tpu.io import audiofile as af
from strugatzki_tpu.kernels import mathref as M
from strugatzki_tpu.span import Span
from strugatzki_tpu_torch import config as PC
from strugatzki_tpu_torch import span as PS
from strugatzki_tpu_torch.analysis import cross_similarity as PX


def _write_feat(path, data, rate=44100 / 512):
    af.write(path, data.astype(np.float32),
             af.feature_spec(data.shape[0], rate))


def _meta(d, name, feats, rate=44100 / 512, **extr):
    fp = os.path.join(d, f"{name}_feat.aif")
    mp = os.path.join(d, f"{name}_feat.xml")
    _write_feat(fp, feats, rate)
    ExtractionConfig(audio_input=os.path.join(d, f"{name}.aif"),
                     feature_output=fp, meta_output=mp, **extr).save_xml(mp)
    return mp


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setattr(PX.CrossSimilarity, "device", "cpu")


def _port_span(span):
    return PS.Span(span.start, span.stop)


def _port_config(**cfg):
    """The port's own ``CrossSimilarityConfig`` of JAX-package fields."""
    return PC.CrossSimilarityConfig(**{
        k: _port_span(v) if isinstance(v, Span) else v
        for k, v in cfg.items()})


def _both(d, m1, m2, **cfg):
    """Run the JAX and the port factory on the same fields, each with its
    own package's config, check that they agree, and return the port's
    ``(sims, spec)``."""
    out = {}
    for tag, factory, make in (
            ("jax", JX.CrossSimilarity, CrossSimilarityConfig),
            ("port", PX.CrossSimilarity, _port_config)):
        path = os.path.join(d, f"{tag}.aif")
        c = make(meta_input1=m1, meta_input2=m2, **cfg)
        c.set_audio_output(path)
        factory.run(c).result(timeout=300)
        out[tag] = af.read(path)
    (p, ps), (j, js) = out["port"], out["jax"]
    assert ps == js and p.shape == j.shape
    np.testing.assert_allclose(p, j, atol=3e-5, rtol=0)
    return p[0], ps


def test_detects_template(tmp_path):
    rng = np.random.default_rng(5)
    long = np.abs(0.5 + 0.12 * rng.standard_normal((14, 400))).astype(
        np.float32)
    mt = _meta(tmp_path, "tmpl", long[:, 250:290].copy())
    ml = _meta(tmp_path, "long", long)
    sims, spec = _both(tmp_path, mt, ml, normalize=False)
    assert spec.num_channels == 1 and spec.num_frames == 400 - 40 + 1
    assert abs(spec.sample_rate - 44100 / 512) < 1e-4
    assert int(np.argmax(sims)) == 250 and sims[250] > 0.999


def test_longer_input1_is_swapped_and_keeps_its_rate(tmp_path):
    rng = np.random.default_rng(10)
    long = np.abs(0.5 + 0.12 * rng.standard_normal((14, 300))).astype(
        np.float32)
    m1 = _meta(tmp_path, "long", long, rate=22050 / 512)
    m2 = _meta(tmp_path, "short", long[:, 100:160].copy())
    sims, spec = _both(tmp_path, m1, m2, normalize=False)
    assert spec.num_frames == 300 - 60 + 1
    assert abs(spec.sample_rate - 22050 / 512) < 1e-4     # input 1's rate
    assert int(np.argmax(sims)) == 100


def test_spans_and_norm(tmp_path):
    rng = np.random.default_rng(6)
    f1 = np.abs(0.5 + 0.12 * rng.standard_normal((14, 500))).astype(
        np.float32)
    f2 = f1[:, 200:320].copy()
    norm = np.stack([f1.min(axis=1) - 1e-3, f1.max(axis=1) + 1e-3], 1)
    af.write(os.path.join(tmp_path, "feat_norms.aif"), norm.astype(np.float32),
             af.AudioFileSpec(num_channels=14, sample_rate=44100.0))
    m1, m2 = _meta(tmp_path, "a", f1), _meta(tmp_path, "b", f2)
    sims, spec = _both(tmp_path, m1, m2, database_folder=str(tmp_path),
                       span1=Span(100 * 512, 480 * 512),
                       span2=Span.from_(20 * 512), temporal_weight=0.3)
    assert spec.num_frames == 380 - 100 + 1
    assert int(np.argmax(sims)) == 120


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_matches_jax_and_mathref(tmp_path, seed):
    """Randomized lengths, norms, weights and boost limits: every output
    sample against the f64 mirror of the intended semantics (shorter span
    as template, ``len2 − len1 + 1`` windows, boost gate)."""
    rng = np.random.default_rng(3000 + seed)
    C = 14
    t1, t2 = int(rng.integers(40, 300)), int(rng.integers(40, 300))
    f1 = np.abs(0.5 + 0.12 * rng.standard_normal((C, t1))).astype(np.float32)
    f2 = np.abs(0.5 + 0.12 * rng.standard_normal((C, t2))).astype(np.float32)
    norm = None
    if rng.random() < 0.5:
        allf = np.concatenate([f1, f2], axis=1)
        norm = np.stack([allf.min(axis=1) - 1e-3, allf.max(axis=1) + 1e-3],
                        axis=1).astype(np.float32)
        af.write(os.path.join(tmp_path, "feat_norms.aif"), norm,
                 af.AudioFileSpec(num_channels=C, sample_rate=44100.0))
    w = float(rng.choice([0.0, 0.5, 1.0]))
    max_boost = float(rng.choice([2.0, 8.0]))
    m1, m2 = _meta(tmp_path, "a", f1), _meta(tmp_path, "b", f2)
    sims, _ = _both(tmp_path, m1, m2, temporal_weight=w,
                    normalize=norm is not None,
                    database_folder=str(tmp_path), max_boost=max_boost)

    a, b = (f1, f2) if t1 < t2 else (f2, f1)
    an, bn = a.copy(), b.copy()
    M.normalize(norm, an, 0, an.shape[1])
    M.normalize(norm, bn, 0, bn.shape[1])
    L = an.shape[1]
    mean_t, std_t = M.stat(an, 0, L, 0, 1)
    mean_s, std_s = M.stat(an, 0, L, 1, C - 1)
    ln_avg = np.log(np.float64(M.avg(an[0], 0, L)))
    W = bn.shape[1] - L + 1
    assert len(sims) == W
    for t in range(0, W, max(1, W // 17)):
        win = bn[:, t:t + L]
        boost = np.float32(np.exp(
            (ln_avg - np.log(np.float64(M.avg(win[0], 0, L)))) / 0.6))
        if boost <= max_boost:
            bm_t, bs_t = M.stat(win, 0, L, 0, 1)
            bm_s, bs_s = M.stat(win, 0, L, 1, C - 1)
            st = M.correlate(an[:1], mean_t, std_t, L, 1, win, bm_t, bs_t,
                             0, 0) if w > 0 else np.float32(0)
            ss = M.correlate(an[1:], mean_s, std_s, L, C - 1, win, bm_s, bs_s,
                             0, 1) if w < 1 else np.float32(0)
            ref = np.float32(st * np.float32(w) + ss * np.float32(1 - w))
        else:
            ref = np.float32(0)
        assert abs(float(sims[t]) - float(ref)) < 3e-5, (seed, t)


def test_copied_open_span_equals_the_original():
    extr = ExtractionConfig(audio_input="a.aif")
    p_extr = PC.ExtractionConfig(audio_input="a.aif")
    for span in (Span.all(), Span(1000, 90000), Span.from_(5000),
                 Span.until(70000), Span(-3000, 10 ** 9), Span(0, 0)):
        for n in (0, 50, 200):
            assert PX._open_span(p_extr, _port_span(span), n) == \
                JX._open_span(extr, span, n)


def test_rejections(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    f = np.abs(0.5 + 0.1 * rng.standard_normal((14, 100))).astype(np.float32)
    m1 = _meta(tmp_path, "a", f)
    m2 = _meta(tmp_path, "b", f, fft_size=2048)

    def run(**cfg):
        c = _port_config(meta_input1=m1, normalize=False, **cfg)
        c.set_audio_output(str(tmp_path / "o.aif"))
        return PX.CrossSimilarity.run(c).result(timeout=60)

    with pytest.raises(ValueError, match="differ"):
        run(meta_input2=m2)
    with pytest.raises(ValueError, match="empty span"):
        run(meta_input2=m1, span2=Span(50 * 512, 50 * 512))
    monkeypatch.setattr(PX.CrossSimilarity, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(meta_input2=m1)
    assert not (tmp_path / "o.aif").exists()
