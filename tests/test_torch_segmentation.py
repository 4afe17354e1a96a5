"""The port's segmentation (``-s``) against the JAX package on the CPU: the
novelty curve and its batched form, the break selection, and the
transcription of the reference loop in tests/test_segmentation.py.

Tolerances: novelty sims within 2e-5 of the JAX package's curve (its f32
round trip against the port's float64 statistics, two FFT libraries) and
of the f64 mirror ``mathref.correlate_half``; breaks position for position
with sims within 2e-5 of the JAX package's and 3e-5 of the transcription's
(the budget tests/test_segmentation.py holds the JAX package to).  The
inputs keep every window's variance far above the JAX package's f32
round-off, except in
``test_novelty_trace_holds_the_budget_on_long_steady_sections``, which
holds the port alone to the mirror; windows inside a silent stretch longer
than the window are 0/0, and
``test_silence_longer_than_the_window_is_degenerate`` says what holds there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strugatzki_tpu.analysis import segmentation as JS
from strugatzki_tpu.config import SegmentationConfig
from strugatzki_tpu.kernels import corr as JK
from strugatzki_tpu.kernels import mathref as M
from strugatzki_tpu.parallel import sweep as JW
from strugatzki_tpu.span import Span
from strugatzki_tpu_torch.analysis import segmentation as PS
from strugatzki_tpu_torch.kernels import corr as PK
from strugatzki_tpu_torch.parallel import sweep as PW
from test_segmentation import (_features_with_sections,
                               _scala_reference_segmentation)

STEP = 512


def _features(seed, C, T):
    """Feature-like rows with distinct levels; adjacent frames alternate by
    ±0.2, so even the two-frame windows of half_win 1 have a variance far
    above the FFT round-off."""
    rng = np.random.default_rng(seed)
    alt = 0.2 * (-1.0) ** np.arange(T)
    x = rng.uniform(0.3, 0.7, (C, 1)) + alt + 0.05 * rng.standard_normal(
        (C, T))
    return np.abs(x).astype(np.float32)


def _same_breaks(got, want, tol):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.pos == b.pos, (a, b)
        assert abs(a.sim - b.sim) < tol, (a, b)


@pytest.mark.parametrize("half_win", [1, 5, 86])
@pytest.mark.parametrize("num_temporal", [1, 2])
@pytest.mark.parametrize("temp_weight", [0.0, 0.5, 1.0])
def test_novelty_trace_matches_jax(half_win, num_temporal, temp_weight):
    """The single curve and the batched curves (three files, one padded
    width), each against the JAX package."""
    mats = [_features(s, 14, 300 + 2 * half_win) for s in range(3)]
    xs_b = np.stack([PK.shift_per_group(m, num_temporal)[0] for m in mats])
    want = np.asarray(JK.novelty_trace(
        jnp.asarray(xs_b[0]), half_win, jnp.float32(temp_weight),
        num_temporal=num_temporal))
    got = PK.novelty_trace(torch.from_numpy(xs_b[0]), half_win, temp_weight,
                           num_temporal=num_temporal)
    assert got.dtype == torch.float32 and got.shape == (301,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)

    if num_temporal == 1:    # the batched entry points take the default
        want_b = JW.batched_novelty_traces(xs_b, half_win, temp_weight)
        got_b = PW.batched_novelty_traces(xs_b, half_win, temp_weight,
                                          device="cpu")
        assert got_b.shape == want_b.shape == (3, 301)
        np.testing.assert_allclose(got_b, want_b, atol=2e-5, rtol=0)
        np.testing.assert_allclose(got_b[0], got.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("half_win", [1, 5, 86])
def test_novelty_trace_matches_mathref(half_win):
    x = _features(7, 6, 260 + 2 * half_win)
    xs, _, _ = PK.shift_per_group(x)
    sims = PK.novelty_trace(torch.from_numpy(xs), half_win, 0.5).numpy()
    for t in range(0, len(sims), 13):
        win = x[:, t:t + 2 * half_win]
        ref = (np.float32(M.correlate_half(1, half_win, win, 0, 0))
               * np.float32(0.5)
               + np.float32(M.correlate_half(5, half_win, win, 0, 1))
               * np.float32(0.5))
        assert abs(sims[t] - ref) < 2e-5, (t, sims[t], ref)


def test_novelty_trace_upcasts_reduced_precision():
    """A bf16 input gives the float32 input's curve (the products never
    run in the storage dtype), and the curve comes back float32."""
    xs = PK.shift_per_group(_features(3, 5, 200))[0]
    half = torch.from_numpy(xs).to(torch.bfloat16)
    got = PK.novelty_trace(half, 10, 0.5)
    want = PK.novelty_trace(half.to(torch.float32), 10, 0.5)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def _steady_sections(seed, T=20000, C=14):
    """Long steady sections: the loudness row steps between levels and
    barely moves inside a section, so a window's variance is tiny against
    its squared mean (the cancellation the float64 statistics answer)."""
    rng = np.random.default_rng(seed)
    level = np.repeat(rng.uniform(0.1, 0.9, T // 2000 + 1), 2000)[:T]
    x = np.empty((C, T), np.float32)
    x[0] = level + 0.01 * rng.standard_normal(T)
    x[1:] = rng.uniform(0.2, 0.8, (C - 1, 1)) + 0.05 * rng.standard_normal(
        (C - 1, T))
    return x


def test_novelty_trace_holds_the_budget_on_long_steady_sections():
    h = 86
    x = _steady_sections(4)
    xs, _, _ = PK.shift_per_group(x)
    sims = PK.novelty_trace(torch.from_numpy(xs), h, 0.5).numpy()
    for t in list(range(0, len(sims), 613)) + [1914, 3914, 9914]:
        win = xs[:, t:t + 2 * h]
        ref = (np.float32(M.correlate_half(1, h, win, 0, 0)) * np.float32(0.5)
               + np.float32(M.correlate_half(13, h, win, 0, 1))
               * np.float32(0.5))
        assert abs(sims[t] - ref) < 2e-5, (t, sims[t], ref)


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_matches_jax_and_transcription(seed):
    """tests/test_segmentation.py's randomized spans, lengths, norms and
    break counts: break for break against the JAX package and against the
    transcription of the reference loop."""
    rng = np.random.default_rng(2000 + seed)
    C = int(rng.integers(3, 15))
    T = int(rng.integers(40, 700))
    base = rng.uniform(0.3, 0.7, size=(C, 1))
    feats = np.abs(base + 0.15 * rng.standard_normal((C, T))).astype(np.float32)
    norm = None
    if rng.random() < 0.5:
        norm = np.stack([feats.min(axis=1) - 1e-3, feats.max(axis=1) + 1e-3],
                        axis=1).astype(np.float32)
    span = Span.all()
    r = rng.random()
    if r < 0.25:
        span = Span(int(rng.integers(0, T // 2)) * STEP,
                    int(rng.integers(T // 2, T + 50)) * STEP)
    elif r < 0.5:
        span = Span.from_(int(rng.integers(0, T // 2)) * STEP)
    elif r < 0.75:
        span = Span.until(int(rng.integers(T // 2, T + 50)) * STEP)
    cfg = SegmentationConfig(
        normalize=norm is not None, span=span,
        corr_len=int(rng.integers(2, 60)) * STEP,
        temporal_weight=float(rng.choice([0.0, 0.5, 1.0])),
        num_breaks=int(rng.integers(1, 8)),
        min_spacing=int(rng.integers(0, 50)) * STEP).build()

    ours = PS.segment_features(feats, norm, STEP, cfg, device="cpu")
    _same_breaks(ours, JS.segment_features(feats, norm, STEP, cfg), 2e-5)
    _same_breaks(ours, _scala_reference_segmentation(feats, norm, STEP, cfg),
                 3e-5)


@pytest.mark.parametrize("case", ["plain", "norm_and_span", "short_span"])
def test_scala_transcription_cases(case):
    if case == "plain":
        feats = _features_with_sections()
        norm = None
        cfg = SegmentationConfig(normalize=False, corr_len=20 * STEP,
                                 num_breaks=4, min_spacing=30 * STEP)
    elif case == "norm_and_span":
        feats = _features_with_sections(seed=3)
        norm = np.stack([feats.min(axis=1) - 0.01, feats.max(axis=1) + 0.01],
                        axis=1).astype(np.float32)
        cfg = SegmentationConfig(normalize=True, corr_len=15 * STEP,
                                 num_breaks=3, min_spacing=20 * STEP,
                                 span=Span(50 * STEP, 550 * STEP))
    else:   # a span shorter than the window: one zero-padded window
        feats = _features_with_sections(seed=1, T=50)
        norm = None
        cfg = SegmentationConfig(normalize=False, corr_len=40 * STEP,
                                 num_breaks=1, min_spacing=0)
    cfg = cfg.build()
    ours = PS.segment_features(feats, norm, STEP, cfg, device="cpu")
    _same_breaks(ours, _scala_reference_segmentation(feats, norm, STEP, cfg),
                 2e-5)
    _same_breaks(ours, JS.segment_features(feats, norm, STEP, cfg), 2e-5)


def test_finds_section_boundaries():
    feats = _features_with_sections(seed=7, T=900)
    cfg = SegmentationConfig(normalize=False, corr_len=30 * STEP,
                             num_breaks=2, min_spacing=60 * STEP).build()
    breaks = PS.segment_features(feats, None, STEP, cfg, device="cpu")
    positions = sorted(b.pos // STEP for b in breaks)
    assert abs(positions[0] - 300) < 20
    assert abs(positions[1] - 600) < 20


def test_batch_matches_jax_and_single_files():
    """Mixed lengths, an empty span and a span shorter than the window in
    one batch: the JAX package's batch break for break, and each file's own
    segmentation (the batch's common width changes the FFT plan only)."""
    mats = [_features_with_sections(seed=s, T=t)
            for s, t in ((0, 600), (1, 50), (2, 333), (3, 900))]
    mats.append(mats[0][:, :0])
    cfg = SegmentationConfig(normalize=False, corr_len=20 * STEP,
                             num_breaks=3, min_spacing=15 * STEP).build()
    got = PS.segment_features_batch(mats, None, STEP, cfg, device="cpu")
    want = JS.segment_features_batch(mats, None, STEP, cfg)
    assert len(got) == len(want) == 5 and got[4] == want[4] == []
    for g, w, m in zip(got[:4], want[:4], mats):
        _same_breaks(g, w, 2e-5)
        _same_breaks(g, PS.segment_features(m, None, STEP, cfg,
                                            device="cpu"), 2e-5)
    with pytest.raises(ValueError):
        PS.segment_features_batch([mats[0], mats[0][:5]], None, STEP, cfg,
                                  device="cpu")


def _with_silence(seed, T, start, stop):
    """Sectioned features with digital silence in ``[start, stop)``: the
    loudness row is 0 and each MFCC row holds its own constant, as
    extraction writes them for silent audio."""
    feats = _features_with_sections(seed=seed, T=T)
    feats[0, start:stop] = 0.0
    feats[1:, start:stop] = np.linspace(0.2, 0.9, feats.shape[0] - 1)[:, None]
    return feats


def test_silence_shorter_than_the_window():
    """Every window still holds sounding frames, so every sim is finite and
    both packages pick the same breaks (the silence's edges among them)."""
    feats = _with_silence(4, 700, 400, 430)          # 30 frames < 2·20
    cfg = SegmentationConfig(normalize=False, corr_len=20 * STEP,
                             num_breaks=6, min_spacing=10 * STEP).build()
    xs, nw, _, h = PS._novelty_prep(feats, None, STEP, cfg)
    sims = PK.novelty_trace(torch.from_numpy(xs), h, 0.5)[:nw].numpy()
    assert np.isfinite(sims).all()
    ours = PS.segment_features(feats, None, STEP, cfg, device="cpu")
    _same_breaks(ours, JS.segment_features(feats, None, STEP, cfg), 2e-5)
    _same_breaks(ours, _scala_reference_segmentation(feats, None, STEP, cfg),
                 3e-5)
    assert any(abs(b.pos // STEP - 400) <= 20 for b in ours)


def test_silence_longer_than_the_window_is_degenerate():
    """A window inside a silence longer than the window has a constant
    loudness row: its temporal ``correlateHalf`` is 0/0, NaN in the f64
    mirror of the reference.  The FFT window sums leave round-off in place
    of both zeros, so such windows carry noise (±inf, NaN or any finite
    value) that differs between FFT libraries and precisions.  Everywhere
    else the port holds the JAX package's curve."""
    start, stop, h = 400, 520, 20
    feats = _with_silence(5, 800, start, stop)
    cfg = SegmentationConfig(normalize=False, corr_len=h * STEP,
                             num_breaks=6, min_spacing=10 * STEP).build()
    xs, nw, _, _ = PS._novelty_prep(feats, None, STEP, cfg)
    got = PK.novelty_trace(torch.from_numpy(xs), h, 0.5)[:nw].numpy()
    want = np.asarray(JK.novelty_trace(jnp.asarray(xs), h,
                                       jnp.float32(0.5)))[:nw]
    inside = (np.arange(nw) >= start) & (np.arange(nw) + 2 * h <= stop)
    assert inside.sum() == stop - start - 2 * h + 1
    np.testing.assert_allclose(got[~inside], want[~inside], atol=2e-5, rtol=0)
    with np.errstate(invalid="ignore"):
        ref = M.correlate_half(1, h, feats[:, start:start + 2 * h], 0, 0)
    assert np.isnan(ref)


def test_copied_select_breaks_equals_the_original():
    """``_select_breaks`` is the JAX package's, call for call: the same
    breaks from curves with ties, NaN and ±inf, and the same abort checks
    (every 4096 windows) and progress reports."""
    rng = np.random.default_rng(11)
    sims = rng.uniform(-1, 1, 10000).astype(np.float32)
    sims[::97] = sims[5]
    sims[[10, 20, 4100]] = np.nan
    sims[[30, 5000]] = -np.inf
    sims[40] = np.inf
    cfg = SegmentationConfig(normalize=False, corr_len=10 * STEP,
                             num_breaks=9, min_spacing=3 * STEP).build()
    calls = {}
    for tag, mod in (("port", PS), ("jax", JS)):
        log = []
        breaks = mod._select_breaks(
            sims, 17, 10, STEP, cfg,
            check_aborted=lambda log=log: log.append("abort"),
            progress=lambda f, log=log: log.append(f))
        # repr: a NaN break equals the other package's NaN break
        calls[tag] = ([(b.pos, repr(b.sim)) for b in breaks], log)
    assert calls["port"] == calls["jax"]
    # while the set has room a NaN or -inf sim is admitted like any other
    assert {"nan", "-inf"} <= {s for _, s in calls["port"][0]}
    assert calls["port"][1].count("abort") == 3       # t = 0, 4096, 8192


def test_abort_between_passes():
    class Stop(RuntimeError):
        pass

    def check():
        raise Stop()

    feats = _features_with_sections()
    cfg = SegmentationConfig(normalize=False, corr_len=20 * STEP,
                             num_breaks=2).build()
    with pytest.raises(Stop):
        PS.segment_features(feats, None, STEP, cfg, check_aborted=check,
                            device="cpu")


def test_mesh_and_missing_cuda_raise(monkeypatch):
    feats = _features_with_sections()
    cfg = SegmentationConfig(normalize=False, corr_len=20 * STEP).build()
    with pytest.raises(NotImplementedError, match="item 14"):
        PS.segment_features(feats, None, STEP, cfg, mesh=object(),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        PS.segment_features_batch([feats], None, STEP, cfg, mesh=object(),
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        PW.batched_novelty_traces(np.zeros((1, 14, 64), np.float32), 4, 0.5,
                                  mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.segment_features(feats, None, STEP, cfg, device="cuda")
