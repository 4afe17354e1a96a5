"""The port's self-similarity (``-x``) against the JAX package on the CPU:
window statistics, the gram block, the resident block-pair engine, the
device colorization, the in-memory and stripe-streamed PNG paths, and the
factory.

Tolerances: sims within 2e-5 of the JAX package's (its f32 matmul against
the port's float64 one) and of the f64 mirror ``mathref.correlate_half``
(steady windows included, where f32 would not hold it), NaN cells where
the JAX package has them; window extraction exact; the device pixel stages
bit-equal to the host quantization (``_colorize``) of the same sims; the
streamed PNG pixel-equal to the in-memory one.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strugatzki_tpu.analysis import self_similarity as JS
from strugatzki_tpu.config import ExtractionConfig, SelfSimilarityConfig
from strugatzki_tpu.io import audiofile as af
from strugatzki_tpu.kernels import corr as JK
from strugatzki_tpu.kernels import mathref as M
from strugatzki_tpu_torch.analysis import self_similarity as PS
from strugatzki_tpu_torch.kernels import corr as PK


def _x(seed, c, t):
    """Prepared (group-shifted) feature-like rows."""
    rng = np.random.default_rng(seed)
    x = np.abs(0.5 + 0.15 * rng.standard_normal((c, t))).astype(np.float32)
    return PK.shift_per_group(x)[0]


def _windows(seed, B, C, h):
    rng = np.random.default_rng(seed)
    return np.abs(0.5 + 0.15 * rng.standard_normal((B, C, h))).astype(
        np.float32) - 0.5


def decode_png(path):
    """8-bit RGB PNG with filter 0 scanlines (what util/png writes) →
    ``[h, w, 3]`` uint8."""
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, bytearray(), None, None
    while pos < len(raw):
        n, tag = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def test_extract_windows_equals_jax():
    x = _x(1, 5, 300)
    starts = np.array([0, 7, 100, 250, 250], np.int64)
    got = PK.extract_windows(torch.from_numpy(x), torch.from_numpy(starts), 20)
    want = np.asarray(JK.extract_windows(jnp.asarray(x), jnp.asarray(starts),
                                         20))
    assert got.is_contiguous() and got.shape == (5, 5, 20)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_temporal", [1, 2])
@pytest.mark.parametrize("temp_weight", [0.0, 0.5, 1.0])
def test_window_stats_and_gram_block_match_jax(num_temporal, temp_weight):
    wi, wj = _windows(2, 40, 6, 10), _windows(3, 33, 6, 10)
    st_p = [PK.window_stats(torch.from_numpy(w), num_temporal=num_temporal)
            for w in (wi, wj)]
    st_j = [JK.window_stats(jnp.asarray(w), num_temporal=num_temporal)
            for w in (wi, wj)]
    for sp, sj in zip(st_p, st_j):
        for a, b in zip(sp, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                       rtol=0)
    got = PK.gram_similarity_block(torch.from_numpy(wi), torch.from_numpy(wj),
                                   *st_p, temp_weight,
                                   num_temporal=num_temporal)
    want = np.asarray(JK.gram_similarity_block(
        jnp.asarray(wi), jnp.asarray(wj), *st_j, jnp.float32(temp_weight),
        num_temporal=num_temporal))
    assert got.dtype == torch.float32 and got.shape == (40, 33)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)

    # a leading pairs dimension is the batched matmul of the engine
    stacked = PK.gram_similarity_block(
        torch.from_numpy(np.stack([wi[:33], wi[7:]])),
        torch.from_numpy(np.stack([wj, wj])),
        *[tuple(torch.stack([a, b]) for a, b in zip(*pair))
          for pair in ((PK.window_stats(torch.from_numpy(wi[:33]),
                                        num_temporal=num_temporal),
                        PK.window_stats(torch.from_numpy(wi[7:]),
                                        num_temporal=num_temporal)),
                       (st_p[1], st_p[1]))],
        temp_weight, num_temporal=num_temporal)
    np.testing.assert_allclose(stacked[0].numpy(), want[:33], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(stacked[1].numpy(), want[7:], atol=2e-5,
                               rtol=0)


def test_gram_holds_the_budget_on_steady_windows():
    """Windows whose loudness row barely moves around a level far from the
    group's mean: the pair statistics cancel, and the float64 gram still
    holds 2e-5 against the f64 mirror."""
    rng = np.random.default_rng(6)
    T, h = 4000, 86
    x = np.empty((14, T), np.float32)
    x[0] = np.repeat(rng.uniform(0.1, 0.9, 4), 1000) + 0.01 * \
        rng.standard_normal(T)
    x[1:] = rng.uniform(0.2, 0.8, (13, 1)) + 0.05 * rng.standard_normal(
        (13, T))
    xs, _, _ = PK.shift_per_group(x)
    sims = PS.self_similarity_matrix(xs, xs, h, 7, 0.5, device="cpu")
    n = sims.shape[0]
    for i in range(0, n, 37):
        for j in range(i, n, 53):
            win = np.concatenate([xs[:, 7 * i:7 * i + h],
                                  xs[:, 7 * j:7 * j + h]], axis=1)
            ref = (np.float32(M.correlate_half(1, h, win, 0, 0))
                   * np.float32(0.5)
                   + np.float32(M.correlate_half(13, h, win, 0, 1))
                   * np.float32(0.5))
            assert abs(sims[i, j] - ref) < 2e-5, (i, j, sims[i, j], ref)


def test_gram_runs_at_full_f32():
    """No matmul of the port runs in TF32: it stays off for cuBLAS and
    cuDNN once a device is resolved, as ``runtime/device.py`` pins it (the
    gram itself is a float64 matmul)."""
    from strugatzki_tpu_torch.runtime.device import resolve

    resolve("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,decim", [(700, 1), (1700, 2)])
def test_matrix_matches_jax(t, decim):
    # 700/1: extent 681, two blocks with a ragged tail; 1700/2: 840, two
    x = _x(1, 5, t)
    got = PS.self_similarity_matrix(x, x, 10, decim, 0.5, device="cpu")
    want = JS.self_similarity_matrix(x, x, 10, decim, 0.5)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, equal_nan=True)
    np.testing.assert_array_equal(got, got.T)


def test_matrix_cross_mode_matches_jax():
    x1, x2 = _x(2, 6, 900), _x(3, 6, 1100)
    got = PS.self_similarity_matrix(x1, x2, 12, 1, 0.3, device="cpu")
    want = JS.self_similarity_matrix(x1, x2, 12, 1, 0.3)
    assert got.shape == (877, 877)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, equal_nan=True)


def test_matrix_matches_mathref():
    rng = np.random.default_rng(3)
    x = np.abs(0.5 + 0.15 * rng.standard_normal((5, 160))).astype(np.float32)
    h, d = 20, 3
    xs, _, _ = PK.shift_per_group(x)
    sims = PS.self_similarity_matrix(xs, xs, h, d, 0.5, device="cpu")
    n = (160 - 2 * h + 1) // d
    assert sims.shape == (n, n)
    for i in range(0, n, 7):
        for j in range(i, n, 11):
            win = np.concatenate([x[:, i * d:i * d + h],
                                  x[:, j * d:j * d + h]], axis=1)
            ref = (M.correlate_half(1, h, win, 0, 0) * 0.5
                   + M.correlate_half(4, h, win, 0, 1) * 0.5)
            assert abs(sims[i, j] - ref) < 2e-5
    np.testing.assert_allclose(np.diag(sims), 1.0, atol=1e-4)


def test_prep_resident_pads_to_whole_blocks_only():
    x = _x(4, 4, 1400)   # extent 1381 → 3 blocks, no power-of-two padding
    n, nb, res1, res2 = PS._prep_resident(x, x, 10, 1, device="cpu")
    assert (n, nb) == (1381, 3)
    win_all, stats_all, nt = res1
    assert win_all.shape == (3 * PS._BLOCK, 4, 10)
    assert stats_all.shape == (4, 3 * PS._BLOCK) and nt == 1
    assert res2 is res1   # self mode shares the stacks
    assert torch.equal(win_all[n - 1], win_all[-1])
    _, _, c1, c2 = PS._prep_resident(x, x.copy(), 10, 1, device="cpu")
    assert c2 is not c1 and torch.equal(c2[0], c1[0])


def test_pairs_carry_num_temporal():
    """The split the stats were computed with rides in the stacks, so a
    pair call blends with that split; its sims equal the block kernel's."""
    x = _x(5, 6, 800)
    h = 10
    n, _, res2t, _ = PS._prep_resident(x, x, h, 1, num_temporal=2,
                                       device="cpu")
    assert res2t[2] == 2
    out2 = PS._dispatch_pairs_fast(res2t, res2t, [(0, 0), (0, 1)], 0.5)
    _, _, res1t, _ = PS._prep_resident(x, x, h, 1, device="cpu")
    out1 = PS._dispatch_pairs_fast(res1t, res1t, [(0, 0), (0, 1)], 0.5)
    assert out2.shape == (2, PS._BLOCK, PS._BLOCK)
    assert not torch.equal(out2, out1)
    starts = torch.as_tensor(np.minimum(np.arange(PS._BLOCK), n - 1))
    win = PK.extract_windows(torch.from_numpy(x), starts, h)
    st = PK.window_stats(win, num_temporal=2)
    want = PK.gram_similarity_block(win, win, st, st, 0.5, num_temporal=2)
    np.testing.assert_allclose(out2[0].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    jwant = np.asarray(JK.gram_similarity_block(
        jnp.asarray(win.numpy()), jnp.asarray(win.numpy()),
        JK.window_stats(jnp.asarray(win.numpy()), num_temporal=2),
        JK.window_stats(jnp.asarray(win.numpy()), num_temporal=2),
        jnp.float32(0.5), num_temporal=2))
    np.testing.assert_allclose(out2[0].numpy(), jwant, atol=2e-5, rtol=0)


def test_iter_pair_sims_abort_honored_between_fetches():
    class Aborted(RuntimeError):
        pass

    state = {"abort": False}

    def check():
        if state["abort"]:
            raise Aborted()

    def dispatch(chunk):
        return torch.zeros((len(chunk), 1))

    pairs = [(i, i) for i in range(8)]
    it = PS._iter_pair_sims(pairs, dispatch, 2, check_aborted=check)
    assert next(it)[0] == (0, 0)
    assert next(it)[0] == (1, 1)     # finishes chunk 0
    state["abort"] = True
    with pytest.raises(Aborted):
        next(it)                     # chunk 1 was already queued


def test_iter_pair_sims_lookahead_order():
    calls = []

    def dispatch(chunk):
        calls.append((len(calls), list(chunk)))
        return torch.tensor([[p[0] * 10.0 + p[1]] for p in chunk])

    pairs = [(i, j) for i in range(3) for j in range(i, 3)]   # 6 pairs
    it = PS._iter_pair_sims(pairs, dispatch, 4)
    first = next(it)
    assert len(calls) == 2       # the second chunk is queued before a fetch
    got = [first] + list(it)
    assert [p for p, _ in got] == pairs
    assert [float(s[0]) for _, s in got] == [p[0] * 10 + p[1] for p in pairs]
    assert [c for _, c in calls] == [pairs[:4], pairs[4:]]   # no padding


# ---------------------------------------------------------------------------
# colorization
# ---------------------------------------------------------------------------

def _stages_rgb(sims, colors, ceil, inv):
    """The device pixel stages on ``sims`` (here on the CPU), narrowed and
    expanded to RGB like the render paths."""
    pix = PS._device_pix(colors, 1.0, ceil, inv)
    assert pix is not None
    vals = PS._apply_pix_stages(torch.from_numpy(sims), pix).numpy()
    assert vals.dtype == (np.uint8 if pix[2] else np.int32)
    return PS._pix_to_rgb(vals.astype(np.uint8 if pix[2] else np.uint16),
                          pix[2])


@pytest.mark.parametrize("colors", ["psycho", "gray"])
@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("ceil", [1.0, 0.8, 1.3])
def test_pixel_stages_bit_equal_to_host_colorize(colors, inv, ceil):
    rng = np.random.default_rng(zlib.crc32(f"{colors}|{inv}|{ceil}".encode()))
    sims = rng.uniform(-0.5, 1.6, size=(64, 64)).astype(np.float32)
    # palette-bin boundaries, NaN, ±inf, 0, 1, and the round-to-even tie
    # 1 − s·(1/1.3) that an FMA would resolve differently
    sims[0, :9] = [np.nan, np.inf, -np.inf, 0.0, 1.0, 0.5,
                   511.5 / 1023.0, 0.25, np.float32(0.49369505)]
    np.testing.assert_array_equal(_stages_rgb(sims, colors, ceil, inv),
                                  PS._colorize(sims, colors, 1.0, ceil, inv))


@pytest.mark.parametrize("seed", [49, 145, 184, 206])
def test_pixel_stages_fma_tie_cases(seed):
    """tests/test_selfsim_device_color.py's datasets whose products land on
    round-to-even ties at colorCeil 1.3 with colorInv."""
    rng = np.random.default_rng(seed)
    sims = rng.uniform(-0.5, 1.6, size=(64, 64)).astype(np.float32)
    np.testing.assert_array_equal(_stages_rgb(sims, "psycho", 1.3, True),
                                  PS._colorize(sims, "psycho", 1.0, 1.3, True))


def test_device_pix_gates_and_values_equal_jax():
    for args in (("psycho", 1.0, 1.0, False), ("gray", 1.0, 0.7, True),
                 ("psycho", 1.0, 1.3, True)):
        got, want = PS._device_pix(*args), JS._device_pix(*args)
        assert got[2:] == want[2:]
        assert got[0] == float(want[0]) and got[1] == float(want[1])
    assert PS._device_pix("psycho", 1.2, 1.0, False) is None


def test_raster_bit_equal_to_host_quantization_of_its_sims():
    """Within one engine the device raster equals the host quantization of
    the same sims."""
    x1, x2 = _x(2, 6, 900), _x(3, 6, 1100)
    sims = PS._pixel_matrix(x1, x2, 12, 1, 0.3, device="cpu")
    for colors, inv in (("psycho", False), ("gray", True)):
        pix = PS._device_pix(colors, 1.0, 0.9, inv)
        vals = PS._pixel_matrix(x1, x2, 12, 1, 0.3, pix=pix, device="cpu")
        assert vals.dtype == (np.uint8 if pix[2] else np.uint16)
        np.testing.assert_array_equal(
            PS._pix_to_rgb(vals, pix[2]),
            PS._colorize(sims, colors, 1.0, 0.9, inv))


@pytest.mark.parametrize("colors,warp,inv", [("psycho", 1.0, False),
                                             ("gray", 1.0, True),
                                             ("psycho", 1.2, False)])
def test_image_equals_host_render(colors, warp, inv):
    """The device colorization (warp 1) and the host fallback (warp 1.2)
    both equal render_image of the float matrix."""
    x = _x(7, 5, 700)
    img = PS.self_similarity_image(x, x, 10, 1, 0.5, colors, warp, 0.9, inv,
                                   device="cpu")
    sims = PS.self_similarity_matrix(x, x, 10, 1, 0.5, device="cpu")
    np.testing.assert_array_equal(
        img, PS.render_image(sims, colors, warp, 0.9, inv))


def test_copied_helpers_equal_the_originals():
    rng = np.random.default_rng(12)
    sims = rng.uniform(-0.5, 1.6, size=(40, 40)).astype(np.float32)
    sims[0, :4] = [np.nan, np.inf, -np.inf, 0.0]
    for colors in ("psycho", "gray"):
        for warp, ceil, inv in ((1.0, 1.0, False), (1.7, 0.8, True)):
            np.testing.assert_array_equal(
                PS._colorize(sims, colors, warp, ceil, inv),
                JS._colorize(sims, colors, warp, ceil, inv))
            np.testing.assert_array_equal(
                PS.render_image(sims, colors, warp, ceil, inv),
                JS.render_image(sims, colors, warp, ceil, inv))
    idx = rng.integers(0, 1024, (9, 11)).astype(np.uint16)
    np.testing.assert_array_equal(PS._pix_to_rgb(idx, False),
                                  JS._pix_to_rgb(idx, False))
    g = idx.astype(np.uint8)
    np.testing.assert_array_equal(PS._pix_to_rgb(g, True),
                                  JS._pix_to_rgb(g, True))
    for shape1, shape2, h, d in (((5, 300), (5, 300), 10, 1),
                                 ((5, 300), (5, 200), 10, 3),
                                 ((5, 15), (5, 300), 10, 1)):
        a, b = np.zeros(shape1), np.zeros(shape2)
        assert PS._extent(a, b, h, d) == JS._extent(a, b, h, d)
    for name in ("_MAX_EXTENT", "_BLOCK", "_STREAM_EXTENT",
                 "_FAST_DEFLATE_EXTENT", "_PAIRS_PER_CALL"):
        assert getattr(PS, name) == getattr(JS, name)


# ---------------------------------------------------------------------------
# PNG paths and the factory
# ---------------------------------------------------------------------------

def _write_feat(path, data, rate=44100 / 512):
    af.write(path, data.astype(np.float32),
             af.feature_spec(data.shape[0], rate))


def _meta(tmp_path, name, feats, **extr):
    fp, mp = tmp_path / f"{name}_feat.aif", tmp_path / f"{name}_feat.xml"
    _write_feat(fp, feats)
    ExtractionConfig(audio_input=str(tmp_path / f"{name}.aif"),
                     feature_output=str(fp), meta_output=str(mp),
                     **extr).save_xml(mp)
    return str(mp)


@pytest.mark.parametrize("colors,inv", [("psycho", False), ("gray", True)])
def test_streamed_png_equals_in_memory_image(tmp_path, colors, inv):
    """Three column stripes (mirrored pairs included) against the
    in-memory image; a cross pair of inputs, so the lower triangle of a
    diagonal block really is a mirror."""
    x1, x2 = _x(8, 5, 1400), _x(9, 5, 1300)
    path = tmp_path / "s.png"
    n = PS.self_similarity_to_png(x1, x2, 10, 1, 0.5, path, colors, 1.0,
                                  1.0, inv, device="cpu")
    img = PS.self_similarity_image(x1, x2, 10, 1, 0.5, colors, 1.0, 1.0, inv,
                                   device="cpu")
    assert n == 1281 and img.shape == (n, n, 3)
    np.testing.assert_array_equal(decode_png(path), img)


def test_factory_streaming_branch_equals_matrix_branch(tmp_path, monkeypatch):
    from strugatzki_tpu_torch.analysis.self_similarity import SelfSimilarity

    rng = np.random.default_rng(11)
    a = np.abs(0.5 + 0.1 * rng.standard_normal((14, 160))).astype(np.float32)
    meta = _meta(tmp_path, "a", a)
    monkeypatch.setattr(SelfSimilarity, "device", "cpu")
    cfg = dict(meta_input=meta, corr_len=15 * 512, decimation=1,
               normalize=False, colors="psycho")
    SelfSimilarity.run(SelfSimilarityConfig(
        image_output=str(tmp_path / "mat.png"), **cfg)).result(timeout=300)
    progress = []
    monkeypatch.setattr(PS, "_STREAM_EXTENT", 50)    # extent 131 > 50
    SelfSimilarity.run(
        SelfSimilarityConfig(image_output=str(tmp_path / "str.png"), **cfg),
        observer=progress.append).result(timeout=300)
    mat, streamed = (decode_png(tmp_path / n) for n in ("mat.png", "str.png"))
    assert mat.shape == (131, 131, 3)
    np.testing.assert_array_equal(streamed, mat)
    assert progress


def test_factory_png_level_policy(tmp_path, monkeypatch):
    from strugatzki_tpu_torch.analysis.self_similarity import SelfSimilarity

    rng = np.random.default_rng(12)
    a = np.abs(0.5 + 0.1 * rng.standard_normal((14, 160))).astype(np.float32)
    meta = _meta(tmp_path, "a", a)
    seen = []

    def stub(x1, x2, half_win, decim, tw, path, *args, **kw):
        seen.append((kw.get("png_level"), kw.get("device")))
        return 1

    monkeypatch.setattr(PS, "self_similarity_to_png", stub)
    monkeypatch.setattr(PS, "_STREAM_EXTENT", 50)
    monkeypatch.setattr(SelfSimilarity, "device", "cpu")

    def run():
        SelfSimilarity.run(SelfSimilarityConfig(
            meta_input=meta, image_output=str(tmp_path / "o.png"),
            corr_len=15 * 512, normalize=False)).result(timeout=300)

    run()                                                    # auto, small
    monkeypatch.setattr(PS, "_FAST_DEFLATE_EXTENT", 100)     # extent 131 >
    run()                                                    # auto, giant
    monkeypatch.setattr(SelfSimilarity, "png_level", 3)      # forced
    run()
    assert seen == [(6, "cpu"), (1, "cpu"), (3, "cpu")]


def test_factory_cross_mode_and_span_match_jax(tmp_path, monkeypatch):
    """Two inputs (the joint shift over both) and a span: the port's PNG
    has the JAX package's size, and its pixels differ only where a sim sits
    within the tolerance of a quantization step."""
    from strugatzki_tpu.analysis.self_similarity import SelfSimilarity as JSS
    from strugatzki_tpu.span import Span
    from strugatzki_tpu_torch.analysis.self_similarity import SelfSimilarity

    rng = np.random.default_rng(8)
    a = np.abs(0.5 + 0.1 * rng.standard_normal((14, 260))).astype(np.float32)
    b = np.abs(0.5 + 0.1 * rng.standard_normal((14, 220))).astype(np.float32)
    b[:, 40:70] = a[:, 10:40]
    ma, mb = _meta(tmp_path, "a", a), _meta(tmp_path, "b", b)
    monkeypatch.setattr(SelfSimilarity, "device", "cpu")
    cfg = dict(meta_input=ma, meta_input2=mb, corr_len=15 * 512,
               normalize=False, colors="gray", span=Span(10 * 512, 200 * 512))
    JSS.run(SelfSimilarityConfig(image_output=str(tmp_path / "j.png"),
                                 **cfg)).result(timeout=300)
    SelfSimilarity.run(SelfSimilarityConfig(
        image_output=str(tmp_path / "p.png"), **cfg)).result(timeout=300)
    got, want = decode_png(tmp_path / "p.png"), decode_png(tmp_path / "j.png")
    n = 190 - 30 + 1
    assert got.shape == want.shape == (n, n, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("bad", [dict(color_warp=-1.0), dict(color_ceil=0.0),
                                 dict(decimation=0), "mismatch"])
def test_factory_rejections(tmp_path, monkeypatch, bad):
    from strugatzki_tpu_torch.analysis.self_similarity import SelfSimilarity

    rng = np.random.default_rng(9)
    feats = np.abs(0.5 + 0.05 * rng.standard_normal((14, 120))
                   ).astype(np.float32)
    meta = _meta(tmp_path, "q", feats)
    extra = {}
    if bad == "mismatch":
        extra["meta_input2"] = _meta(tmp_path, "r", feats, fft_size=2048)
    else:
        extra.update(bad)
    monkeypatch.setattr(SelfSimilarity, "device", "cpu")
    cfg = SelfSimilarityConfig(meta_input=meta,
                               image_output=str(tmp_path / "o.png"),
                               corr_len=10 * 512, normalize=False, **extra)
    with pytest.raises(ValueError):
        SelfSimilarity.run(cfg).result(timeout=60)
    assert not (tmp_path / "o.png").exists()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _x(1, 5, 300)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.self_similarity_matrix(x, x, 10, 1, 0.5, device="cuda")
