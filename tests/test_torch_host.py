"""The port's copies of the JAX package's host modules against their
originals, on seeded inputs: the XML sidecars of every config class written
by each package and read by the other, byte for byte; the DSP tables and
constants, the f64 reference math and the palette, array for array; PNG
bytes; the match selection replay, match for match; feature and sound files
across packages; ``--stats``; the processor's events; the CLI's formatting.

Everything here is exact: a copy must give the original's bits.  The port's
classes are its own (a port ``Span`` is not a JAX ``Span``), so results are
compared field by field.
"""

import dataclasses
import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest

import strugatzki_tpu as J
import strugatzki_tpu_torch as P
from strugatzki_tpu import cli as jcli
from strugatzki_tpu.analysis import common as jcommon
from strugatzki_tpu.analysis import feature_stats as jstats
from strugatzki_tpu.analysis import topk as jtopk
from strugatzki_tpu.dsp import constants as jconst
from strugatzki_tpu.dsp import ml_tables as jml
from strugatzki_tpu.io import audiofile as jaf
from strugatzki_tpu.io import formats as jformats
from strugatzki_tpu.io import native as jnative
from strugatzki_tpu.kernels import mathref as jmath
from strugatzki_tpu.util import palette as jpal
from strugatzki_tpu.util import png as jpng
from strugatzki_tpu_torch import cli as pcli
from strugatzki_tpu_torch.analysis import common as pcommon
from strugatzki_tpu_torch.analysis import feature_stats as pstats
from strugatzki_tpu_torch.analysis import topk as ptopk
from strugatzki_tpu_torch.dsp import constants as pconst
from strugatzki_tpu_torch.dsp import ml_tables as pml
from strugatzki_tpu_torch.io import audiofile as paf
from strugatzki_tpu_torch.io import formats as pformats
from strugatzki_tpu_torch.io import native as pnative
from strugatzki_tpu_torch.kernels import mathref as pmath
from strugatzki_tpu_torch.util import palette as ppal
from strugatzki_tpu_torch.util import png as ppng


def to_port(obj):
    """A JAX-package dataclass (a config, ``Span``, ``Punch``, ``Match``,
    an ``AudioFileType``) rebuilt field by field as the port's class of the
    same module path and name; anything else unchanged."""
    cls = type(obj)
    if dataclasses.is_dataclass(obj) and cls.__module__.split(".")[0] == \
            "strugatzki_tpu":
        mod = importlib.import_module(
            "strugatzki_tpu_torch" + cls.__module__[len("strugatzki_tpu"):])
        return getattr(mod, cls.__name__)(**{
            f.name: to_port(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _fields(obj):
    """Field values of a dataclass of either package, spans and punches as
    tuples, so two packages' objects compare."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return obj


# ---------------------------------------------------------------------------
# configs and their XML sidecars
# ---------------------------------------------------------------------------

def _span(rng):
    a, b = sorted(int(v) for v in rng.integers(0, 10 ** 7, 2))
    return [J.Span.all(), J.Span(a, b), J.Span.from_(a),
            J.Span.until(b)][int(rng.integers(4))]


def _weight(rng):
    return float(rng.choice([0.0, 1.0, rng.uniform(), 1 / 3]))


def _config(name, seed):
    """A JAX-package config of class ``name`` with seeded, non-default
    fields."""
    rng = np.random.default_rng(seed)
    if name == "ExtractionConfig":
        return J.ExtractionConfig(
            audio_input=f"/snd/in{seed}.aif",
            feature_output=f"/db/in{seed}_feat.aif",
            meta_output=None if seed % 2 else f"/db/in{seed}_feat.xml",
            num_coeffs=int(rng.integers(5, 40)),
            fft_size=int(rng.choice([512, 1024, 2048])),
            fft_overlap=int(rng.choice([1, 2, 4])),
            channels_behavior=int(rng.integers(3)))
    if name == "CorrelationConfig":
        a, b = sorted(int(v) for v in rng.integers(0, 10 ** 6, 2))
        out = None if seed % 2 else J.Punch(J.Span(b, b + 44100),
                                            _weight(rng))
        return J.CorrelationConfig(
            database_folder=f"/db{seed}", meta_input=f"/db/q{seed}_feat.xml",
            punch_in=J.Punch(J.Span(a, b), _weight(rng)), punch_out=out,
            min_punch=int(rng.integers(1, 50000)),
            max_punch=int(rng.integers(50000, 10 ** 6)),
            normalize=bool(seed % 3), max_boost=float(rng.uniform(1, 20)),
            num_matches=int(rng.integers(1, 30)),
            num_per_file=int(rng.integers(1, 5)),
            min_spacing=int(rng.integers(0, 10 ** 5)))
    if name == "SegmentationConfig":
        return J.SegmentationConfig(
            database_folder=f"/db{seed}", meta_input=f"/db/s{seed}_feat.xml",
            span=_span(rng), corr_len=int(rng.integers(512, 10 ** 5)),
            temporal_weight=_weight(rng), normalize=bool(seed % 2),
            num_breaks=int(rng.integers(1, 40)),
            min_spacing=int(rng.integers(0, 10 ** 5)))
    if name == "SelfSimilarityConfig":
        return J.SelfSimilarityConfig(
            database_folder=f"/db{seed}", meta_input=f"/db/x{seed}_feat.xml",
            meta_input2=None if seed % 2 else f"/db/y{seed}_feat.xml",
            image_output=f"/out/x{seed}.png", span=_span(rng),
            corr_len=int(rng.integers(512, 10 ** 5)),
            decimation=int(rng.integers(1, 9)), temporal_weight=_weight(rng),
            colors=["gray", "psycho"][seed % 2],
            color_warp=float(rng.uniform(0.2, 3)),
            color_ceil=float(rng.uniform(0.2, 2)),
            color_inv=bool(seed % 3), normalize=bool(seed % 2))
    tpe = [jformats.AIFF, jformats.WAVE, jformats.IRCAM, jformats.NEXT,
           jformats.WAVE64, jformats.RAW][seed % 6]
    return J.CrossSimilarityConfig(
        database_folder=f"/db{seed}", meta_input1=f"/db/a{seed}_feat.xml",
        meta_input2=f"/db/b{seed}_feat.xml",
        audio_output=f"/out/c{seed}.{tpe.extension}", audio_output_type=tpe,
        span1=_span(rng), span2=_span(rng), temporal_weight=_weight(rng),
        normalize=bool(seed % 2), max_boost=float(rng.uniform(1, 20)))


CONFIGS = ["ExtractionConfig", "CorrelationConfig", "SegmentationConfig",
           "SelfSimilarityConfig", "CrossSimilarityConfig"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", CONFIGS)
def test_config_sidecars_are_byte_equal_across_packages(tmp_path, name, seed):
    jcfg = _config(name, seed)
    pcfg = to_port(jcfg)
    assert type(pcfg) is getattr(P, name)
    jpath, ppath = tmp_path / "j.xml", tmp_path / "p.xml"
    jcfg.save_xml(jpath)
    pcfg.save_xml(ppath)
    assert ppath.read_bytes() == jpath.read_bytes()
    assert pcfg.to_xml_string() == jcfg.to_xml_string()
    # each package reads the other's sidecar to the same fields
    p_back = getattr(P, name).from_xml_file(jpath)
    j_back = getattr(J, name).from_xml_file(ppath)
    assert type(p_back) is getattr(P, name)
    assert _fields(p_back) == _fields(j_back) == _fields(
        getattr(J, name).from_xml_file(jpath))


def test_to_port_keeps_every_field():
    for name in CONFIGS:
        jcfg = _config(name, 5)
        pcfg = to_port(jcfg)
        assert _fields(pcfg) == _fields(jcfg)
        assert type(pcfg).__module__ == "strugatzki_tpu_torch.config"


def test_punch_match_and_span_helpers_equal_the_originals():
    rng = np.random.default_rng(2)
    for _ in range(50):
        s1, s2 = _span(rng), _span(rng)
        p1, p2 = to_port(s1), to_port(s2)
        assert type(p1).__module__ == "strugatzki_tpu_torch.span"
        if s1.is_closed and s2.is_closed:
            assert P.span.spacing(p1, p2) == J.span.spacing(s1, s2)
        for attr in ("is_all", "has_start", "has_stop", "is_closed"):
            assert getattr(p1, attr) == getattr(s1, attr)
    m = J.Match(sim=0.7, file="a.aif", punch=J.Span(10, 99), boost_in=1.5,
                boost_out=0.25)
    assert _fields(to_port(m)) == _fields(m)
    assert P.config.fmt_f32(0.1) == J.config.fmt_f32(0.1)


# ---------------------------------------------------------------------------
# DSP tables, constants, the f64 reference math, the palette
# ---------------------------------------------------------------------------

def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_value(a[k], b[k])
    else:
        assert a == b or (a != a and b != b)


@pytest.mark.parametrize("jmod,pmod", [(jconst, pconst), (jml, pml),
                                       (jpal, ppal)],
                         ids=["constants", "ml_tables", "palette"])
def test_module_tables_equal(jmod, pmod):
    names = [n for n, v in vars(jmod).items()
             if not n.startswith("__") and not callable(v)
             and not isinstance(v, type(np))]
    assert names
    for n in names:
        _same_value(getattr(pmod, n), getattr(jmod, n))


@pytest.mark.parametrize("sr,fft", [(44100.0, 1024), (48000.0, 2048),
                                    (22050.0, 512), (96000.0, 4096)])
def test_ml_tables_and_mel_scale_equal(sr, fft):
    for fn in ("erb_band_edges", "band_centers_hz", "rd_contour_table",
               "contour_table"):
        _same_value(getattr(pml, fn)(sr, fft), getattr(jml, fn)(sr, fft))
    freqs = np.linspace(20.0, sr / 2, 97)
    for phon in (2.0, 40.0, 90.0):
        _same_value(pml.iso226_spl(freqs, phon), jml.iso226_spl(freqs, phon))
    _same_value(pconst.mel_of_hz(freqs), jconst.mel_of_hz(freqs))
    _same_value(pconst.hz_of_mel(freqs), jconst.hz_of_mel(freqs))
    for f in (50.0, 1000.0, sr / 3):
        assert pml.rd_slope_target(f) == jml.rd_slope_target(f)


@pytest.mark.parametrize("seed", range(4))
def test_mathref_equals_the_original(seed):
    rng = np.random.default_rng(seed)
    C, T = int(rng.integers(2, 15)), int(rng.integers(40, 300))
    a = np.abs(0.5 + 0.2 * rng.standard_normal((C, T))).astype(np.float32)
    b = np.abs(0.5 + 0.2 * rng.standard_normal((C, T))).astype(np.float32)
    norm = np.stack([a.min(axis=1), a.max(axis=1) + 0.1], 1).astype(
        np.float32) if seed % 2 else None
    an, bn = a.copy(), b.copy()
    jmath.normalize(norm, a, 0, T)
    pmath.normalize(norm, an, 0, T)
    np.testing.assert_array_equal(an, a)
    L = int(rng.integers(5, T // 2))
    for off in (0, 3, T - L):
        _same_value(pmath.stat(a, off, L, 0, C), jmath.stat(a, off, L, 0, C))
        _same_value(pmath.avg(a[0], off, L), jmath.avg(a[0], off, L))
        mt, st = jmath.stat(a, 0, L, 0, C)
        bm, bs = jmath.stat(b, off, L, 0, C)
        _same_value(pmath.correlate(a, mt, st, L, C, b, bm, bs, off, 0),
                    jmath.correlate(a, mt, st, L, C, b, bm, bs, off, 0))
    h = L // 2
    with np.errstate(invalid="ignore", divide="ignore"):
        for off in (0, 1, h):
            _same_value(pmath.correlate_half(C, h, bn, off, 0),
                        jmath.correlate_half(C, h, bn, off, 0))


def test_palette_lookups_equal():
    rng = np.random.default_rng(4)
    vals = rng.uniform(-0.2, 1.2, (37, 41)).astype(np.float32)
    vals[0, :3] = [np.nan, np.inf, -np.inf]
    np.testing.assert_array_equal(ppal.apply_palette(vals),
                                  jpal.apply_palette(vals))
    idx = rng.integers(0, ppal.NUM_COLORS, (29, 31))
    np.testing.assert_array_equal(ppal.lookup(idx), jpal.lookup(idx))
    for v in (0.0, 0.3, 1.0, 0.999999):
        assert ppal.intensity_rgb(v) == jpal.intensity_rgb(v)


@pytest.mark.parametrize("h,w", [(1, 1), (17, 23), (300, 257)])
def test_png_bytes_equal(tmp_path, h, w):
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    rgb[h // 2:] = rgb[0]                      # runs that deflate
    jpng.write_png(tmp_path / "j.png", rgb)
    ppng.write_png(tmp_path / "p.png", rgb)
    assert (tmp_path / "p.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    bands = [rgb[y:y + 7] for y in range(0, h, 7)]
    for level in (1, 6):
        jpng.write_png_rows(tmp_path / "jr.png", h, w, iter(bands), level, 2)
        ppng.write_png_rows(tmp_path / "pr.png", h, w, iter(bands), level, 2)
        assert (tmp_path / "pr.png").read_bytes() == \
            (tmp_path / "jr.png").read_bytes()


# ---------------------------------------------------------------------------
# the match selection replay
# ---------------------------------------------------------------------------

def _candidates(pkg, rng, files, per_file, in_sims):
    out = []
    for i in range(files):
        starts = np.sort(rng.integers(0, 10 ** 6, per_file))
        sims = rng.choice([rng.uniform(-1, 1), 0.5, np.nan, 1.0], per_file)
        sims = np.where(rng.uniform(size=per_file) < 0.7,
                        rng.uniform(-1, 1, per_file), sims)
        cands = []
        for s, sim in zip(starts, sims):
            m = pkg.Match(sim=float(sim), file=f"f{i}.aif",
                          punch=pkg.Span(int(s), int(s) + 44100),
                          boost_in=1.0, boost_out=1.0)
            mod = jtopk if pkg is J else ptopk
            cands.append(mod._Candidate(m, float(rng.uniform(-1, 1)))
                         if in_sims else m)
        out.append(cands)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_replay_selection_matches_the_original(seed):
    rng = np.random.default_rng(seed)
    files, per_file = int(rng.integers(1, 12)), int(rng.integers(1, 40))
    k, nper = int(rng.integers(1, 20)), int(rng.integers(1, 4))
    spacing = int(rng.choice([0, 20000, 200000]))
    in_sims, skip_nan = bool(seed % 2), bool(seed % 3 == 0)
    jc = _candidates(J, np.random.default_rng(seed), files, per_file, in_sims)
    pc = _candidates(P, np.random.default_rng(seed), files, per_file, in_sims)
    got = ptopk.replay_selection(pc, k, nper, spacing, skip_nan)
    want = jtopk.replay_selection(jc, k, nper, spacing, skip_nan)
    assert [repr(_fields(getattr(m, "match", m))) for m in got] == \
        [repr(_fields(getattr(m, "match", m))) for m in want]
    assert len(got) >= min(1, files * per_file) or skip_nan


def test_sim_sorted_set_equals_the_original():
    rng = np.random.default_rng(7)
    sets = {"j": jtopk.SimSortedSet(True), "p": ptopk.SimSortedSet(True)}
    other = {"j": jtopk.SimSortedSet(True), "p": ptopk.SimSortedSet(True)}
    for i in range(300):
        sim = float(rng.choice([rng.uniform(-1, 1), 0.5, -0.0, 0.0, np.nan]))
        op = rng.integers(4)
        for tag in ("j", "p"):
            s = sets[tag]
            if op == 0 and len(s):
                s.remove_sim(s.last_sim)
            elif op == 1 and len(s) > 3:
                s.truncate(len(s) - 2)
            else:
                s.add(sim, SimpleNamespace(sim=sim, i=i))
                other[tag].add(-sim, SimpleNamespace(sim=-sim, i=-i))
    for tag in ("j", "p"):
        sets[tag].update(other[tag])
    assert [(repr(m.sim), m.i) for m in sets["p"].items()] == \
        [(repr(m.sim), m.i) for m in sets["j"].items()]
    assert repr(sets["p"].last_sim) == repr(sets["j"].last_sim)
    for v in (0.0, -0.0, 1.0, -1.0, np.nan, np.inf):
        assert ptopk.java_float_key(v) == jtopk.java_float_key(v)


# ---------------------------------------------------------------------------
# files across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["features", "INT16", "INT24", "FLOAT",
                                  "wave"])
def test_audio_files_cross_packages(tmp_path, kind):
    rng = np.random.default_rng(1)
    data = rng.uniform(-0.9, 0.9, (3, 1001)).astype(np.float32)
    if kind == "features":
        js = jaf.feature_spec(3, 44100 / 512)
        ps = paf.feature_spec(3, 44100 / 512)
    else:
        tpe = "WAVE" if kind == "wave" else "AIFF"
        fmt = "INT16" if kind == "wave" else kind
        js = jaf.AudioFileSpec(getattr(jformats, tpe),
                               getattr(jformats.SampleFormat, fmt), 3,
                               48000.0)
        ps = paf.AudioFileSpec(getattr(pformats, tpe),
                               getattr(pformats.SampleFormat, fmt), 3,
                               48000.0)
    assert _fields(ps) == _fields(js)
    jp, pp = tmp_path / f"j.{js.file_type.extension}", \
        tmp_path / f"p.{ps.file_type.extension}"
    jaf.write(jp, data, js)
    paf.write(pp, data, ps)
    assert pp.read_bytes() == jp.read_bytes()
    (a, sa), (b, sb) = paf.read(jp), jaf.read(pp)
    np.testing.assert_array_equal(a, b)
    assert _fields(sa) == _fields(sb)
    assert paf.identify(jp) == to_port(jaf.identify(jp))


def test_native_codec_equals_the_original():
    rng = np.random.default_rng(3)
    data = rng.uniform(-1, 1, (2, 513)).astype(np.float32)
    for fmt in ("int16", "int24", "float"):
        for big in (True, False):
            raw = jnative.encode(data, fmt, big)
            assert pnative.encode(data, fmt, big) == raw
            np.testing.assert_array_equal(
                pnative.decode(raw, 513, 2, fmt, big),
                jnative.decode(raw, 513, 2, fmt, big))
    nans = data.copy()
    nans[:, 100:140] = np.nan
    a, b = nans.copy(), nans.copy()
    assert pnative.fix_nans(a, 64) == jnative.fix_nans(b, 64)
    np.testing.assert_array_equal(a, b)


def test_feature_stats_and_common_helpers_equal(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        f = np.abs(0.5 + 0.2 * rng.standard_normal((14, 300 + 50 * i)))
        p = tmp_path / f"f{i}_feat.aif"
        jaf.write(p, f.astype(np.float32), jaf.feature_spec(14, 86.13))
        paths.append(str(p))
        for got, want in zip(pstats.stats_for_file(p),
                             jstats.stats_for_file(p)):
            np.testing.assert_array_equal(got, want)
    got = pstats.FeatureStats.run(paths).result(timeout=60)
    assert got == jstats.FeatureStats.run(paths).result(timeout=60)
    norm = np.asarray(got, np.float32)
    jaf.write(tmp_path / "feat_norms.aif", norm,
              jaf.AudioFileSpec(num_channels=14, sample_rate=44100.0))
    np.testing.assert_array_equal(pcommon.load_norm(str(tmp_path), 13),
                                  jcommon.load_norm(str(tmp_path), 13))
    feats = rng.standard_normal((14, 50)).astype(np.float32)
    np.testing.assert_array_equal(pcommon.normalized(feats, norm),
                                  jcommon.normalized(feats, norm))
    for n in (0, 1, 255, 256, 257, 10 ** 6 + 3):
        for step in (256, 512):
            assert pcommon.full_to_feat(n, step) == jcommon.full_to_feat(
                n, step)
            assert pcommon.feat_to_full(n, step) == jcommon.feat_to_full(
                n, step)


def test_processor_events_equal():
    def run(mod_processor):
        events = []

        def body(proc):
            for i in range(4):
                proc.check_aborted()
                proc.set_progress((i + 1) / 4)
            return "done"

        proc = mod_processor.Processor(body, observer=events.append).start()
        assert proc.result(timeout=30) == "done"
        return [(type(e).__name__, getattr(e, "fraction", None),
                 getattr(e, "is_success", None)) for e in events]

    from strugatzki_tpu.runtime import processor as jproc
    from strugatzki_tpu_torch.runtime import processor as pproc

    assert run(pproc) == run(jproc)
    p = pproc.Processor(lambda proc: proc.check_aborted()).start()
    p.abort()
    res = p.ready(timeout=30)
    assert res.is_aborted or res.is_success
    assert issubclass(pproc.Aborted, Exception)
    assert pproc.Aborted is not jproc.Aborted


def test_cli_formatting_equals_the_original():
    for v in (0.0, 0.12345, 1.0, -0.5, math.nan, math.inf, -math.inf,
              1e-9, 123.456):
        assert pcli.to_percent_str(v) == jcli.to_percent_str(v)
        assert pcli.to_db_str(v) == jcli.to_db_str(v)
    for s in (0.0, 0.5, 1.25, 3.999):
        assert pcli._secs_to_frames(s, 44100.0) == \
            jcli._secs_to_frames(s, 44100.0)
    for a, b in ((None, None), (0.5, None), (None, 2.0), (0.5, 2.0)):
        assert _fields(pcli._mk_span(a, b, 44100.0)) == \
            _fields(jcli._mk_span(a, b, 44100.0))
    assert pcli._USAGE == jcli._USAGE and pcli.NAME == jcli.NAME


def test_logging_trace_and_profile(tmp_path, monkeypatch):
    """``runtime/logging.py`` held to tests/test_cli_punchout.py:158-175: the
    ``strugatzki`` logger (its own handler, no propagation), ``trace``
    logging its span at DEBUG in the original's words, and ``profile`` a
    no-op without ``STRUGATZKI_PROFILE``; with it, the port writes a
    torch.profiler Chrome trace where the JAX package writes a jax.profiler
    trace."""
    import json
    import logging

    from strugatzki_tpu.runtime import logging as jlog
    from strugatzki_tpu_torch.runtime import logging as plog

    assert plog.logger is jlog.logger               # one logging.getLogger
    assert plog.logger.name == "strugatzki" and not plog.logger.propagate
    assert len(plog.logger.handlers) >= 1
    records = []

    class H(logging.Handler):
        def emit(self, r):
            records.append(r.getMessage())

    h = H()
    plog.logger.addHandler(h)
    old = plog.logger.level
    plog.logger.setLevel(logging.DEBUG)
    try:
        for mod in (plog, jlog):
            with mod.trace("unit-span", file="x.aif"):
                pass
        assert len(records) == 2
        assert all("unit-span took" in m and m.endswith("file=x.aif")
                   for m in records)
        monkeypatch.delenv("STRUGATZKI_PROFILE", raising=False)
        with plog.profile("nothing"):
            pass
        assert not list(tmp_path.iterdir())
        monkeypatch.setenv("STRUGATZKI_PROFILE", str(tmp_path / "prof"))
        with plog.profile("span"):
            np.fft.rfft(np.ones(64))
        trace = json.loads((tmp_path / "prof" / "span.json").read_text())
        assert "traceEvents" in trace
    finally:
        plog.logger.removeHandler(h)
        plog.logger.setLevel(old)


@pytest.mark.parametrize("level,want", [("DEBUG", "10"), ("15", "15"),
                                        ("bogus", "30")])
def test_logging_level_from_the_environment(level, want):
    """``STRUGATZKI_LOG`` sets the level as the original reads it: a name,
    a number, or WARNING with a warning for anything else."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from strugatzki_tpu_torch.runtime.logging import logger; "
            "print(logger.level)")
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code, repo], text=True,
                       capture_output=True, timeout=120,
                       env=dict(os.environ, STRUGATZKI_LOG=level))
    assert r.returncode == 0 and r.stdout.split()[-1] == want, r
    assert ("not a logging level" in r.stderr) == (level == "bogus")
