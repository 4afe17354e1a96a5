"""The port end to end on the CPU: ``-f`` → ``--stats`` → ``-c`` with
punch-out through both packages' CLIs and correlation factories, then
``-s``, ``-x`` and ``-y`` through both CLIs on one feature folder.

Feature files agree within 2e-5 (the plan budget) and their XML sidecars
byte for byte; ``feat_norms.aif`` within 2e-5 (min and max of those
features); matches match for match: the same files and punch spans, sims
within 3e-5, boosts within rtol 1e-4.  The data has clear gaps between
candidates, so no near tie can resolve differently in the two packages.
The analyses print the same transcripts (break lines included), write PNGs
of equal size, and cross-similarity files of equal length and rate whose
sims agree within 3e-5.
"""

import os
import shutil
import struct

import numpy as np
import pytest

from strugatzki_tpu import CorrelationConfig, Punch, Span
from strugatzki_tpu.analysis import extraction as JE
from strugatzki_tpu.analysis.correlation import FeatureCorrelation as JFC
from strugatzki_tpu.cli import main as jax_main
from strugatzki_tpu.config import ChannelsBehavior
from strugatzki_tpu.io import audiofile as af
from strugatzki_tpu.io.audiofile import AudioFileSpec, SampleFormat
from strugatzki_tpu.io.formats import AIFF
from strugatzki_tpu_torch.analysis import extraction as PE
from strugatzki_tpu_torch.analysis.correlation import FeatureCorrelation as PFC
from strugatzki_tpu_torch.cli import main as port_main
from strugatzki_tpu_torch.dsp.frontend import num_output_frames

SR = 44100


def _write_sounds(snd):
    """A query and four database files of 3 s PCM16.  ``tgt`` holds the
    query's 0.5-1.0 s in place and its 1.5-2.0 s 43 frames later (~2.0 s),
    the scheme of tests/test_cli_punchout.py with frame-aligned offsets and
    a one-window margin, so the planted windows match the punches."""
    rng = np.random.default_rng(3)
    n = 3 * SR
    t = np.arange(n) / SR
    src = (0.4 * np.sin(2 * np.pi * 300 * t)
           + 0.1 * rng.standard_normal(n)).astype(np.float32)
    tgt = (0.2 * rng.standard_normal(n)).astype(np.float32)
    m = 1024
    a, b = int(0.5 * SR) - m, int(1.0 * SR) + m
    tgt[a:b] = src[a:b]
    a, b, d = int(1.5 * SR) - m, int(2.0 * SR) + m, 43 * 512
    tgt[a + d:b + d] = src[a:b]
    sounds = {"src": src, "tgt": tgt}
    for k in range(3):
        f = rng.uniform(150, 900)
        sounds[f"other{k}"] = (0.3 * np.sin(2 * np.pi * f * t)
                               + rng.uniform(0.05, 0.3)
                               * rng.standard_normal(n)).astype(np.float32)
    for name, x in sounds.items():
        af.write(snd / f"{name}.aif", x[None],
                 AudioFileSpec(AIFF, SampleFormat.INT16, 1, float(SR)))


CORR_ARGS = ["--in-start", "0.5", "--in-stop", "1.0", "--in-temp", "0.5",
             "--out-start", "1.5", "--out-stop", "2.0", "--out-temp", "0.5",
             "--dur-min", "1.0", "--dur-max", "2.5", "-m", "3"]


def _corr_config(db):
    def fr(s):
        return int(s * SR + 0.5)
    return CorrelationConfig(
        database_folder=str(db), meta_input=str(db / "src_feat.xml"),
        punch_in=Punch(Span(fr(0.5), fr(1.0)), 0.5),
        punch_out=Punch(Span(fr(1.5), fr(2.0)), 0.5),
        min_punch=fr(1.0), max_punch=fr(2.5), num_matches=3)


def _run(main, db, snd, capsys, extra):
    """-f, --stats and -c through one package's CLI; returns the -c
    transcript."""
    assert main(["-f", "-d", str(db), *extra, str(snd)]) == 0
    assert main(["--stats", "-d", str(db)]) == 0
    capsys.readouterr()
    assert main(["-c", "-d", str(db), *CORR_ARGS, *extra,
                 str(db / "src_feat.xml")]) == 0
    return capsys.readouterr().out


@pytest.fixture
def slice_runs(tmp_path, capsys, monkeypatch):
    snd = tmp_path / "snd"
    db = tmp_path / "db"
    snd.mkdir()
    db.mkdir()
    _write_sounds(snd)
    # the factories' searches skip NaN candidates (the reference admits a
    # NaN sqrt(inSim*outSim) of a negative product, and ranks it first);
    # the CLI runs keep the reference's behaviour
    monkeypatch.setattr(JFC, "skip_nan", True)
    monkeypatch.setattr(PFC, "skip_nan", True)
    jax_out = _run(jax_main, db, snd, capsys, [])
    jax_matches = JFC.run(_corr_config(db)).result()
    shutil.move(str(db), str(tmp_path / "db_jax"))
    db.mkdir()
    port_out = _run(port_main, db, snd, capsys, ["--device", "cpu"])
    monkeypatch.setattr(PFC, "device", "cpu")
    port_matches = PFC.run(_corr_config(db)).result()
    return tmp_path, jax_out, port_out, jax_matches, port_matches


def test_slice_agrees_with_jax(slice_runs):
    root, jax_out, port_out, jax_matches, port_matches = slice_runs
    db, db_jax = root / "db", root / "db_jax"
    names = sorted(os.listdir(db_jax))
    assert sorted(os.listdir(db)) == names
    assert "feat_norms.aif" in names and "tgt_feat.xml" in names
    for name in names:
        if name.endswith("_feat.xml"):
            assert (db / name).read_bytes() == (db_jax / name).read_bytes()
        elif name.endswith(".aif"):
            a, spec_a = af.read(str(db / name))
            b, spec_b = af.read(str(db_jax / name))
            assert spec_a == spec_b and a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=2e-5, err_msg=name)

    assert len(port_matches) == len(jax_matches) == 3
    for p, j in zip(port_matches, jax_matches):
        assert (p.file, p.punch) == (j.file, j.punch)
        assert abs(p.sim - j.sim) < 3e-5
        np.testing.assert_allclose([p.boost_in, p.boost_out],
                                   [j.boost_in, j.boost_out], rtol=1e-4)
    assert port_matches[0].file.endswith("tgt.aif")
    assert port_matches[0].sim > 0.99

    # the CLI transcripts of -c print the same matches
    assert "Span stop" in port_out and "tgt.aif" in port_out
    assert port_out == jax_out


def test_streaming_extraction_matches_jax(tmp_path, monkeypatch, capsys):
    """Files above the streaming threshold take the bounded-memory path,
    through the factory and through the grouped ``-f`` chain alike."""
    snd = tmp_path / "snd"
    snd.mkdir()
    _write_sounds(snd)
    monkeypatch.setattr(JE, "STREAMING_THRESHOLD", 20000)
    monkeypatch.setattr(PE, "STREAMING_THRESHOLD", 20000)
    out = {}
    for tag, mod, extra in (("jax", JE, {}), ("port", PE, {"device": "cpu"})):
        db = tmp_path / tag
        db.mkdir()
        assert mod.extract_batch_cli([str(snd / "src.aif"),
                                      str(snd / "tgt.aif")],
                                     str(db), ChannelsBehavior.MIX,
                                     **extra) == 0
        out[tag] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    for name in ("src_feat.aif", "tgt_feat.aif"):
        a, _ = af.read(str(tmp_path / "port" / name))
        b, _ = af.read(str(tmp_path / "jax" / name))
        assert a.shape == b.shape == (14, num_output_frames(3 * SR, 512))
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_copied_extraction_helpers_equal_the_originals():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 2500)).astype(np.float32)
    feats[rng.uniform(size=feats.shape) < 0.2] = np.nan
    feats[:, 1024:1030] = np.nan
    np.testing.assert_array_equal(PE.fix_nans(feats), JE.fix_nans(feats))
    assert not np.isnan(PE.fix_nans(feats)).any()

    block = rng.uniform(-0.5, 0.5, (2, 100)).astype(np.float32)
    for fmt in (SampleFormat.INT16, SampleFormat.FLOAT):
        for chans in (1, 2):
            spec = AudioFileSpec(AIFF, fmt, chans, 44100.0)
            for mode in (ChannelsBehavior.MIX, ChannelsBehavior.FIRST,
                         ChannelsBehavior.LAST):
                class Cfg:
                    channels_behavior = mode
                a = PE._collapse_mono(block[:chans], spec, Cfg)
                b = JE._collapse_mono(block[:chans], spec, Cfg)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.fixture
def feature_folder(tmp_path, capsys):
    """The sounds of ``_write_sounds`` through the port's ``-f`` and
    ``--stats``: the folder both CLIs analyse below."""
    snd, db = tmp_path / "snd", tmp_path / "db"
    snd.mkdir()
    db.mkdir()
    _write_sounds(snd)
    assert port_main(["-f", "-d", str(db), "--device", "cpu", str(snd)]) == 0
    assert port_main(["--stats", "-d", str(db)]) == 0
    capsys.readouterr()
    return db


def _both_clis(capsys, args):
    """One analysis through the JAX CLI, then the port's on the CPU;
    returns both transcripts."""
    assert jax_main(list(args)) == 0
    jax_out = capsys.readouterr().out
    assert port_main(list(args) + ["--device", "cpu"]) == 0
    return jax_out, capsys.readouterr().out


def test_segmentation_cli_matches_jax(feature_folder, capsys):
    db = feature_folder
    jax_out, port_out = _both_clis(
        capsys, ["-s", "-d", str(db), "--length", "0.25", "-m", "4",
                 "--spacing", "0.1", "--span-start", "0.2",
                 str(db / "tgt_feat.xml")])
    assert port_out.count("Position:") == 4
    assert port_out == jax_out


@pytest.mark.parametrize("extra", [[], ["-c", "gray", "-i", "-m", "2",
                                        "--input2"]])
def test_selfsim_cli_matches_jax(feature_folder, capsys, extra):
    """The psycho palette over one file, and the gray inverted cross image
    of two files at decimation 2: transcripts and PNG sizes equal."""
    db = feature_folder
    if extra:
        extra = extra + [str(db / "other0_feat.xml")]
    sizes = {}
    outs = []
    for tag, main, dev in (("jax", jax_main, []),
                           ("port", port_main, ["--device", "cpu"])):
        png = db / f"{tag}.png"
        assert main(["-x", "-d", str(db), "--length", "0.3", *extra, *dev,
                     str(db / "src_feat.xml"), str(png)]) == 0
        outs.append(capsys.readouterr().out)
        raw = png.read_bytes()
        sizes[tag] = struct.unpack(">II", raw[16:24])
    n = (num_output_frames(3 * SR, 512) - 2 * 26 + 1) // (2 if extra else 1)
    assert sizes["port"] == sizes["jax"] == (n, n)
    assert "Done." in outs[1] and outs[0] == outs[1]


def test_cross_cli_matches_jax(feature_folder, capsys):
    db = feature_folder
    outs, files = [], []
    for tag, main, dev in (("jax", jax_main, []),
                           ("port", port_main, ["--device", "cpu"])):
        out = db / f"{tag}_cross.aif"
        assert main(["-y", "-d", str(db), "--span2-start", "0.5",
                     "--span2-stop", "1.0", *dev, str(db / "tgt_feat.xml"),
                     str(db / "src_feat.xml"), str(out)]) == 0
        outs.append(capsys.readouterr().out)
        files.append(af.read(str(out)))
    (p, ps), (j, js) = files[1], files[0]
    assert (ps.num_frames, ps.sample_rate) == (js.num_frames, js.sample_rate)
    assert ps.num_frames == num_output_frames(3 * SR, 512) - 43 + 1
    np.testing.assert_allclose(p, j, atol=3e-5, rtol=0)
    # the planted 0.5-1.0 s sits in place in tgt
    assert int(np.argmax(p[0])) == 43
    assert "Success." in outs[1] and outs[0] == outs[1]
