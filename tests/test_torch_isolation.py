"""The port stands apart from JAX: its analyses (``-f``, ``--stats``,
``-c``, ``-s``, ``-x``, ``-y``, and a resident ``FeatureDatabase`` queried,
saved and loaded, in its capacity modes too) run without importing jax, and ``chip_smoke.py`` fails
loudly where there is no CUDA card."""

import os
import shutil
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SLICE = textwrap.dedent("""
    import os, pkgutil, sys, importlib
    import numpy as np
    import strugatzki_tpu_torch
    from strugatzki_tpu_torch.cli import main
    from strugatzki_tpu_torch.io import AIFF, AudioFileSpec, SampleFormat
    from strugatzki_tpu_torch.io import audiofile as af

    for m in pkgutil.walk_packages(strugatzki_tpu_torch.__path__,
                                   "strugatzki_tpu_torch."):
        if m.name != "strugatzki_tpu_torch.__main__":
            importlib.import_module(m.name)
    import chip_smoke  # noqa: F401

    root = sys.argv[1]
    snd, db = os.path.join(root, "snd"), os.path.join(root, "db")
    os.makedirs(snd)
    os.makedirs(db)
    rng = np.random.default_rng(0)
    spec = AudioFileSpec(AIFF, SampleFormat.INT16, 1, 44100.0)
    src = (0.2 * rng.standard_normal(66150)).astype(np.float32)
    for name in ("a", "b"):
        x = (0.2 * rng.standard_normal(66150)).astype(np.float32)
        x[22050:44100] = src[22050:44100]
        af.write(os.path.join(snd, name + ".aif"), x[None], spec)
    af.write(os.path.join(snd, "src.aif"), src[None], spec)
    assert main(["-f", "-d", db, "--device", "cpu", snd]) == 0
    assert main(["--stats", "-d", db]) == 0
    assert main(["-c", "-d", db, "--in-start", "0.5", "--in-stop", "1.0",
                 "--dur-min", "0.5", "--dur-max", "1.0", "-m", "2",
                 "--device", "cpu", os.path.join(db, "src_feat.xml")]) == 0
    assert main(["-s", "-d", db, "--length", "0.2", "-m", "2", "--device",
                 "cpu", os.path.join(db, "a_feat.xml")]) == 0
    png = os.path.join(root, "a.png")
    assert main(["-x", "-d", db, "--length", "0.2", "--device", "cpu",
                 os.path.join(db, "a_feat.xml"), png]) == 0
    assert open(png, "rb").read(4)[1:] == b"PNG"
    cross = os.path.join(root, "cross.aif")
    assert main(["-y", "-d", db, "--span2-start", "0.5", "--span2-stop",
                 "1.0", "--device", "cpu", os.path.join(db, "a_feat.xml"),
                 os.path.join(db, "src_feat.xml"), cross]) == 0
    sims, _ = af.read(cross)
    assert int(np.argmax(sims[0])) == 43, sims

    from strugatzki_tpu_torch import FeatureDatabase
    from strugatzki_tpu_torch.analysis.correlation import InputTemplate
    fdb = FeatureDatabase.from_folder(db, device="cpu")
    feats, _ = af.read(os.path.join(db, "src_feat.aif"))
    t_in = InputTemplate.from_features(feats, fdb.norm, 43, 86)
    t_out = InputTemplate.from_features(feats, fdb.norm, 100, 120)
    res = fdb.query(t_in, k=2)
    top = res.matches(43, 512, 3)
    assert [m.punch.start for m in top] == [43 * 512] * 3, top
    assert top[0].file.endswith("src.aif") and top[0].sim > 0.999, top
    pres = fdb.query_punch(t_in, t_out, 20, 60, k=2)
    assert pres.sims.shape == (3, 2)
    path = os.path.join(root, "fdb.npz")
    fdb.save(path)
    back = FeatureDatabase.load(path, device="cpu")
    assert back.files == fdb.files
    assert (back.query(t_in, k=2).frames == res.frames).all()
    # the capacity modes: a memmap store streamed from the archive, bf16
    # features and the compact cache
    modes = FeatureDatabase.load(path, device="cpu", raw_store="memmap",
                                 storage_dtype="bf16", cache_spectra="bf16")
    top = modes.query_punch(t_in, t_out, 20, 60, k=2).matches(512, 1)
    assert top[0].file.endswith("src.aif") and top[0].sim > 0.999, top
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_port_slice_runs_without_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", _SLICE, str(tmp_path)],
                       capture_output=True, text=True, cwd=REPO, env=_env(),
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout
    assert "Success." in r.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    no_card = _env(CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, cwd=REPO, env=no_card, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "CUDA is not available" in r.stderr

    # alone in a directory, without the package beside it
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
