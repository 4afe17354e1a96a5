"""Seeded traffic and data: the same seed gives the same inputs, a run never
repeats a request, and the benchmark's own AIFF codec round-trips."""

import json
import os

import numpy as np
import pytest

from portbench import aiff, harness
from portbench.traffic import database, folder, sound

SEED = 2**31 + 123_456_789          # larger than 32 signed bits hold


def config(name):
    with open(os.path.join(harness.BASE, "configs", f"{name}.json")) as f:
        return json.load(f)


def mix(name):
    with open(os.path.join(harness.BASE, "workloads", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("traffic", ["punch", "query"])
def test_serving_pool_repeats_per_seed_and_never_within_a_run(traffic):
    cfg, m = config("serve10k"), mix(traffic)
    a = database._pool(cfg, m, SEED)
    assert np.array_equal(a, database._pool(cfg, m, SEED))
    assert not np.array_equal(a, database._pool(cfg, m, SEED + 1))
    # one request per file: no two requests of a run are alike, and the
    # pool outlasts a window (a 40 s window at ~50 ms a query is ~800)
    assert len(np.unique(a[:, 0])) == len(a) == m["pool"] >= 4 * 820
    # every cut lies inside its file, a punch's out window too
    T = cfg["frames"]
    assert (a[:, 1] >= 0).all() and (a[:, 1] + m["in_frames"] <= T).all()
    if traffic == "punch":
        span = m["max_punch"] - m["min_punch"]
        assert (a[:, 2] >= 0).all() and (a[:, 2] <= span).all()
        assert (a[:, 1] + m["min_punch"] + a[:, 2] + m["out_frames"]
                <= T).all()


def test_search_pairs_repeat_per_seed_and_never_within_a_run():
    cfg, m = config("slice20"), mix("correlate")
    a = folder._pairs(cfg, m, SEED, 10_335)
    assert np.array_equal(a, folder._pairs(cfg, m, SEED, 10_335))
    assert not np.array_equal(a, folder._pairs(cfg, m, SEED + 1, 10_335))
    assert len({tuple(p) for p in a}) == len(a)
    # the first search is the planted pair (frames of 20 s and 45 s)
    assert tuple(a[0]) == (1723, 3876)


def test_sound_folder_repeats_per_seed(tmp_path):
    cfg = config("slice20")
    cfg.update(files=2, seconds=3)
    cfg["planted"] = {"in_s": [0.5, 1.0], "out_s": [1.5, 1.75],
                      "shift_in": 20, "shift_out": 10, "margin": 1024}
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pcm, target = sound.write_folder(cfg, SEED, str(tmp_path / "a"))
    pcm2, target2 = sound.write_folder(cfg, SEED, str(tmp_path / "b"))
    assert target == target2 and sorted(pcm) == ["db00.aif", "db01.aif",
                                                 "query.aif"]
    for name, x in pcm.items():
        assert np.array_equal(x, pcm2[name])
        back, rate = aiff.read(str(tmp_path / "a" / name))
        assert rate == 44100.0 and back.shape == (1, 3 * 44100)
        assert np.array_equal(back[0], x)
    # the planted punch-in is in the target, whole feature frames later
    q, t = pcm["query.aif"], pcm[target]
    a = int(0.5 * 44100) - 1024
    b = int(1.0 * 44100) + 1024
    assert np.array_equal(t[a + 20 * 512:b + 20 * 512], q[a:b])


def test_feature_files_read_back(tmp_path):
    from strugatzki_tpu_torch.io import audiofile as af

    x = np.random.default_rng(1).random((14, 37)).astype(np.float32)
    path = str(tmp_path / "f_feat.aif")
    af.write(path, x, af.feature_spec(14, 44100 / 512))
    back, rate = aiff.read(path)
    assert back.dtype == np.float32 and np.array_equal(back, x)
    assert rate == pytest.approx(44100 / 512)
