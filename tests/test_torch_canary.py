"""The port's planted-match canary (``strugatzki_tpu_torch/parallel/
canary.py``) on the CPU: it passes at rounding level in both cache modes,
and a deflated sim or a wrong frame in any family flips it to FAIL."""

import numpy as np
import pytest

from strugatzki_tpu.parallel import canary as JC
from strugatzki_tpu_torch.parallel import canary
from strugatzki_tpu_torch.parallel import database as PD

FAMILIES = {"query_batch", "query_punch_batch", "query", "query_punch"}


@pytest.mark.parametrize("cache_spectra", [False, True])
def test_canary_passes_on_cpu(cache_spectra):
    report = canary.run_batch_canary(cache_spectra=cache_spectra,
                                     device="cpu")
    assert report["pass"], canary.format_report(report)
    assert report["frames_ok"]
    assert set(report["families"]) == FAMILIES
    # rounding-level only: orders of magnitude inside the verdict tolerance
    assert report["worst"] < 1e-5
    assert canary.TOLERANCE == JC.TOLERANCE
    line = canary.format_report(report)
    assert line.startswith("batch-kernel canary: PASS")


def test_canary_fails_on_deflated_sims(monkeypatch):
    """Scale every batched-query sim by 0.95: the canary must FAIL on that
    family alone."""
    orig = PD.FeatureDatabase.query_batch

    def deflated(self, *a, **kw):
        out = orig(self, *a, **kw)
        for r in out:
            r.sims = np.asarray(r.sims) * 0.95
        return out

    monkeypatch.setattr(PD.FeatureDatabase, "query_batch", deflated)
    report = canary.run_batch_canary(device="cpu")
    assert not report["pass"]
    assert report["families"]["query_batch"] > canary.TOLERANCE
    assert report["families"]["query_punch_batch"] < 1e-5
    assert "FAIL" in canary.format_report(report)


def test_canary_fails_on_wrong_frames(monkeypatch):
    orig = PD.FeatureDatabase.query_punch_batch

    def shifted(self, *a, **kw):
        out = orig(self, *a, **kw)
        for r in out:
            r.frames = np.asarray(r.frames) + 1
        return out

    monkeypatch.setattr(PD.FeatureDatabase, "query_punch_batch", shifted)
    report = canary.run_batch_canary(device="cpu")
    assert not report["pass"]
    assert not report["frames_ok"]
    assert "PLANTED FRAMES WRONG" in canary.format_report(report)


def test_canary_layout_guard():
    with pytest.raises(ValueError, match="too short"):
        canary.run_batch_canary(file_frames=400, device="cpu")
