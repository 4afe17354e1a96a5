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


RAW = {f + "[raw]" for f in FAMILIES}


@pytest.mark.parametrize("kw", [dict(cache_spectra="bf16"),
                                dict(storage_dtype="bfloat16")])
def test_reduced_canary_runs_raw_families(kw):
    """A reduced-precision database runs the families twice: re-ranked at
    TOLERANCE and raw (re-rank off) at REDUCED_TOLERANCE; each class
    reports its own worst deviation."""
    report = canary.run_batch_canary(device="cpu", **kw)
    assert report["pass"], canary.format_report(report)
    assert set(report["families"]) == FAMILIES | RAW
    assert canary.REDUCED_TOLERANCE == JC.REDUCED_TOLERANCE
    assert all(report["tols"][f] == canary.REDUCED_TOLERANCE for f in RAW)
    assert report["worst"] <= canary.TOLERANCE
    assert report["worst"] == max(report["families"][f] for f in FAMILIES)
    assert report["worst_raw"] == max(report["families"][f] for f in RAW)
    assert report["worst_raw"] <= canary.REDUCED_TOLERANCE


def test_compact_canary_matches_the_jax_package():
    """The compact canary's families deviate like the JAX package's on the
    same planted database (both quantize the same f32 spectra to bf16)."""
    port = canary.run_batch_canary(n_files=64, cache_spectra="bf16",
                                   device="cpu")
    jax_ = JC.run_batch_canary(n_files=64, cache_spectra="bf16")
    assert port["pass"] and jax_["pass"]
    assert set(port["families"]) == set(jax_["families"])
    for f, v in port["families"].items():
        assert abs(v - jax_["families"][f]) <= canary.TOLERANCE, f


def test_format_report_keeps_each_class_beside_its_tolerance():
    """The headline number never exceeds the headline tolerance: the raw
    families' worst is printed apart, beside its own tolerance."""
    fams = {"query": 2e-7, "query_batch": 1e-6, "query[raw]": 1.2e-3,
            "query_batch[raw]": 5e-4}
    tols = {f: canary.REDUCED_TOLERANCE if f.endswith("[raw]")
            else canary.TOLERANCE for f in fams}
    report = {"families": fams, "tols": tols, "frames_ok": True,
              "pass": True, "worst": 1e-6, "worst_raw": 1.2e-3}
    line = canary.format_report(report)
    assert line.startswith("batch-kernel canary: PASS worst |sim-1|="
                           "1.00e-06 (tol 0.0001); raw worst |sim-1|="
                           "1.20e-03 (tol 0.004) [")
    report.update(worst_raw=None, families={"query": 2e-7},
                  tols={"query": canary.TOLERANCE}, worst=2e-7)
    assert "raw" not in canary.format_report(report)
