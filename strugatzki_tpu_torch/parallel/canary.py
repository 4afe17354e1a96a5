"""Planted-match canary for the port's serving queries.

It plants exact matches (the reference's own ``correlate(a, a) == 1``
guarantee, impl/MathUtil.scala:195) in a synthetic database and pushes them
through the four production query families of
:class:`~.database.FeatureDatabase` — ``query_batch``,
``query_punch_batch``, ``query`` and ``query_punch`` — asserting that every
planted hit comes back at its planted frames with a sim within
:data:`TOLERANCE` of 1.  A wrong FFT length, a broken files-step split, a
top-k that loses or reorders hits, or a deflated trace on some device all
show up here.  Run it on the device being validated::

    from strugatzki_tpu_torch.parallel.canary import (format_report,
                                                      run_batch_canary)
    print(format_report(run_batch_canary(device="cuda")))

The shape is the JAX package's canary: 256 files of 1,200 frames, 8
templates of 96 frames and punch-outs of 48, each planted in its own file
at a template-distinct offset.  A reduced-precision database (the compact
spectra cache or bf16 features) also runs the families as ``[raw]`` ones,
without the exact re-rank, at :data:`REDUCED_TOLERANCE`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["run_batch_canary", "format_report"]

#: FAIL when any planted sim deviates from 1.0 by more than this.  Float32
#: FFT rounding on a planted exact match is orders of magnitude below it.
TOLERANCE = 1e-4

#: Tolerance for the RAW device sims of a reduced-precision database (the
#: compact bf16 spectra cache or bf16 features) with the exact re-rank off:
#: bf16 quantization puts up to ~1e-3 of noise on a trace, which the exact
#: re-rank removes from the results held to :data:`TOLERANCE`.
REDUCED_TOLERANCE = 4e-3


def run_batch_canary(n_files: int = 256, file_frames: int = 1200,
                     num_queries: int = 8, l_in: int = 96, l_out: int = 48,
                     seed: int = 0, cache_spectra=False, storage_dtype=None,
                     device="cuda", mesh=None) -> dict:
    """Plant exact matches, run the four query families on ``device`` (or
    on a database sharded over ``mesh``), report.

    On a reduced-precision database (``cache_spectra="bf16"`` or
    ``storage_dtype=torch.bfloat16``) the families run twice: with the
    default exact re-rank at :data:`TOLERANCE`, and as ``[raw]`` families
    with ``exact_rerank=False`` at :data:`REDUCED_TOLERANCE` — the re-rank
    alone would hide a uniform deflation of the traces, since deflated but
    correctly ranked candidates re-rank to an exact 1.

    Returns a dict: ``pass`` (bool), ``worst`` (max ``|sim − 1|`` over the
    families held to :data:`TOLERANCE`), ``worst_raw`` (the same over the
    ``[raw]`` families, or None), per-family worsts (``families``) and
    tolerances (``tols``), and ``frames_ok`` (every planted hit surfaced at
    its planted offset).  A pure function of ``seed``: no files touched,
    ~40 MB of synthetic features staged.
    """
    from ..analysis.correlation import InputTemplate
    from .database import FeatureDatabase

    rng = np.random.default_rng(seed)
    base = rng.uniform(0.3, 0.7, size=(n_files, 14, 1)).astype(np.float32)
    feats = np.abs(base + 0.1 * rng.standard_normal(
        (n_files, 14, file_frames)).astype(np.float32))
    entries = [(f"f{i}.aif", feats[i]) for i in range(n_files)]

    # plant query templates and punch pairs in distinct, non-adjacent files
    # (file q·stride), each at a query-distinct offset so a frame collision
    # can't mask a wrong index
    stride = max(1, n_files // max(1, num_queries) - 1)
    o_in = 100
    o_out = o_in + 2 * l_in + 200              # punch distance D = o_out−o_in
    d_punch = o_out - o_in
    min_punch, max_punch = d_punch - 50, d_punch + 50
    if o_out + l_out + num_queries >= file_frames:
        raise ValueError("file_frames too short for the planted layout")
    tmpls, pairs, planted = [], [], []
    for q in range(num_queries):
        f = (q * stride + 1) % n_files
        src = feats[f]
        tmpls.append(InputTemplate(src[:, o_in + q:o_in + q + l_in].copy()))
        pairs.append((tmpls[-1],
                      InputTemplate(src[:, o_out + q:o_out + q + l_out]
                                    .copy()),
                      min_punch, max_punch))
        planted.append((f, o_in + q))

    db = FeatureDatabase(entries, norm=None, cache_spectra=cache_spectra,
                         storage_dtype=storage_dtype, device=device,
                         mesh=mesh)
    report = {"families": {}, "tols": {}, "frames_ok": True}

    def record(name: str, devs, frames_ok: bool, tol: float) -> None:
        report["families"][name] = float(np.max(devs))
        report["tols"][name] = tol
        report["frames_ok"] = report["frames_ok"] and frames_ok

    def run_families(suffix: str = "", tol: float = TOLERANCE,
                     **kw) -> None:
        qb = db.query_batch(tmpls, k=2, **kw)
        devs, f_ok = [], True
        for q, (f, off) in enumerate(planted):
            devs.append(abs(float(qb[q].sims[f, 0]) - 1.0))
            f_ok &= int(qb[q].frames[f, 0]) == off
        record("query_batch" + suffix, devs, f_ok, tol)

        pb = db.query_punch_batch(pairs, k=2, **kw)
        devs, f_ok = [], True
        for q, (f, off) in enumerate(planted):
            devs.append(abs(float(pb[q].sims[f, 0]) - 1.0))
            # punch_lens is the matched length − min_punch
            f_ok &= (int(pb[q].frames[f, 0]) == off
                     and min_punch + int(pb[q].punch_lens[f, 0]) == d_punch)
        record("query_punch_batch" + suffix, devs, f_ok, tol)

        sq = db.query(tmpls[0], k=2, **kw)
        f0, off0 = planted[0]
        record("query" + suffix, [abs(float(sq.sims[f0, 0]) - 1.0)],
               int(sq.frames[f0, 0]) == off0, tol)
        sp = db.query_punch(pairs[0][0], pairs[0][1], min_punch=min_punch,
                            max_punch=max_punch, k=2, **kw)
        record("query_punch" + suffix, [abs(float(sp.sims[f0, 0]) - 1.0)],
               int(sp.frames[f0, 0]) == off0
               and min_punch + int(sp.punch_lens[f0, 0]) == d_punch, tol)

    run_families()
    if db._reduced:
        run_families(suffix="[raw]", tol=REDUCED_TOLERANCE,
                     exact_rerank=False)

    fams, tols = report["families"], report["tols"]

    def worst(tol):
        devs = [v for k, v in fams.items() if tols[k] == tol]
        return max(devs) if devs else None

    report["worst"] = worst(TOLERANCE)
    report["worst_raw"] = worst(REDUCED_TOLERANCE)
    report["pass"] = bool(report["frames_ok"] and all(
        fams[k] <= tols[k] for k in fams))
    return report


def format_report(report: dict) -> str:
    """One status line: ``batch-kernel canary: PASS/FAIL ...``, with the
    worst deviation of each tolerance class beside its own tolerance."""
    fams = ", ".join(f"{k} |Δ|={v:.2e}"
                     for k, v in sorted(report["families"].items()))
    verdict = "PASS" if report["pass"] else "FAIL"
    extra = "" if report["frames_ok"] else "; PLANTED FRAMES WRONG"
    raw = "" if report.get("worst_raw") is None else (
        f"; raw worst |sim-1|={report['worst_raw']:.2e} "
        f"(tol {REDUCED_TOLERANCE:g})")
    return (f"batch-kernel canary: {verdict} worst |sim-1|="
            f"{report['worst']:.2e} (tol {TOLERANCE:g}){raw} [{fams}]"
            f"{extra}")
