#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA Hopper card.  It
drives the README quick start through the port (``strugatzki_tpu_torch``):

1. device: the card's name and power limit, and the full-f32 matmul settings;
2. build: ``csrc/prep.cu`` with nvcc for sm_90a;
3. kernel: the prep kernel against its plain PyTorch version on the card, at
   the slice's chunk shape ``[32, 14, _bucket(10335)]`` and on ragged batches
   with zero-length files and degenerate norm rows, and both timed;
4. slice: 20 PCM16 files of 120 s plus a query, written from the seed;
   ``-f`` over the folder, ``--stats``, and a punch-in/punch-out search
   (``FeatureCorrelation``, temporal weight 0.5, 12-20 s, top 10) on CUDA.
   One database file holds the query's 20-30 s at ~40 s and its 45-50 s at
   ~55 s; the search must rank it first at exactly those frames.  One file's
   features and one chunk's traces are held against the CPU.
5. database: the resident ``FeatureDatabase``.  The tie-stable top-k on the
   card against the CPU; the planted-match canary through the four query
   families with and without the spectra cache; a seeded 64-file database
   on CUDA against the same database on the CPU (``query``,
   ``query_punch``, mixed-length ``query_batch``, ``query_punch_batch``,
   the exact re-rank, and the device re-rank against the host f64 oracle);
   the prep kernel at the staging slab shape, timed; then the deployment
   README.md's north star names: 10,000 two-minute files staged with the
   spectra cache, a 10 s punch-in and a 5 s punch-out planted in one file,
   which must rank first in ``query`` and ``query_punch`` (12-20 s) with
   sim > 0.999.  It prints the staging time, the first and warm latencies
   of the four query families and of the exact re-rank, the peak device
   memory of staging and of the queries, and a profile of one warm
   ``query`` and ``query_punch``; then it stages the same files without the
   spectra cache and times ``query`` and ``query_punch`` again.
   modes: the database's capacity modes.  The canary with the compact
   spectra cache and with bfloat16 features, exact families at 1e-4 and
   ``[raw]`` ones at 4e-3; on 64 north-star files the compact cache's raw
   sims against the complex64 cache's over every valid window; a 64-file
   database A (memmap raw store, compact cache) and B (bfloat16 features,
   compact cache) on CUDA against the same on the CPU.  Then A and B at
   10,000 two-minute files made file by file from the seed, one after the
   other: A streamed from a generator into the memmap store (f32 features,
   device re-rank), B in memory (host f64 re-rank).  For each: staging
   seconds, resident GB, peak device memory, first and warm latencies of
   the four query families, the planted match first with a re-ranked sim
   > 0.999 and a raw sim within 4e-3 of it; for A also VmRSS, the temp
   file and its file system's free space, and a profile of one warm
   compact ``query`` and ``query_punch``.
6. analyses: BASELINE.json's segmentation and self-similarity configs and a
   cross-similarity, written from the seed as PCM16 and run through ``-f``,
   ``--stats`` and the three factories on CUDA.  ``-s`` on a 5-minute
   recording of five timbres (boundaries at 60/120/180/240 s, a stretch of
   digital silence), corrLen 44100, 20 breaks: the novelty curve and the
   breaks against the CPU, a break near every boundary.  ``-x`` on a
   3-minute piece in which a 30 s passage recurs, corrLen 44100, at
   decimation 1 (the streamed PNG) and 2 (in memory), psycho and gray
   inverted: 8 sampled block pairs against the CPU, the recurrence above
   0.999, the device raster bit-equal to the host quantization of the same
   sims (FMA tie cases included), every PNG decoded to its extent.  ``-y``
   of the piece against a 20 s excerpt of itself: the trace against the
   CPU, its length, rate and peak.  It prints each analysis's first and
   warm wall time, the peak device memory, and for ``-x`` a profile of the
   device time beside the host's colorize and deflate.

Every phase that drives a path of the port sets the prep kernel's counters
to 0 just before and reads them just after: the slice and the database must
launch the kernel and never its plain version; the analyses (``-s``, ``-x``,
``-y``) prepare on the host and must not reach the plain version.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit from nvidia-smi, and the
one before that the kernels' launch counts (summed over the paths driven)
and times as JSON.  Any failed check raises: the script then exits non-zero
and prints no result line.
Without CUDA, or without the package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SR = 44100
STEP = 512

#: the slice's deployment (BASELINE.json's correlation config, scaled to
#: two-minute files): 20 database files, a 10 s punch-in, a 5 s punch-out
DB_FILES = 20
SECONDS = 120
PUNCH_IN = (20.0, 30.0)
PUNCH_OUT = (45.0, 50.0)
DUR = (12.0, 20.0)
NUM_MATCHES = 10
TEMP_WEIGHT = 0.5
#: where the target holds the punches, in feature frames after the query's
#: own position (~20 s and ~10 s: frame-aligned, so the planted windows
#: equal the query's windows sample for sample)
SHIFT_IN = 1723
SHIFT_OUT = 861
#: samples planted on each side of a punch beyond its span: one window
MARGIN = 1024


class CheckFailed(RuntimeError):
    pass


def require(ok, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 3: the prep kernel against its plain version
# ---------------------------------------------------------------------------

def _features(rng, B, C, T, lens):
    """Feature-like stacks: loudness/32 in [0, 0.6], MFCC rows around 0.5,
    zero past each file's length (as ``pad_stack`` leaves them)."""
    x = np.empty((B, C, T), np.float32)
    x[:, 0] = rng.uniform(0.0, 0.6, (B, T))
    x[:, 1:] = rng.normal(0.5, 0.1, (B, C - 1, T))
    for b, n in enumerate(lens):
        x[b, :, n:] = 0.0
    return x


def _norm_of(x, lens):
    rows = np.concatenate([x[b, :, :n] for b, n in enumerate(lens) if n],
                          axis=1)
    return np.stack([rows.min(axis=1), rows.max(axis=1)], 1).astype(np.float32)


def _close(a, b, rtol=1e-5):
    """Elementwise: equal (NaN to NaN, inf to the same inf) or, where
    finite, within ``rtol`` (the two sum the shifts in another order)."""
    a, b = np.asarray(a), np.asarray(b)
    with np.errstate(invalid="ignore"):
        return (a == b) | (np.isnan(a) & np.isnan(b)) | (
            np.isfinite(b) & (np.abs(a - b) <= rtol * np.abs(b)))


def compare_prep(feats, norm, lens, nt):
    """Kernel and plain version on the card; returns the max |error| over
    finite values after checking every stated tolerance."""
    import torch

    from strugatzki_tpu_torch.kernels import prep

    dev = torch.device("cuda")
    f = torch.as_tensor(feats, device=dev)
    n = torch.as_tensor(norm, device=dev)
    ln = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    out_k, sh_k = prep.prepare_database_cuda(f, n, ln, nt)
    out_r, sh_r = prep.prepare_database_reference(f, n, ln, nt)
    torch.cuda.synchronize()
    out_k, sh_k = out_k.cpu().numpy(), sh_k.cpu().numpy()
    out_r, sh_r = out_r.cpu().numpy(), sh_r.cpu().numpy()

    require((np.isnan(out_k) == np.isnan(out_r)).all(), "NaN positions")
    require((np.isposinf(out_k) == np.isposinf(out_r)).all()
            and (np.isneginf(out_k) == np.isneginf(out_r)).all(),
            "inf positions")
    fin = np.isfinite(out_r)
    err = float(np.abs(out_k[fin] - out_r[fin]).max()) if fin.any() else 0.0
    require(err <= 1e-6, f"finite values differ by {err:.3e} > 1e-6")
    require(_close(sh_k, sh_r).all(), "temporal shifts differ beyond rtol 1e-5")
    for b, ln_b in enumerate(lens):
        tail = out_k[b, :, ln_b:]
        if tail.shape[1] == 0:
            continue
        require(np.array_equal(tail[:nt], np.full_like(tail[:nt], -sh_k[b]),
                               equal_nan=True), f"temporal tail of file {b}")
        s = tail[nt:]
        require(np.array_equal(s, np.full_like(s, s[0, 0]), equal_nan=True),
                f"spectral tail of file {b} is not one constant")
        require(_close(s[0, 0], out_r[b, nt, ln_b]),
                f"spectral shift of file {b}")
    return err


def kernel_phase(seed: int, card: str):
    import torch

    from strugatzki_tpu_torch.analysis.correlation import CHUNK_SIZE, _bucket
    from strugatzki_tpu_torch.dsp.frontend import num_output_frames
    from strugatzki_tpu_torch.kernels import prep

    rng = np.random.default_rng(seed)
    frames = num_output_frames(SECONDS * SR, STEP)
    B, C, T = CHUNK_SIZE, 14, _bucket(frames)
    lens = [frames] * DB_FILES + [0] * (B - DB_FILES)
    feats = _features(rng, B, C, T, lens)
    norm = _norm_of(feats, lens)
    err = compare_prep(feats, norm, lens, 1)
    print(f"kernel: prep [{B}, {C}, {T}] vs plain: max |err| {err:.3e} "
          f"(atol 1e-6), shifts within rtol 1e-5, tails exactly -shift")

    lens_r = [3000, 0, 1, 1023, 1024, 2999, 1777]
    for name, row, nt in (("spectral", 5, 1), ("temporal", 0, 1),
                          ("two temporal rows", 1, 2)):
        f = _features(rng, len(lens_r), C, 3000, lens_r)
        nrm = _norm_of(f, lens_r)
        nrm[row, 1] = nrm[row, 0]
        f[0, row, :7] = nrm[row, 0]          # 0/0 as well as x/0
        e = compare_prep(f, nrm, lens_r, nt)
        print(f"kernel: ragged {lens_r}, degenerate {name} norm row, "
              f"num_temporal {nt}: max |err| {e:.3e}")

    dev = torch.device("cuda")
    ft = torch.as_tensor(feats, device=dev)
    nt_ = torch.as_tensor(norm, device=dev)
    lt = torch.as_tensor(lens, dtype=torch.int32, device=dev)

    def kern():
        prep.prepare_database_cuda(ft, nt_, lt, 1)

    def plain():
        prep.prepare_database_reference(ft, nt_, lt, 1)

    iters = 200
    runs = [("plain", cuda_ms(plain, iters)), ("kernel", cuda_ms(kern, iters)),
            ("kernel", cuda_ms(kern, iters)), ("plain", cuda_ms(plain, iters))]
    ms = sum(t for k, t in runs if k == "kernel") / 2
    plain_ms = sum(t for k, t in runs if k == "plain") / 2
    moved = 3 * B * C * T * 4
    print(f"kernel: prep {ms:.4f} ms/call vs plain {plain_ms:.4f} ms/call "
          f"(runs {', '.join(f'{k} {t:.4f}' for k, t in runs)}; "
          f"{moved / ms / 1e6:.0f} GB/s at 3 passes of [B,C,T] f32) "
          f"on {card}")
    return err, ms, plain_ms


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

def _sound(rng, seconds: int) -> np.ndarray:
    """Noise re-coloured every second (random spectral tilt and level), so
    both the loudness row and the MFCC rows move."""
    seg = rng.standard_normal((seconds, SR))
    spec = np.fft.rfft(seg, axis=1)
    f = np.arange(spec.shape[1]) / spec.shape[1]
    tilt = rng.uniform(0.0, 2.0, (seconds, 1))
    gain = rng.uniform(0.02, 0.25, (seconds, 1))
    spec *= gain * (1.0 + f / 0.02) ** -tilt
    x = np.fft.irfft(spec, n=SR, axis=1).reshape(-1)
    return (x / max(1.0, np.abs(x).max() / 0.9)).astype(np.float32)


def write_sounds(snd: str, seed: int):
    """The query and the database files; returns the target's name and the
    punch frames it must be found at."""
    from strugatzki_tpu_torch.io import AIFF, AudioFileSpec, SampleFormat
    from strugatzki_tpu_torch.io import audiofile as af

    rng = np.random.default_rng(seed)
    spec = AudioFileSpec(AIFF, SampleFormat.INT16, 1, float(SR))
    query = _sound(rng, SECONDS)
    af.write(os.path.join(snd, "query.aif"), query[None], spec)
    target = DB_FILES // 2
    for i in range(DB_FILES):
        x = _sound(rng, SECONDS)
        if i == target:
            for (s0, s1), shift in ((PUNCH_IN, SHIFT_IN),
                                    (PUNCH_OUT, SHIFT_OUT)):
                a, b = int(s0 * SR) - MARGIN, int(s1 * SR) + MARGIN
                d = shift * STEP
                x[a + d:b + d] = query[a:b]
        af.write(os.path.join(snd, f"db{i:02d}.aif"), x[None], spec)

    def frame(s):                   # the reference's full_to_feat(secs)
        return (int(s * SR + 0.5) + STEP // 2) // STEP

    return (f"db{target:02d}.aif", (frame(PUNCH_IN[0]) + SHIFT_IN) * STEP,
            (frame(PUNCH_OUT[0]) + SHIFT_OUT) * STEP)


def _corr_config(db: str):
    from strugatzki_tpu_torch import CorrelationConfig, Punch, Span

    def fr(s):
        return int(s * SR + 0.5)     # the CLI's secs → frames
    return CorrelationConfig(
        database_folder=db, meta_input=os.path.join(db, "query_feat.xml"),
        punch_in=Punch(Span(fr(PUNCH_IN[0]), fr(PUNCH_IN[1])), TEMP_WEIGHT),
        punch_out=Punch(Span(fr(PUNCH_OUT[0]), fr(PUNCH_OUT[1])),
                        TEMP_WEIGHT),
        min_punch=fr(DUR[0]), max_punch=fr(DUR[1]), num_matches=NUM_MATCHES)


def run_slice(snd: str, db: str):
    """``-f`` and ``--stats`` through the CLI, then the search through the
    correlation factory, all on CUDA; returns (matches, -f seconds, -c
    seconds)."""
    from strugatzki_tpu_torch import FeatureCorrelation
    from strugatzki_tpu_torch.cli import main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(["-f", "-d", db, "--device", "cuda", snd])
    t_f = time.perf_counter() - t0
    require(rc == 0, f"-f exited {rc}:\n{out.getvalue()}")
    n_ok = out.getvalue().count("Success.")
    with contextlib.redirect_stdout(out):
        rc = main(["--stats", "-d", db])
    require(rc == 0, f"--stats exited {rc}:\n{out.getvalue()}")
    print(f"slice: -f wrote {n_ok} feature files, --stats wrote feat_norms.aif")

    # skip_nan: sqrt(inSim*outSim) of a negative product is NaN, and the
    # reference ranks a NaN match first; this search wants real matches
    FeatureCorrelation.device = "cuda"
    FeatureCorrelation.skip_nan = True
    t0 = time.perf_counter()
    matches = FeatureCorrelation.run(_corr_config(db)).result()
    t_c = time.perf_counter() - t0
    return matches, t_f, t_c


def check_matches(matches, target: str, start: int, stop: int) -> None:
    for m in matches[:3]:
        print(f"slice: match {os.path.basename(m.file)} "
              f"span [{m.punch.start}, {m.punch.stop}) sim {m.sim:.7f} "
              f"boost in {m.boost_in:.4f} out {m.boost_out:.4f}")
    require(len(matches) == NUM_MATCHES, f"{len(matches)} matches")
    top = matches[0]
    require(os.path.basename(top.file) == target,
            f"top match {top.file}, planted in {target}")
    require((top.punch.start, top.punch.stop) == (start, stop),
            f"top span {top.punch}, planted at [{start}, {stop})")
    require(top.sim > 0.999, f"top sim {top.sim}")
    require(all(np.isfinite(m.sim) and -1.0 <= m.sim <= 1.0 + 1e-6
                for m in matches), "match sims")


def cpu_checks(snd: str, db: str, target: str) -> None:
    """One file's CUDA features and one chunk's CUDA traces against the
    port's CPU path."""
    from strugatzki_tpu_torch.analysis.correlation import (
        CHUNK_SIZE, InputTemplate, _bucket)
    from strugatzki_tpu_torch.analysis.extraction import fix_nans
    from strugatzki_tpu_torch.dsp.frontend import extract_features
    from strugatzki_tpu_torch.io import audiofile as af
    from strugatzki_tpu_torch.kernels.prep import prepare_database
    from strugatzki_tpu_torch.parallel.sweep import _batched_traces, pad_stack

    name = os.path.splitext(target)[0]
    cuda_feats, _ = af.read(os.path.join(db, f"{name}_feat.aif"))
    audio, _ = af.read(os.path.join(snd, target))
    mono = np.round(audio[0] * 32768.0).astype(np.int16)
    cpu_feats = fix_nans(extract_features(mono, float(SR), device="cpu"))
    require(cuda_feats.shape == cpu_feats.shape, "feature shapes")
    err = float(np.abs(cuda_feats - cpu_feats).max())
    require(err <= 2e-5, f"CUDA vs CPU features differ by {err:.3e} > 2e-5")
    print(f"slice: {target} features [{cpu_feats.shape[0]}, "
          f"{cpu_feats.shape[1]}] CUDA vs CPU max |err| {err:.3e} (2e-5)")

    cfg = _corr_config(db).build()
    norm, _ = af.read(os.path.join(db, "feat_norms.aif"))     # [C, 2]
    query, _ = af.read(os.path.join(db, "query_feat.aif"))
    i0 = (cfg.punch_in.span.start + STEP // 2) // STEP
    i1 = (cfg.punch_in.span.stop + STEP // 2) // STEP
    tmpl = InputTemplate.from_features(query, norm, i0, i1)
    names = sorted(n for n in os.listdir(db)
                   if n.endswith("_feat.aif") and n.startswith("db"))
    mats = [af.read(os.path.join(db, n))[0] for n in names]
    mats += [np.zeros((mats[0].shape[0], 1), np.float32)] * (
        CHUNK_SIZE - len(mats))
    raw, lens = pad_stack(mats)
    t_pad = _bucket(raw.shape[2])
    raw = np.pad(raw, ((0, 0), (0, 0), (0, t_pad - raw.shape[2])))
    traces = {}
    for dev in ("cuda", "cpu"):
        xs, sh = prepare_database(raw, norm, lens, device=dev)
        s, b = _batched_traces(
            xs, tmpl.device_temporal(dev), tmpl.device_spectral(dev),
            tmpl.temporal_std, tmpl.spectral_std, tmpl.ln_avg_loudness, sh,
            TEMP_WEIGHT, cfg.max_boost)
        traces[dev] = (s.cpu().numpy(), b.cpu().numpy())
    L = i1 - i0
    worst_s = worst_b = 0.0
    for k, n in enumerate(lens[:len(names)]):
        w = n - L + 1
        (sc, bc), (sp, bp) = ([t[0][k, :w], t[1][k, :w]]
                              for t in (traces["cuda"], traces["cpu"]))
        require((np.isnan(bc) == np.isnan(bp)).all(), "boost NaN positions")
        worst_s = max(worst_s, float(np.abs(sc - sp).max()))
        ok = np.isfinite(bp)
        worst_b = max(worst_b, float((np.abs(bc[ok] - bp[ok])
                                      / np.abs(bp[ok])).max()))
    require(worst_s <= 3e-5, f"CUDA vs CPU sims differ by {worst_s:.3e}")
    require(worst_b <= 1e-4, f"CUDA vs CPU boosts differ by {worst_b:.3e}")
    print(f"slice: one chunk's punch-in traces [{CHUNK_SIZE}, "
          f"{traces['cpu'][0].shape[1]}] CUDA vs CPU: sims max |err| "
          f"{worst_s:.3e} (3e-5), boosts max rel err {worst_b:.3e} (1e-4)")


def slice_phase(seed: int, card: str) -> int:
    from strugatzki_tpu_torch.kernels import prep

    with tempfile.TemporaryDirectory(prefix="strugatzki_smoke_") as tmp:
        snd, db = os.path.join(tmp, "snd"), os.path.join(tmp, "db")
        os.makedirs(snd)
        os.makedirs(db)
        target, start, stop = write_sounds(snd, seed)

        prep.KERNEL_LAUNCHES = 0
        prep.REFERENCE_CALLS = 0
        matches, t_f, t_c = run_slice(snd, db)
        launches, refs = prep.KERNEL_LAUNCHES, prep.REFERENCE_CALLS
        print(f"slice: prep kernel launches {launches}, plain-version calls "
              f"{refs}")
        require(launches > 0, "the search never launched the prep kernel")
        require(refs == 0, "the search reached the plain version on CUDA")
        check_matches(matches, target, start, stop)
        audio_s = (DB_FILES + 1) * SECONDS
        print(f"slice: -f {audio_s} s of audio in {t_f:.3f} s = "
              f"{audio_s / t_f:.1f}x realtime; -c over {DB_FILES} files in "
              f"{t_c:.3f} s (first run, cold caches) on {card}")
        cpu_checks(snd, db, target)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the resident FeatureDatabase
# ---------------------------------------------------------------------------

#: the serving deployment README.md and BASELINE.json's north star name
#: ("correlate a punch against a 10k-file database"): two-minute files at
#: hop 512, a 10 s punch-in, a 5 s punch-out, punch lengths 12-20 s
SCALE_FILES = 10_000
SCALE_FRAMES = 10_336           # num_output_frames(120 s · 44.1 kHz, 512)
L_IN, L_OUT = 861, 431          # full_to_feat(10 s), full_to_feat(5 s)
BAND = (1034, 1723)             # full_to_feat(12 s), full_to_feat(20 s)
#: where the target file holds the query's punches (feature frames)
PLANT_IN, PLANT_OUT = 2000, 3400
Q_IN, Q_OUT = 1500, 4000        # the punches' frames in the query
SIM_TOL, BOOST_RTOL, RERANK_TOL = 3e-5, 1e-4, 1e-5


def counted(label: str, fn, phase: str = "database"):
    """Run ``fn`` with the prep counters set to 0 just before and read just
    after; the path must have launched the kernel and never its plain
    version.  Returns ``(fn's result, launches)``."""
    from strugatzki_tpu_torch.kernels import prep

    prep.KERNEL_LAUNCHES = 0
    prep.REFERENCE_CALLS = 0
    out = fn()
    launches, refs = prep.KERNEL_LAUNCHES, prep.REFERENCE_CALLS
    print(f"{phase}: {label}: prep kernel launches {launches}, "
          f"plain-version calls {refs}")
    require(launches > 0, f"{label} never launched the prep kernel")
    require(refs == 0, f"{label} reached the plain version on CUDA")
    return out, launches


def _decided(s, tol=SIM_TOL):
    """Candidates whose rank in their file no sub-tolerance difference can
    change: every other candidate of the row is more than ``tol`` away or
    exactly tied with it (NaN with NaN)."""
    s = np.asarray(s, np.float64)
    a, b = s[:, :, None], s[:, None, :]
    with np.errstate(invalid="ignore"):
        ok = (np.abs(a - b) > tol) | (a == b) | (np.isnan(a) & np.isnan(b))
    return ok.all(axis=2)


def _same_result(got, want, what: str, tol: float = SIM_TOL,
                 with_boosts: bool = True):
    """A CUDA query or punch result against the CPU's: sims within ``tol``
    (NaN and inf where the CPU has them), frames (and punch lengths) equal
    wherever the CPU's candidate is decided at ``tol``, and unless
    ``with_boosts`` is off, boosts within BOOST_RTOL where they pass the
    max_boost gate of 8.  Returns the worst sim and boost errors."""
    gs, ws = np.asarray(got.sims), np.asarray(want.sims)
    require(gs.shape == ws.shape, f"{what}: shapes {gs.shape} {ws.shape}")
    for f in (np.isnan, np.isposinf, np.isneginf):
        require((f(gs) == f(ws)).all(), f"{what}: {f.__name__} positions")
    fin = np.isfinite(ws)
    s_err = float(np.abs(gs[fin] - ws[fin]).max()) if fin.any() else 0.0
    require(s_err <= tol, f"{what}: sims differ by {s_err:.3e}")
    dec = _decided(ws, tol) & fin
    pairs = [(got.frames, want.frames)]
    if hasattr(want, "punch_lens"):
        pairs.append((got.punch_lens, want.punch_lens))
        boosts = [(got.boosts_in, want.boosts_in),
                  (got.boosts_out, want.boosts_out)]
    else:
        boosts = [(got.boosts, want.boosts)]
    if not with_boosts:
        boosts = []
    for g, w in pairs:
        require((np.asarray(g)[dec] == np.asarray(w)[dec]).all(),
                f"{what}: frames differ where the CPU's sims are decided")
    b_err = 0.0
    for g, w in boosts:
        g, w = np.asarray(g)[dec], np.asarray(w)[dec]
        with np.errstate(invalid="ignore"):
            ok = w <= 8.0
            require(((g <= 8.0) == ok).all(), f"{what}: boost gate")
        if ok.any():
            b_err = max(b_err, float((np.abs(g[ok] - w[ok])
                                      / np.abs(w[ok])).max()))
    require(b_err <= BOOST_RTOL, f"{what}: boosts differ by {b_err:.3e}")
    return s_err, b_err


def _db_features(rng, n, frames):
    """Feature-like rows: loudness in [0, 0.6], MFCC rows around 0.5."""
    return [np.concatenate([rng.uniform(0.0, 0.6, (1, t)),
                            rng.normal(0.5, 0.1, (13, t))]).astype(np.float32)
            for t in frames[:n]]


def topk_on_card() -> None:
    """The tie-stable top-k on the card against the CPU on rows full of
    exact ties, signed zeros, ±inf and NaN of both signs."""
    import torch

    from strugatzki_tpu_torch.parallel.database import _topk

    rng = np.random.default_rng(5)
    vals = np.array([0.0, -0.0, 0.5, -0.25, 1.0, np.inf, -np.inf, np.nan,
                     -np.float32(np.nan)], np.float32)
    x = rng.choice(vals, size=(64, 4096))
    gv, gi = _topk(torch.as_tensor(x, device="cuda"), 100)
    cv, ci = _topk(torch.as_tensor(x), 100)
    require(torch.equal(gi.cpu(), ci), "top-k order on the card vs the CPU")
    require(np.array_equal(gv.cpu().numpy(), cv.numpy(), equal_nan=True),
            "top-k values on the card vs the CPU")
    print("database: tie-stable top-k of [64, 4096] rows of ties, ±0, ±inf "
          "and ±NaN: CUDA order equals the CPU's")


def canary_phase() -> int:
    from strugatzki_tpu_torch.parallel.canary import (format_report,
                                                      run_batch_canary)

    total = 0
    for cache in (False, True):
        report, n = counted(f"canary (cache_spectra={cache})",
                            lambda: run_batch_canary(device="cuda",
                                                     cache_spectra=cache))
        print(f"database: cache_spectra={cache}: {format_report(report)}")
        require(report["pass"], "canary FAIL")
        total += n
    return total


def _compare_set(seed: int):
    """The seeded 64-file set of the CUDA-vs-CPU comparisons: ``(entries,
    norm, t_in, t_out, batch, pairs)``, the templates of the query families
    and a pair planted in c20.aif."""
    from strugatzki_tpu_torch.analysis.correlation import InputTemplate

    rng = np.random.default_rng(seed + 1)
    frames = [1500 + 37 * i for i in range(64)]
    feats = _db_features(rng, 64, frames)
    # a planted pair 420 frames apart (file 7's own pair is 400 apart,
    # outside the band)
    feats[20][:, 300:420] = feats[7][:, 100:220]
    feats[20][:, 720:780] = feats[7][:, 500:560]
    entries = [(f"c{i:02d}.aif", f) for i, f in enumerate(feats)]
    allf = np.concatenate(feats, axis=1)
    norm = np.stack([allf.min(axis=1), allf.max(axis=1)], 1).astype(
        np.float32)

    def tmpl(i, a, b):
        return InputTemplate.from_features(feats[i], norm, a, b)

    t_in, t_out = tmpl(7, 100, 220), tmpl(7, 500, 560)
    batch = [t_in, tmpl(3, 40, 160), tmpl(11, 900, 1000)]    # 120/120/100
    pairs = [(t_in, t_out, 410, 450), (tmpl(2, 10, 110), tmpl(5, 30, 90),
                                      200, 600)]
    return entries, norm, t_in, t_out, batch, pairs


def _same_results(got, want, names, what: str = "", **kw):
    """:func:`_same_result` over parallel lists of results (or of result
    batches); returns the worst sim and boost errors."""
    worst_s = worst_b = 0.0
    for name, g, w in zip(names, got, want):
        for q, (gr, wr) in enumerate(zip(g, w) if isinstance(g, list)
                                     else [(g, w)]):
            s, b = _same_result(gr, wr, f"{what}{name}[{q}]", **kw)
            worst_s, worst_b = max(worst_s, s), max(worst_b, b)
    return worst_s, worst_b


def _require_planted_pair(res, what: str = "") -> None:
    m = res.matches(512, 1)[0]
    require(m.file == "c20.aif" and m.punch.start == 300 * 512
            and m.punch.stop == 720 * 512, f"{what}planted pair: {m}")


def compare_phase(seed: int) -> int:
    """One seeded 64-file database on CUDA and on the CPU; the same four
    query families, and the device re-rank against the host f64 oracle."""
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    entries, norm, t_in, t_out, batch, pairs = _compare_set(seed)

    def run(db):
        return (db.query(t_in, k=6), db.query_punch(t_in, t_out, 410, 450,
                                                    k=4),
                db.query_batch(batch, k=4), db.query_punch_batch(pairs, k=3),
                db.query(t_in, k=6, exact_rerank=True),
                db.query_punch(t_in, t_out, 410, 450, k=4,
                               exact_rerank=True))

    cpu = run(FeatureDatabase(entries, norm, device="cpu"))

    def on_card():
        db = FeatureDatabase(entries, norm, device="cuda")
        return db, run(db)

    (db, got), launches = counted("64-file database on CUDA", on_card)
    names = ["query", "query_punch", "query_batch", "query_punch_batch",
             "query exact_rerank", "query_punch exact_rerank"]
    worst_s, worst_b = _same_results(got, cpu, names)
    _require_planted_pair(got[1])
    print(f"database: 64 files CUDA vs CPU, {', '.join(names)}: sims max "
          f"|err| {worst_s:.3e} ({SIM_TOL}), boosts max rel err "
          f"{worst_b:.3e} ({BOOST_RTOL}), frames equal where decided")

    fin = np.argwhere(np.isfinite(got[0].sims))
    fi, fr = fin[:, 0], got[0].frames[fin[:, 0], fin[:, 1]]
    d_s, d_b = db._device_window_scores(fi, fr, t_in, 0.5, 8.0)
    h_s, h_b = db._exact_window_scores(fi, fr, t_in, 0.5, 8.0)
    e_s = float(np.abs(d_s - h_s).max())
    e_b = float((np.abs(d_b - h_b) / np.abs(h_b)).max())
    require(e_s <= RERANK_TOL and e_b <= RERANK_TOL,
            f"device re-rank vs host oracle: {e_s:.3e}, {e_b:.3e}")
    print(f"database: device re-rank of {len(fi)} windows vs the host f64 "
          f"oracle: sims max |err| {e_s:.3e}, boosts max rel err {e_b:.3e} "
          f"(both {RERANK_TOL})")
    return launches


def prep_slab_timing(card: str) -> None:
    """The prep kernel against its plain version at the staging slab shape
    of the scale database."""
    import torch

    from strugatzki_tpu_torch.kernels import prep
    from strugatzki_tpu_torch.parallel.database import _QUERY_CHUNK

    B, C, T = _QUERY_CHUNK, 14, 10752
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((B, C, T), device="cuda", generator=g)
    norm = torch.tensor([[0.0, 1.0]] * C, device="cuda")
    lens = torch.full((B,), SCALE_FRAMES, dtype=torch.int32, device="cuda")
    out_k, sh_k = prep.prepare_database_cuda(x, norm, lens, 1)
    out_r, sh_r = prep.prepare_database_reference(x, norm, lens, 1)
    err = float((out_k - out_r).abs().max())
    require(err <= 1e-6, f"prep at [{B}, {C}, {T}] differs by {err:.3e}")
    del out_k, out_r, sh_k, sh_r
    runs = []
    for kind in ("plain", "kernel", "kernel", "plain"):
        fn = prep.prepare_database_cuda if kind == "kernel" \
            else prep.prepare_database_reference
        runs.append((kind, cuda_ms(lambda: fn(x, norm, lens, 1), 10)))
    ms = sum(t for k, t in runs if k == "kernel") / 2
    plain = sum(t for k, t in runs if k == "plain") / 2
    print(f"database: prep at the staging slab [{B}, {C}, {T}]: max |err| "
          f"{err:.3e}; kernel {ms:.3f} ms vs plain {plain:.3f} ms (runs "
          f"{', '.join(f'{k} {t:.3f}' for k, t in runs)}) on {card}")
    del x
    torch.cuda.empty_cache()


def _latency(fn, warm: int = 5):
    """(first, median of ``warm`` more) wall seconds of ``fn``, whose
    result is host arrays (so the device work is done when it returns)."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def _profile(label: str, fn, card: str, warmup: bool = True) -> None:
    """Device time by kernel for one warm call (``warmup``: after one
    unprofiled call), and the device's busy share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own events (kernels, copies); a CPU op's self device
    # time repeats its kernels'
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == cuda and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    require(rows, f"{label}: the profiler saw no device time")
    busy = sum(dev_us(e) for e in rows) / 1e3
    print(f"profile: {label}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / 1e3 / wall:.1f}%) on {card}")
    for e in rows[:12]:
        print(f"profile: {label}:   {dev_us(e) / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def _scale_calls(query, norm):
    """The serving deployment's templates, cut from ``query``: the 10 s
    punch-in, the 5 s punch-out, batches of 8 templates and of 8 pairs;
    returns ``(t_in, t_out, {name: call of a database})``."""
    from strugatzki_tpu_torch.analysis.correlation import InputTemplate

    def tmpl(a, n):
        return InputTemplate.from_features(query, norm, a, a + n)

    t_in, t_out = tmpl(Q_IN, L_IN), tmpl(Q_OUT, L_OUT)
    t_batch = [t_in] + [tmpl(200 + 1000 * q, L_IN) for q in range(7)]
    pairs = [(t_in, t_out) + BAND] + [
        (tmpl(100 + 1100 * q, L_IN), tmpl(300 + 1100 * q, L_OUT)) + BAND
        for q in range(7)]
    calls = {
        "query": lambda db: db.query(t_in, k=4),
        "query_punch": lambda db: db.query_punch(t_in, t_out, *BAND, k=4),
        "query_batch of 8": lambda db: db.query_batch(t_batch, k=4),
        "query_punch_batch of 8": lambda db: db.query_punch_batch(pairs,
                                                                  k=4),
        "query exact_rerank": lambda db: db.query(t_in, k=4,
                                                  exact_rerank=True)}
    return t_in, t_out, calls


def _require_planted(res, name: str, target: int):
    """The planted file first in ``query`` and ``query_punch`` at the
    planted frames (and punch length) with sim > 0.999, and the batches'
    results in range with the planted hit; returns the two results."""
    q = res["query"][0]
    m = q.matches(L_IN, STEP, 1)[0]
    require(m.file == name and int(q.frames[target, 0])
            == PLANT_IN and q.sims[target, 0] > 0.999,
            f"query: top {m}, planted {name} at {PLANT_IN}")
    p = res["query_punch"][0]
    m = p.matches(STEP, 1)[0]
    require(m.file == name and int(p.frames[target, 0])
            == PLANT_IN and BAND[0] + int(p.punch_lens[target, 0])
            == PLANT_OUT - PLANT_IN and p.sims[target, 0] > 0.999,
            f"query_punch: top {m}, planted at {PLANT_IN}-{PLANT_OUT}")
    for r in res["query_batch of 8"][0] + res["query_punch_batch of 8"][0]:
        require(r.sims.shape == (SCALE_FILES, 4), "batch result shape")
        fin = r.sims[np.isfinite(r.sims)]
        require(fin.size and (np.abs(fin) <= 1.0 + 1e-5).all(),
                "batch sims out of range")
    require(res["query_batch of 8"][0][0].frames[target, 0] == PLANT_IN
            and res["query_punch_batch of 8"][0][0].frames[target, 0]
            == PLANT_IN, "batches lost the planted hit")
    return q, p


def scale_phase(seed: int, card: str) -> int:
    """10,000 two-minute files staged with the spectra cache; the planted
    file must come first in query and query_punch."""
    import torch

    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    rng = np.random.default_rng(seed + 2)
    t0 = time.perf_counter()
    feats = np.empty((SCALE_FILES, 14, SCALE_FRAMES), np.float32)
    for o in range(0, SCALE_FILES, 500):
        feats[o:o + 500] = rng.random((min(500, SCALE_FILES - o), 14,
                                       SCALE_FRAMES), dtype=np.float32)
    query = rng.random((14, SCALE_FRAMES), dtype=np.float32)
    target = SCALE_FILES // 3
    feats[target, :, PLANT_IN:PLANT_IN + L_IN] = query[:, Q_IN:Q_IN + L_IN]
    feats[target, :, PLANT_OUT:PLANT_OUT + L_OUT] = \
        query[:, Q_OUT:Q_OUT + L_OUT]
    entries = [(f"s{i:05d}.aif", feats[i]) for i in range(SCALE_FILES)]
    norm = np.stack([np.zeros(14), np.ones(14)], 1).astype(np.float32)
    print(f"database: scale: {SCALE_FILES} files x [14, {SCALE_FRAMES}] "
          f"f32 ({feats.nbytes / 1e9:.2f} GB) made in "
          f"{time.perf_counter() - t0:.1f} s")

    t_in, t_out, calls = _scale_calls(query, norm)

    def stage_and_query(cache: bool, names):
        """Stage, then time ``names``; peak device memory of each part."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        db = FeatureDatabase(entries, norm, cache_spectra=cache,
                             device="cuda")
        t_stage = time.perf_counter() - t0
        peak_stage = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = {n: _latency(lambda: calls[n](db)) for n in names}
        peak_query = torch.cuda.max_memory_allocated()
        xs_gb = db._xs.numel() * 4 / 1e9
        sp_gb = sum(x.numel() * 8 for x in db._spectra or ()) / 1e9
        print(f"database: scale: staged {SCALE_FILES} files (rows "
              f"{db._xs.shape[0]}, T {db._xs.shape[2]}) with "
              f"cache_spectra={cache} in {t_stage:.3f} s: features "
              f"{xs_gb:.2f} GB + spectra {sp_gb:.2f} GB resident on {card}")
        for name, (_, first, warm) in res.items():
            print(f"database: scale: cache_spectra={cache}: {name}: first "
                  f"{first * 1e3:.3f} ms, warm median of 5 "
                  f"{warm * 1e3:.3f} ms on {card}")
        print(f"database: scale: cache_spectra={cache}: "
              f"torch.cuda.max_memory_allocated {peak_stage / 1e9:.3f} GB "
              f"while staging, {peak_query / 1e9:.3f} GB over the queries "
              f"on {card}")
        return db, res

    (db, res), launches = counted("scale database, cache_spectra=True",
                                  lambda: stage_and_query(True, calls))
    q, p = _require_planted(res, entries[target][0], target)
    print(f"database: scale: planted {entries[target][0]} first in query "
          f"(frame {PLANT_IN}, sim {q.sims[target, 0]:.7f}) and query_punch "
          f"(frames {PLANT_IN}-{PLANT_OUT}, sim {p.sims[target, 0]:.7f})")

    _profile("warm query", lambda: db.query(t_in, k=4), card)
    _profile("warm query_punch",
             lambda: db.query_punch(t_in, t_out, *BAND, k=4), card)
    del db

    # the same database without the spectra cache: each query computes
    # every file's forward spectra again
    (db, res2), n = counted(
        "scale database, cache_spectra=False",
        lambda: stage_and_query(False, ["query", "query_punch"]))
    launches += n
    for name, (got, _, _) in res2.items():
        want = res[name][0]
        require(np.array_equal(got.frames[target], want.frames[target])
                and np.abs(got.sims[target] - want.sims[target]).max()
                <= SIM_TOL, f"{name} without the cache differs at the "
                "planted file")
    del db, entries, feats
    torch.cuda.empty_cache()
    return launches


def database_phase(seed: int, card: str) -> int:
    """Every check of the resident database; returns the prep launches of
    the paths it drove."""
    topk_on_card()
    launches = canary_phase()
    launches += compare_phase(seed)
    prep_slab_timing(card)
    launches += scale_phase(seed, card)
    return launches


# ---------------------------------------------------------------------------
# phase 5b: the database's capacity modes
# ---------------------------------------------------------------------------

#: raw sims of reduced-precision data (exact re-rank off) against their
#: re-ranked or full-precision value: bf16 quantization, ~1e-3
RAW_TOL = 4e-3
#: the four query families timed per database
FAMILIES = ("query", "query_punch", "query_batch of 8",
            "query_punch_batch of 8")


def _vmrss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise CheckFailed("no VmRSS line in /proc/self/status")


def _mode_query(seed: int):
    """The deployment's query features (seeded apart from every file) and
    its identity norm."""
    query = np.random.default_rng([seed, SCALE_FILES]).random(
        (14, SCALE_FRAMES), dtype=np.float32)
    return query, np.stack([np.zeros(14), np.ones(14)], 1).astype(np.float32)


def _mode_files(seed: int, query, n: int | None = None):
    """``(name, features)`` of the north-star deployment (the first ``n``
    files, default all), one file at a time from its own seed (the host
    never holds the stack); file ``SCALE_FILES // 3`` holds the query's
    punches."""
    target = SCALE_FILES // 3
    for i in range(SCALE_FILES if n is None else n):
        f = np.random.default_rng([seed, i]).random((14, SCALE_FRAMES),
                                                    dtype=np.float32)
        if i == target:
            f[:, PLANT_IN:PLANT_IN + L_IN] = query[:, Q_IN:Q_IN + L_IN]
            f[:, PLANT_OUT:PLANT_OUT + L_OUT] = query[:, Q_OUT:Q_OUT + L_OUT]
        yield f"m{i:05d}.aif", f


def modes_canary() -> int:
    """The planted-match canary on reduced databases: the families at
    1e-4 and their ``[raw]`` runs at 4e-3."""
    import torch

    from strugatzki_tpu_torch.parallel.canary import (format_report,
                                                      run_batch_canary)

    total = 0
    for kw in (dict(cache_spectra="bf16"),
               dict(storage_dtype=torch.bfloat16)):
        label = ", ".join(f"{k}={v}" for k, v in kw.items())
        report, n = counted(f"canary ({label})",
                            lambda: run_batch_canary(device="cuda", **kw),
                            "modes")
        print(f"modes: {label}: {format_report(report)}")
        require(report["pass"] and report["worst_raw"] is not None,
                "reduced canary FAIL")
        total += n
    return total


def modes_compare(seed: int) -> int:
    """64 seeded files: the compact raw traces against a full-precision
    cache over every valid window, then databases A (memmap, compact) and
    B (bf16 features, compact) on CUDA against the same on the CPU."""
    from strugatzki_tpu_torch.analysis.correlation import InputTemplate
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    # (a) the first 64 files of the deployment (north-star length): the
    # compact cache's raw sims against the complex64 cache's, every window
    query, norm = _mode_query(seed)
    files = list(_mode_files(seed, query, 64))
    t_in = InputTemplate.from_features(files[21][1], norm, 3000,
                                       3000 + L_IN)

    def traces():
        full = FeatureDatabase(files, norm, cache_spectra=True,
                               device="cuda")
        comp = FeatureDatabase((f for f in files), norm, device="cuda",
                               raw_store="memmap",
                               time_capacity=SCALE_FRAMES,
                               cache_spectra="bf16")
        return [d.query(t_in, k=4, with_traces=True, exact_rerank=False)[1]
                for d in (full, comp)]

    ((fs, _, lens), (cs, _, _)), launches = counted(
        "64 files, compact vs complex64 cache", traces, "modes")
    w = SCALE_FRAMES - L_IN + 1
    require((lens == SCALE_FRAMES).all(), "lens")
    d = np.abs(cs[:, :w].astype(np.float64) - fs[:, :w])
    fi, t = np.unravel_index(int(np.argmax(d)), d.shape)
    err = float(d[fi, t])
    require(err <= RAW_TOL, f"compact raw sims differ by {err:.3e}")
    require(int(np.argmax(cs[21, :w])) == 3000, "compact lost the self-hit")
    print(f"modes: 64 files x {SCALE_FRAMES} frames: compact (bf16 planar "
          f"X + f32 window-sum tables) raw sims vs the complex64 cache over "
          f"{d.size} valid windows: max |err| {err:.3e} ({RAW_TOL}) at file "
          f"{fi}, window {t} (t/T {t / SCALE_FRAMES:.3f}); mean |err| "
          f"{d.mean():.3e}; by quarter of T: " + ", ".join(
              f"{d[:, q * w // 4:(q + 1) * w // 4].max():.3e}"
              for q in range(4)))

    # (b) A and B on CUDA against the same databases on the CPU
    entries, norm, t_in, t_out, batch, pairs = _compare_set(seed)

    def run(db):
        return ([db.query(t_in, k=6), db.query_punch(t_in, t_out, 410, 450,
                                                     k=4),
                 db.query_batch(batch, k=4), db.query_punch_batch(pairs, k=3)],
                [db.query(t_in, k=6, exact_rerank=False),
                 db.query_punch(t_in, t_out, 410, 450, k=4,
                                exact_rerank=False)])

    import torch

    for label, kw in (("A", dict(raw_store="memmap",
                                 cache_spectra="bf16")),
                      ("B", dict(storage_dtype=torch.bfloat16,
                                 cache_spectra="bf16"))):
        cpu = run(FeatureDatabase(entries, norm, device="cpu", **kw))
        got, n = counted(f"64-file database {label} on CUDA",
                         lambda: run(FeatureDatabase(entries, norm,
                                                     device="cuda", **kw)),
                         "modes")
        launches += n
        names = ["query", "query_punch", "query_batch", "query_punch_batch"]
        s_err, b_err = _same_results(got[0], cpu[0], names, f"{label} ")
        r_err = _same_results(got[1], cpu[1], names, f"{label} raw ",
                              tol=RAW_TOL, with_boosts=False)[0]
        _require_planted_pair(got[0][1], f"{label} ")
        print(f"modes: 64 files, database {label} ({kw}) CUDA vs CPU: "
              f"re-ranked sims max |err| {s_err:.3e} ({SIM_TOL}), boosts "
              f"max rel err {b_err:.3e} ({BOOST_RTOL}), frames equal where "
              f"decided; raw sims max |err| {r_err:.3e} ({RAW_TOL})")
    return launches


def modes_phase(seed: int, card: str) -> int:
    """The capacity modes at the north-star deployment: database A
    (memmap raw store from a generator, f32 features, compact cache, device
    re-rank) and B (in memory, bf16 features, compact cache, host f64
    re-rank), staged one after the other."""
    import shutil

    import torch

    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    launches = modes_canary()
    launches += modes_compare(seed)

    query, norm = _mode_query(seed)
    target = SCALE_FILES // 3
    name = f"m{target:05d}.aif"
    t_in, t_out, calls = _scale_calls(query, norm)

    def stage_and_serve(label, make_entries, **kw):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rss = [_vmrss_gb()]
        t0 = time.perf_counter()
        db = FeatureDatabase(make_entries(), norm, device="cuda", **kw)
        t_stage = time.perf_counter() - t0
        peak_stage = torch.cuda.max_memory_allocated()
        rss.append(_vmrss_gb())
        torch.cuda.reset_peak_memory_stats()
        res = {n: _latency(lambda: calls[n](db)) for n in FAMILIES}
        peak_query = torch.cuda.max_memory_allocated()
        rss.append(_vmrss_gb())
        xs_gb = db._xs.numel() * db._xs.element_size() / 1e9
        sp_gb = sum(x.numel() * x.element_size() for x in db._spectra) / 1e9
        print(f"modes: {label}: staged {SCALE_FILES} files (rows "
              f"{db._xs.shape[0]}, T {db._xs.shape[2]}) in {t_stage:.3f} s: "
              f"features {xs_gb:.2f} GB ({db._xs.dtype}) + spectra "
              f"{sp_gb:.2f} GB ({db._spectra[0].dtype} planar) resident, "
              f"{'device' if db._rerank_device else 'host f64'} re-rank, on "
              f"{card}")
        for n, (_, first, warm) in res.items():
            print(f"modes: {label}: {n}: first {first * 1e3:.3f} ms, warm "
                  f"median of 5 {warm * 1e3:.3f} ms on {card}")
        print(f"modes: {label}: torch.cuda.max_memory_allocated "
              f"{peak_stage / 1e9:.3f} GB while staging, "
              f"{peak_query / 1e9:.3f} GB over the queries on {card}; "
              f"VmRSS {rss[0]:.3f} GB before staging, {rss[1]:.3f} GB "
              f"after staging, {rss[2]:.3f} GB after the queries")
        q, p = _require_planted(res, name, target)
        rq = db.query(t_in, k=4, exact_rerank=False)
        rp = db.query_punch(t_in, t_out, *BAND, k=4, exact_rerank=False)
        dq = abs(float(rq.sims[target, 0]) - float(q.sims[target, 0]))
        dp = abs(float(rp.sims[target, 0]) - float(p.sims[target, 0]))
        require(int(rq.frames[target, 0]) == PLANT_IN
                and int(rp.frames[target, 0]) == PLANT_IN
                and max(dq, dp) <= RAW_TOL, f"{label}: raw planted hit: "
                f"frames {rq.frames[target, 0]}/{rp.frames[target, 0]}, "
                f"|raw - re-ranked| {dq:.3e}/{dp:.3e}")
        print(f"modes: {label}: planted {name} first in query (frame "
              f"{PLANT_IN}, re-ranked sim {q.sims[target, 0]:.7f}, raw "
              f"{rq.sims[target, 0]:.7f}) and query_punch (frames "
              f"{PLANT_IN}-{PLANT_OUT}, re-ranked sim "
              f"{p.sims[target, 0]:.7f}, raw {rp.sims[target, 0]:.7f}); "
              f"|raw - re-ranked| {dq:.3e} and {dp:.3e} ({RAW_TOL})")
        return db

    # A: the memmap raw store needs its whole stack on the temp file system
    tmp = tempfile.gettempdir()
    rows = SCALE_FILES + (-SCALE_FILES % 2048)
    need = rows * 14 * 10752 * 4
    free = shutil.disk_usage(tmp).free
    print(f"modes: A: {tmp} has {free / 1e9:.2f} GB free; the memmap store "
          f"needs {need / 1e9:.2f} GB")
    require(free >= need, f"{tmp}: {free / 1e9:.2f} GB free < "
            f"{need / 1e9:.2f} GB for the memmap raw store")
    db, n = counted("A (memmap, compact)", lambda: stage_and_serve(
        "A memmap+compact", lambda: _mode_files(seed, query),
        raw_store="memmap", time_capacity=SCALE_FRAMES,
        cache_spectra="bf16"), "modes")
    launches += n
    require(isinstance(db._raw, np.memmap) and db._rerank_device,
            "A: memmap store, device re-rank")
    print(f"modes: A: temp file {db._raw._mmap.size() / 1e9:.3f} GB "
          f"(unlinked) beside a raw stack of {db._raw.nbytes / 1e9:.3f} GB")
    _profile("warm compact query (A)", lambda: db.query(t_in, k=4), card)
    _profile("warm compact query_punch (A)",
             lambda: db.query_punch(t_in, t_out, *BAND, k=4), card)
    del db
    torch.cuda.empty_cache()

    # B: in memory, bf16 features (the host keeps the f32 raw stack)
    db, n = counted("B (bf16 features, compact)", lambda:
                    stage_and_serve("B bf16+compact",
                                    lambda: list(_mode_files(seed, query)),
                                    storage_dtype=torch.bfloat16,
                                    cache_spectra="bf16"), "modes")
    launches += n
    require(db._xs.dtype == torch.bfloat16 and not db._rerank_device,
            "B: bf16 features, host re-rank")
    del db
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: segmentation, self-similarity and cross-similarity
# ---------------------------------------------------------------------------

#: BASELINE.json's "FeatureSegmentation: novelty break detection on 5-min
#: recording (corrLen 44100, 20 breaks)": five sections of distinct timbres
#: with frame-aligned boundaries, and digital silence inside one section.
#: The silence is shorter than the 2 s window: a window inside a longer
#: silence is 0/0 and carries FFT round-off that differs between devices
#: (PERF.md, Findings)
SEG_SECONDS = 300
SEG_BOUNDS = (60, 120, 180, 240)
SILENCE = (150.0, 151.5)
SEG_BREAKS = 20
CORR_LEN = 44100
#: BASELINE.json's "SelfSimilarity: full self-similarity matrix image of a
#: 3-min piece with decimation": a 30 s passage recurs sample for sample
#: RECUR_SHIFT frames (~90 s) later
SELF_SECONDS = 180
RECUR = (20.0, 50.0)
RECUR_SHIFT = 7752
#: the -y template: a 20 s excerpt of the piece (frame-aligned, away from
#: the recurring passage)
EXCERPT_AT, EXCERPT_FRAMES = 12_900, 1723
NOVELTY_TOL, GRAM_TOL, CROSS_TOL = 2e-5, 2e-5, 3e-5


def _aligned(sec: float) -> int:
    """The frame-aligned sample position nearest ``sec``."""
    return int(round(sec * SR / STEP)) * STEP


def _band_noise(rng, n: int, lo: float, hi: float) -> np.ndarray:
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1.0 / SR)
    spec[(f < lo) | (f >= hi)] = 0.0
    return np.fft.irfft(spec, n=n)


def _section(rng, n: int, kind: int, level: float) -> np.ndarray:
    """One of five timbres at ``level``, under a random 1-8 Hz envelope so
    the loudness row moves without a trend: low rumble, a harmonic tone
    with vibrato, bright noise, a sine chord over faint noise, a 2 kHz
    noise band."""
    t = np.arange(n) / SR
    if kind == 0:
        x = _band_noise(rng, n, 40.0, 400.0)
    elif kind == 1:
        ph = 2 * np.pi * 220.0 * t + 3.0 * np.sin(2 * np.pi * 5.0 * t)
        x = sum(np.sin(k * ph) / k for k in range(1, 7))
    elif kind == 2:
        x = _band_noise(rng, n, 4000.0, 16000.0)
    elif kind == 3:
        x = sum(np.sin(2 * np.pi * f * t) for f in (330.0, 415.0, 495.0))
        x = x + 0.05 * rng.standard_normal(n)
    else:
        x = _band_noise(rng, n, 1500.0, 2500.0)
    env = _band_noise(rng, n, 1.0, 8.0)
    env = 0.7 + 0.3 * env / np.abs(env).max()
    return level * env * x / np.abs(x).max()


#: section levels: every boundary is also a loudness step
SEG_LEVELS = (0.2, 0.55, 0.15, 0.45, 0.3)


def write_analysis_sounds(snd: str, seed: int) -> None:
    """``seg.aif`` (the segmentation recording), ``piece.aif`` (the
    self-similarity piece) and ``excerpt.aif`` (its -y template), PCM16
    mono at 44.1 kHz."""
    from strugatzki_tpu_torch.io import AIFF, AudioFileSpec, SampleFormat
    from strugatzki_tpu_torch.io import audiofile as af

    rng = np.random.default_rng(seed + 3)
    spec = AudioFileSpec(AIFF, SampleFormat.INT16, 1, float(SR))
    cuts = [0] + [_aligned(s) for s in SEG_BOUNDS] + [_aligned(SEG_SECONDS)]
    seg = np.concatenate([_section(rng, b - a, k, SEG_LEVELS[k])
                          for k, (a, b) in enumerate(zip(cuts, cuts[1:]))])
    seg[_aligned(SILENCE[0]):_aligned(SILENCE[1])] = 0.0
    af.write(os.path.join(snd, "seg.aif"), seg[None].astype(np.float32), spec)

    piece = _sound(rng, SELF_SECONDS)
    a, b = _aligned(RECUR[0]), _aligned(RECUR[1])
    d = RECUR_SHIFT * STEP
    piece[a + d:b + d] = piece[a:b]
    af.write(os.path.join(snd, "piece.aif"), piece[None], spec)
    ex = piece[EXCERPT_AT * STEP:(EXCERPT_AT + EXCERPT_FRAMES) * STEP]
    af.write(os.path.join(snd, "excerpt.aif"), ex[None], spec)


def _peak_gb() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 1e9


def _fresh_peak() -> None:
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def segmentation_checks(db: str, card: str, dev: str = "cuda") -> None:
    """``-s`` through the factory on ``dev`` and on the CPU: the novelty
    curve, the breaks, and the planted boundaries."""
    import torch

    from strugatzki_tpu_torch import FeatureSegmentation, SegmentationConfig
    from strugatzki_tpu_torch.analysis.segmentation import _novelty_prep
    from strugatzki_tpu_torch.io import audiofile as af
    from strugatzki_tpu_torch.kernels import corr as K

    cfg = SegmentationConfig(database_folder=db,
                             meta_input=os.path.join(db, "seg_feat.xml"),
                             corr_len=CORR_LEN, temporal_weight=TEMP_WEIGHT,
                             num_breaks=SEG_BREAKS)
    _fresh_peak()
    FeatureSegmentation.device = dev
    breaks, first, warm = _latency(
        lambda: FeatureSegmentation.run(cfg).result(), warm=3)
    peak = _peak_gb()
    FeatureSegmentation.device = "cpu"
    want = FeatureSegmentation.run(cfg).result()
    FeatureSegmentation.device = dev

    feats, _ = af.read(os.path.join(db, "seg_feat.aif"))
    norm, _ = af.read(os.path.join(db, "feat_norms.aif"))
    xs, nw, _, h = _novelty_prep(feats, norm, STEP, cfg.build())
    curves = [K.novelty_trace(torch.as_tensor(xs, device=d), h,
                              TEMP_WEIGHT)[:nw].cpu().numpy()
              for d in (dev, "cpu")]
    require(all(np.isfinite(c).all() for c in curves),
            "novelty curve not finite")
    err = float(np.abs(curves[0] - curves[1]).max())
    require(err <= NOVELTY_TOL, f"novelty CUDA vs CPU {err:.3e}")
    require(len(breaks) == len(want) == SEG_BREAKS,
            f"{len(breaks)} / {len(want)} breaks")
    require([b.pos for b in breaks] == [b.pos for b in want],
            "break positions CUDA vs CPU")
    b_err = max(abs(a.sim - b.sim) for a, b in zip(breaks, want))
    require(b_err <= NOVELTY_TOL, f"break sims CUDA vs CPU {b_err:.3e}")
    found = []
    for s in SEG_BOUNDS:
        near = [b for b in breaks if abs(b.pos - _aligned(s)) <= CORR_LEN // 2]
        require(near, f"no break within {CORR_LEN // 2} samples of {s} s")
        found.append(min(near, key=lambda b: abs(b.pos - _aligned(s))))
    print(f"analyses: -s {feats.shape[1]} frames, corrLen {CORR_LEN} (half "
          f"window {h}), {SEG_BREAKS} breaks: novelty curve [{nw}] CUDA vs "
          f"CPU max |err| {err:.3e} ({NOVELTY_TOL}), breaks equal position "
          f"for position, sims max |err| {b_err:.3e}; planted boundaries "
          + ", ".join(f"{s} s → {b.pos} (sim {b.sim:.4f})"
                      for s, b in zip(SEG_BOUNDS, found)))
    print(f"analyses: -s wall first {first:.3f} s, warm median of 3 "
          f"{warm:.3f} s; peak device memory {peak:.3f} GB on {card}")


def _png_rows(path: str, rows=()):
    """Stream-decode an 8-bit RGB PNG of filter-0 scanlines: ``(width,
    height, {row: [width, 3] pixels})`` for the asked rows; raises unless
    the data holds exactly ``height`` scanlines."""
    import struct
    import zlib

    z = zlib.decompressobj()
    got, seen, w, h = {}, 0, None, None

    def take(out: bytes) -> None:
        nonlocal seen
        stride = 1 + 3 * w
        for r in rows:
            lo, hi = max(r * stride, seen), min((r + 1) * stride,
                                                seen + len(out))
            if lo < hi:
                got.setdefault(r, bytearray()).extend(
                    out[lo - seen:hi - seen])
        seen += len(out)

    with open(path, "rb") as f:
        require(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
        while True:
            n, tag = struct.unpack(">I4s", f.read(8))
            body = f.read(n)
            f.read(4)
            if tag == b"IHDR":
                w, h = struct.unpack(">II", body[:8])
            elif tag == b"IDAT":
                take(z.decompress(body))
            elif tag == b"IEND":
                break
    take(z.flush())
    require(seen == h * (1 + 3 * w), f"{path}: {seen} bytes of scanlines")
    return w, h, {r: np.frombuffer(bytes(v), np.uint8)[1:].reshape(w, 3)
                  for r, v in got.items()}


def _prepared_piece(db: str):
    """The piece's features as the self-similarity factory prepares them."""
    from strugatzki_tpu_torch.analysis.self_similarity import _joint_shifted
    from strugatzki_tpu_torch.io import audiofile as af

    feats, _ = af.read(os.path.join(db, "piece_feat.aif"))
    norm, _ = af.read(os.path.join(db, "feat_norms.aif"))
    return _joint_shifted(feats, feats, norm, 0, feats.shape[1])[0]


def selfsim_pair_checks(x: np.ndarray, h: int, dev: str):
    """Eight block pairs at decimation 1 (diagonal blocks, the planted
    recurrence, far corners) on ``dev`` and on the CPU; the device raster
    of those sims against their host quantization, and the FMA tie
    datasets on ``dev``.  Returns the recurrence cell and its sim."""
    import torch

    from strugatzki_tpu_torch.analysis import self_similarity as SS

    n, nb, res, _ = SS._prep_resident(x, x, h, 1, device=dev)
    i = _aligned(sum(RECUR) / 2) // STEP      # mid-passage
    j = i + RECUR_SHIFT
    rec = (i // SS._BLOCK, j // SS._BLOCK)
    pairs = list(dict.fromkeys([(0, 0), rec, (rec[0], rec[0]),
                                (rec[1], rec[1]), (nb - 1, nb - 1),
                                (0, nb - 1), (3, nb // 2), (nb // 3, nb - 2)]))
    require(len(pairs) == 8, f"sampled pairs {pairs}")
    _, _, res_c, _ = SS._prep_resident(x, x, h, 1, device="cpu")
    sims_d = SS._dispatch_pairs_fast(res, res, pairs, TEMP_WEIGHT)
    got = sims_d.cpu().numpy()
    want = SS._dispatch_pairs_fast(res_c, res_c, pairs, TEMP_WEIGHT).numpy()
    require(np.isfinite(got).all() and np.isfinite(want).all(),
            "gram sims not finite")
    err = float(np.abs(got - want).max())
    require(err <= GRAM_TOL, f"gram CUDA vs CPU {err:.3e}")
    rec_sim = float(got[pairs.index(rec)][i % SS._BLOCK, j % SS._BLOCK])
    require(rec_sim > 0.999, f"recurrence sim {rec_sim}")
    print(f"analyses: -x extent {n} ({nb} blocks): {len(pairs)} block pairs "
          f"{pairs} CUDA vs CPU max |err| {err:.3e} ({GRAM_TOL}); planted "
          f"recurrence cell ({i}, {j}) sim {rec_sim:.7f}")

    rng = np.random.default_rng(0)
    ties = [np.random.default_rng(s).uniform(-0.5, 1.6, (64, 64)).astype(
        np.float32) for s in (49, 145, 184, 206)]
    edge = rng.uniform(-0.5, 1.6, (64, 64)).astype(np.float32)
    edge[0, :9] = [np.nan, np.inf, -np.inf, 0.0, 1.0, 0.5, 511.5 / 1023.0,
                   0.25, np.float32(0.49369505)]
    cases = [(sims_d, got, c, 1.0, inv) for c, inv in (("psycho", False),
                                                       ("gray", True))]
    cases += [(torch.as_tensor(t, device=dev), t, "psycho", 1.3, True)
              for t in ties]
    cases += [(torch.as_tensor(edge, device=dev), edge, c, ceil, inv)
              for c in ("psycho", "gray") for ceil in (1.0, 0.8, 1.3)
              for inv in (False, True)]
    for sims_dev, sims_host, colors, ceil, inv in cases:
        pix = SS._device_pix(colors, 1.0, ceil, inv)
        vals = SS._apply_pix_stages(sims_dev, pix).cpu().numpy()
        vals = vals.astype(np.uint8 if pix[2] else np.uint16)
        require(np.array_equal(SS._pix_to_rgb(vals, pix[2]),
                               SS._colorize(sims_host, colors, 1.0, ceil,
                                            inv)),
                f"device raster ({colors}, ceil {ceil}, inv {inv}) differs "
                "from the host quantization")
    print(f"analyses: -x device raster bit-equal to the host quantization of "
          f"the same {dev} sims: the 8 pairs (psycho; gray inverted), the 4 "
          f"FMA tie datasets (psycho, ceil 1.3, inverted), and NaN/±inf/"
          f"bin-edge values ({len(cases) - 6} more cases)")
    return n, i, j, rec_sim


def selfsim_checks(db: str, out: str, card: str, dev: str = "cuda") -> None:
    """``-x`` through the factory on ``dev`` at decimation 1 (the streamed
    PNG) and 2 (in memory), psycho palette and gray inverted; then the
    sampled block pairs."""
    from strugatzki_tpu_torch import SelfSimilarity, SelfSimilarityConfig
    from strugatzki_tpu_torch.analysis import self_similarity as SS

    SelfSimilarity.device = dev
    meta = os.path.join(db, "piece_feat.xml")
    h = (CORR_LEN + STEP // 2) // STEP

    def run(decim, colors="psycho", inv=False, name=None):
        path = os.path.join(out, name or f"self_d{decim}_{colors}.png")
        cfg = SelfSimilarityConfig(database_folder=db, meta_input=meta,
                                   image_output=path, corr_len=CORR_LEN,
                                   decimation=decim, colors=colors,
                                   color_inv=inv)
        return lambda: (SelfSimilarity.run(cfg).result(), path)[1]

    x = _prepared_piece(db)
    n, i, j, rec_sim = selfsim_pair_checks(x, h, dev)
    require(n > SS._STREAM_EXTENT, f"extent {n} takes the in-memory path")

    _fresh_peak()
    p1, first, warm = _latency(run(1), warm=1)
    peak = _peak_gb()
    timing = io.StringIO()
    os.environ["STRUGATZKI_RENDER_TIMING"] = "1"
    try:
        with contextlib.redirect_stderr(timing):
            _profile(f"-x decimation 1 (extent {n}, streamed PNG, deflate "
                     "level 6)", run(1, name="self_profiled.png"), card,
                     warmup=False)
    finally:
        del os.environ["STRUGATZKI_RENDER_TIMING"]
    w, hh, rows = _png_rows(p1, (n - 1 - j,))
    require((w, hh) == (n, n), f"{p1}: {w}x{hh}, extent {n}")
    want = SS._colorize(np.float32([[rec_sim]]), "psycho", 1.0, 1.0, False)
    require(np.array_equal(rows[n - 1 - j][i], want[0, 0]),
            "the PNG's recurrence pixel is not the colorized sim")
    print(f"analyses: -x decimation 1: {os.path.getsize(p1)} B PNG of "
          f"{n} x {n}; wall first {first:.3f} s, warm {warm:.3f} s; peak "
          f"device memory {peak:.3f} GB on {card}")
    for line in timing.getvalue().splitlines():
        if line.startswith("render timing"):
            print(f"analyses: -x decimation 1 (profiled run): {line}")

    n2 = n // 2
    i2 = i // 2
    top_colors = SS._pix_to_rgb(np.uint16([1022, 1023]), False)
    for decim, colors, inv, top in ((2, "psycho", False, top_colors),
                                    (2, "gray", True, np.zeros((1, 3)))):
        _fresh_peak()
        if colors == "psycho":
            path, first, warm = _latency(run(decim, colors, inv), warm=1)
        else:
            t0 = time.perf_counter()
            path = run(decim, colors, inv, name="self_d2_gray_inv.png")()
            first = warm = time.perf_counter() - t0
        peak = _peak_gb()
        j2 = i2 + RECUR_SHIFT // 2
        w, hh, rows = _png_rows(path, (n2 - 1 - j2,))
        require((w, hh) == (n2, n2), f"{path}: {w}x{hh}, extent {n2}")
        px = rows[n2 - 1 - j2][i2]
        require((np.asarray(top) == px).all(axis=-1).any(),
                f"{path}: recurrence pixel {px}")
        print(f"analyses: -x decimation {decim} {colors}"
              f"{' inverted' if inv else ''}: {os.path.getsize(path)} B PNG "
              f"of {n2} x {n2}, recurrence pixel {px.tolist()}; wall first "
              f"{first:.3f} s, warm {warm:.3f} s; peak device memory "
              f"{peak:.3f} GB on {card}")


def cross_checks(db: str, out: str, card: str, dev: str = "cuda") -> None:
    """``-y``: the piece (input 1, the longer) against its excerpt, on
    ``dev`` and on the CPU."""
    from strugatzki_tpu_torch import CrossSimilarity, CrossSimilarityConfig
    from strugatzki_tpu_torch.io import audiofile as af

    def run(device):
        path = os.path.join(out, f"cross_{device}.aif")
        cfg = CrossSimilarityConfig(
            database_folder=db,
            meta_input1=os.path.join(db, "piece_feat.xml"),
            meta_input2=os.path.join(db, "excerpt_feat.xml"))
        cfg.set_audio_output(path)
        CrossSimilarity.device = device
        CrossSimilarity.run(cfg).result()
        return af.read(path)

    _fresh_peak()
    (got, spec), first, warm = _latency(lambda: run(dev), warm=3)
    peak = _peak_gb()
    want, _ = run("cpu")
    CrossSimilarity.device = dev
    len1 = af.read_spec(os.path.join(db, "piece_feat.aif")).num_frames
    len2 = af.read_spec(os.path.join(db, "excerpt_feat.aif"))
    rate1 = af.read_spec(os.path.join(db, "piece_feat.aif")).sample_rate
    require(spec.num_frames == len1 - len2.num_frames + 1,
            f"-y length {spec.num_frames}")
    require(spec.sample_rate == rate1, f"-y rate {spec.sample_rate}")
    err = float(np.abs(got - want).max())
    require(err <= CROSS_TOL, f"-y CUDA vs CPU {err:.3e}")
    peak_at = int(np.argmax(got[0]))
    require(peak_at == EXCERPT_AT and got[0, peak_at] > 0.999,
            f"-y peak {peak_at} sim {got[0, peak_at]}")
    print(f"analyses: -y [{spec.num_frames}] = {len1} - {len2.num_frames} + "
          f"1 at {spec.sample_rate:.4f} Hz (input 1's rate): CUDA vs CPU max "
          f"|err| {err:.3e} ({CROSS_TOL}); peak at frame {peak_at} (planted "
          f"{EXCERPT_AT}) sim {got[0, peak_at]:.7f}")
    print(f"analyses: -y wall first {first:.3f} s, warm median of 3 "
          f"{warm:.3f} s; peak device memory {peak:.3f} GB on {card}")


def analyses_phase(seed: int, card: str, dev: str = "cuda") -> None:
    """-f and --stats on the analysis sounds, then -s, -x and -y through
    their factories."""
    from strugatzki_tpu_torch.cli import main as cli
    from strugatzki_tpu_torch.kernels import prep

    with tempfile.TemporaryDirectory(prefix="strugatzki_analyses_") as tmp:
        snd, db = os.path.join(tmp, "snd"), os.path.join(tmp, "db")
        os.makedirs(snd)
        os.makedirs(db)
        write_analysis_sounds(snd, seed)
        prep.KERNEL_LAUNCHES = 0
        prep.REFERENCE_CALLS = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            require(cli(["-f", "-d", db, "--device", dev, snd]) == 0,
                    f"-f:\n{out.getvalue()}")
            require(cli(["--stats", "-d", db]) == 0,
                    f"--stats:\n{out.getvalue()}")
        segmentation_checks(db, card, dev)
        selfsim_checks(db, tmp, card, dev)
        cross_checks(db, tmp, card, dev)
        print(f"analyses: prep kernel launches {prep.KERNEL_LAUNCHES}, "
              f"plain-version calls {prep.REFERENCE_CALLS} (-s, -x and -y "
              "prepare on the host)")
        require(prep.REFERENCE_CALLS == 0,
                "the analyses reached the plain prep version")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "strugatzki_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    from strugatzki_tpu_torch.kernels import _build
    from strugatzki_tpu_torch.runtime.device import resolve

    resolve("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    require(torch.backends.cuda.matmul.allow_tf32 is False
            and torch.backends.cudnn.allow_tf32 is False
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 settings")
    print(f"device: {name} ({card}); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off for matmul and cuDNN, "
          f"float32 matmul precision 'highest'; host {os.cpu_count()} "
          f"cores, {len(os.sched_getaffinity(0))} usable")

    t0 = time.perf_counter()
    _build.load("prep")
    info = _build.build_info["prep"]
    print(f"build: csrc/prep.cu with nvcc {' '.join(_build.NVCC_FLAGS)} in "
          f"{info['seconds']:.2f} s ({time.perf_counter() - t0:.2f} s with "
          f"loading)")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"build: {line.strip()}")

    walls = []

    def timed(phase, fn):
        t0 = time.perf_counter()
        out = fn(args.seed, card)
        walls.append(f"{phase} {time.perf_counter() - t0:.1f} s")
        return out

    err, ms, plain_ms = timed("kernel", kernel_phase)
    launches = timed("slice", slice_phase)
    launches += timed("database", database_phase)
    launches += timed("modes", modes_phase)
    timed("analyses", analyses_phase)
    print(f"phases: wall {', '.join(walls)}")

    print(json.dumps({"kernels": [{
        "name": "prep", "route": "cuda",
        "source": "strugatzki_tpu_torch/csrc/prep.cu",
        "replaces": "strugatzki_tpu/kernels/pallas_prep.py:39",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
