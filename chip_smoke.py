#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA Hopper card.  It
drives the README quick start through the port (``strugatzki_tpu_torch``):

1. device: the card's name and power limit, and the full-f32 matmul settings;
2. build: ``csrc/prep.cu`` (the prep kernel ``prep_long``),
   ``csrc/band.cu`` (the punch's band maximum ``band_max_kernel``) and
   ``csrc/trace.cu`` (a files step's traces, ``trace_spectra_kernel`` and
   ``trace_epilogue_kernel``) with nvcc for sm_90a;
3. kernel: ``prep_long``, one persistent launch over a queue of row tiles,
   against its plain PyTorch version on the card, compared there: at a
   ``-c`` chunk ``[32, 14, 11925]`` (an odd ``T``; once more with NaN and
   inf in its padded tail), the staging slab ``[2048, 14, 10752]``, ragged
   batches with zero-length files and degenerate norm rows, another odd
   ``T``, tiny shapes, 7.7-minute files (also with NaN in the padded tail),
   a song library's slab ``[2048, 14, 36352]`` (2-6 minute songs and one
   of 7 minutes), a ``-c`` chunk holding an hour-long broadcast ``[32, 14,
   338990]``, and eight broadcasts of 1-2 hours ``[8, 14, 662092]``, whose
   tiles outnumber the CTAs the card holds at once, so each valid frame is
   read a second time (also with NaN in the padded tail).  Two runs must
   give the same bits.  It is timed at each of these main-path shapes with
   the L2 warm and cold (inputs rotated through more than the 50 MB L2)
   beside its bound (the valid frames read once, every frame written once)
   and the plain version's time.  ``band_max_kernel`` against its plain
   version on the card, bit for bit in ``band_sim`` and ``best_j``: on
   adversarial traces (NaN, +-inf, +-0 and ties; band widths 1 to 5,000;
   ``min_punch`` 0 and past ``Tp``; tombstones, files shorter than the
   punch-in, an out trace off a 16-byte boundary) and at a punch files step
   of the serving deployment (455 rows, ``W_in`` 9,892, ``W_out`` 10,322,
   S 690, and S 26,000), and on the wide path (bands of 30,000 frames
   and more at ``Tp`` 80,000, the levels through a global scratch, ``j_sel
   + 2`` launches); timed warm and cold at the step beside its bound (both traces read
   once, both results written once) and the plain version's time.  The
   trace kernels against their plain versions on the card at the serving
   cells' files steps (a ``serve10k`` punch ``[455, 14, 8193]`` and query
   ``[910, 14, 8193]``, a ``serve107k`` punch ``[227, 14, 16385]``, the
   compact cache's punch ``[369, 14, 8193]`` with window-sum tables), at
   ``nt`` 2 and with blend weights 0 and 1, on files with a constant
   temporal group, a quiet stretch and negative loudness: the rows within
   1e-6 of each row's largest bin, the epilogue bit for bit on the same
   rows, a whole group (one launch of each) against the same templates
   traced one at a time through the plain versions on the card within
   2e-6; each kernel timed (cold:
   its inputs exceed the L2) beside its bound and its plain version, with
   the irfft, the group against the plain pipeline on the card and the
   peak memory of each;
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
   the same set plus one 40,000-frame recording against the CPU; a song
   library of 2,048 songs of 2-6 minutes and a 7-minute track with a
   planted 10 s punch-in, staged with the defaults in two ``prep_long``
   launches (its staging wall and their device time), the planted match
   first in one ``query``; then the deployment
   README.md's north star names: 10,000 two-minute files staged with the
   spectra cache, a 10 s punch-in and a 5 s punch-out planted in one file,
   which must rank first in ``query`` and ``query_punch`` (12-20 s) with
   sim > 0.999.  It prints the staging time, the first and warm latencies
   of the four query families and of the exact re-rank, the peak device
   memory of staging and of the queries, and a profile of one warm
   ``query`` and ``query_punch``; one ``query_punch`` must launch
   ``band_max_kernel`` once a files step and ``query_punch_batch`` of 8
   pairs eight times a step, never the plain version, and each trace
   kernel once a trace group and step (a ``query``'s template, each
   pair); then it stages the
   same files without the spectra cache and times ``query`` and
   ``query_punch`` again (again once a step).
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
   file and its file system's free space, a profile of one warm
   compact ``query`` and ``query_punch``, and its ``query_punch`` once a
   files step.
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
7. mesh: the files mesh, every shard on ``cuda:0`` (4 shards: the sharding's
   correctness and cost on one card, not its scaling across cards).  The
   serving deployment staged with the spectra cache under the mesh (the
   single-device database gone first): the planted file first in ``query``
   and ``query_punch``, all four families and the exact re-rank equal to the
   single-device database's results (sims 3e-5, frames where decided),
   staging seconds, latencies and peak memory, ``band_max_kernel`` once a
   files step of every shard; the slice's search with
   ``FeatureCorrelation.mesh``, match for match with the unsharded search,
   one prep launch per shard and chunk; a one-hour recording made from the
   seed through ``sharded_extract_long`` (2e-5), ``sharded_long_file_trace``
   with a 10 s template (3e-5) and ``sharded_long_novelty_trace`` at corrLen
   44100 (2e-5) against the unsharded paths, with their seconds; ``-x`` of
   the 3-minute piece at decimation 2 through ``SelfSimilarity.mesh`` (8
   block pairs against the unsharded engine, the raster bit-equal to the
   host quantization, the PNG decoded to its extent); and the repairs: the
   novelty curve over 3 s of digital silence NaN at exactly the windows
   inside it and the CPU curve elsewhere, and prep launches that leave
   PyTorch's current device as it was.

Every phase that drives a path of the port sets the prep counters to 0
just before and reads them just after: the slice, the database and the
mesh must launch ``prep_long`` and never the plain version; the analyses
(``-s``, ``-x``, ``-y``) prepare on the host and must not reach the plain
version.  The band counters are read the same way around each punch path
it drives (a cache mode, the batch, the mesh), beside the files steps the
recorder counts, and the trace counters around every path: each trace
kernel, on its own counter, once a trace group and step or ``-c`` chunk,
the plain traces never.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit from nvidia-smi, and the
one before that each kernel's launch count (summed over the paths driven
and counted) and times as JSON.  Any failed check raises: the script then exits non-zero
and prints no result line.
Without CUDA, or without the package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

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
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls.
    The calls are queued behind a sleeping kernel, so the device runs them
    back to back and a short kernel's time is not the host's launch
    rate."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - h0          # one call, host and device
    # at most 2e9 cycles a second: the sleep outlasts the enqueueing
    torch.cuda._sleep(int(min(2.0, 1.5 * host_s * iters + 1e-3) * 2e9))
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


def _card_features(g, B, C, T, lens):
    """:func:`_features` made on the card from the generator ``g`` (a host
    copy of a slab would take seconds), with its per-row norm of the valid
    frames: ``(x, norm, lens)`` as CUDA tensors."""
    import torch

    ln = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    x = torch.empty((B, C, T), device="cuda")
    x[:, 0].uniform_(0.0, 0.6, generator=g)
    x[:, 1:].normal_(0.5, 0.1, generator=g)
    tail = torch.arange(T, device="cuda")[None, :] >= ln[:, None]
    x.masked_fill_(tail[:, None, :], 0.0)
    inf = torch.tensor(float("inf"), device="cuda")
    norm = torch.stack([
        torch.stack([torch.where(tail, inf, x[:, c]).amin(),
                     torch.where(tail, -inf, x[:, c]).amax()])
        for c in range(C)])
    return x, norm, ln


def _norm_of(x, lens):
    rows = np.concatenate([x[b, :, :n] for b, n in enumerate(lens) if n],
                          axis=1)
    return np.stack([rows.min(axis=1), rows.max(axis=1)], 1).astype(np.float32)


def _close(a, b, rtol=1e-5):
    """Elementwise on the card: equal (NaN to NaN, inf to the same inf) or,
    where finite, within ``rtol`` (the two sum the shifts in another
    order)."""
    return (a == b) | (a.isnan() & b.isnan()) | (
        b.isfinite() & ((a - b).abs() <= rtol * b.abs()))


def _bits_equal(a, b):
    return (a == b) | (a.isnan() & b.isnan())


#: the card's memory rate (H100 SXM, HBM3; NVIDIA's data sheet), for bounds
HBM_BYTES_PER_S = 3.35e12


def compare_prep(feats, norm, lens, nt):
    """The kernel and the plain version on the card, compared there; returns
    the max |error| over finite values after checking every stated
    tolerance: NaN and inf where the plain version has them, finite values
    within 1e-6, temporal shifts within rtol 1e-5, every frame at or past a
    file's length exactly -shift (the spectral tail one constant, within
    1e-5 of the plain version's)."""
    import torch

    from strugatzki_tpu_torch.kernels import prep

    dev = torch.device("cuda")
    f = torch.as_tensor(feats, device=dev)
    n = torch.as_tensor(norm, device=dev)
    ln = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    out_k, sh_k = prep.prepare_database_cuda(f, n, ln, nt)
    out_r, sh_r = prep.prepare_database_reference(f, n, ln, nt)
    for cls in (torch.isnan, torch.isposinf, torch.isneginf):
        require(torch.equal(cls(out_k), cls(out_r)),
                f"prep_long: {cls.__name__} positions")
    fin = out_r.isfinite()
    err = float(torch.where(fin, (out_k - out_r).abs(), 0.0).max())
    require(err <= 1e-6, f"prep_long: finite values differ by {err:.3e} > 1e-6")
    require(bool(_close(sh_k, sh_r).all()),
            "prep_long: temporal shifts differ beyond rtol 1e-5")
    B, C, T = f.shape
    tail = torch.arange(T, device=dev)[None, None, :] >= ln[:, None, None]
    require(bool((_bits_equal(out_k[:, :nt], -sh_k[:, None, None])
                  | ~tail).all()), "prep_long: a temporal tail is not -shift")
    if nt < C:
        at = ln.clamp(0, T - 1).long()[:, None, None]
        first = out_k[:, nt:nt + 1].gather(2, at)        # [B, 1, 1]
        require(bool((_bits_equal(out_k[:, nt:], first) | ~tail).all()),
                "prep_long: a spectral tail is not one constant")
        has = ln < T
        require(bool(_close(first[has], out_r[:, nt:nt + 1].gather(
            2, at)[has]).all()), "prep_long: spectral tail shifts")
    del out_k, out_r, fin, tail
    return err


def prep_bound_ms(B: int, C: int, T: int, valid: int) -> float:
    """The least time of one prep call on the card: the bytes it must move
    over the memory rate.  The ``valid`` frames (the sum over files of
    ``min(len, T)``) of every row are read once, since nothing past a
    file's length reaches the result; all of the prepared ``[B, C, T]`` is
    written once; and the norm, the lengths and the temporal shifts.  Its
    few operations an element bound it far less."""
    moved = C * valid * 4 + B * C * T * 4 + C * 2 * 4 + B * 4 + B * 4
    return moved / HBM_BYTES_PER_S * 1e3


def _valid(lens, T: int) -> int:
    import torch

    return int(torch.as_tensor(lens).clamp(0, T).sum())


def _l2_rotation(x, copies_bytes: int = 128 << 20):
    """Copies of ``x`` that together exceed the 50 MB L2 (at least two), so
    a call on each in turn finds its input cold."""
    n = max(2, -(-copies_bytes // (x.numel() * 4)))
    return [x] + [x.clone() for _ in range(n - 1)]


def time_prep(label: str, x, norm, lens, card: str, iters: int,
              plain_iters: int):
    """Warm (the same input every call) and cold (inputs rotated through
    more than the L2) device times of the kernel, twice each, between two
    timings of the plain version at one shape; prints them beside the
    bound and the plan.  Returns (warm ms, cold ms, plain ms, bound ms)."""
    from strugatzki_tpu_torch.kernels import prep

    B, C, T = x.shape
    bufs = _l2_rotation(x)
    bound = prep_bound_ms(B, C, T, _valid(lens.cpu(), T))
    plan = prep.long_plan(B, C, T, prep.long_ctas(min(prep.LONG_TILE, T), 0))

    def run(kernel, cold):
        it = itertools.count()

        def fn():
            xi = bufs[next(it) % len(bufs)] if cold else x
            if kernel:
                prep.prepare_database_cuda(xi, norm, lens, 1)
            else:
                prep.prepare_database_reference(xi, norm, lens, 1)
        return cuda_ms(fn, iters if kernel else plain_iters)

    plain = [run(False, False)]
    warm = [run(True, False), run(True, False)]
    cold = [run(True, True), run(True, True)]
    plain.append(run(False, False))
    w, c, plain_ms = sum(warm) / 2, sum(cold) / 2, sum(plain) / 2
    print(f"kernel: {label} [{B}, {C}, {T}] prep_long ({plan.tiles_per_row} "
          f"tiles a row of {plan.tile}, grid {plan.grid}, "
          f"{'held' if plan.resident else 're-read'}): warm {w:.4f} ms, "
          f"cold {c:.4f} ms (runs warm {warm[0]:.4f}, {warm[1]:.4f}, cold "
          f"{cold[0]:.4f}, {cold[1]:.4f}; {len(bufs)} rotated inputs of "
          f"{x.numel() * 4 / 1e6:.1f} MB); bound {bound:.4f} ms, share "
          f"{bound / c:.1%} cold, {bound / w:.1%} warm; plain version "
          f"{plain_ms:.4f} ms (runs {plain[0]:.4f}, {plain[1]:.4f}); on "
          f"{card}")
    del bufs
    return w, c, plain_ms, bound


#: the song library (2-6 minute songs, one 7-minute track), the hour-long
#: broadcast of a -c chunk and a folder of 1-2 hour broadcasts, in feature
#: frames at hop 512
SONG_FRAMES = (10_335, 31_007)
SEVEN_MINUTES = 36_175
HOUR_FRAMES = 310_078
TWO_HOURS = 620_156
BROADCASTS = 8


def _song_lens(rng, n: int, longest: int, frames=SONG_FRAMES):
    """``n`` lengths uniform over ``frames`` (2-6 minutes), the first
    ``longest``."""
    lens = rng.integers(frames[0], frames[1] + 1, n)
    lens[0] = longest
    return [int(v) for v in lens]


def kernel_phase(seed: int, card: str):
    """The kernel against the plain version at every shape the paths give
    it and at the edge cases, its determinism, and its times.  Returns
    ``{"prep_long": {"err", "ms", "plain_ms", "bound_ms", "shape"}}`` at its
    main-path shape, the staging slab of the serving deployment."""
    import torch

    from strugatzki_tpu_torch.analysis.correlation import CHUNK_SIZE, _bucket
    from strugatzki_tpu_torch.dsp.frontend import num_output_frames
    from strugatzki_tpu_torch.kernels import prep
    from strugatzki_tpu_torch.parallel.database import _QUERY_CHUNK

    rng = np.random.default_rng(seed)
    errs = [0.0]

    def check(label, f, nrm, lens, nt):
        e = compare_prep(f, nrm, lens, nt)
        errs[0] = max(errs[0], e)
        print(f"kernel: {label} [{', '.join(map(str, f.shape))}], "
              f"num_temporal {nt}: max |err| {e:.3e} (atol 1e-6, shifts "
              f"rtol 1e-5, tails exactly -shift)")

    frames = num_output_frames(SECONDS * SR, STEP)
    B, C, T = CHUNK_SIZE, 14, _bucket(frames)
    lens = [frames] * DB_FILES + [0] * (B - DB_FILES)
    feats = _features(rng, B, C, T, lens)
    norm = _norm_of(feats, lens)
    check("the -c chunk", feats, norm, lens, 1)
    dirty = feats.copy()
    for b, n in enumerate(lens):
        dirty[b, :, n:] = rng.choice(np.float32([np.nan, np.inf, -np.inf]),
                                     (C, T - n))
    check("the -c chunk, NaN and inf in the padded tail", dirty, norm, lens,
          1)

    lens_r = [3000, 0, 1, 1023, 1024, 2999, 1777]
    for name, row, nt in (("spectral", 5, 1), ("temporal", 0, 1),
                          ("two temporal rows", 1, 2)):
        f = _features(rng, len(lens_r), C, 3000, lens_r)
        nrm = _norm_of(f, lens_r)
        nrm[row, 1] = nrm[row, 0]
        f[0, row, :7] = nrm[row, 0]          # 0/0 as well as x/0
        check(f"ragged {lens_r}, degenerate {name} norm row", f, nrm, lens_r,
              nt)
    lens_o = [4097, 0, 4096, 1, 333, 4095, 2048, 17, 4000]
    f = _features(rng, len(lens_o), C, 4097, lens_o)
    nrm = _norm_of(f, lens_o)
    nrm[9, 1] = nrm[9, 0]
    check("odd T, ragged, degenerate spectral row", f, nrm, lens_o, 1)
    for shape, nt in (((5, 14, 3), 1), ((3, 1, 4099), 1), ((6, 5, 7), 2)):
        lens_t = [shape[2], 0, 1] + [shape[2] - 1] * (shape[0] - 3)
        f = _features(rng, shape[0], shape[1], shape[2], lens_t)
        check("tiny", f, _norm_of(f, lens_t), lens_t, nt)
    L = LONG_FRAMES
    TL = -(-L // 512) * 512
    lens_l = [L, TL, 0, 31234, TL + 9]
    f = _features(rng, len(lens_l), C, TL, lens_l)
    check("long files", f, _norm_of(f, lens_l), lens_l, 1)
    for b, n in enumerate(lens_l):
        f[b, :, n:] = np.nan
    check("long files, NaN in the padded tail", f, _norm_of(f, lens_l[:2]),
          lens_l, 1)

    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    # the staging slab of two-minute files
    xs = torch.rand((_QUERY_CHUNK, C, 10752), device="cuda", generator=g)
    ns = torch.tensor([[0.0, 1.0]] * C, device="cuda")
    ls = torch.full((_QUERY_CHUNK,), SCALE_FRAMES, dtype=torch.int32,
                    device="cuda")
    check("the staging slab", xs, ns, ls, 1)
    # a song library's slab with a 7-minute track, a -c chunk with an
    # hour-long broadcast, and a folder of 1-2 hour broadcasts, whose files'
    # tiles outnumber the CTAs the card holds at once (the re-read plan)
    TS = -(-SEVEN_MINUTES // 512) * 512
    song = _card_features(g, _QUERY_CHUNK, C, TS,
                          _song_lens(rng, _QUERY_CHUNK, SEVEN_MINUTES))
    check("the song-library slab", *song, 1)
    TH = _bucket(HOUR_FRAMES)
    hour = _card_features(g, CHUNK_SIZE, C, TH,
                          _song_lens(rng, CHUNK_SIZE, HOUR_FRAMES))
    check("the hour-long -c chunk", *hour, 1)
    T2 = _bucket(TWO_HOURS)
    two = _card_features(g, BROADCASTS, C, T2,
                         _song_lens(rng, BROADCASTS, TWO_HOURS,
                                    (TWO_HOURS // 2, TWO_HOURS)))
    plan = prep.long_plan(BROADCASTS, C, T2,
                          prep.long_ctas(min(prep.LONG_TILE, T2), 0))
    require(not plan.resident, f"[{C}, {T2}] files are held: {plan}")
    check(f"the two-hour broadcasts (re-read plan: {plan.tiles_per_row} "
          f"tiles a row, grid {plan.grid})", *two, 1)
    x2, n2, l2 = two
    pad = torch.arange(T2, device=dev)[None, :] >= l2[:, None]
    x2n = x2.masked_fill(pad[:, None, :], float("nan"))
    check("the two-hour broadcasts, NaN in the padded tail", x2n, n2, l2, 1)
    del x2n, pad

    # the same bits on every run
    ft = torch.as_tensor(feats, device=dev)
    nt_ = torch.as_tensor(norm, device=dev)
    lt = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    runs = [(ft, nt_, lt), (xs, ns, ls), song, hour, two]
    for x_, n_, l_ in runs:
        a = prep.prepare_database_cuda(x_, n_, l_, 1)
        b = prep.prepare_database_cuda(x_, n_, l_, 1)
        require(all(torch.equal(p.view(torch.int32), q.view(torch.int32))
                    for p, q in zip(a, b)),
                f"prep_long runs differ at {tuple(x_.shape)}")
        del a, b
    print("kernel: two runs give bit-equal outputs and shifts at "
          f"{', '.join(str(list(r[0].shape)) for r in runs)}")

    time_prep("the -c chunk", ft, nt_, lt, card, 200, 50)
    _, slab_ms, slab_plain, slab_bound = time_prep(
        "the staging slab", xs, ns, ls, card, 20, 5)
    del xs
    xl = torch.as_tensor(_features(rng, LONG_DB, C, TL,
                                   [L] + [1500] * (LONG_DB - 1)), device=dev)
    nl = torch.as_tensor(_norm_of(xl.cpu().numpy(), [L]), device=dev)
    ll = torch.tensor([L] + [1500] * (LONG_DB - 1), dtype=torch.int32,
                      device=dev)
    time_prep("the long-file database", xl, nl, ll, card, 50, 10)
    del xl
    time_prep("the hour-long -c chunk", *hour, card, 20, 3)
    del hour
    time_prep("the two-hour broadcasts", *two, card, 20, 3)
    del two
    time_prep("the song-library slab", *song, card, 10, 3)
    vs = _valid(song[2].cpu(), TS)
    full = prep_bound_ms(_QUERY_CHUNK, C, TS, _QUERY_CHUNK * TS)
    print(f"kernel: bounds count the valid frames read and every frame "
          f"written: at the song-library slab {prep_bound_ms(_QUERY_CHUNK, C, TS, vs):.4f} "
          f"ms ({vs / (_QUERY_CHUNK * TS):.1%} of the frames valid); a read "
          f"of every frame, as earlier bounds counted, would give "
          f"{full:.4f} ms")
    del song
    torch.cuda.empty_cache()
    return {"prep_long": {"err": errs[0], "ms": slab_ms,
                          "plain_ms": slab_plain, "bound_ms": slab_bound,
                          "shape": [_QUERY_CHUNK, C, 10752]}}


# ---------------------------------------------------------------------------
# phase 3b: the band-maximum kernel against its plain version
# ---------------------------------------------------------------------------

#: a punch files step of the serving deployment: 455 two-minute files
#: (``_files_step`` at T 10,752 with two traces a file), a 10 s punch-in and
#: a 5 s punch-out, lengths 12-20 s
BAND_STEP = dict(B=455, Tp=10_752, L_in=861, L_out=431, min_punch=1034,
                 S=690)


def _adversarial_traces(rng, B, W_in, W_out):
    """Traces of few distinct values (ties everywhere) with NaN, +-inf and
    +-0 among them, the first windows NaN as a constant group's are."""
    pool = np.float32([-0.5, -0.0, 0.0, 0.25, 0.5, 0.75, 1.0, np.inf,
                       -np.inf, np.nan])
    prob = np.array([1, 1, 1, 2, 3, 3, 2, 0.3, 0.3, 0.6])
    s_in = rng.choice(pool, (B, W_in), p=prob / prob.sum())
    s_out = rng.choice(pool, (B, W_out), p=prob / prob.sum())
    s_out[:, :40] = np.nan
    return s_in.astype(np.float32), s_out.astype(np.float32)


def compare_band(s_in, s_out, lens, L_in, L_out, Tp, min_punch, S):
    """The kernels and the plain version on the card: ``band_sim`` and
    ``best_j`` bit for bit, masked positions included, in the launches the
    plan gives; returns the plan."""
    import torch

    from strugatzki_tpu_torch.kernels import band

    plan = band.band_plan(Tp - L_in + 1, Tp, min_punch, S)
    k0 = band.KERNEL_LAUNCHES
    got = band.band_max(s_in, s_out, lens, L_in, L_out, Tp, min_punch, S)
    require(band.KERNEL_LAUNCHES - k0 == (plan.j_sel + 2 if plan.wide
                                          else 1),
            f"{band.KERNEL_LAUNCHES - k0} launches for {plan}")
    want = band.band_max_reference(s_in, s_out, lens, L_in, L_out, Tp,
                                   min_punch, S)
    require(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]),
            f"band_max_kernel differs from the plain version at "
            f"{tuple(s_in.shape)}, L {L_in}/{L_out}, Tp {Tp}, min_punch "
            f"{min_punch}, S {S} ({plan})")
    return plan


def band_bound_ms(B: int, W_in: int, W_out: int) -> float:
    """The least time of one band-maximum call: ``sims_in`` and
    ``sims_out`` read once, ``band_sim`` and ``best_j`` written once, the
    lengths read, over the memory rate."""
    return (B * (3 * W_in + W_out) * 4 + B * 4) / HBM_BYTES_PER_S * 1e3


def band_phase(seed: int, card: str):
    """``band_max_kernel`` against ``band_max_reference`` on the card, bit
    for bit, on adversarial traces (NaN, +-inf, +-0, ties; band widths 1,
    2, 511-513, 690 and wider than a tile; ``min_punch`` 0 and past ``Tp``;
    tombstones and files shorter than the punch-in; rows that start off a
    16-byte boundary), at a punch files step of the serving deployment,
    and on the wide path; times at the step.  Returns the kernel's entry of
    the ``kernels`` line."""
    import torch

    from strugatzki_tpu_torch.kernels import band

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 13)
    Tp, L_in, L_out = 1536, 200, 120
    W_in, W_out = Tp - L_in + 1, Tp - L_out + 1
    lens = torch.tensor([Tp, 0, L_in - 5, 700, Tp - 301, 1000],
                        dtype=torch.int32, device=dev)
    n = 0
    for S in (1, 2, 511, 512, 513, 690, 5000):
        for mp in (0, 37, Tp + 50):
            s_in, s_out = (torch.as_tensor(a, device=dev) for a in
                           _adversarial_traces(rng, len(lens), W_in, W_out))
            compare_band(s_in, s_out, lens, L_in, L_out, Tp, mp, S)
            n += 1
    # the whole out trace one element off a 16-byte boundary
    flat = torch.empty(len(lens) * W_out + 1, device=dev)
    s_out = flat[1:].view(len(lens), W_out)
    s_out.copy_(torch.as_tensor(_adversarial_traces(
        rng, len(lens), W_in, W_out)[1], device=dev))
    compare_band(s_in, s_out, lens, L_in, L_out, Tp, 37, 690)
    print(f"kernel: band_max_kernel equals the plain version bit for bit on "
          f"{n + 1} adversarial cases ([{len(lens)}, {W_in}] in, [{len(lens)}"
          f", {W_out}] out; S 1-5000; min_punch 0, 37, Tp + 50; an "
          f"unaligned out trace)")

    st = BAND_STEP
    B, Tp, L_in, L_out = st["B"], st["Tp"], st["L_in"], st["L_out"]
    W_in, W_out = Tp - L_in + 1, Tp - L_out + 1
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    s_in = torch.rand((B, W_in), device=dev, generator=g) * 2 - 1
    s_out = torch.rand((B, W_out), device=dev, generator=g) * 2 - 1
    s_out[::7, :300] = float("nan")              # constant groups
    s_out[1::5] = (s_out[1::5] * 8).round() / 8  # ties
    lens = torch.full((B,), SCALE_FRAMES, dtype=torch.int32, device=dev)
    lens[-3:] = 0                                # padding rows
    lens[0] = L_in - 1                           # no valid punch-in window
    lens[1] = 5000
    for S in (st["S"], 26_000):
        plan = compare_band(s_in, s_out, lens, L_in, L_out, Tp,
                            st["min_punch"], S)
        print(f"kernel: band_max_kernel equals the plain version bit for "
              f"bit at the punch step [{B}, {W_in}] / [{B}, {W_out}], S {S} "
              f"({plan})")
    # bands whose halo does not fit one CTA's shared memory: the wide path,
    # on adversarial traces of 80,000 frames (the second block clamped in
    # the last case)
    TW = 80_000
    tw_in, tw_out = TW - L_in + 1, TW - L_out + 1
    wlens = torch.tensor([TW, 0, L_in - 5, 40_000, TW - 301, 70_000],
                         dtype=torch.int32, device=dev)
    for mp, S in ((1034, 30_000), (0, 33_000), (9_000, 65_536),
                  (79_000, 40_000)):
        w_in, w_out = (torch.as_tensor(a, device=dev) for a in
                       _adversarial_traces(rng, len(wlens), tw_in, tw_out))
        plan = compare_band(w_in, w_out, wlens, L_in, L_out, TW, mp, S)
        require(plan.wide, f"S {S}, min_punch {mp}: not the wide path")
    wargs = (w_in, w_out, wlens, L_in, L_out, TW, 1034, 30_000)
    wide_ms = cuda_ms(lambda: band.band_max_cuda(*wargs), 20)
    wide_plain = cuda_ms(lambda: band.band_max_reference(*wargs), 5)
    print(f"kernel: the wide path equals the plain version bit for bit at "
          f"[{len(wlens)}, {tw_in}] / [{len(wlens)}, {tw_out}], S 30,000 "
          f"to 65,536 (last {plan}); at S 30,000, min_punch 1034 "
          f"({band.band_plan(tw_in, TW, 1034, 30_000).j_sel + 2} launches):"
          f" {wide_ms:.4f} ms, plain version {wide_plain:.4f} ms")
    del w_in, w_out

    plan = band.band_plan(W_in, Tp, st["min_punch"], st["S"])
    bufs = [(s_in, s_out)] + [(s_in.clone(), s_out.clone())
                              for _ in range(3)]
    args = (lens, L_in, L_out, Tp, st["min_punch"], st["S"])

    def run(fn, cold, iters):
        it = itertools.count()

        def call():
            a, b = bufs[next(it) % len(bufs)] if cold else bufs[0]
            fn(a, b, *args)
        return cuda_ms(call, iters)

    plain = [run(band.band_max_reference, False, 10)]
    warm = [run(band.band_max_cuda, False, 200) for _ in range(2)]
    cold = [run(band.band_max_cuda, True, 200) for _ in range(2)]
    plain.append(run(band.band_max_reference, False, 10))
    w, c, pm = sum(warm) / 2, sum(cold) / 2, sum(plain) / 2
    bound = band_bound_ms(B, W_in, W_out)
    print(f"kernel: band_max_kernel at the punch step [{B}, {W_in}] / "
          f"[{B}, {W_out}], S {st['S']} ({plan.tiles} tiles a row of "
          f"{plan.tile}, {plan.pairs * 8} B of shared memory a CTA): warm "
          f"{w:.4f} ms, cold {c:.4f} ms (runs warm {warm[0]:.4f}, "
          f"{warm[1]:.4f}, cold {cold[0]:.4f}, {cold[1]:.4f}; {len(bufs)} "
          f"rotated inputs of {(s_in.numel() + s_out.numel()) * 4 / 1e6:.1f}"
          f" MB); bound {bound:.4f} ms, share {bound / c:.1%} cold, "
          f"{bound / w:.1%} warm; plain version {pm:.4f} ms (runs "
          f"{plain[0]:.4f}, {plain[1]:.4f}); on {card}")
    del bufs
    torch.cuda.empty_cache()
    return {"err": 0.0, "ms": c, "plain_ms": pm, "bound_ms": bound,
            "shape": [B, W_in, W_out, st["S"]]}


# ---------------------------------------------------------------------------
# phase 3c: the trace kernels against their plain versions
# ---------------------------------------------------------------------------

#: (label, files, channels, padded width, template lengths, blend weights,
#: num_temporal, the compact cache's window-sum table): the cells' files
#: steps (``_files_step`` at two traces a file for a punch, one for a
#: query; the compact cache's punch step), then ``nt`` 2 and the zero-weight
#: groups at the punch step
TRACE_STEPS = [
    ("serve10k punch step", 455, 14, 10_752, (861, 431), (0.5, 0.5),
     1, False),
    ("serve10k query step", 910, 14, 10_752, (861,), (0.5,), 1, False),
    ("serve107k punch step", 227, 14, 24_064, (861, 431), (0.5, 0.5),
     1, False),
    ("compact punch step", 369, 14, 10_752, (861, 431), (0.5, 0.5),
     1, True),
    ("punch step, nt 2", 455, 14, 10_752, (861, 431), (0.5, 0.5), 2,
     False),
    ("compact punch step, nt 2, weights 0 and 1", 369, 14, 10_752,
     (861, 431), (0.0, 1.0), 2, True),
]
#: the kernels' traces against the plain version's on the card: the rows
#: differ in the order of the channel sums, so the sims carry that
#: round-off through one inverse FFT and the window statistics
TRACE_SIM_TOL, TRACE_BOOST_RTOL = 2e-6, 2e-6


def _trace_step(g, B, C, T, lengths, weights, nt, sums):
    """A files step on the card: features made from ``g`` and shifted per
    group (file 0's temporal group constant, file 1 quiet for a stretch,
    file 2's loudness negative for a stretch), their spectra as the cache
    holds them, and templates of ``lengths`` cut from file 3 → ``(X, aux,
    shifts, templates)``."""
    import torch

    from strugatzki_tpu_torch.analysis.correlation import InputTemplate
    from strugatzki_tpu_torch.kernels import corr as K

    x = torch.empty((B, C, T), device="cuda")
    x[:, 0].uniform_(0.05, 0.6, generator=g)
    x[:, 1:].normal_(0.5, 0.1, generator=g)
    x[0, :nt] = 0.4
    x[1, 0, 2000:3000] *= 1e-3
    x[2, 0, 4000:4600] = -0.3
    blocks = [x[3, :, 500 + 700 * i:500 + 700 * i + L].cpu().numpy().copy()
              for i, L in enumerate(lengths)]
    t_mean = x[:, :nt].double().mean(dim=(1, 2))
    s_mean = x[:, nt:].double().mean(dim=(1, 2))
    x[:, :nt] = (x[:, :nt].double() - t_mean[:, None, None]).float()
    x[:, nt:] = (x[:, nt:].double() - s_mean[:, None, None]).float()
    shifts = t_mean.float()
    if sums:
        X, aux = K.forward_spectra(x), K.window_sum_table(x, nt)
    else:
        X, aux = K.trace_spectra(x, num_temporal=nt)
    n = K._fft_len(T)
    templates = [InputTemplate(b, nt).trace_template("cuda", n, w)
                 for b, w in zip(blocks, weights)]
    del x
    return X, aux, shifts, templates


def _trace_errors(got, want):
    """Kernel against plain traces: NaN boosts and the boost gate at the
    same windows; the largest |sim error| where both sims are finite; the
    largest relative boost error where the boost passes the gate (as the
    serving checks compare it: past the gate a window's loudness mean is
    tiny, and an FFT window sum's round-off is large against it)."""
    import torch

    s_err = b_err = 0.0
    for (gs, gb), (ws, wb) in zip(got, want):
        require(torch.equal(gb.isnan(), wb.isnan()), "boost NaN positions")
        require(torch.equal(gb <= 8.0, wb <= 8.0), "boost gate")
        require(torch.equal(gs.isfinite(), ws.isfinite()),
                "finite sim positions")
        fin = ws.isfinite()
        s_err = max(s_err, float(torch.where(fin, (gs - ws).abs(), 0).max()))
        ok = wb <= 8.0
        b_err = max(b_err, float(torch.where(
            ok, (gb - wb).abs() / wb.abs(), 0).max()))
    return s_err, b_err


def trace_bound_ms(B, C, F, plan, sums: bool):
    """The least times of the two kernels at a step: the bytes each must
    move over the memory rate.  Spectra kernel: ``X`` (and ``Xsq`` off the
    sums path) and the template spectra read once, the rows written once.
    Epilogue: each template's window-sum rows (or the table, once) and dot
    rows read over its ``W`` windows, the shifts, and its two traces
    written."""
    G = len(plan.lengths)
    rows_b = (B * C * F + (0 if sums else B * 2 * F) + G * C * F
              + len(plan.ones) * F + B * plan.rows * F) * 8
    epi_b = B * 4 + (B * plan.n_sum * (plan.t_padded + 1) * 4 if sums else 0)
    for L, (r_t, r_s) in zip(plan.lengths, plan.dots):
        W = plan.t_padded - L + 1
        reads = (r_t >= 0) + (r_s >= 0) + (0 if sums else plan.n_sum)
        epi_b += B * W * 4 * (reads + 2)
    return rows_b / HBM_BYTES_PER_S * 1e3, epi_b / HBM_BYTES_PER_S * 1e3


def _plain_traces(X, aux, sums, T, templates, shifts, nt):
    """The templates of a group traced one at a time on the card through
    the kernels' plain versions: each template's own :func:`trace_plan`,
    ``trace_rows_reference``, the scaled irfft and
    ``trace_epilogue_reference`` (the pipeline ``correlation_traces`` runs
    on CPU tensors) → ``[(sim, boost)]``."""
    import torch

    from strugatzki_tpu_torch.kernels import corr as K

    xsq, table = (None, aux) if sums else (aux, None)
    out = []
    for t in templates:
        plan = K.trace_plan(T, (t.temporal.shape[-1],), (t.temp_weight,),
                            sums, nt)
        Y = torch.fft.irfft(K.trace_rows_reference(X, xsq, [t.spectrum],
                                                   plan, nt), n=plan.n_fft)
        out += K.trace_epilogue_reference(Y, table, plan, [t], shifts, 8.0,
                                          X.shape[-2], nt)
        del Y
    return out


def trace_phase(seed: int, card: str):
    """``trace_spectra_kernel`` and ``trace_epilogue_kernel`` against their
    plain versions on the card at each of ``TRACE_STEPS``: the rows within
    1e-6 of each row's largest bin; the epilogue on the same real rows bit
    for bit; the whole group (two launches, one irfft) against the same
    templates traced one at a time through the plain versions on the card
    (:func:`_plain_traces`) within
    TRACE_SIM_TOL / TRACE_BOOST_RTOL, NaN and gate positions equal.  Times
    at the cells' steps: each kernel (its inputs exceed the L2, so every
    call is cold) beside its bound and its plain version, the irfft, the
    whole group and the plain pipeline on the card, and the peak memory of
    a group against the plain pipeline's.  Returns the two kernels'
    entries of the ``kernels`` line."""
    import torch

    from strugatzki_tpu_torch.kernels import corr as K

    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    entries = {}
    for label, B, C, T, lengths, weights, nt, sums in TRACE_STEPS:
        X, aux, shifts, templates = _trace_step(g, B, C, T, lengths, weights,
                                                nt, sums)
        F = X.shape[-1]
        plan = K.trace_plan(T, lengths, weights, sums, nt)
        spectra = [t.spectrum for t in templates]
        xsq = None if sums else aux
        table = aux if sums else None
        rows = K.trace_rows_cuda(X, xsq, spectra, plan, nt)
        ref = K.trace_rows_reference(X, xsq, spectra, plan, nt)
        # (a row of zeros, file 0's constant temporal group, stays zero)
        scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        row_err = float(((rows - ref).abs() / scale).max())
        require(row_err <= 1e-6, f"{label}: rows differ by {row_err:.3e} of "
                "their largest bin")
        del rows
        # the kernel takes the unscaled transform and scales by the exact
        # 1/N itself; the plain version the scaled one
        Y = torch.fft.irfft(ref, n=plan.n_fft, norm="forward")
        scaled = torch.fft.irfft(ref, n=plan.n_fft)
        require(torch.equal(scaled, Y * (1.0 / plan.n_fft)),
                f"{label}: the scaled inverse FFT is not the unscaled one "
                "times 1/N")
        del ref
        got = K.trace_epilogue_cuda(Y, table, plan, templates, shifts, 8.0,
                                    C, nt)
        want = K.trace_epilogue_reference(scaled, table, plan, templates,
                                          shifts, 8.0, C, nt)
        diff = sum(int((~_bits_equal(a, b)).sum())
                   for pair in zip(got, want) for a, b in zip(*pair))
        require(diff == 0, f"{label}: the epilogue differs from the plain "
                f"version at {diff} values")
        del Y, scaled, got, want
        k0 = (K.SPECTRA_LAUNCHES, K.EPILOGUE_LAUNCHES)
        got = K.correlation_traces(X, aux, sums, T, templates, shifts, 8.0,
                                   nt)
        k1 = (K.SPECTRA_LAUNCHES - k0[0], K.EPILOGUE_LAUNCHES - k0[1])
        require(k1 == (1, 1), f"{label}: {k1} launches of "
                "(trace_spectra_kernel, trace_epilogue_kernel) for one "
                "trace group")
        s_err, b_err = _trace_errors(
            got, _plain_traces(X, aux, sums, T, templates, shifts, nt))
        require(s_err <= TRACE_SIM_TOL and b_err <= TRACE_BOOST_RTOL,
                f"{label}: sims differ by {s_err:.3e}, boosts by {b_err:.3e}")
        del got
        print(f"kernel: trace kernels, {label} [{B}, {C}, {F}], L {lengths},"
              f" weights {weights}, nt {nt}{', window-sum table' if sums else ''}"
              f" ({plan.rows} rows a file): rows within {row_err:.3e} of "
              f"their largest bin; epilogue equal bit for bit; the group "
              f"against the templates one at a time through the plain "
              f"versions: sims max |err| {s_err:.3e} "
              f"({TRACE_SIM_TOL}), boosts max rel err {b_err:.3e} "
              f"({TRACE_BOOST_RTOL})")
        if label.startswith(("serve", "compact punch step")) and nt == 1:
            timed = _time_trace(label, X, aux, xsq, table, shifts, templates,
                                plan, sums, nt, card)
            for e in timed.values():
                e["err"] = s_err
            entries.update(timed)
        del X, aux, shifts, templates, xsq, table
        torch.cuda.empty_cache()
    return entries


def _time_trace(label, X, aux, xsq, table, shifts, templates, plan, sums,
                nt, card):
    """Times and peak memory of a trace group at one step (see
    :func:`trace_phase`); returns the kernels' entries at the serve10k
    punch step, else {}."""
    import torch

    from strugatzki_tpu_torch.kernels import corr as K

    B, C, F = X.shape
    spectra = [t.spectrum for t in templates]
    rows = K.trace_rows_cuda(X, xsq, spectra, plan, nt)
    Y = torch.fft.irfft(rows, n=plan.n_fft, norm="forward")
    t_rows = cuda_ms(lambda: K.trace_rows_cuda(X, xsq, spectra, plan, nt), 20)
    t_fft = cuda_ms(lambda: torch.fft.irfft(rows, n=plan.n_fft,
                                            norm="forward"), 20)
    t_epi = cuda_ms(lambda: K.trace_epilogue_cuda(
        Y, table, plan, templates, shifts, 8.0, C, nt), 20)
    p_rows = cuda_ms(lambda: K.trace_rows_reference(X, xsq, spectra, plan,
                                                    nt), 5)
    Y = Y * (1.0 / plan.n_fft)
    p_epi = cuda_ms(lambda: K.trace_epilogue_reference(
        Y, table, plan, templates, shifts, 8.0, C, nt), 5)
    del rows, Y

    def plain():
        Y = torch.fft.irfft(K.trace_rows_reference(X, xsq, spectra, plan, nt),
                            n=plan.n_fft)
        return K.trace_epilogue_reference(Y, table, plan, templates, shifts,
                                          8.0, C, nt)
    group = [cuda_ms(lambda: K.correlation_traces(
        X, aux, sums, plan.t_padded, templates, shifts, 8.0, nt), 20)
        for _ in range(2)]
    old = [cuda_ms(plain, 5) for _ in range(2)]
    peaks = []
    for fn in (lambda: K.correlation_traces(X, aux, sums, plan.t_padded,
                                            templates, shifts, 8.0, nt),
               plain):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 1e9)
        del out
    b_rows, b_epi = trace_bound_ms(B, C, F, plan, sums)
    print(f"kernel: trace kernels at the {label} [{B}, {C}, {F}], "
          f"{plan.rows} rows a file (inputs beyond the 50 MB L2: cold): "
          f"trace_spectra_kernel {t_rows:.4f} ms, bound {b_rows:.4f} ms "
          f"({b_rows / t_rows:.1%}), plain version {p_rows:.4f} ms; unscaled "
          f"irfft of "
          f"{B * plan.rows} rows {t_fft:.4f} ms; trace_epilogue_kernel "
          f"{t_epi:.4f} ms, bound {b_epi:.4f} ms ({b_epi / t_epi:.1%}), "
          f"plain version {p_epi:.4f} ms; the group {group[0]:.4f} / "
          f"{group[1]:.4f} ms against the plain pipeline {old[0]:.4f} / "
          f"{old[1]:.4f} ms; transient peak {peaks[0]:.3f} GB against "
          f"{peaks[1]:.3f} GB; on {card}")
    if label != "serve10k punch step":
        return {}
    shape = [B, C, F, plan.rows]
    return {"trace_spectra_kernel": {"ms": t_rows, "plain_ms": p_rows,
                                     "bound_ms": b_rows, "shape": shape},
            "trace_epilogue_kernel": {"ms": t_epi, "plain_ms": p_epi,
                                      "bound_ms": b_epi, "shape": shape}}


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


def slice_phase(seed: int, card: str) -> Counter:
    from strugatzki_tpu_torch.analysis.correlation import CHUNK_SIZE

    with tempfile.TemporaryDirectory(prefix="strugatzki_smoke_") as tmp:
        snd, db = os.path.join(tmp, "snd"), os.path.join(tmp, "db")
        os.makedirs(snd)
        os.makedirs(db)
        target, start, stop = write_sounds(snd, seed)

        (matches, t_f, t_c), launches = counted(
            "-f, --stats and -c", lambda: run_slice(snd, db), "slice")
        check_matches(matches, target, start, stop)
        # the punch-in and the punch-out trace of each 32-file chunk
        chunks = -(-DB_FILES // CHUNK_SIZE)
        require(launches["trace_spectra_kernel"] == 2 * chunks
                and launches["trace_epilogue_kernel"] == 2 * chunks,
                f"-c: each trace kernel's launches are not one a trace group "
                f"and chunk ({chunks} chunk(s), two groups each)")
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
#: a recording of ~7.7 minutes (staged at T = 40,448, 2.3 MB a file, four
#: tiles a row) beside the 64-file set
LONG_FRAMES = 40_000
LONG_DB = 65


def counted(label: str, fn, phase: str = "database"):
    """Run ``fn`` with the prep and trace counters set to 0 just before and
    read just after; the path must have launched ``prep_long`` and never
    the plain versions.  Returns ``(fn's result, Counter of launches by
    kernel)``."""
    from strugatzki_tpu_torch.kernels import corr, prep

    prep.KERNEL_LAUNCHES = prep.REFERENCE_CALLS = 0
    _reset_trace_counters()
    out = fn()
    launches = Counter(prep_long=prep.KERNEL_LAUNCHES,
                       **_trace_launches())
    refs = prep.REFERENCE_CALLS
    print(f"{phase}: {label}: prep_long launches {launches['prep_long']}, "
          f"plain-version calls {refs}; trace_spectra_kernel launches "
          f"{launches['trace_spectra_kernel']}, trace_epilogue_kernel "
          f"launches {launches['trace_epilogue_kernel']}, plain traces "
          f"{corr.REFERENCE_CALLS}")
    require(launches["prep_long"] > 0, f"{label} never launched prep_long")
    require(refs == 0, f"{label} reached the plain version on CUDA")
    require(corr.REFERENCE_CALLS == 0,
            f"{label} reached the plain traces on CUDA")
    return out, launches


def _reset_trace_counters() -> None:
    from strugatzki_tpu_torch.kernels import corr

    corr.KERNEL_LAUNCHES = corr.REFERENCE_CALLS = 0
    corr.SPECTRA_LAUNCHES = corr.EPILOGUE_LAUNCHES = 0


def _trace_launches() -> dict:
    """Each trace kernel's launches since :func:`_reset_trace_counters`,
    from its own counter; their sum must be the total counter's."""
    from strugatzki_tpu_torch.kernels import corr

    n = {"trace_spectra_kernel": corr.SPECTRA_LAUNCHES,
         "trace_epilogue_kernel": corr.EPILOGUE_LAUNCHES}
    require(sum(n.values()) == corr.KERNEL_LAUNCHES,
            f"trace kernel launches {n} do not add up to "
            f"{corr.KERNEL_LAUNCHES}")
    return n


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


def canary_phase() -> Counter:
    from strugatzki_tpu_torch.parallel.canary import (format_report,
                                                      run_batch_canary)

    total = Counter()
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


def compare_phase(seed: int) -> Counter:
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
    del db
    return launches + long_file_compare(seed, entries, norm, t_in, t_out)


def long_file_compare(seed: int, entries, norm, t_in, t_out) -> Counter:
    """The 64-file set plus one recording of ~7.7 minutes (the staging
    slab's T follows it) on CUDA against the CPU; the planted pair stays
    first."""
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    rng = np.random.default_rng(seed + 2)
    entries = entries + [("long.aif",
                          _db_features(rng, 1, [LONG_FRAMES])[0])]

    def run(db):
        return (db.query(t_in, k=6),
                db.query_punch(t_in, t_out, 410, 450, k=4))

    cpu = run(FeatureDatabase(entries, norm, device="cpu"))
    got, launches = counted(
        f"64 files and one of {LONG_FRAMES} frames on CUDA",
        lambda: run(FeatureDatabase(entries, norm, device="cuda")))
    worst_s, worst_b = _same_results(got, cpu, ["query", "query_punch"],
                                     "long-file database ")
    _require_planted_pair(got[1], "long-file database ")
    print(f"database: 64 files and one of {LONG_FRAMES} frames CUDA vs CPU, "
          f"query, query_punch: sims max |err| {worst_s:.3e} ({SIM_TOL}), "
          f"boosts max rel err {worst_b:.3e} ({BOOST_RTOL})")
    return launches


#: the song library: 2,048 songs of 2-6 minutes and one 7-minute track at
#: SONG_TARGET holding a 10 s punch-in at SONG_PLANT (in its third tile of
#: a row)
SONG_FILES = 2048
SONG_TARGET, SONG_PLANT = 1500, 34_000


def song_library(seed: int, card: str) -> Counter:
    """A song library staged end to end with the defaults (no spectra
    cache): the 7-minute track sets every slab's T to 36,352, and
    prep_long prepares both slabs.  One query must rank the planted punch-in first.
    Prints the staging wall and prep_long's device time in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from strugatzki_tpu_torch.analysis.correlation import InputTemplate
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    rng = np.random.default_rng(seed + 6)
    t0 = time.perf_counter()
    lens = _song_lens(rng, SONG_FILES + 1, SEVEN_MINUTES)
    lens[0], lens[SONG_TARGET] = lens[SONG_TARGET], lens[0]
    entries = [(f"song{i:04d}.aif", rng.random((14, n), dtype=np.float32))
               for i, n in enumerate(lens)]
    query = rng.random((14, L_IN), dtype=np.float32)
    entries[SONG_TARGET][1][:, SONG_PLANT:SONG_PLANT + L_IN] = query
    norm = np.stack([np.zeros(14), np.ones(14)], 1).astype(np.float32)
    t_in = InputTemplate.from_features(query, norm, 0, L_IN)
    print(f"database: songs: {len(entries)} files of {min(lens)}-"
          f"{max(lens)} frames ({sum(lens) * 14 * 4 / 1e9:.2f} GB valid) "
          f"made in {time.perf_counter() - t0:.1f} s")

    def stage_and_query():
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            db = FeatureDatabase(entries, norm, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        prep_ms = sum(getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
                      for e in prof.key_averages()
                      if e.device_type == cuda and "prep_long" in e.key) / 1e3
        res, first, warm = _latency(lambda: db.query(t_in, k=4), warm=3)
        print(f"database: songs: staged {len(entries)} files (T "
              f"{db._xs.shape[2]}, {db._xs.numel() * 4 / 1e9:.2f} GB "
              f"resident) in {wall:.3f} s under torch.profiler, prep_long "
              f"{prep_ms:.4f} ms of device time in it; query first "
              f"{first * 1e3:.3f} ms, warm median of 3 {warm * 1e3:.3f} ms "
              f"on {card}")
        del db
        return res

    res, launches = counted("song library", stage_and_query)
    require(launches["prep_long"] == 2,
            f"song library: {launches}, not two prep_long launches")
    m = res.matches(L_IN, STEP, 1)[0]
    require(m.file == entries[SONG_TARGET][0]
            and int(res.frames[SONG_TARGET, 0]) == SONG_PLANT
            and res.sims[SONG_TARGET, 0] > 0.999,
            f"song library: top {m}, planted {entries[SONG_TARGET][0]} at "
            f"{SONG_PLANT}")
    print(f"database: songs: planted {m.file} first in query (frame "
          f"{SONG_PLANT}, sim {res.sims[SONG_TARGET, 0]:.7f})")
    del entries
    torch.cuda.empty_cache()
    return launches


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


def _scale_set(seed: int, phase: str = "database"):
    """The serving deployment's files, made from the seed: ``(feats, query,
    target, entries, norm)``, the planted punches in file ``target``."""
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
    print(f"{phase}: scale: {SCALE_FILES} files x [14, {SCALE_FRAMES}] "
          f"f32 ({feats.nbytes / 1e9:.2f} GB) made in "
          f"{time.perf_counter() - t0:.1f} s")
    return feats, query, target, entries, norm


#: the single-device scale database's results (cache_spectra=True) by
#: query family, kept as host arrays for the mesh phase
SCALE_RESULTS: dict = {}


def band_counted(phase: str, label: str, fn, per_step: int = 1,
                 punch: bool = True) -> Counter:
    """Run the serving call ``fn`` with the band and trace counters set to
    0 just before and read just after, and the recorder on at DEBUG (its
    lines held back) to count the files steps: the trace kernels must
    launch twice a trace group and step (``per_step`` groups: a punch pair
    or a query template each), ``band_max_kernel`` once a pair and step of
    a punch (never for a query), and the plain versions never.  Returns a
    Counter of the launches."""
    import logging

    from strugatzki_tpu_torch.kernels import band, corr
    from strugatzki_tpu_torch.runtime import logging as slog

    level = slog.logger.level
    handlers = [(h, h.level) for h in slog.logger.handlers]
    slog.logger.setLevel(logging.DEBUG)
    for h, _ in handlers:
        h.setLevel(logging.INFO)
    slog.reset()
    band.KERNEL_LAUNCHES = band.REFERENCE_CALLS = 0
    _reset_trace_counters()
    try:
        fn()
    finally:
        slog.logger.setLevel(level)
        for h, lv in handlers:
            h.setLevel(lv)
    steps = slog.snapshot()["counters"].get("db.files_steps", 0)
    slog.reset()
    n, refs = band.KERNEL_LAUNCHES, band.REFERENCE_CALLS
    t, t_refs = _trace_launches(), corr.REFERENCE_CALLS
    print(f"{phase}: {label}: {steps} files steps, band_max_kernel launches "
          f"{n}, plain-version calls {refs}; trace_spectra_kernel launches "
          f"{t['trace_spectra_kernel']}, trace_epilogue_kernel launches "
          f"{t['trace_epilogue_kernel']}, plain traces {t_refs}")
    require(steps > 0 and n == per_step * steps * punch and refs == 0,
            f"{label}: band_max_kernel launches are not {per_step * punch} a "
            f"files step, or it reached the plain version")
    require(all(v == per_step * steps for v in t.values()) and t_refs == 0,
            f"{label}: each trace kernel's launches are not {per_step} a "
            f"files step, or it reached the plain traces")
    return Counter(band_max_kernel=n, **t)


def scale_phase(seed: int, card: str) -> Counter:
    """10,000 two-minute files staged with the spectra cache; the planted
    file must come first in query and query_punch."""
    import torch

    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    feats, query, target, entries, norm = _scale_set(seed)
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
    SCALE_RESULTS.update({name: r[0] for name, r in res.items()})
    q, p = _require_planted(res, entries[target][0], target)
    print(f"database: scale: planted {entries[target][0]} first in query "
          f"(frame {PLANT_IN}, sim {q.sims[target, 0]:.7f}) and query_punch "
          f"(frames {PLANT_IN}-{PLANT_OUT}, sim {p.sims[target, 0]:.7f})")

    _profile("warm query", lambda: db.query(t_in, k=4), card)
    _profile("warm query_punch",
             lambda: db.query_punch(t_in, t_out, *BAND, k=4), card)
    launches += band_counted("database", "scale: one query",
                             lambda: calls["query"](db), punch=False)
    launches += band_counted("database", "scale: one query_batch of 8",
                             lambda: calls["query_batch of 8"](db),
                             per_step=8, punch=False)
    launches += band_counted("database", "scale: one query_punch",
                             lambda: calls["query_punch"](db))
    launches += band_counted(
        "database", "scale: one query_punch_batch of 8",
        lambda: calls["query_punch_batch of 8"](db), per_step=8)
    del db

    # the same database without the spectra cache: each query computes
    # every file's forward spectra again
    (db, res2), n = counted(
        "scale database, cache_spectra=False",
        lambda: stage_and_query(False, ["query", "query_punch"]))
    launches += n
    launches += band_counted("database",
                             "scale without the cache: one query_punch",
                             lambda: calls["query_punch"](db))
    for name, (got, _, _) in res2.items():
        want = res[name][0]
        require(np.array_equal(got.frames[target], want.frames[target])
                and np.abs(got.sims[target] - want.sims[target]).max()
                <= SIM_TOL, f"{name} without the cache differs at the "
                "planted file")
    del db, entries, feats
    torch.cuda.empty_cache()
    return launches


def database_phase(seed: int, card: str) -> Counter:
    """Every check of the resident database; returns the prep launches of
    the paths it drove."""
    topk_on_card()
    launches = canary_phase()
    launches += compare_phase(seed)
    launches += song_library(seed, card)
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


def modes_canary() -> Counter:
    """The planted-match canary on reduced databases: the families at
    1e-4 and their ``[raw]`` runs at 4e-3."""
    import torch

    from strugatzki_tpu_torch.parallel.canary import (format_report,
                                                      run_batch_canary)

    total = Counter()
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


def modes_compare(seed: int) -> Counter:
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


def modes_phase(seed: int, card: str) -> Counter:
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
    launches += band_counted("modes", "A: one compact query_punch",
                             lambda: calls["query_punch"](db))
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
#: with frame-aligned boundaries, and digital silence inside one section,
#: shorter than the 2 s window (a window inside a longer silence is 0/0:
#: NaN, which the mesh phase checks)
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
    from strugatzki_tpu_torch.runtime import logging as tracing

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
    # the profiled render's spans: its stages and the PNG's own time
    tracing.reset()
    _profile(f"-x decimation 1 (extent {n}, streamed PNG, deflate level 6)",
             run(1, name="self_profiled.png"), card, warmup=False)
    spans = tracing.snapshot()["spans"]
    w, hh, rows = _png_rows(p1, (n - 1 - j,))
    require((w, hh) == (n, n), f"{p1}: {w}x{hh}, extent {n}")
    want = SS._colorize(np.float32([[rec_sim]]), "psycho", 1.0, 1.0, False)
    require(np.array_equal(rows[n - 1 - j][i], want[0, 0]),
            "the PNG's recurrence pixel is not the colorized sim")
    print(f"analyses: -x decimation 1: {os.path.getsize(p1)} B PNG of "
          f"{n} x {n}; wall first {first:.3f} s, warm {warm:.3f} s; peak "
          f"device memory {peak:.3f} GB on {card}")
    render = spans["x.render"]
    print(f"analyses: -x decimation 1 (profiled run): total "
          f"{render['total_s']:.3f}s = dispatch "
          f"{spans['x.dispatch']['total_s']:.3f}s + fetch-wait "
          f"{spans['x.fetch']['total_s']:.3f}s + raster "
          f"{spans['x.raster']['total_s']:.3f}s + png(filter+deflate+io) "
          f"{render['self_s']:.3f}s")

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
        prep.KERNEL_LAUNCHES = prep.REFERENCE_CALLS = 0
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


# ---------------------------------------------------------------------------
# phase 7: the files mesh (every shard on the one card)
# ---------------------------------------------------------------------------

#: shards of the mesh phase's meshes, all on cuda:0: the sharding's
#: correctness and its cost on one card, not its scaling across cards
MESH_SHARDS = 4
#: the long-broadcast recording of the sequence-sharded paths
LONG_SECONDS = 3600
LONG_TEMPLATE_AT, LONG_TEMPLATE_FRAMES = 150_000, 861     # a 10 s template
#: the repair check: 3 s of digital silence inside 30 s, corrLen 44100
SILENT_SECONDS, SILENT_AT, SILENT_LEN = 30, 12.0, 3.0


def _mesh():
    from strugatzki_tpu_torch.parallel.sweep import make_files_mesh
    return make_files_mesh(["cuda:0"] * MESH_SHARDS)


def mesh_scale(seed: int, card: str, mesh) -> Counter:
    """The serving deployment staged with the spectra cache under the mesh,
    after the single-device database is gone: the planted file first, and
    all four families and the exact re-rank equal to the single-device
    database's results."""
    import torch

    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    if not SCALE_RESULTS:           # the phase run alone: stage one first
        scale_phase(seed, card)
    feats, query, target, entries, norm = _scale_set(seed, "mesh")
    _, _, calls = _scale_calls(query, norm)

    def stage_and_query():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        db = FeatureDatabase(entries, norm, cache_spectra=True, mesh=mesh)
        t_stage = time.perf_counter() - t0
        peak_stage = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = {n: _latency(lambda: calls[n](db), warm=3) for n in calls}
        peak_query = torch.cuda.max_memory_allocated()
        gb = sum(sh.xs.numel() * 4 + sum(x.numel() * 8 for x in sh.spectra)
                 for sh in db._shards) / 1e9
        print(f"mesh: scale: staged {SCALE_FILES} files over "
              f"{db._num_shards} shards of {db._shards[0].xs.shape[0]} rows "
              f"(T {db._raw.shape[2]}) with cache_spectra=True in "
              f"{t_stage:.3f} s: {gb:.2f} GB resident on {card}")
        for name, (_, first, warm) in res.items():
            print(f"mesh: scale: {name}: first {first * 1e3:.3f} ms, warm "
                  f"median of 3 {warm * 1e3:.3f} ms on {card}")
        print(f"mesh: scale: torch.cuda.max_memory_allocated "
              f"{peak_stage / 1e9:.3f} GB while staging, "
              f"{peak_query / 1e9:.3f} GB over the queries on {card}")
        return db, res

    (db, res), launches = counted(f"{MESH_SHARDS}-shard scale database",
                                  stage_and_query, "mesh")
    per_shard = -(-(SCALE_FILES // MESH_SHARDS) // 2048)
    require(launches["prep_long"] == MESH_SHARDS * per_shard,
            f"{launches['prep_long']} prep launches, not {per_shard} a shard")
    q, p = _require_planted(res, entries[target][0], target)
    worst_s = worst_b = 0.0
    for name, (got, _, _) in res.items():
        s, b = _same_results([got], [SCALE_RESULTS[name]], [name], "mesh ")
        worst_s, worst_b = max(worst_s, s), max(worst_b, b)
    print(f"mesh: scale: planted {entries[target][0]} first in query (sim "
          f"{q.sims[target, 0]:.7f}) and query_punch (sim "
          f"{p.sims[target, 0]:.7f}); {', '.join(res)} against the "
          f"single-device database: sims max |err| {worst_s:.3e} "
          f"({SIM_TOL}), boosts max rel err {worst_b:.3e} ({BOOST_RTOL}), "
          f"frames equal where decided; prep launches {per_shard} a shard")
    launches += band_counted(
        "mesh", f"scale: one query_punch over {MESH_SHARDS} shards",
        lambda: calls["query_punch"](db))
    del db, entries, feats
    torch.cuda.empty_cache()
    return launches


def mesh_correlation(seed: int, card: str, mesh) -> Counter:
    """The slice's 20-file search with ``FeatureCorrelation.mesh``: the
    unsharded search's matches, one prep launch per shard-chunk."""
    from strugatzki_tpu_torch import FeatureCorrelation
    from strugatzki_tpu_torch.analysis.correlation import CHUNK_SIZE

    with tempfile.TemporaryDirectory(prefix="strugatzki_mesh_") as tmp:
        snd, db = os.path.join(tmp, "snd"), os.path.join(tmp, "db")
        os.makedirs(snd)
        os.makedirs(db)
        target, start, stop = write_sounds(snd, seed)
        want, _, _ = run_slice(snd, db)
        FeatureCorrelation.mesh = mesh
        try:
            t0 = time.perf_counter()
            got, launches = counted(
                f"-c with a {MESH_SHARDS}-shard mesh",
                lambda: FeatureCorrelation.run(_corr_config(db)).result(),
                "mesh")
            t_c = time.perf_counter() - t0
        finally:
            FeatureCorrelation.mesh = None
    chunks = -(-DB_FILES // (-(-CHUNK_SIZE // MESH_SHARDS) * MESH_SHARDS))
    require(launches["prep_long"] == MESH_SHARDS * chunks,
            f"{launches['prep_long']} prep launches for {chunks} chunk(s)")
    require(launches["trace_spectra_kernel"] == 2 * MESH_SHARDS * chunks
            and launches["trace_epilogue_kernel"] == 2 * MESH_SHARDS * chunks,
            f"sharded -c: each trace kernel's launches are not one a trace "
            f"group, shard and chunk (two groups each)")
    require([(m.file, m.punch.start, m.punch.stop) for m in got]
            == [(m.file, m.punch.start, m.punch.stop) for m in want],
            "sharded -c matches differ from the unsharded search")
    err = max(abs(a.sim - b.sim) for a, b in zip(got, want))
    require(err <= SIM_TOL, f"sharded -c sims differ by {err:.3e}")
    check_matches(got, target, start, stop)
    print(f"mesh: -c over {DB_FILES} files with {MESH_SHARDS} shards: "
          f"{len(got)} matches equal to the unsharded search's match for "
          f"match (sims max |err| {err:.3e}); {launches['prep_long']} prep_long "
          f"launches = {MESH_SHARDS} shards x {chunks} chunk(s); "
          f"{t_c:.3f} s on {card}")
    return launches


def mesh_long_file(seed: int, card: str, mesh) -> None:
    """One hour of audio: the sequence-sharded extraction, template trace
    and novelty curve against the unsharded paths on the card."""
    import torch

    from strugatzki_tpu_torch.analysis.correlation import (InputTemplate,
                                                           sliding_traces)
    from strugatzki_tpu_torch.dsp.frontend import extract_features
    from strugatzki_tpu_torch.kernels import corr as K
    from strugatzki_tpu_torch.parallel import sweep as W

    rng = np.random.default_rng(seed + 4)
    t0 = time.perf_counter()
    audio = _sound(rng, LONG_SECONDS)
    print(f"mesh: long: {LONG_SECONDS} s recording ({len(audio)} samples) "
          f"made in {time.perf_counter() - t0:.1f} s")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    seq, t_seq = timed(lambda: extract_features(audio, float(SR),
                                                device="cuda"))
    shd, t_shd = timed(lambda: W.sharded_extract_long(audio, float(SR),
                                                      mesh))
    require(shd.shape == seq.shape, f"long features {shd.shape}")
    e_f = float(np.abs(shd - seq).max())
    require(e_f <= 2e-5, f"sharded extraction differs by {e_f:.3e}")

    lo, hi = seq.min(axis=1, keepdims=True), seq.max(axis=1, keepdims=True)
    x = ((seq - lo) / (hi - lo)).astype(np.float32)
    xs, sh_t, sh_s = K.shift_per_group(x)
    a = LONG_TEMPLATE_AT
    tmpl = InputTemplate(x[:, a:a + LONG_TEMPLATE_FRAMES].copy())
    (s1, b1), t_t1 = timed(lambda: sliding_traces(
        xs, sh_t, sh_s, tmpl, x.shape[1], TEMP_WEIGHT, 8.0, device="cuda"))
    (s4, b4), t_t4 = timed(lambda: W.sharded_long_file_trace(
        xs, sh_t, tmpl, TEMP_WEIGHT, 8.0, mesh))
    require(s4.shape == s1.shape, "long trace shape")
    e_t = float(np.abs(s4 - s1).max())
    require(e_t <= CROSS_TOL, f"sharded trace differs by {e_t:.3e}")
    require(int(np.argmax(s4)) == a and s4[a] > 0.999, "long trace peak")

    h = (CORR_LEN + STEP // 2) // STEP
    n1, t_n1 = timed(lambda: K.novelty_trace(
        torch.as_tensor(xs, device="cuda"), h, TEMP_WEIGHT).cpu().numpy())
    n4, t_n4 = timed(lambda: W.sharded_long_novelty_trace(xs, h, TEMP_WEIGHT,
                                                          mesh))
    require(n4.shape == n1.shape and np.isfinite(n1).all(),
            "long novelty shape")
    e_n = float(np.abs(n4 - n1).max())
    require(e_n <= NOVELTY_TOL, f"sharded novelty differs by {e_n:.3e}")
    print(f"mesh: long: features [{seq.shape[0]}, {seq.shape[1]}]: "
          f"sharded_extract_long {t_shd:.3f} s vs extract_features "
          f"{t_seq:.3f} s, max |err| {e_f:.3e} (2e-5); sharded_long_file_"
          f"trace (10 s template) {t_t4:.3f} s vs {t_t1:.3f} s, max |err| "
          f"{e_t:.3e} ({CROSS_TOL}), peak at {a}; sharded_long_novelty_"
          f"trace (corrLen {CORR_LEN}) {t_n4:.3f} s vs {t_n1:.3f} s, max "
          f"|err| {e_n:.3e} ({NOVELTY_TOL}) on {card}")


def mesh_selfsim(seed: int, card: str, mesh, db: str, out: str) -> None:
    """``-x`` of the 3-minute piece at decimation 2 through
    ``SelfSimilarity.mesh``: 8 block pairs against the unsharded engine,
    the device raster of the sharded sims bit-equal to their host
    quantization, and the PNG decoded to its extent."""
    from strugatzki_tpu_torch import SelfSimilarity, SelfSimilarityConfig
    from strugatzki_tpu_torch.analysis import self_similarity as SS
    from strugatzki_tpu_torch.parallel.sweep import fetch

    x = _prepared_piece(db)
    h = (CORR_LEN + STEP // 2) // STEP
    n, nb, res_m, _ = SS._prep_resident(x, x, h, 2, mesh=mesh)
    _, _, res_1, _ = SS._prep_resident(x, x, h, 2, device="cuda")
    pairs = list(dict.fromkeys([(0, 0), (0, nb - 1), (nb - 1, nb - 1),
                                (1, 3), (2, nb // 2), (nb // 3, nb - 2),
                                (3, 5), (nb // 2, nb // 2)]))
    require(len(pairs) == 8, f"sampled pairs {pairs}")
    parts = SS._dispatch_pairs_fast(res_m, res_m, pairs, TEMP_WEIGHT,
                                    mesh=mesh)
    got = fetch(parts)
    want = SS._dispatch_pairs_fast(res_1, res_1, pairs, TEMP_WEIGHT)
    err = float(np.abs(got - want.cpu().numpy()).max())
    require(np.isfinite(got).all() and err <= GRAM_TOL,
            f"sharded gram vs unsharded {err:.3e}")
    pix = SS._device_pix("psycho", 1.0, 1.0, False)
    vals = fetch([SS._apply_pix_stages(t, pix) for t in parts])
    require(np.array_equal(SS._pix_to_rgb(vals.astype(np.uint16), False),
                           SS._colorize(got, "psycho", 1.0, 1.0, False)),
            "sharded device raster differs from the host quantization")

    SelfSimilarity.mesh = mesh
    try:
        path = os.path.join(out, "self_d2_mesh.png")
        cfg = SelfSimilarityConfig(
            database_folder=db, meta_input=os.path.join(db, "piece_feat.xml"),
            image_output=path, corr_len=CORR_LEN, decimation=2)
        _, first, warm = _latency(lambda: SelfSimilarity.run(cfg).result(),
                                  warm=1)
    finally:
        SelfSimilarity.mesh = None
    i2 = (_aligned(sum(RECUR) / 2) // STEP) // 2
    j2 = i2 + RECUR_SHIFT // 2
    w, hh, rows = _png_rows(path, (n - 1 - j2,))
    require((w, hh) == (n, n), f"{path}: {w}x{hh}, extent {n}")
    top = SS._pix_to_rgb(np.uint16([1022, 1023]), False)
    px = rows[n - 1 - j2][i2]
    require((top == px).all(axis=-1).any(), f"recurrence pixel {px}")
    print(f"mesh: -x decimation 2 (extent {n}) with {MESH_SHARDS} shards: "
          f"8 block pairs {pairs} vs unsharded max |err| {err:.3e} "
          f"({GRAM_TOL}), device raster bit-equal to the host quantization, "
          f"PNG {w} x {hh} with the recurrence pixel {px.tolist()}; wall "
          f"first {first:.3f} s, warm {warm:.3f} s on {card}")


def mesh_repairs(seed: int, card: str, db: str) -> None:
    """The 0/0 repair on the card: ``novelty_trace`` over 3 s of digital
    silence at corrLen 44100 is NaN at exactly the windows inside the
    silence and the CPU curve elsewhere; a prep launch leaves PyTorch's
    current device as it was."""
    import torch

    from strugatzki_tpu_torch import SegmentationConfig
    from strugatzki_tpu_torch.analysis.segmentation import _novelty_prep
    from strugatzki_tpu_torch.io import audiofile as af
    from strugatzki_tpu_torch.kernels import corr as K
    from strugatzki_tpu_torch.kernels import prep

    feats, _ = af.read(os.path.join(db, "silent_feat.aif"))
    cfg = SegmentationConfig(meta_input="silent", normalize=False,
                             corr_len=CORR_LEN).build()
    xs, nw, _, h = _novelty_prep(feats, None, STEP, cfg)
    curves = [K.novelty_trace(torch.as_tensor(xs, device=d), h,
                              TEMP_WEIGHT)[:nw].cpu().numpy()
              for d in ("cuda", "cpu")]
    loud = feats[0, :nw - 1 + 2 * h]
    silent = loud == loud[int((SILENT_AT + SILENT_LEN / 2) * SR) // STEP]
    run = int(silent.sum())
    require(run >= int(SILENT_LEN * SR) // STEP - 2,
            f"only {run} silent frames")
    inside = np.array([silent[t:t + 2 * h].all() for t in range(nw)])
    for dev, c in zip(("cuda", "cpu"), curves):
        require(np.array_equal(np.isnan(c), inside),
                f"{dev}: NaN at {int(np.isnan(c).sum())} windows, "
                f"{int(inside.sum())} inside the silence")
    err = float(np.abs(curves[0][~inside] - curves[1][~inside]).max())
    require(err <= NOVELTY_TOL, f"silence curve CUDA vs CPU {err:.3e}")

    currents = []
    for d in range(torch.cuda.device_count()):
        torch.cuda.set_device((d + 1) % torch.cuda.device_count())
        current = torch.cuda.current_device()
        x = torch.rand((3, 14, 500), device=f"cuda:{d}")
        prep.prepare_database_cuda(
            x, torch.tensor([[0.0, 1.0]] * 14, device=f"cuda:{d}"),
            torch.full((3,), 400, dtype=torch.int32, device=f"cuda:{d}"))
        torch.cuda.synchronize(d)
        require(torch.cuda.current_device() == current,
                f"a prep_long launch on cuda:{d} left cuda:"
                f"{torch.cuda.current_device()} current, not {current}")
        currents.append(current)
    torch.cuda.set_device(0)
    # with one card the launch device is the current one, so the guard in
    # prep.cu has nothing to put back and this check cannot fail
    restore = ("each launched on a card that was not current"
               if torch.cuda.device_count() > 1 else
               "on the only card, which was current: the restore is not "
               "exercised")
    print(f"mesh: repairs: {SILENT_LEN} s of silence at corrLen {CORR_LEN} "
          f"(half window {h}): NaN at exactly the {int(inside.sum())} "
          f"windows inside it on CUDA and the CPU, elsewhere CUDA vs CPU "
          f"max |err| {err:.3e} ({NOVELTY_TOL}); prep_long "
          f"launches on each of {torch.cuda.device_count()} card(s) left "
          f"the current device as it was ({currents}; {restore})")


def mesh_phase(seed: int, card: str) -> Counter:
    """The files mesh on the one card: the sharded serving deployment, the
    sharded -c, the sequence-sharded long-file paths, -x under a mesh, and
    the repairs."""
    from strugatzki_tpu_torch.cli import main as cli
    from strugatzki_tpu_torch.io import AIFF, AudioFileSpec, SampleFormat
    from strugatzki_tpu_torch.io import audiofile as af

    mesh = _mesh()
    launches = mesh_scale(seed, card, mesh)
    launches += mesh_correlation(seed, card, mesh)
    mesh_long_file(seed, card, mesh)
    with tempfile.TemporaryDirectory(prefix="strugatzki_mesh_") as tmp:
        snd, db = os.path.join(tmp, "snd"), os.path.join(tmp, "db")
        os.makedirs(snd)
        os.makedirs(db)
        write_analysis_sounds(snd, seed)
        for name in ("seg.aif", "excerpt.aif"):
            os.remove(os.path.join(snd, name))
        silent = _sound(np.random.default_rng(seed + 5), SILENT_SECONDS)
        a = _aligned(SILENT_AT)
        silent[a:a + int(SILENT_LEN * SR)] = 0.0
        af.write(os.path.join(snd, "silent.aif"), silent[None],
                 AudioFileSpec(AIFF, SampleFormat.INT16, 1, float(SR)))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            require(cli(["-f", "-d", db, "--device", "cuda", snd]) == 0,
                    f"-f:\n{out.getvalue()}")
            require(cli(["--stats", "-d", db]) == 0,
                    f"--stats:\n{out.getvalue()}")
        mesh_selfsim(seed, card, mesh, db, tmp)
        mesh_repairs(seed, card, db)
    return launches


#: each CUDA source and the kernels it holds, and the TPU kernel each
#: replaces (the band maximum and the traces replace XLA ops, no TPU kernel)
KERNEL_SOURCES = {"prep": ("prep_long",), "band": ("band_max_kernel",),
                  "trace": ("trace_spectra_kernel", "trace_epilogue_kernel")}
REPLACES = {"prep_long": "strugatzki_tpu/kernels/pallas_prep.py:39",
            "band_max_kernel": None, "trace_spectra_kernel": None,
            "trace_epilogue_kernel": None}


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

    for src, names in KERNEL_SOURCES.items():
        t0 = time.perf_counter()
        _build.load(src)
        info = _build.build_info[src]
        print(f"build: csrc/{src}.cu ({', '.join(names)}) with nvcc "
              f"{' '.join(_build.NVCC_FLAGS)} in {info['seconds']:.2f} s "
              f"({time.perf_counter() - t0:.2f} s with loading)")
        for line in info["log"].splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"build: {line.strip()}")

    walls = []

    def timed(phase, fn):
        t0 = time.perf_counter()
        out = fn(args.seed, card)
        walls.append(f"{phase} {time.perf_counter() - t0:.1f} s")
        return out

    kernels = timed("kernel", kernel_phase)
    kernels["band_max_kernel"] = timed("band", band_phase)
    kernels.update(timed("trace", trace_phase))
    launches = timed("slice", slice_phase)
    launches += timed("database", database_phase)
    launches += timed("modes", modes_phase)
    timed("analyses", analyses_phase)
    launches += timed("mesh", mesh_phase)
    print(f"phases: wall {', '.join(walls)}")

    print(json.dumps({"kernels": [{
        "name": kernel, "route": "cuda",
        "source": f"strugatzki_tpu_torch/csrc/{src}.cu",
        "replaces": REPLACES[kernel], "launches": launches[kernel],
        "max_abs_err": kernels[kernel]["err"], "ms": kernels[kernel]["ms"],
        "plain_ms": kernels[kernel]["plain_ms"],
        "bound_ms": kernels[kernel]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": kernels[kernel]["shape"]}
        for src, names in KERNEL_SOURCES.items() for kernel in names]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
