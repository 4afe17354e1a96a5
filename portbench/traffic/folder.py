"""Traffic over a folder of recordings: back-to-back ``-f`` passes through
the port's CLI (``op: extract``), or back-to-back one-off ``-c`` searches
through ``FeatureCorrelation`` over the folder's features (``op:
correlate``).

Set-up writes the configuration's folder from the seed (``sound.py``: 16-bit
mono AIFF files of re-coloured noise, the query's punches planted in one
seeded file) under the run's temporary directory.  An extract pass writes
the folder's feature files and sidecars into a folder of its own, so that
every pass's answers remain to be checked.  A correlate cell's set-up runs
``-f`` once for the sidecars, writes the reference front-end's features
over the program's feature files, so that the search and its reference
read the same features, made by the benchmark, and runs ``--stats`` on
them; each search takes its punch-in and punch-out at a pair of positions
of the query drawn from the seed (the first pair is the planted one).

The check, after the window: a sample of passes drawn from the seed (and the
last) is read back and held to the float64 front-end reference
(``reference/frontend.py``), computed from the same samples; a sample of
searches is held to the reference search (``reference/correlate.py``) over
the features the benchmark wrote, with norms the reference works out again
from them and compares with ``feat_norms.aif``."""

from __future__ import annotations

import contextlib
import math
import os
from types import SimpleNamespace

import numpy as np
import torch

from portbench import aiff
from portbench.reference.frontend import num_frames
from portbench.traffic.sound import write_folder

__all__ = ["setup", "unit", "facts", "release", "check", "close"]


def _cli(*args) -> None:
    from strugatzki_tpu_torch.cli import main

    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        rc = main(list(args))
    if rc != 0:
        raise RuntimeError(f"the CLI exited {rc} on {args[0]}")


def _extract(state, out: str) -> None:
    os.makedirs(out)
    _cli("-f", "-d", out, "--device", state.ctx.device, state.snd)


def _pairs(cfg: dict, mix: dict, seed: int, frames: int) -> np.ndarray:
    """``[pool, 2]`` distinct punch-in and punch-out start frames in the
    query: the planted pair first, then pairs drawn from the seed."""
    rate, step = cfg["sample_rate"], cfg["extraction"]["step"]
    n_in = frames - int(mix["punch_in_s"] * rate) // step
    n_out = frames - int(mix["punch_out_s"] * rate) // step
    rng = np.random.default_rng([seed, 2])
    idx = rng.choice(n_in * n_out, mix["pool"], replace=False)
    pairs = np.stack([idx // n_out, idx % n_out], axis=1)
    plant = cfg["planted"]
    pairs[0] = [round(plant["in_s"][0] * rate / step),
                round(plant["out_s"][0] * rate / step)]
    return pairs


def _corr_config(state, pair):
    from strugatzki_tpu_torch import CorrelationConfig, Punch, Span

    cfg, mix = state.ctx.config, state.ctx.mix
    rate, step = cfg["sample_rate"], cfg["extraction"]["step"]
    a, b = int(pair[0]) * step, int(pair[1]) * step
    w = mix["temp_weight"]
    return CorrelationConfig(
        database_folder=state.db, meta_input=state.meta,
        punch_in=Punch(Span(a, a + int(mix["punch_in_s"] * rate)), w),
        punch_out=Punch(Span(b, b + int(mix["punch_out_s"] * rate)), w),
        min_punch=int(mix["min_punch_s"] * rate),
        max_punch=int(mix["max_punch_s"] * rate),
        num_matches=mix["num_matches"], max_boost=mix["max_boost"])


def setup(ctx):
    from strugatzki_tpu_torch import FeatureCorrelation

    cfg, mix = ctx.config, ctx.mix
    snd = os.path.join(ctx.tmp, "snd")
    os.makedirs(snd)
    pcm, target = write_folder(cfg, ctx.seed, snd)
    state = SimpleNamespace(ctx=ctx, snd=snd, pcm=pcm, target=target,
                            db=os.path.join(ctx.tmp, "db"))
    if mix["op"] == "extract":
        for w in range(mix["warmup"]):
            _extract(state, os.path.join(ctx.tmp, f"warm{w}"))
        return state
    _extract(state, state.db)
    state.feats = _write_features(state)
    _cli("--stats", "-d", state.db)
    state.meta = os.path.join(state.db, "query_feat.xml")
    FeatureCorrelation.device = ctx.device
    FeatureCorrelation.skip_nan = True
    frames = num_frames(len(pcm["query.aif"]), cfg["extraction"]["step"])
    state.pairs = _pairs(cfg, mix, ctx.seed, frames)
    for w in range(mix["warmup"]):
        _search(state, state.pairs[-1 - w])
    return state


def _basis(cfg: dict):
    from portbench.reference import frontend as R

    ex = cfg["extraction"]
    return R.Basis(cfg["sample_rate"], ex["fft_size"], ex["num_coeffs"],
                   cfg["loudness"])


def _write_features(state) -> dict:
    """The reference front-end's features of every file, written over the
    program's feature files (the sidecars stay): ``{name: [C, F]
    float32}``."""
    from portbench.reference import frontend as R

    cfg = state.ctx.config
    step = cfg["extraction"]["step"]
    basis = _basis(cfg)
    feats = {}
    for name, pcm in state.pcm.items():
        x = R.features(pcm, basis, step, state.ctx.device)[0]
        feats[name] = x.astype(np.float32)
        aiff.write_fl32(os.path.join(state.db, name[:-4] + "_feat.aif"),
                        feats[name], cfg["sample_rate"] / step)
    return feats


def _search(state, pair):
    """One ``-c`` search → ``[(file, start, stop, sim, boost_in,
    boost_out)]`` of its matches."""
    from strugatzki_tpu_torch import FeatureCorrelation

    matches = FeatureCorrelation.run(_corr_config(state, pair)).result()
    return [(os.path.basename(m.file), m.punch.start, m.punch.stop, m.sim,
             m.boost_in, m.boost_out) for m in matches]


def unit(state, i: int):
    if state.ctx.mix["op"] == "extract":
        out = os.path.join(state.ctx.tmp, f"pass{i}")
        _extract(state, out)
        return out
    return _search(state, state.pairs[i % len(state.pairs)])


def facts(state) -> dict:
    cfg = state.ctx.config
    step = cfg["extraction"]["step"]
    lens = {n: len(p) for n, p in state.pcm.items()}
    return {"audio_s_per_unit": sum(lens.values()) / cfg["sample_rate"],
            "searched_frames": sum(num_frames(n, step)
                                   for name, n in lens.items()
                                   if name != "query.aif"),
            "channels": 1 + cfg["extraction"]["num_coeffs"]}


def release(state) -> None:
    if state.ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()


def close(state) -> None:
    state.pcm = state.feats = None


def _sample(ctx, done, extra=()):
    rng = np.random.default_rng([ctx.seed, 3])
    n = min(ctx.mix["sample"], len(done))
    pick = set(rng.choice(done, n, replace=False).tolist()) if n else set()
    return sorted(pick | set(extra))


def check(state, outputs, ctx):
    done = [i for i, r in enumerate(outputs) if r is not None]
    if ctx.mix["op"] == "extract":
        return _check_extract(state, outputs, ctx, done)
    return _check_correlate(state, outputs, ctx, done)


def _check_extract(state, outputs, ctx, done):
    """Features of sampled passes against the front-end reference: the
    largest |error| of the MFCC rows, and of the loudness row outside the
    interval the reference leaves open at sone-gate thresholds."""
    from portbench.reference import frontend as R

    cfg, lim = ctx.config, ctx.mix["limits"]
    ex = cfg["extraction"]
    basis = _basis(cfg)
    refs = {n: R.features(p, basis, ex["step"], ctx.device)
            for n, p in state.pcm.items()}
    if ctx.variant == "control":
        ctl = {n: R.features(p, basis, ex["step"], ctx.device, "tf32")[0]
               for n, p in state.pcm.items()}
        served = [lambda name, c=ctl: c[name]]
    else:
        served = [lambda name, d=outputs[i]: aiff.read(os.path.join(
            d, name[:-4] + "_feat.aif"))[0]
            for i in _sample(ctx, done, done[-1:])]
    mfcc = loud = 0.0
    for get in served:
        for name, (ref, lo, hi) in refs.items():
            got = np.asarray(get(name), np.float64)
            if got.shape != ref.shape or not np.isfinite(got).all():
                mfcc = loud = math.inf
                continue
            mfcc = max(mfcc, float(np.abs(got[1:] - ref[1:]).max()))
            loud = max(loud, float(np.maximum(got[0] - hi, lo - got[0]).max()),
                       0.0)
    return [("mfcc_err", mfcc, lim["mfcc_err"]),
            ("loud_err", loud, lim["loud_err"])]


def _check_correlate(state, outputs, ctx, done):
    """Sampled searches against the reference search over the features the
    benchmark wrote, root mean square over their matches: each served
    match's score against the reference's at its windows (``sim_rms``) and
    against the reference's match of that rank (``rank_rms``), both on the
    scale of the product in · out, and its boosts (``boost_rms``,
    relative); and ``feat_norms.aif`` against the norms the reference
    works out again, exactly."""
    from portbench.reference import correlate as R

    cfg, mix, lim = ctx.config, ctx.mix, ctx.mix["limits"]
    rate, step = cfg["sample_rate"], cfg["extraction"]["step"]
    names = sorted(n for n in state.pcm if n != "query.aif")
    feats = state.feats
    norm = R.norms([feats[n] for n in sorted(feats)])
    stored = aiff.read(os.path.join(state.db, "feat_norms.aif"))[0]
    norm_err = float(np.abs(stored.astype(np.float64) - norm).max())
    files = [feats[n] for n in names]
    sims, ranks, boosts = [], [], []
    for i in _sample(ctx, done):
        pair = state.pairs[i % len(state.pairs)]
        a, b = int(pair[0]) * step, int(pair[1]) * step
        spans = [(a, a + int(mix["punch_in_s"] * rate)),
                 (b, b + int(mix["punch_out_s"] * rate))]
        args = (files, feats["query.aif"], norm, spans,
                int(mix["min_punch_s"] * rate), int(mix["max_punch_s"] * rate),
                step, mix["temp_weight"], mix["max_boost"],
                mix["num_matches"], ctx.device)
        score_at, ranked = R.search(*args)
        if ctx.variant == "control":
            _, ctl = R.search(*args, precision="tf32")
            got = [(names[f], t * step, o * step, s, bi, bo)
                   for s, f, t, o, bi, bo in ctl]
        else:
            got = outputs[i]
        if len(got) != len(ranked):
            sims.append(math.inf)
            continue
        for (name, start, stop, sim, b_in, b_out), want in zip(got, ranked):
            ref, ref_in, ref_out = (
                score_at(names.index(name), start // step, stop // step)
                if name in names else (-math.inf, math.nan, math.nan))
            sims.append(sim * sim - ref * ref)
            ranks.append(sim * sim - want[0] ** 2)
            boosts += [(b_in - ref_in) / ref_in, (b_out - ref_out) / ref_out]
    return [("norm_err", norm_err, lim["norm_err"]),
            ("sim_rms", _rms(sims), lim["sim_rms"]),
            ("rank_rms", _rms(ranks), lim["rank_rms"]),
            ("boost_rms", _rms(boosts), lim["boost_rms"])]


def _rms(errors) -> float:
    """Root mean square; inf for a non-finite error (a missing match)."""
    e = np.asarray(errors, np.float64)
    if not np.isfinite(e).all():
        return math.inf
    return float(np.sqrt(np.mean(e * e))) if e.size else 0.0
