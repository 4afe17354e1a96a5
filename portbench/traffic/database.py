"""Serving traffic against the port's resident ``FeatureDatabase``: one
client in a closed loop, each request a ``query`` or ``query_punch`` call up
to its host result arrays.

The database is the configuration's: ``files`` feature matrices of
``[channels, frames]`` float32, made on the device from the seed (uniform
inside per-channel norm rows drawn from the seed, so that staging and the
templates must normalise; the work depends on the shapes only) and handed
to the database as host arrays, as a serving process hands the arrays it
read.  Each
request's templates are cut from a file of a pool drawn from the seed
(distinct files, seeded positions; a punch-out template lies a seeded
punch length after its punch-in), so each has one decided answer: its own
file, at the cut, with a similarity of 1.

The check: every completed request's top hit is its own cut; a sample of
requests drawn from the seed is held, over every file, to the float64
reference (``reference/serve.py``): the served sims against the
reference's at the served windows, the reference's top-k against what was
served, and the boosts."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness

__all__ = ["setup", "unit", "facts", "release", "check", "close"]


def _norm(cfg: dict, seed: int) -> np.ndarray:
    """``[channels, 2]`` float32 (min, max) rows drawn from the seed."""
    spec = cfg["norm"]
    rng = np.random.default_rng([seed, 4])
    C = cfg["channels"]
    lo = rng.uniform(*spec["offset"], C)
    width = np.exp(rng.uniform(*np.log(spec["width"]), C))
    return np.stack([lo, lo + width], axis=1).astype(np.float32)


def _features(cfg: dict, norm: np.ndarray, seed: int,
              device: str) -> torch.Tensor:
    """``[files, channels, frames]`` float32 from the seed, uniform inside
    each channel's ``norm`` row, made on the device in a few large calls
    and copied to (pinned) host memory."""
    B, C, T = cfg["files"], cfg["channels"], cfg["frames"]
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed % (1 << 63))
    lo = torch.as_tensor(norm[:, :1], device=dev)
    width = torch.as_tensor(norm[:, 1:] - norm[:, :1], device=dev)
    host = torch.empty((B, C, T), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    step = 512
    for o in range(0, B, step):
        n = min(step, B - o)
        u = torch.rand((n, C, T), generator=g, device=dev)
        host[o:o + n].copy_(u.mul_(width).add_(lo))
    return host


def _pool(cfg: dict, mix: dict, seed: int) -> np.ndarray:
    """``[pool, 3]`` rows (file, punch-in frame, punch length past
    ``min_punch``): distinct files in seeded order."""
    rng = np.random.default_rng([seed, 2])
    T = cfg["frames"]
    n = min(mix["pool"], cfg["files"])
    files = rng.permutation(cfg["files"])[:n]
    if mix["call"] == "query_punch":
        span = mix["max_punch"] - mix["min_punch"] + 1
        last = T - mix["max_punch"] - mix["out_frames"]
        lens = rng.integers(0, span, n)
    else:
        last = T - mix["in_frames"]
        lens = np.zeros(n, np.int64)
    return np.stack([files, rng.integers(0, last + 1, n), lens], axis=1)


def setup(ctx):
    from strugatzki_tpu_torch.parallel.database import FeatureDatabase

    cfg, mix = ctx.config, ctx.mix
    norm = _norm(cfg, ctx.seed)
    feats = _features(cfg, norm, ctx.seed, ctx.device)
    kw = dict(cfg["database"])
    call_kw = {}
    if ctx.variant == "control":
        kw.update(cfg["control"]["database"])
        call_kw = dict(cfg["control"]["call"])
    arrays = feats.numpy()
    entries = [(f"f{i:05d}.aif", arrays[i]) for i in range(len(arrays))]
    db = FeatureDatabase(entries, norm, device=ctx.device,
                         mesh=_mesh(ctx), **kw)
    state = SimpleNamespace(ctx=ctx, feats=feats, arrays=arrays, norm=norm,
                            db=db, pool=_pool(cfg, mix, ctx.seed),
                            call_kw=call_kw)
    warm = [state.pool[-1 - w] for w in range(mix["warmup"])]
    for row in warm:
        _call(state, row)
    for d in harness.cards(ctx.devices):
        torch.cuda.synchronize(d)
    return state


def _mesh(ctx):
    """A files mesh over the cell's cards, one shard a card; None on one."""
    if len(ctx.devices) < 2:
        return None
    from strugatzki_tpu_torch.parallel.sweep import make_files_mesh
    return make_files_mesh(ctx.devices)


def _call(state, row):
    from strugatzki_tpu_torch.analysis.correlation import InputTemplate

    mix = state.ctx.mix
    f, a, j = (int(v) for v in row)
    x = state.arrays[f]
    t_in = InputTemplate.from_features(x, state.norm, a, a + mix["in_frames"])
    common = dict(max_boost=mix["max_boost"], k=mix["k"], **state.call_kw)
    if mix["call"] == "query_punch":
        o = a + mix["min_punch"] + j
        t_out = InputTemplate.from_features(x, state.norm, o,
                                            o + mix["out_frames"])
        return state.db.query_punch(
            t_in, t_out, mix["min_punch"], mix["max_punch"],
            temp_weight_in=mix["temp_weight"],
            temp_weight_out=mix["temp_weight"], **common)
    return state.db.query(t_in, temp_weight=mix["temp_weight"], **common)


def unit(state, i: int):
    return _call(state, state.pool[i % len(state.pool)])


def facts(state) -> dict:
    return {}


def release(state) -> None:
    state.db = None
    for d in harness.cards(state.ctx.devices):
        with torch.cuda.device(d):
            torch.cuda.empty_cache()


def close(state) -> None:
    state.feats = state.arrays = None


def _planted_missed(state, outputs) -> int:
    """Completed requests whose best hit is not their own cut."""
    punch = state.ctx.mix["call"] == "query_punch"
    missed = 0
    for i, res in enumerate(outputs):
        if res is None:
            continue
        f, a, j = (int(v) for v in state.pool[i % len(state.pool)])
        top = int(np.nanargmax(np.where(np.isfinite(res.sims[:, 0]),
                                        res.sims[:, 0], -np.inf)))
        ok = (top == f and int(res.frames[f, 0]) == a
              and res.sims[f, 0] > 0.999
              and (not punch or int(res.punch_lens[f, 0]) == j))
        missed += not ok
    return missed


def check(state, outputs, ctx):
    """``[(name, value, limit)]`` of the run's outputs.  The reference's
    blocks of files go round the cell's cards in turn, and each card keeps
    its own running maxima, read back once at the end: the cards work on
    their blocks at the same time."""
    from portbench.reference import serve as R

    cfg, mix = ctx.config, ctx.mix
    lim = mix["limits"]
    done = [i for i, r in enumerate(outputs) if r is not None]
    rng = np.random.default_rng([ctx.seed, 3])
    sample = sorted(rng.choice(done, min(mix["sample"], len(done)),
                               replace=False)) if done else []
    punch = mix["call"] == "query_punch"
    T, k = cfg["frames"], mix["k"]
    L_in, L_out = mix["in_frames"], mix["out_frames"]
    mp, xp = mix["min_punch"], mix["max_punch"]
    w, mb = mix["temp_weight"], mix["max_boost"]
    cards = {d: _Card(state, torch.device(d), sample, mix)
             for d in dict.fromkeys(ctx.devices)}
    block = mix["reference_block"]
    for n, b0 in enumerate(range(0, cfg["files"], block)):
        card = cards[ctx.devices[n % len(ctx.devices)]]
        dev, norm, tmpls = card.dev, card.norm, card.tmpls
        rows = slice(b0, min(b0 + block, cfg["files"]))
        # every upload first: each waits for the card's queue, and the
        # traces after them are queued without a wait.  The block goes up
        # from the page-locked features in float32 and widens on the card:
        # the same numbers, half the bytes and no host conversion
        x = state.feats[rows].to(dev).double()
        served = {i: _served(outputs[i], rows, dev, punch) for i in sample}
        spec = R.Spectra(R.normalise(x, norm))
        for i in sample:
            got = served[i]
            s_in, b_in = spec.trace(tmpls[i][0], w, mb)
            frames, sims = got["frames"], got["sims"]
            if punch:
                s_out, b_out = spec.trace(tmpls[i][1], w, mb)
                top = R.punch_topk(R.band_best(s_in, s_out, T, L_in, L_out,
                                               mp, xp), k)
                outs = frames + mp + got["punch_lens"]
                si = s_in.gather(1, frames)
                so = s_out.gather(1, outs.clamp(max=s_out.shape[1] - 1))
                ok = (si > 0) & (so > 0) & (outs < T - L_out + 1)
                at = torch.where(ok, torch.sqrt(torch.clamp_min(si * so, 0)),
                                 torch.full_like(si, -math.inf))
                boosts = [(got["boosts_in"], b_in.gather(1, frames)),
                          (got["boosts_out"], b_out.gather(
                              1, outs.clamp(max=b_out.shape[1] - 1)))]
                # on the scale of the product in · out: a square root near
                # 0 would magnify rounding without bound
                sims, at, top = (torch.where(torch.isfinite(v), v * v, v)
                                 for v in (sims, at, top))
            else:
                top = R.query_topk(s_in, T, L_in, k)
                at = s_in.gather(1, frames)
                boosts = [(got["boosts"], b_in.gather(1, frames))]
            card.keep(0, _max_abs(sims, at))
            if top.numel():
                card.keep(1, _max_gap(top, at))
            for b, ref in boosts:
                card.keep(2, ((b - ref).abs() / ref.abs()).amax())
        del spec, x, served
    sim_err, gap, boost_err = torch.stack(
        [c.maxima.cpu() for c in cards.values()]).amax(0).tolist()
    return [("planted_missed", float(_planted_missed(state, outputs)),
             lim["planted_missed"]),
            ("sim_err", sim_err, lim["sim_err"]),
            ("rank_gap", gap, lim["rank_gap"]),
            ("boost_err", boost_err, lim["boost_err"])]


class _Card:
    """One card's part of the check: the norm rows, each sampled
    request's templates, normalised and prepared there, and its running
    maxima of ``sim_err``, ``rank_gap`` and ``boost_err``."""

    def __init__(self, state, dev, sample, mix) -> None:
        from portbench.reference import serve as R

        self.dev = dev
        self.norm = torch.as_tensor(state.norm, dtype=torch.float64,
                                    device=dev)
        L_in, L_out = mix["in_frames"], mix["out_frames"]
        self.tmpls = {}
        for i in sample:
            f, a, j = (int(v) for v in state.pool[i % len(state.pool)])
            x = torch.as_tensor(state.arrays[f], dtype=torch.float64,
                                device=dev)
            x = R.normalise(x, self.norm)
            o = a + mix["min_punch"] + j
            out = R.Template(x[:, o:o + L_out]) \
                if mix["call"] == "query_punch" else None
            self.tmpls[i] = (R.Template(x[:, a:a + L_in]), out)
        self.maxima = torch.zeros(3, dtype=torch.float64, device=dev)

    def keep(self, slot: int, value: torch.Tensor) -> None:
        """The running maximum of ``slot``; a NaN reading leaves it as it
        was, as Python's ``max`` over the readings would."""
        self.maxima[slot] = torch.fmax(self.maxima[slot], value)


def _served(res, rows, dev, punch: bool) -> dict:
    """A request's served results for ``rows`` of files, on ``dev``."""
    f64 = dict(dtype=torch.float64, device=dev)
    got = {"frames": torch.as_tensor(res.frames[rows], device=dev).long(),
           "sims": torch.as_tensor(res.sims[rows], **f64)}
    if punch:
        got["punch_lens"] = torch.as_tensor(res.punch_lens[rows],
                                            device=dev).long()
        got["boosts_in"] = torch.as_tensor(res.boosts_in[rows], **f64)
        got["boosts_out"] = torch.as_tensor(res.boosts_out[rows], **f64)
    else:
        got["boosts"] = torch.as_tensor(res.boosts[rows], **f64)
    return got


def _max_abs(served, ref) -> torch.Tensor:
    """Largest |served − reference| where both are finite (0 where none
    is); inf where one is finite and the other not."""
    both = torch.isfinite(served) & torch.isfinite(ref)
    one = torch.isfinite(served) ^ torch.isfinite(ref)
    d = torch.where(both, (served - ref).abs(), torch.zeros_like(served))
    return torch.where(one.any(), torch.full_like(d[0, 0], math.inf),
                       d.amax())


def _max_gap(top, at) -> torch.Tensor:
    """Largest amount by which the served candidate of a rank lies below
    the reference's candidate of that rank (0 where both are −inf)."""
    d = torch.where(torch.isinf(top) & torch.isinf(at) & (top == at),
                    torch.zeros_like(top), top - at)
    return d.amax()
