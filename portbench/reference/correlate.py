"""Plain reference of ``--stats`` and of the ``-c`` search over a feature
folder, in float64.

``percentiles`` is Strugatzki's FeatureStats estimate (a skewed 2048-bin
histogram per channel, read at the 1st and 99th percentiles, float64 over
float32 samples with Java's float and integer semantics), written out
plainly; the database range is the element-wise min and max of the files'
(p01, p99).  ``search`` is the punch-in × punch-out search with one match
per file (``numPerFile`` 1, ``minSpacing`` 0, NaN candidates skipped): the
best ``√(in · out)`` of each file, the files ranked by it.  Imports nothing
of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import serve as S

__all__ = ["percentiles", "norms", "full_to_feat", "search"]


def full_to_feat(n: int, step: int) -> int:
    """Sample frame → feature frame, rounded to nearest (Java division)."""
    q = int(n) + (step >> 1)
    return q // step if q >= 0 else -((-q) // step)


def percentiles(data: np.ndarray):
    """``(p01, p99)`` per channel of one float32 feature matrix ``[C, T]``."""
    C, n = data.shape
    mins, maxs = data.min(axis=1), data.max(axis=1)
    d32 = (maxs - mins).astype(np.float32)
    # summed left to right in float64, as the reference adds each sample
    mean = data.astype(np.float64).cumsum(axis=1)[:, -1] / n
    p01, p99 = np.zeros(C), np.zeros(C)
    with np.errstate(divide="ignore", invalid="ignore"):
        skew = np.log(0.5) / np.log((mean - mins) / d32.astype(np.float64))
        for c in range(C):
            q = ((data[c] - mins[c]) / d32[c]).astype(np.float32)
            v = np.power(q.astype(np.float64), skew[c]) * 2047 + 0.5
            v = np.trunc(np.clip(np.nan_to_num(v, nan=0.0), -2.0**31,
                                 2.0**31 - 1)).astype(np.int64)
            counts = np.bincount(np.clip(v, 0, 2047), minlength=2048)
            cum = np.concatenate([[0], np.cumsum(counts)])
            # the reference walks bins while the running count is below
            # the target, ending one past the bin that reached it
            i01 = int(np.argmax(cum >= int(n * 0.01)))
            i99 = int(np.argmax(cum >= int(n * 0.99)))
            for out, i in ((p01, i01), (p99, i99)):
                out[c] = (np.power(i / 2048.0, 1.0 / skew[c]) * float(d32[c])
                          + float(mins[c]))
    return p01, p99


def norms(mats) -> np.ndarray:
    """The database range ``[C, 2]`` over feature matrices, float32 as
    ``feat_norms.aif`` stores it."""
    lo = hi = None
    for m in mats:
        p01, p99 = percentiles(m)
        lo = p01 if lo is None else np.minimum(lo, p01)
        hi = p99 if hi is None else np.maximum(hi, p99)
    return np.stack([lo, hi], axis=1).astype(np.float32)


def _template(query: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Feature frames ``[start, stop)`` of ``query``, zeros past its end."""
    out = np.zeros((query.shape[0], stop - start))
    avail = query[:, start:min(stop, query.shape[1])]
    out[:, :avail.shape[1]] = avail
    return out


def search(files, query, norm, spans, min_punch: int, max_punch: int,
           step: int, w: float, max_boost: float, num_matches: int, device,
           precision: str = "float64"):
    """The search's reference traces and its ranking.

    ``files``: float32 feature matrices ``[C, T_f]`` in the search's file
    order; ``query``: the query's ``[C, T]``; ``norm``: ``[C, 2]``;
    ``spans``: punch-in and punch-out ``(start, stop)`` in samples;
    ``min_punch``/``max_punch`` in samples.  Returns ``(score_at,
    ranked)``: ``score_at(f, t, o)`` gives the reference's ``(sim,
    boost_in, boost_out)`` of a candidate, and ``ranked`` the matches
    ``(sim, f, t, o, boost_in, boost_out)``, best first.

    The ranking follows the reference's order-dependent scan (see
    :func:`_file_best`).  ``precision`` ``"tf32"`` computes in float32
    with every operand of a product or sum rounded to TF32 (the
    control)."""
    from portbench.reference.frontend import _tf32

    dtype = torch.float64 if precision == "float64" else torch.float32
    operand = S.tf32 if precision == "tf32" else None
    dev = torch.device(device)
    nrm = torch.as_tensor(norm, dtype=dtype, device=dev)
    mp, xp = full_to_feat(min_punch, step), full_to_feat(max_punch, step)
    tmpls = []
    for a, b in spans:
        t = _template(query, full_to_feat(a, step), full_to_feat(b, step))
        tmpls.append(S.normalise(torch.as_tensor(t, dtype=dtype,
                                                 device=dev), nrm))
    L_in, L_out = tmpls[0].shape[-1], tmpls[1].shape[-1]
    traces, ranked = [], []
    with _tf32(False):
        for f, m in enumerate(files):
            x = S.normalise(torch.as_tensor(m, dtype=dtype, device=dev), nrm)
            (si, bi), (so, bo) = (S.direct_trace(x, t, w, max_boost,
                                                 operand=operand)
                                  for t in tmpls)
            T = m.shape[1]
            score = S.band_best(si[None], so[None], T, L_in, L_out, mp, xp,
                                zero=True)[0].double().cpu().numpy()
            tr = [v.double().cpu().numpy() for v in (si, bi, so, bo)]
            traces.append((*tr, T))
            w_in = max(T - mp - L_in + 1, 0)
            kept = _file_best(tr[0], score, w_in, ranked, num_matches,
                              T - mp - L_out)
            if kept is not None:
                t1 = kept
                band = tr[2][t1 + mp:min(t1 + xp + 1, T - L_out + 1)]
                o1 = t1 + mp + int(np.argmax(band))
                ranked.append((float(score[t1]), f, t1, o1, tr[1][t1],
                               tr[3][o1]))
                ranked.sort(key=lambda r: -r[0])
                del ranked[num_matches:]

    def score_at(f: int, t: int, o: int):
        si, bi, so, bo, T = traces[f]
        ok = (0 <= t < T - mp - L_in + 1 and t + mp <= o <= t + xp
              and o < T - L_out + 1 and si[t] > 0 and so[o] >= 0)
        sim = math.sqrt(si[t] * so[o]) if ok else -math.inf
        return sim, (bi[t] if 0 <= t < len(bi) else math.nan), \
            (bo[o] if 0 <= o < len(bo) else math.nan)

    return score_at, ranked


def _file_best(s_in, score, w_in: int, ranked, num_matches: int,
               out_room: int):
    """The punch-in window of the match one file adds to ``ranked`` (None
    for none), in the reference's scan (FeatureCorrelationImpl.scala:
    190-389, one match per file).

    ``low`` is the file's kept match, else the lowest kept match overall,
    else 0.  Once ``num_matches`` are kept, the file's windows before the
    first whose punch-in similarity alone beats ``low`` are not searched
    (:213).  A window is searched only while its punch-in similarity beats
    ``low²`` (:342); its best candidate (``score``) is kept when the file
    has room (no match of its own yet while fewer than ``num_matches`` are
    kept), or when it beats ``low``."""
    full = len(ranked) >= num_matches
    t = 0
    if full:
        above = np.nonzero(s_in[:w_in] > ranked[-1][0])[0]
        if not above.size:
            return None
        t = int(above[0])
    if out_room - t < 0:
        return None
    kept = None
    while t < w_in:
        low = score[kept] if kept is not None else (
            ranked[-1][0] if ranked else 0.0)
        gate = low * low
        if not s_in[t] > gate:
            nxt = np.nonzero(s_in[t:w_in] > gate)[0]
            if not nxt.size:
                break
            t += int(nxt[0])
        m = score[t]
        if m > -math.inf and ((kept is None and not full) or m > low):
            kept = t
        t += 1
    return kept
