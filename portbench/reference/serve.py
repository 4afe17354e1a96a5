"""Plain reference of the correlation search in float64: the sliding
similarity and boost of a template at every window of every file, the
per-file top-k of ``query``, and the punch-in × punch-out band search of
``query_punch`` and ``-c``.

Semantics (Strugatzki's FeatureCorrelation, as the repository's docs state
them): features are normalised per channel, ``(x − min) / (max − min)``;
the template and each window are split into a temporal group (row 0) and a
spectral group (the other rows); a group's similarity is the Pearson
correlation of its cells, ``Σ(a − ā)(b − b̄) / (σ_a σ_b n)`` with
population deviations; ``sim = w · sim_t + (1 − w) · sim_s``; the boost is
``exp((ln mean(a₀) − ln mean(b₀)) / 0.6)`` over row 0, and a window whose
boost is not ``≤ max_boost`` has ``sim = 0``.  A punch candidate at punch-in
window ``t`` takes the best punch-out window ``o`` in ``t + min_punch + [0,
max_punch − min_punch]`` that fits the file, scored ``√(in · out)``, and
only where ``in > 0`` and the product is positive.

Template products are computed by FFT (``Spectra``, for thousands of files)
or directly (``direct_trace``, whose float32 form with every operand of a
product or sum rounded by :func:`tf32` is the reference in the precision
below the program's).  Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["normalise", "Template", "Spectra", "direct_trace", "tf32",
           "query_topk", "band_best", "punch_topk"]


def normalise(x: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """``x [..., C, T]`` normalised by ``norm [C, 2]`` (min, max)."""
    lo, hi = norm[:, :1], norm[:, 1:]
    return (x - lo) / (hi - lo)


def _template(tmpl: torch.Tensor, nt: int):
    """Per group: (centred cells, population deviation, cell count)."""
    out = []
    for g in (tmpl[:nt], tmpl[nt:]):
        c = g - g.mean()
        out.append((c, math.sqrt(float((c * c).mean())), g.numel()))
    return out


class Template:
    """A template ``[C, L]`` with what every trace of it needs: each
    group's centred cells, deviation and cell count, and row 0's log mean.
    Worked out once, with its reads back from the device, so that tracing
    it against many blocks of files reads nothing back."""

    def __init__(self, tmpl: torch.Tensor, nt: int = 1) -> None:
        self.L = tmpl.shape[-1]
        self.groups = _template(tmpl, nt)
        self.ln_a = math.log(float(tmpl[0].mean()))


def _finish(dots, sums, t: Template, w, max_boost):
    """Traces from each group's template dots and window (sum, sum of
    squares), and row 0's window sums: ``(sims, boosts)``."""
    sims = 0.0
    for (c, sd_a, n), dot, (s, q), wg in zip(t.groups, dots, sums[:2],
                                              (w, 1.0 - w)):
        mu = s / n
        sd_b = torch.sqrt(torch.clamp_min(q / n - mu * mu, 0.0))
        sims = sims + wg * dot / (sd_a * sd_b * n)
    boosts = torch.exp((t.ln_a - torch.log(sums[2] / t.L)) / 0.6)
    sims = torch.where(boosts <= max_boost, sims, torch.zeros_like(sims))
    return sims, boosts


def _window_sums(x: torch.Tensor, L: int, nt: int):
    """Window (sum, sum of squares) of each group, and row 0's sums."""
    def win(rows):
        cs = torch.cumsum(F.pad(rows, (1, 0)), dim=-1)
        return cs[..., L:] - cs[..., :-L]
    t, s = x[..., :nt, :], x[..., nt:, :]
    return ((win(t.sum(-2)), win((t * t).sum(-2))),
            (win(s.sum(-2)), win((s * s).sum(-2))), win(x[..., 0, :]))


class Spectra:
    """Forward spectra and window sums of a block of normalised files
    ``x [B, C, T]``, shared by every template traced against it."""

    def __init__(self, x: torch.Tensor, nt: int = 1) -> None:
        self.x, self.nt, self.T = x, nt, x.shape[-1]
        self.N = 1 << (self.T - 1).bit_length()
        self.X = torch.fft.rfft(x, n=self.N, dim=-1)

    def trace(self, tmpl, w: float, max_boost: float):
        """``(sims, boosts)`` ``[B, T − L + 1]`` of ``tmpl``, a
        :class:`Template` or a tensor ``[C, L]``."""
        t = tmpl if isinstance(tmpl, Template) else Template(tmpl, self.nt)
        nt, W = self.nt, self.T - t.L + 1
        dots = []
        for (c, _, _), rows in zip(t.groups,
                                   (slice(0, nt), slice(nt, None))):
            A = torch.fft.rfft(c, n=self.N, dim=-1)
            prod = (self.X[:, rows] * A.conj()).sum(dim=-2)
            dots.append(torch.fft.irfft(prod, n=self.N, dim=-1)[..., :W])
        return _finish(dots, _window_sums(self.x, t.L, nt), t, w, max_boost)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as TF32 tensor cores read their operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def direct_trace(x: torch.Tensor, tmpl: torch.Tensor, w: float,
                 max_boost: float, nt: int = 1, operand=None):
    """:meth:`Spectra.trace` of one normalised file ``x [C, T]``, the
    template products taken as a convolution.  ``operand`` (e.g.
    :func:`tf32`) is applied to every operand of a product or a sum: the
    file's cells, the template's and the centred template's."""
    op = operand or (lambda t: t)
    x, t = op(x), Template(op(tmpl), nt)
    dots = [F.conv1d(x[None, rows], op(c)[None])[0, 0]
            for (c, _, _), rows in zip(t.groups,
                                       (slice(0, nt), slice(nt, None)))]
    return _finish(dots, _window_sums(x, t.L, nt), t, w, max_boost)


def _masked(v: torch.Tensor, valid: int) -> torch.Tensor:
    """``v [..., W]`` with windows at or past ``valid`` set to −inf."""
    idx = torch.arange(v.shape[-1], device=v.device)
    return torch.where(idx < valid, v, torch.full_like(v, -math.inf))


def query_topk(sims: torch.Tensor, length: int, L: int, k: int):
    """Sorted top-``k`` values of each file's valid windows."""
    return torch.topk(_masked(sims, length - L + 1), k, dim=-1).values


def band_best(s_in, s_out, length: int, L_in: int, L_out: int,
              min_punch: int, max_punch: int, zero: bool = False):
    """Per punch-in window ``t``: the punch score ``√(in · best out)``, −inf
    where there is no candidate: ``in > 0`` and the best out window above
    0 (at or above 0 with ``zero``, as the ``-c`` search takes a candidate
    of score 0).  ``s_in``/``s_out``: ``[B, W]`` traces of files of
    ``length`` frames."""
    span = max_punch - min_punch + 1
    w_in = s_in.shape[-1]
    out = _masked(s_out, length - L_out + 1)
    need = min_punch + w_in - 1 + span
    out = F.pad(out, (0, max(0, need - out.shape[-1])), value=-math.inf)
    best = F.max_pool1d(out[..., None, min_punch:need], span, stride=1)
    best = best[..., 0, :]
    s_in = _masked(s_in, length - min_punch - L_in + 1)
    ok = (s_in > 0) & ((best >= 0) if zero else (best > 0))
    return torch.where(ok, torch.sqrt(torch.clamp_min(s_in * best, 0.0)),
                       torch.full_like(s_in, -math.inf))


def punch_topk(score: torch.Tensor, k: int):
    """Sorted top-``k`` punch scores of each file."""
    return torch.topk(score, k, dim=-1).values
