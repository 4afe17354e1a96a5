"""Sliding-correlation kernels in PyTorch.

Port of ``strugatzki_tpu/kernels/corr.py``:

* **sliding template correlation** (FeatureCorrelation, CrossSimilarity):
  one rfft per channel serves the template dots and, through a ones-kernel
  spectrum, the sliding window sums and sums of squares.  On a card a
  group of templates over the same files (:func:`correlation_traces`) is
  one pipeline: ``trace_spectra_kernel`` (``csrc/trace.cu``) writes every
  row the inverse FFT needs, one ``torch.fft.irfft`` transforms them all,
  and ``trace_epilogue_kernel`` turns them into sims and boosts.  CPU
  tensors take the same pipeline with each kernel's plain version;
* **novelty curve** (FeatureSegmentation): ``correlateHalf`` at every window
  position from a lag product plus FFT window sums;
* **gram similarity** (SelfSimilarity): ``correlateHalf`` over window pairs
  from one matmul per channel group plus per-window sums.

Templates are pre-centered in f64 on the host and feature matrices
pre-shifted per channel group, which holds the template traces' parity
budget in f32 (see the JAX module's docstring for the algebra).  The two
``correlateHalf`` families compute their statistics in float64 instead:
their ``q/N − μ²`` has no template centering to rescue it (see
:func:`novelty_trace`).

Every device function takes ``[..., C, Tp]`` feature stacks (``[..., B, C,
h]`` window blocks for the gram): a leading batch dimension stands in for
``vmap``.  Template statistics and weights are host scalars (rounded to f32
like the JAX package's ``jnp.float32`` arguments); ``temporal_shift`` is a
scalar or a ``[...]`` tensor of per-file shifts.  A group whose blend weight
is zero is never evaluated (the JAX package computes it and selects 0 with
``where``: the same values).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check, ints, pointers, raise_on

__all__ = ["prepare_template", "shift_per_group", "sliding_dot_fft",
           "correlation_trace", "trace_spectra", "forward_spectra",
           "TraceTemplate", "template_spectrum", "TracePlan", "trace_plan",
           "trace_rows_reference", "trace_epilogue_reference",
           "trace_rows_cuda", "trace_epilogue_cuda",
           "correlation_traces_cuda", "correlation_traces",
           "pack_spectra", "unpack_spectra", "window_sum_table",
           "novelty_trace", "novelty_sums", "novelty_finish",
           "extract_windows", "window_stats", "gram_similarity_block"]

# Read the counters as ``corr.KERNEL_LAUNCHES``: a ``from`` import copies
# the int.
#: kernel launches of :func:`trace_rows_cuda` and
#: :func:`trace_epilogue_cuda`: two a trace group
KERNEL_LAUNCHES = 0
#: of them, launches of ``trace_spectra_kernel`` (:func:`trace_rows_cuda`)
SPECTRA_LAUNCHES = 0
#: and of ``trace_epilogue_kernel`` (:func:`trace_epilogue_cuda`)
EPILOGUE_LAUNCHES = 0
#: templates traced by the plain PyTorch version (:func:`_trace_finish`)
REFERENCE_CALLS = 0


# ---------------------------------------------------------------------------
# host-side preparation (float64, tiny) — copied verbatim from
# strugatzki_tpu/kernels/corr.py, whose module imports jax
# ---------------------------------------------------------------------------

def prepare_template(mat: np.ndarray):
    """Center a template channel-group in f64; return (centered f32, mean, std).

    ``mean``/``std`` come from the single parity anchor
    :func:`~strugatzki_tpu_torch.kernels.mathref.stat` (MathUtil.stat,
    FeatureCorrelationImpl.scala:92-97) so the device template statistics
    can never desynchronize from the host mirror the tests anchor to.
    """
    from ..kernels import mathref as M

    m64 = np.asarray(mat, dtype=np.float64)
    mean, std = M.stat(m64, 0, m64.shape[1], 0, m64.shape[0])
    centered = (m64 - mean).astype(np.float32)
    return centered, float(mean), float(std)


def shift_per_group(x: np.ndarray, num_temporal: int = 1):
    """Subtract the global f64 mean of each channel group (temporal = rows
    ``[0:num_temporal)``, spectral = the rest).  Returns (shifted f32,
    temporal_shift, spectral_shift).  Correlations are invariant to this; the
    temporal shift is returned so loudness window means can be recovered for
    the boost estimate."""
    x = np.asarray(x, dtype=np.float32)
    t64 = x[:num_temporal].astype(np.float64)
    s64 = x[num_temporal:].astype(np.float64)
    ts = float(t64.mean()) if t64.size else 0.0
    ss = float(s64.mean()) if s64.size else 0.0
    out = np.empty_like(x)
    out[:num_temporal] = (t64 - ts).astype(np.float32)
    out[num_temporal:] = (s64 - ss).astype(np.float32)
    return out, ts, ss


# ---------------------------------------------------------------------------
# device primitives
# ---------------------------------------------------------------------------

def _f32(v) -> float:
    """A host scalar rounded to float32 (the JAX package passes these as
    ``jnp.float32``); exactly representable, so torch casts it losslessly."""
    return float(np.float32(v))


def _fft_len(n: int) -> int:
    """Next power of two ≥ n (the JAX package's rule; cuFFT sizes on the
    H100 are not measured yet)."""
    p = 1
    while p < n:
        p <<= 1
    return p


@lru_cache(maxsize=64)
def _ones_spectrum(length: int, n: int, device: torch.device,
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """rfft of a length-``length`` ones kernel, built in f64 on the host and
    cast to ``dtype``: correlating with it yields sliding window sums."""
    return torch.as_tensor(np.fft.rfft(np.ones(length), n=n), dtype=dtype,
                           device=device)


def _blend(temp_weight: float, temporal, spectral):
    """``temporal()·w + spectral()·(1 − w)`` with ``1 − w`` rounded to f32;
    a group whose weight is zero is never evaluated, which keeps NaN/inf
    from an unused degenerate group out of the result."""
    w = _f32(temp_weight)
    sim_t = temporal() if w > 0.0 else 0.0
    sim_s = spectral() if w < 1.0 else 0.0
    return sim_t * w + sim_s * _f32(np.float32(1.0) - np.float32(w))


def sliding_dot_fft(template: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """FFT cross-correlation: ``Σ_c Σ_i template[c,i]·x[...,c,t+i]`` for all
    valid ``t`` → ``[..., T − L + 1]``."""
    L = template.shape[-1]
    T = x.shape[-1]
    W = T - L + 1
    if W <= 0:
        raise ValueError(f"template length {L} exceeds signal length {T}")
    N = _fft_len(T)
    ta = torch.fft.rfft(template, n=N, dim=-1)
    xa = torch.fft.rfft(x, n=N, dim=-1)
    spec = (torch.conj(ta) * xa).sum(dim=-2)
    return torch.fft.irfft(spec, n=N)[..., :W].to(torch.float32)


# ---------------------------------------------------------------------------
# sliding template correlation (FeatureCorrelation)
# ---------------------------------------------------------------------------

def correlation_trace(xs: torch.Tensor,
                      template_t: torch.Tensor, template_s: torch.Tensor,
                      a_std_t: float, a_std_s: float,
                      ln_avg_loud: float, temporal_shift,
                      temp_weight: float, max_boost: float,
                      num_temporal: int = 1):
    """Similarity + boost traces for a template slid over feature matrices.

    * ``xs``: ``[..., C, Tp]`` normalized, group-shifted features,
      zero-padded so ``Tp = W + L − 1`` for ``W`` window positions.
    * ``template_t``/``template_s``: pre-centered template groups
      ``[nt, L]`` / ``[C−nt, L]`` (:func:`prepare_template`).
    * boost(t) = ``exp((lnAvgLoud_template − ln(mean loud window))/0.6)``;
      windows whose boost is not ``≤ max_boost`` get sim = 0, NaN included.
    * a group with zero weight is skipped, keeping NaN/inf from an unused
      degenerate group out of the result.

    Returns ``(sim [..., W], boost [..., W])`` float32.
    """
    X, Xsq = trace_spectra(xs, num_temporal=num_temporal)
    return correlation_traces(
        X, Xsq, False, xs.shape[-1],
        [TraceTemplate(template_t, template_s, a_std_t, a_std_s, ln_avg_loud,
                       temp_weight)],
        temporal_shift, max_boost, num_temporal=num_temporal)[0]


def trace_spectra(xs: torch.Tensor, num_temporal: int = 1):
    """The per-file half of :func:`correlation_trace`: forward spectra of
    every channel (``[..., C, N/2+1]``) plus the two group power rows
    (``[..., 2, N/2+1]``)."""
    nt = num_temporal
    N = _fft_len(xs.shape[-1])
    xs = xs.to(torch.float32)
    X = torch.fft.rfft(xs, n=N, dim=-1)
    t, s = xs[..., :nt, :], xs[..., nt:, :]
    Xsq = torch.fft.rfft(
        torch.cat([(t * t).sum(dim=-2, keepdim=True),
                   (s * s).sum(dim=-2, keepdim=True)], dim=-2), n=N, dim=-1)
    return X, Xsq


# ---------------------------------------------------------------------------
# the compact spectra cache: reduced planar spectra + window-sum tables
# ---------------------------------------------------------------------------

def forward_spectra(xs: torch.Tensor) -> torch.Tensor:
    """Per-channel forward spectra only (``X`` of :func:`trace_spectra`,
    ``[..., C, N/2+1]``): the half the sums-based trace needs."""
    N = _fft_len(xs.shape[-1])
    return torch.fft.rfft(xs.to(torch.float32), n=N, dim=-1)


def pack_spectra(z: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """Complex spectra → planar ``(re, im)`` tensors of a real ``dtype``
    (round to nearest even, as XLA casts).  Bfloat16 halves a spectra
    cache and puts ~1e-3 of noise on the sims traced from it."""
    return z.real.to(dtype), z.imag.to(dtype)


def unpack_spectra(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_spectra`: any real dtype pair → complex64."""
    return torch.complex(re.to(torch.float32), im.to(torch.float32))


def window_sum_table(xs: torch.Tensor, num_temporal: int = 1) -> torch.Tensor:
    """Exclusive prefix sums of the window-statistic rows of ``[..., C,
    Tp]`` features: ``[..., R, Tp+1]`` float32 with rows ``[Σ_t x, Σ_t x²,
    Σ_s x, Σ_s x²]`` (plus an ``x[0]`` row when ``num_temporal != 1``: the
    boost averages channel 0 alone).  A length-``L`` window sum is then
    ``P[..., L:] − P[..., :W]``, no inverse FFT.

    The table stays float32 as in the JAX package, so the error of a window
    sum is absolute in the prefix magnitude: about ``eps32 · max|P|`` (the
    scan order of ``torch.cumsum`` and XLA's differ, the bound does not),
    which for a low-energy window near the end of a long row is far more
    than the ~1e-5 relative the JAX docstring claims.  Hold anything traced
    from it to a tolerance sized from ``max|P|``, not from the window."""
    nt = num_temporal
    xs = xs.to(torch.float32)
    t, s = xs[..., :nt, :], xs[..., nt:, :]
    rows = [t.sum(dim=-2), (t * t).sum(dim=-2),
            s.sum(dim=-2), (s * s).sum(dim=-2)]
    if nt != 1:
        rows.append(xs[..., 0, :])
    r = torch.stack(rows, dim=-2)
    zero = torch.zeros(r.shape[:-1] + (1,), dtype=torch.float32,
                       device=r.device)
    return torch.cat([zero, torch.cumsum(r, dim=-1, dtype=torch.float32)],
                     dim=-1)


def _trace_finish(s_t, q_t, s_s, q_s, mu0, dot_t, dot_s, L: int, C_s: int,
                  a_std_t, a_std_s, ln_avg_loud, temporal_shift, temp_weight,
                  max_boost, num_temporal: int = 1):
    """The elementwise end of a trace: window statistics, the blend of the
    template dots ``dot_t()``/``dot_s()`` (callables: a group the blend
    leaves out is never evaluated) and the boost gate → ``(sim [..., W],
    boost [..., W])`` float32."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    nt = num_temporal

    n_t = nt * L
    mu_t = s_t / n_t
    var_t = torch.clamp_min(q_t / n_t - mu_t * mu_t, 0.0)
    std_t = torch.sqrt(var_t)

    n_s = C_s * L
    mu_s = s_s / n_s
    var_s = torch.clamp_min(q_s / n_s - mu_s * mu_s, 0.0)
    std_s = torch.sqrt(var_s)

    sim = _blend(
        temp_weight,
        lambda: dot_t() / (std_t * _f32(a_std_t) * n_t),
        lambda: dot_s() / (std_s * _f32(a_std_s) * n_s))

    # loudness boost: window mean of (unshifted) channel 0 — NOT the whole
    # temporal group (FeatureCorrelationImpl.scala:73-78)
    if mu0 is None:
        mu0 = mu_t
    shift = torch.as_tensor(temporal_shift, dtype=torch.float32,
                            device=mu0.device)
    loud_mean = mu0 + shift[..., None]
    boost = torch.exp((_f32(ln_avg_loud) - torch.log(loud_mean)) / 0.6)
    # `<=` is false for a NaN boost: such windows are gated to 0
    sim = torch.where(boost <= _f32(max_boost), sim, 0.0)
    return sim.to(torch.float32), boost.to(torch.float32)


# ---------------------------------------------------------------------------
# trace groups: a files step's traces as one pipeline
# ---------------------------------------------------------------------------

class TraceTemplate(NamedTuple):
    """One template of a trace group: its centered groups ``temporal [nt,
    L]`` and ``spectral [C − nt, L]`` (:func:`prepare_template`), their
    host statistics, its blend weight, and its :func:`template_spectrum` at
    the group's FFT length, or ``None`` to have it computed per call."""
    temporal: torch.Tensor
    spectral: torch.Tensor
    std_t: float
    std_s: float
    ln_avg_loud: float
    temp_weight: float
    spectrum: Optional[torch.Tensor] = None


def template_spectrum(template_t: torch.Tensor, template_s: torch.Tensor,
                      n: int) -> torch.Tensor:
    """``conj(rfft)`` of a template's centered groups at FFT length ``n``,
    temporal rows first: ``[C, n/2+1]`` complex64, the spectra the template
    dots multiply the files' spectra by."""
    return torch.conj_physical(torch.cat(
        [torch.fft.rfft(template_t, n=n, dim=-1),
         torch.fft.rfft(template_s, n=n, dim=-1)]))


class TracePlan(NamedTuple):
    """The complex rows of a trace group, one block per file: for each
    distinct template length (the full spectra cache only) the window-sum
    rows ``Σ_t X·conj(1_L)``, ``Xsq_0·conj(1_L)``, ``Σ_s X·conj(1_L)``,
    ``Xsq_1·conj(1_L)`` (and ``X_0·conj(1_L)`` when ``num_temporal != 1``),
    then each template's dots ``Σ_t conj(ta)·X`` and ``Σ_s conj(ta)·X``, a
    dot only where the blend weighs its group."""
    t_padded: int
    n_fft: int
    rows: int         # R, complex rows a file
    ones: tuple       # the window-sum blocks' lengths; () on the sums path
    n_sum: int        # rows a window-sum block: 4, or 5 when nt != 1
    lengths: tuple    # each template's L
    bases: tuple      # each template's window-sum block's first row, or -1
    dots: tuple       # each template's (temporal, spectral) dot rows, or -1


@lru_cache(maxsize=256)
def trace_plan(t_padded: int, lengths: tuple, weights: tuple,
               use_sums: bool, num_temporal: int = 1) -> TracePlan:
    """The :class:`TracePlan` of templates of ``lengths`` and blend
    ``weights`` over files of padded width ``t_padded``; window sums from
    the rows, or with ``use_sums`` from a :func:`window_sum_table`."""
    for L in lengths:
        if t_padded - L + 1 <= 0:
            raise ValueError(f"template length {L} exceeds padded signal "
                             f"length {t_padded}")
    n_sum = 4 if num_temporal == 1 else 5
    ones = () if use_sums else tuple(dict.fromkeys(lengths))
    r = len(ones) * n_sum
    dots = []
    for w in weights:
        w = _f32(w)
        r_t = r if w > 0.0 else -1
        r += w > 0.0
        r_s = r if w < 1.0 else -1
        r += w < 1.0
        dots.append((r_t, r_s))
    bases = tuple(-1 if use_sums else ones.index(L) * n_sum
                  for L in lengths)
    return TracePlan(t_padded, _fft_len(t_padded), r, ones, n_sum,
                     tuple(lengths), bases, tuple(dots))


def _step_bytes(C: int, t_padded: int, lanes: int, compact: bool = False,
                num_temporal: int = 1) -> int:
    """Bytes of transients one file holds in a files step of ``lanes``
    traces (one a query template, two a punch pair) over files of ``C``
    channels and padded width ``t_padded``.

    The budget is ``2C + 8`` complex64 rows of ``N/2 + 1`` bins a file and
    lane — ``8·(N/2+1)·(2C + 8)`` bytes, 2.4 MB for a two-minute file (C =
    14, N = 16384): 36 rows a query file, 72 a punch file.  What a step
    holds a file, in such rows: the forward spectra (``C`` + 2, unless
    cached), and for its trace group the ``R`` rows of :func:`trace_plan`
    (6 a query, 12 a punch), torch's copy of them for the c2r and the real
    inverse-FFT output (about ``R`` rows' worth), so ~3R: 18 a query file
    and 36 a punch file, 34 and 52 with the spectra uncached; the ``[W]``
    traces and the band maximum's are under a row each.  2 GiB steps so
    take ~880 such files a query lane, ~440 a punch pair.  The compact
    cache (``compact``) adds, once a file, the unpacked complex64 ``X``
    (``C`` rows) and the float32 :func:`window_sum_table` (``[4 or 5,
    Tp+1]``): ~620 such files a query lane, ~370 a punch pair."""
    bins = _fft_len(t_padded) // 2 + 1
    per_file = 8 * bins * (2 * C + 8) * lanes
    if compact:
        rows = 4 if num_temporal == 1 else 5
        per_file += 8 * bins * C + 4 * (t_padded + 1) * rows
    return per_file


def trace_rows_reference(X: torch.Tensor, Xsq, spectra, plan: TracePlan,
                         num_temporal: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``trace_spectra_kernel``: the plan's
    complex rows ``[..., R, N/2+1]`` from the files' spectra ``X [..., C,
    N/2+1]``, their group power spectra ``Xsq [..., 2, N/2+1]`` (unused on
    the sums path) and each template's :func:`template_spectrum`: each
    window-sum row the product of a spectra row with ``conj`` of a ones
    kernel's spectrum, each dot the channel sum of products with the
    template's spectrum."""
    nt = num_temporal
    rows = []
    if plan.ones:
        s_t = X[..., :nt, :].sum(dim=-2)
        s_s = X[..., nt:, :].sum(dim=-2)
        for L in plan.ones:
            ones_l = torch.conj(_ones_spectrum(L, plan.n_fft, X.device))
            rows += [s_t * ones_l, Xsq[..., 0, :] * ones_l, s_s * ones_l,
                     Xsq[..., 1, :] * ones_l]
            if nt != 1:
                rows.append(X[..., 0, :] * ones_l)
    for spec, (r_t, r_s) in zip(spectra, plan.dots):
        if r_t >= 0:
            rows.append((spec[:nt] * X[..., :nt, :]).sum(dim=-2))
        if r_s >= 0:
            rows.append((spec[nt:] * X[..., nt:, :]).sum(dim=-2))
    return torch.stack(rows, dim=-2)


def trace_epilogue_reference(Y: torch.Tensor, sums, plan: TracePlan,
                             templates, temporal_shift, max_boost: float,
                             C: int, num_temporal: int = 1):
    """Plain PyTorch version of ``trace_epilogue_kernel``: each template's
    ``(sim, boost) [..., W]`` from the real rows ``Y = irfft(rows) [..., R,
    N]`` of :func:`trace_rows_reference` and, on the sums path, a
    :func:`window_sum_table` ``sums``, through :func:`_trace_finish`."""
    nt = num_temporal
    out = []
    for t, L, base, (r_t, r_s) in zip(templates, plan.lengths, plan.bases,
                                      plan.dots):
        W = plan.t_padded - L + 1
        if sums is not None:
            stats = [sums[..., r, L:L + W] - sums[..., r, :W]
                     for r in range(plan.n_sum)]
        else:
            stats = [Y[..., base + r, :W] for r in range(plan.n_sum)]
        mu0 = None if nt == 1 else stats[4] / L
        # _trace_finish calls the dots before the loop moves on
        out.append(_trace_finish(
            *stats[:4], mu0, lambda: Y[..., r_t, :W],
            lambda: Y[..., r_s, :W], L, C - nt, t.std_t, t.std_s,
            t.ln_avg_loud, temporal_shift, t.temp_weight, max_boost,
            num_temporal=nt))
    return out


@lru_cache(maxsize=1)
def _trace_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("trace")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.trace_spectra_launch.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.trace_spectra_launch.restype = i
    lib.trace_epilogue_launch.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.trace_epilogue_launch.restype = i
    lib.trace_error_string.argtypes = [i]
    lib.trace_error_string.restype = ctypes.c_char_p
    return lib


#: templates a trace group, and distinct template lengths, that the kernels
#: of ``csrc/trace.cu`` take at most (``kMaxTemplates`` there): a query's
#: one, a punch's pair
TRACE_MAX_TEMPLATES = 2


def trace_rows_cuda(X: torch.Tensor, Xsq, spectra, plan: TracePlan,
                    num_temporal: int = 1) -> torch.Tensor:
    """Launch ``trace_spectra_kernel`` (``csrc/trace.cu``) on ``X``'s
    device and current stream: :func:`trace_rows_reference` of contiguous
    CUDA tensors ``X [B, C, F]``, ``Xsq [B, 2, F]`` (``None`` on the sums
    path) and ``[C, F]`` spectra → ``[B, R, F]`` complex64."""
    global KERNEL_LAUNCHES, SPECTRA_LAUNCHES
    dev = X.device
    B, C, F = X.shape
    check(X, "X", torch.complex64, dev, (B, C, plan.n_fft // 2 + 1))
    if plan.ones:
        check(Xsq, "Xsq", torch.complex64, dev, (B, 2, F))
    for s in spectra:
        check(s, "template spectrum", torch.complex64, dev, (C, F))
    if (not 1 <= len(spectra) <= TRACE_MAX_TEMPLATES
            or not 0 < num_temporal < C or B > 65535):
        raise ValueError(f"unsupported trace group: {len(spectra)} "
                         f"templates, {B} files, C {C}, num_temporal "
                         f"{num_temporal}")
    rows = torch.empty((B, plan.rows, F), dtype=torch.complex64, device=dev)
    if B == 0:
        return rows
    ones = [_ones_spectrum(L, plan.n_fft, dev) for L in plan.ones]
    lib = _trace_lib()
    err = lib.trace_spectra_launch(
        X.data_ptr(), Xsq.data_ptr() if plan.ones else None,
        pointers(o.data_ptr() for o in ones),
        pointers(s.data_ptr() for s in spectra), rows.data_ptr(),
        _spectra_dots(plan), B, C, F, num_temporal,
        plan.rows, len(spectra), len(ones), plan.n_sum, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.trace_error_string, "trace_spectra_kernel launch",
             plan)
    KERNEL_LAUNCHES += 1
    SPECTRA_LAUNCHES += 1
    return rows


def trace_epilogue_cuda(Y: torch.Tensor, sums, plan: TracePlan, templates,
                        shifts: torch.Tensor, max_boost: float, C: int,
                        num_temporal: int = 1):
    """Launch ``trace_epilogue_kernel`` (``csrc/trace.cu``) on ``Y``'s
    device and current stream: :func:`trace_epilogue_reference` of the
    scaled rows ``Y / N``, from contiguous CUDA tensors ``Y [B, R, N]``
    (the unscaled inverse FFT, ``norm="forward"``: the kernel scales what
    it reads by the exact ``1/N``), ``sums [B, 4|5, Tp+1]`` (or ``None``)
    and ``shifts [B]`` → ``[(sim, boost) [B, W]]`` float32."""
    global KERNEL_LAUNCHES, EPILOGUE_LAUNCHES
    dev = Y.device
    B, nt, Tp1 = Y.shape[0], num_temporal, plan.t_padded + 1
    check(Y, "Y", torch.float32, dev, (B, plan.rows, plan.n_fft))
    if sums is not None:
        check(sums, "sums", torch.float32, dev, (B, plan.n_sum, Tp1))
    check(shifts, "shifts", torch.float32, dev, (B,))
    if len(templates) != len(plan.lengths) or B > 65535:
        raise ValueError(f"unsupported trace group: {len(templates)} "
                         f"templates for {plan}, {B} files")
    outs = [tuple(torch.empty((B, plan.t_padded - L + 1),
                              dtype=torch.float32, device=dev)
                  for _ in range(2)) for L in plan.lengths]
    if B == 0:
        return outs
    lib = _trace_lib()
    err = lib.trace_epilogue_launch(
        Y.data_ptr(), sums.data_ptr() if sums is not None else None,
        shifts.data_ptr(),
        pointers(o.data_ptr() for pair in outs for o in pair),
        _epilogue_ints(plan),
        _epilogue_scalars(plan, tuple((t.std_t, t.std_s, t.ln_avg_loud,
                                       t.temp_weight) for t in templates),
                          max_boost, C, nt),
        B, plan.rows, plan.n_fft, plan.n_sum, Tp1, nt, len(templates),
        plan.t_padded - min(plan.lengths) + 1, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.trace_error_string, "trace_epilogue_kernel launch",
             plan)
    KERNEL_LAUNCHES += 1
    EPILOGUE_LAUNCHES += 1
    return outs


def correlation_traces_cuda(X: torch.Tensor, aux: torch.Tensor,
                            use_sums: bool, t_padded: int, templates,
                            temporal_shift, max_boost: float,
                            num_temporal: int = 1):
    """:func:`correlation_traces` of CUDA tensors, on ``X``'s device and
    current stream: :func:`trace_rows_cuda`, one unscaled
    ``torch.fft.irfft`` and :func:`trace_epilogue_cuda`.  A CPU tensor
    raises ``ValueError``."""
    if X.device.type != "cuda":
        raise ValueError(f"X on {X.device}: the kernels take CUDA tensors")
    return correlation_traces(X, aux, use_sums, t_padded, templates,
                              temporal_shift, max_boost, num_temporal)


@lru_cache(maxsize=256)
def _spectra_dots(plan: TracePlan) -> ctypes.Array:
    """``trace_spectra_kernel``'s dot rows, two a template."""
    return ints(r for d in plan.dots for r in d)


@lru_cache(maxsize=256)
def _epilogue_ints(plan: TracePlan) -> ctypes.Array:
    """``trace_epilogue_kernel``'s rows of each template: ``L``, ``W``, its
    window-sum block, its two dots."""
    return ints(v for L, base, (r_t, r_s) in zip(plan.lengths, plan.bases,
                                                plan.dots)
                for v in (L, plan.t_padded - L + 1, base, r_t, r_s))


@lru_cache(maxsize=256)
def _epilogue_scalars(plan: TracePlan, stats: tuple, max_boost: float,
                      C: int, num_temporal: int) -> ctypes.Array:
    """Each template's float32 scalars of :func:`_trace_finish` (``stats``:
    its ``(std_t, std_s, ln_avg_loud, temp_weight)``), rounded as the eager
    ops round them on a card: a division by a host scalar is a product
    with its float32 reciprocal."""
    one = np.float32(1.0)
    consts = []
    for (std_t, std_s, ln_avg, w), L in zip(stats, plan.lengths):
        n_t = np.float32(num_temporal * L)
        n_s = np.float32((C - num_temporal) * L)
        w = np.float32(w)
        consts += [one / n_t, one / n_s, one / np.float32(L), n_t, n_s,
                   std_t, std_s, w, one - w, ln_avg, max_boost,
                   one / np.float32(0.6)]
    return (ctypes.c_float * len(consts))(*(_f32(c) for c in consts))


def correlation_traces(X: torch.Tensor, aux: torch.Tensor, use_sums: bool,
                       t_padded: int, templates, temporal_shift,
                       max_boost: float, num_temporal: int = 1):
    """The traces of a group of templates over the same files →
    ``[(sim [..., W], boost [..., W])]``, one pair a :class:`TraceTemplate`.

    ``X [..., C, N/2+1]`` are the files' forward spectra; ``aux`` their
    group power spectra ``Xsq`` (:func:`trace_spectra`), or with
    ``use_sums`` a :func:`window_sum_table`.  One pipeline a group: the
    rows of :func:`trace_plan`, one ``torch.fft.irfft`` over all of them,
    and the epilogue.  CUDA tensors take the kernels,
    :func:`trace_rows_cuda` and :func:`trace_epilogue_cuda`, around an
    unscaled inverse FFT: no pass of its own multiplies its output by
    ``1/N``, the epilogue scales each value it reads (exactly: ``N`` is a
    power of two).  A build or launch failure raises; nothing is retried.
    CPU tensors take each kernel's plain version,
    :func:`trace_rows_reference` and :func:`trace_epilogue_reference`,
    around the scaled inverse FFT."""
    dev = X.device
    nt = num_temporal
    plan = trace_plan(t_padded, tuple(t.temporal.shape[-1]
                                      for t in templates),
                      tuple(t.temp_weight for t in templates), use_sums, nt)
    lead, C = X.shape[:-2], X.shape[-2]
    B = math.prod(lead)
    X = X.reshape(B, C, X.shape[-1]).contiguous()
    aux = aux.reshape((B,) + aux.shape[-2:]).contiguous()
    shifts = torch.as_tensor(temporal_shift, dtype=torch.float32,
                             device=dev).expand(lead).reshape(B).contiguous()
    spectra = [t.spectrum if t.spectrum is not None
               else template_spectrum(t.temporal, t.spectral, plan.n_fft)
               for t in templates]
    xsq, sums = (None, aux) if use_sums else (aux, None)
    if dev.type == "cuda":
        rows = trace_rows_cuda(X, xsq, spectra, plan, nt)
        Y = torch.fft.irfft(rows, n=plan.n_fft, norm="forward")
        del rows
        outs = trace_epilogue_cuda(Y, sums, plan, templates, shifts,
                                   max_boost, C, nt)
    else:
        Y = torch.fft.irfft(trace_rows_reference(X, xsq, spectra, plan, nt),
                            n=plan.n_fft)
        outs = trace_epilogue_reference(Y, sums, plan, templates, shifts,
                                        max_boost, C, nt)
    return [(s.reshape(lead + s.shape[-1:]), b.reshape(lead + b.shape[-1:]))
            for s, b in outs]


# ---------------------------------------------------------------------------
# novelty curve (FeatureSegmentation)
# ---------------------------------------------------------------------------

def novelty_trace(xs: torch.Tensor, half_win: int, temp_weight: float,
                  num_temporal: int = 1) -> torch.Tensor:
    """``correlateHalf`` at every window position, per group, blended.

    ``xs``: ``[..., C, Tp]`` with ``Tp = W + 2·half_win − 1`` for ``W``
    positions.  Returns float32 ``sim [..., W]``.  For the window at ``t``
    (length ``2h``) the statistics run over the whole window and the
    numerator reduces to ``P(t) − h·C·μ(t)²``, ``P`` the lag-``h`` product
    sum (FeatureSegmentationImpl.scala:107-133, MathUtil.scala:82).

    The JAX package's formulation, computed in float64 whatever dtype comes
    in: both ``P − h·C·μ²`` and ``q/N − μ²`` cancel when a window's
    variance is small against its squared mean, and the FFT window sums
    carry round-off in proportion to the whole row, not to the window.  In
    f32 that costs up to 3e-4 against the f64 mirror on a 5-minute
    recording of steady sections (PERF.md, Findings).

    Even in float64, a window whose variance is tiny against the row's
    energy — a group held (nearly) constant, as the rows are through a
    digital silence — gets noise that differs between FFT libraries where
    the mirror has a value: NaN (0/0) where the variance is exactly zero,
    as for the loudness row through a silence longer than the window.  A
    window whose group is one constant (found exactly, from its range) is
    NaN, as in the mirror; the padding past a file's end is such a window.
    Every other such window (``var·2h·c`` below :data:`_EXACT_BELOW` of the
    row's energy) is recomputed from its cells with the mirror's two
    passes.  The JAX package leaves the round-off (PERF.md, Findings).

    The two steps are :func:`novelty_sums`, which only launches work, and
    :func:`novelty_finish`, which finds the windows to recompute and so
    synchronizes the device once per channel group; a sharded caller
    launches every shard's sums before it finishes the first.
    """
    return novelty_finish(novelty_sums(xs, half_win, temp_weight,
                                       num_temporal=num_temporal))


def novelty_sums(xs: torch.Tensor, half_win: int, temp_weight: float,
                 num_temporal: int = 1):
    """The FFT step of :func:`novelty_trace`, launched without a
    synchronization: for each channel group that the blend uses, its f64
    rows, its curve from the window sums (NaN where the window is one
    constant) and a weight that is nonzero at the windows to recompute.
    Hand the result to :func:`novelty_finish`."""
    h = half_win
    nt = num_temporal
    xs = xs.to(torch.float64)
    Tp = xs.shape[-1]
    W = Tp - 2 * h + 1
    N = _fft_len(Tp)
    ones_h = torch.conj(_ones_spectrum(h, N, xs.device, torch.complex128))
    ones_2h = torch.conj(_ones_spectrum(2 * h, N, xs.device,
                                        torch.complex128))

    def wsum(row, ones):
        return torch.fft.irfft(torch.fft.rfft(row, n=N) * ones, n=N)[..., :W]

    def group(rows: torch.Tensor) -> torch.Tensor:
        c = rows.shape[-2]
        # lag product y[i] = Σ_c x[c, i]·x[c, i+h]
        p = wsum((rows[..., :-h] * rows[..., h:]).sum(dim=-2), ones_h)
        sq = (rows * rows).sum(dim=-2)
        s = wsum(rows.sum(dim=-2), ones_2h)
        q = wsum(sq, ones_2h)
        n2 = 2 * h * c
        mu = s / n2
        # the reference's two-pass variance is non-negative by construction;
        # q/N − μ² can round negative
        var = torch.clamp_min(q / n2 - mu * mu, 0.0)
        n_half = h * c
        sim = (p - n_half * mu * mu) / (var * n_half)
        # written with arithmetic only: comparison, logic and selection
        # kernels would each load on their first call in a process
        rng = _window_range(rows, 2 * h)
        # rng/rng is 1, or NaN where the window is one constant; bad is
        # positive where the window is ill-conditioned but not constant
        bad = torch.clamp_min(_EXACT_BELOW * sq.sum(dim=-1, keepdim=True)
                              - var * n2, 0.0) * rng
        return rows, sim * (rng / rng), bad

    # the groups _blend evaluates, and no other
    w = _f32(temp_weight)
    return (temp_weight, h,
            group(xs[..., :nt, :]) if w > 0.0 else None,
            group(xs[..., nt:, :]) if w < 1.0 else None)


def novelty_finish(sums) -> torch.Tensor:
    """:func:`novelty_trace` from the result of :func:`novelty_sums`: the
    ill-conditioned windows recomputed, the groups blended → float32
    ``sim [..., W]``."""
    temp_weight, h, temporal, spectral = sums
    return _blend(temp_weight, lambda: _exact_windows(*temporal, h),
                  lambda: _exact_windows(*spectral, h)).to(torch.float32)


#: a novelty window whose FFT variance sum ``var·2h·c`` is below this share
#: of its row's energy is recomputed from its cells: the FFT sums' f64
#: round-off (a few ulp of the row's energy, times log N) is then at most
#: ~1e-6 of the window's variance, well inside the 2e-5 budget, and every
#: other window keeps the FFT value
_EXACT_BELOW = 1e-8
#: windows recomputed at a time (a chunk of 13-row, 172-frame f64 windows
#: is ~73 MB)
_EXACT_CHUNK = 4096


def _window_range(rows: torch.Tensor, win: int) -> torch.Tensor:
    """``[..., W]``: max − min over every cell of the length-``win`` window
    at each start, over all ``c`` rows of ``rows`` (``[..., c, Tp]``); zero
    exactly where the window holds one value.  The mirror's mean of such a
    window is that value exactly (its cells are f32 values, so their sum is
    exact), so it gives 0/0 there."""
    c, Tp = rows.shape[-2], rows.shape[-1]
    cells = rows.reshape(-1, 1, c, Tp)
    hi = F.max_pool2d(cells, (c, win), stride=1)
    neg_lo = F.max_pool2d(cells * -1.0, (c, win), stride=1)
    return (hi + neg_lo).reshape(*rows.shape[:-2], -1)


def _exact_windows(rows: torch.Tensor, sim: torch.Tensor, bad: torch.Tensor,
                   h: int) -> torch.Tensor:
    """``sim`` with the windows where ``bad`` is nonzero recomputed from
    ``rows`` (``[..., c, Tp]`` f64) with the mirror's two passes
    (``mathref.correlate_half``): the mean, the variance of the deviations,
    then the lag product of the deviations; 0/0 gives NaN."""
    # the one synchronization; most curves have nothing to recompute
    if float(bad.sum()) == 0.0:
        return sim
    idx = torch.nonzero(bad.reshape(-1, bad.shape[-1]))
    c, Tp = rows.shape[-2], rows.shape[-1]
    flat = rows.reshape(-1, c, Tp)
    out = sim.reshape(-1, sim.shape[-1]).clone()
    lag = torch.arange(2 * h, device=rows.device)
    chan = torch.arange(c, device=rows.device)[None, :, None]
    for o in range(0, idx.shape[0], _EXACT_CHUNK):
        b, t = idx[o:o + _EXACT_CHUNK].unbind(dim=1)
        w = flat[b[:, None, None], chan, (t[:, None] + lag)[:, None, :]]
        d = w - w.mean(dim=(-2, -1), keepdim=True)
        var = (d * d).mean(dim=(-2, -1))
        num = (d[..., :h] * d[..., h:]).sum(dim=(-2, -1))
        out[b, t] = num / (var * (h * c))
    return out.reshape(sim.shape)


# ---------------------------------------------------------------------------
# gram similarity (SelfSimilarity)
# ---------------------------------------------------------------------------

def extract_windows(xs: torch.Tensor, starts: torch.Tensor,
                    half_win: int) -> torch.Tensor:
    """Gather windows ``xs[:, s:s+half_win]`` for each start → contiguous
    ``[B, C, h]``."""
    idx = starts[:, None] + torch.arange(half_win, device=starts.device)
    return xs[:, idx].permute(1, 0, 2).contiguous()


def window_stats(win: torch.Tensor, num_temporal: int = 1):
    """Per-window per-group sums and sums of squares: ``[..., B, C, h]`` →
    ``(s_t, q_t, s_s, q_s)`` each ``[..., B]``, in float64 (see
    :func:`gram_similarity_block`)."""
    nt = num_temporal
    win = win.to(torch.float64)
    t, s = win[..., :nt, :], win[..., nt:, :]
    return (t.sum(dim=(-2, -1)), (t * t).sum(dim=(-2, -1)),
            s.sum(dim=(-2, -1)), (s * s).sum(dim=(-2, -1)))


def gram_similarity_block(win_i: torch.Tensor, win_j: torch.Tensor,
                          stats_i, stats_j, temp_weight: float,
                          num_temporal: int = 1) -> torch.Tensor:
    """Blended ``correlateHalf`` for blocks of window pairs: cell ``(i, j)``
    correlates window ``i`` (first half) against window ``j`` (second half)
    with joint statistics over both (SelfSimilarityImpl.scala:127-165).

    ``win_*``: ``[..., B, C, h]``; ``stats_*`` from :func:`window_stats`.
    The pair dot is one matmul per group over ``[..., B, c·h]`` rows.
    Returns float32 ``sim [..., Bi, Bj]``.

    The JAX package's formulation at float64 (a DGEMM; FP64 runs on the
    H100's tensor cores at the rate of FP32 without them):
    ``D − N·μ²`` and ``q/N − μ²`` cancel for a window pair whose variance
    is small against its squared mean, which in f32 costs up to 3e-4 on a
    3-minute piece (PERF.md, Findings).

    A pair whose group is one constant over both windows (two windows
    inside a digital silence) has zero variance: NaN in the f64 mirror, as
    in :func:`novelty_trace`.  Whether the sums give 0/0 there depends on
    their rounding, so such pairs are found exactly, from each window's
    range and value, and written as NaN."""
    nt = num_temporal
    h = win_i.shape[-1]

    def group(a, b, sa, qa, sb, qb):
        c = a.shape[-2]
        n_h = c * h
        lo_a, lo_b = a.amin(dim=(-2, -1)), b.amin(dim=(-2, -1))
        flat = ((lo_a == a.amax(dim=(-2, -1)))[..., :, None]
                & (lo_b == b.amax(dim=(-2, -1)))[..., None, :]
                & (lo_a[..., :, None] == lo_b[..., None, :]))
        a = a.to(torch.float64).reshape(*a.shape[:-2], n_h)
        b = b.to(torch.float64).reshape(*b.shape[:-2], n_h)
        d = torch.matmul(a, b.transpose(-1, -2))
        mu = (sa[..., :, None] + sb[..., None, :]) / (2 * n_h)
        var = torch.clamp_min(
            (qa[..., :, None] + qb[..., None, :]) / (2 * n_h) - mu * mu, 0.0)
        return torch.where(flat, math.nan, (d - n_h * mu * mu) / (var * n_h))

    s_ti, q_ti, s_si, q_si = stats_i
    s_tj, q_tj, s_sj, q_sj = stats_j
    return _blend(
        temp_weight,
        lambda: group(win_i[..., :nt, :], win_j[..., :nt, :],
                      s_ti, q_ti, s_tj, q_tj),
        lambda: group(win_i[..., nt:, :], win_j[..., nt:, :],
                      s_si, q_si, s_sj, q_sj)).to(torch.float32)
