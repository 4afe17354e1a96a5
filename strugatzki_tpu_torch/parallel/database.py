"""Device-resident feature database for correlation serving, in PyTorch.

Port of ``strugatzki_tpu/parallel/database.py`` for one device (a CUDA card
or the CPU).  The database is loaded once — normalized and group-shifted by
the prep kernel (``kernels/prep.py``, hand-written CUDA on a card), padded,
and kept resident as one ``[B, C, T]`` float32 tensor — and each query runs
batched FFT correlation traces over the files axis (cuFFT), a masked
tie-stable top-k per file, and, on request, an exact re-rank of the
candidates.

Capacity modes, as in the JAX package:

* ``cache_spectra=True`` keeps every file's forward spectra resident
  (complex64, ``X`` and the group-power ``Xsq``), so a query pays only its
  inverse FFTs;
* ``cache_spectra="bf16"`` (any real floating dtype) is the compact cache:
  only ``X``, as planar ``(re, im)`` tensors of that dtype, less than half
  the complex64 cache; window statistics come from float32 window-sum tables
  computed per query step from the resident features, so a trace pays 2
  inverse FFTs instead of 6;
* ``storage_dtype=torch.bfloat16`` keeps the prepared features in bfloat16
  (half the memory); traces upcast them to float32;
* ``raw_store="memmap"`` keeps the host's copy of the raw stack (for the
  exact host re-rank, incremental updates and ``save``) in an unlinked temp
  file instead of memory, streamed from ``entries`` (a one-shot generator
  when ``time_capacity`` is given).

Reduced-precision data (bf16 features or the compact cache) turns on the
exact re-rank by default, with the device top-k inflated 4×.

Serving-path divergence (as in the JAX package): files shorter than the
template (or, for :meth:`FeatureDatabase.query_punch`, shorter than
``min_punch`` + the punch-in template) have no valid window and are left out
of the results; ``FeatureCorrelation`` replays the reference's zero-tailed
single window for them.

Not ported yet, and refused with ``NotImplementedError``: a ``mesh``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np
import torch

from strugatzki_tpu.analysis.common import feat_to_full
from strugatzki_tpu.config import ExtractionConfig, Match
from strugatzki_tpu.span import Span

from ..kernels import corr as K
from ..kernels.prep import prepare_database
from ..runtime.device import resolve
from .sweep import pad_stack

if TYPE_CHECKING:
    from ..analysis.correlation import InputTemplate

__all__ = ["FeatureDatabase", "QueryResult", "PunchQueryResult"]

#: Files per query range; above it the files axis is padded to a multiple
#: (the JAX package's dispatch unit, kept so both packages pad alike and
#: :meth:`FeatureDatabase.add_files` reuses the same slots).  Staging also
#: uploads and prepares one range at a time.
_QUERY_CHUNK = 2048

#: Files per spectra-cache staging step: bounds the forward-FFT transient
#: while the resident cache fills.
_SPECTRA_CHUNK = 1024

#: Bytes of FFT transients one files step of a query may hold.  Per file and
#: trace lane a step holds, in complex64 rows of ``N/2 + 1`` bins: the
#: forward spectra (``C`` + 2 rows, unless cached), the template product of
#: the wider channel group (≤ ``C`` rows) and ~6 rows' worth of real
#: inverse-FFT outputs and epilogue temporaries — ≈ ``8·(N/2+1)·(2C + 8)``
#: bytes, 2.4 MB for a two-minute file (C = 14, N = 16384).  2 GiB steps so
#: take ~880 such files per query lane, ~440 per punch pair.  A compact-cache
#: step also holds, once per file, the unpacked complex64 ``X`` (``C`` rows)
#: and the float32 window-sum table (``[4 or 5, Tp+1]``): ~620 such files
#: per query lane, ~370 per punch pair.
_STEP_BYTES = 2 << 30


def _files_step(C: int, t_padded: int, lanes: int, compact: bool = False,
                num_temporal: int = 1) -> int:
    """Files per query step under :data:`_STEP_BYTES` (see there)."""
    bins = K._fft_len(t_padded) // 2 + 1
    per_file = 8 * bins * (2 * C + 8) * lanes
    if compact:
        rows = 4 if num_temporal == 1 else 5
        per_file += 8 * bins * C + 4 * (t_padded + 1) * rows
    return max(1, _STEP_BYTES // per_file)


def _sync(device: torch.device) -> None:
    """Wait for the device, so an asynchronous CUDA failure surfaces here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(t: torch.Tensor) -> np.ndarray:
    """Device result → host array (indices as int32, the JAX package's)."""
    if t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t.cpu().numpy()


def _reject_unported(mesh=None) -> None:
    """Raise for the one mode of the JAX package the port does not have
    yet; it is never accepted and ignored."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: a files-sharded database is not ported yet")


def _real_dtype(spec, what: str) -> torch.dtype:
    """A real floating torch dtype from a dtype or its name (``"bf16"``,
    ``"bfloat16"``, ``"float16"``, ``torch.bfloat16``, ``np.float32``, …).
    A complex, integer or unknown one raises ``ValueError``: a complex
    "compact" cache would be read as a full one and give garbage sims."""
    if isinstance(spec, torch.dtype):
        dt = spec
    else:
        name = (getattr(spec, "__name__", None) or str(spec)).replace(
            "torch.", "")
        dt = getattr(torch, {"bf16": "bfloat16"}.get(name, name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"{what}={spec!r}: not a real floating dtype")
    return dt


def _spectra_pack(cache_spectra) -> Optional[torch.dtype]:
    """``cache_spectra`` → the compact cache's planar dtype, or None for
    the complex64 cache (True) and for no cache (False or None)."""
    if cache_spectra is None or isinstance(cache_spectra, (bool, np.bool_)):
        return None
    return _real_dtype(cache_spectra, "cache_spectra")


# ---------------------------------------------------------------------------
# host stores and uploads
# ---------------------------------------------------------------------------

def _drop_memmap_pages(raw) -> None:
    """Best-effort MADV_DONTNEED on a memmap raw store: staging reads walk
    the whole mapping once, and without this the touched file-backed pages
    stay resident (RSS ≈ the full stack — exactly what the memmap store
    exists to avoid).  No-op for in-memory stores; reads after the drop
    fault pages back in.  (Copied from the JAX package, whose module
    imports jax.)"""
    if isinstance(raw, np.memmap):
        try:
            import mmap as _mmap
            raw._mmap.madvise(_mmap.MADV_DONTNEED)
        except (AttributeError, OSError, ValueError):
            pass


def _stack_memmap(entries, pad_multiple: int, time_capacity,
                  pad_rows_of, check_aborted=lambda: None):
    """Stream ``(name, [C, T])`` entries into an unlinked temp-file memmap
    ``[B, C, t_cap]``: host RSS stays O(one row) instead of holding a
    second full copy of the database for the life of the process.
    ``entries`` may be a one-shot iterator when ``time_capacity`` (max
    frames, rounded up to ``pad_multiple``) is given; a sequence needs no
    capacity.  Returns ``(memmap, lens, names)`` with the files-axis padding
    rows (``pad_rows_of(count)``) already appended as zeros.  (Copied from
    the JAX package.)"""
    import os
    import tempfile

    if time_capacity is None:
        entries = list(entries)
        if not entries:
            raise ValueError("empty database")
        time_capacity = max(np.asarray(f).shape[1] for _, f in entries)
    t_cap = -(-int(time_capacity) // pad_multiple) * pad_multiple
    fd, tmp_path = tempfile.mkstemp(suffix=".strugdb")
    names, lens = [], []
    C = None
    try:
        with os.fdopen(fd, "wb") as fh:
            row = None
            for name, feat in entries:
                check_aborted()
                a = np.asarray(feat, np.float32)
                if C is None:
                    C = a.shape[0]
                    row = np.zeros((C, t_cap), np.float32)
                if a.shape[0] != C:
                    raise ValueError(
                        f"channel count mismatch ({a.shape[0]} vs {C})")
                if a.shape[1] > t_cap:
                    raise ValueError(
                        f"{name!r} has {a.shape[1]} frames > capacity "
                        f"{t_cap}")
                row[:] = 0.0
                row[:, :a.shape[1]] = a
                row.tofile(fh)
                names.append(name)
                lens.append(a.shape[1])
            if C is None:
                raise ValueError("empty database")
            pad = pad_rows_of(len(names))
            row[:] = 0.0
            for _ in range(pad):
                row.tofile(fh)
        raw = np.memmap(tmp_path, dtype=np.float32, mode="r+",
                        shape=(len(names) + pad, C, t_cap))
    finally:
        # unlink at once: the mapping keeps the inode alive (POSIX), and
        # the backing file vanishes with the last reference
        os.unlink(tmp_path)
    return raw, np.asarray(lens + [0] * pad, np.int32), names


class _HostSlab:
    """One page-locked host buffer that every slab of a staging passes
    through on its way to a card, unlocked and freed by :meth:`close`.

    ``Tensor.pin_memory`` draws from torch's caching host allocator, which
    keeps a freed block pinned for the rest of the process: a staging slab
    of a 10,000-file database (~1.2 GB) would stay resident after staging —
    host memory the memmap raw store exists to save.  This buffer is
    page-locked with ``cudaHostRegister`` instead, and each slab waits for
    the device (the staging loop synchronizes per slab) before the next one
    overwrites it.  On the CPU slabs pass through as they are."""

    _PAGE = 4096

    def __init__(self, shape, device: torch.device) -> None:
        self._device = device
        self._buf = None
        if device.type != "cuda":
            return
        nbytes = int(np.prod(shape)) * 4
        # page-aligned: the whole buffer is locked, and no page is shared
        # with another allocation
        self._mem = np.empty(nbytes + self._PAGE, np.uint8)
        off = -self._mem.ctypes.data % self._PAGE
        buf = self._mem[off:off + nbytes].view(np.float32).reshape(shape)
        rt = torch.cuda.cudart()
        err = rt.cudaHostRegister(buf.ctypes.data, nbytes, 0)
        if err != rt.cudaError.success:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                               f"{rt.cudaGetErrorString(err)}")
        self._buf = buf

    def upload(self, host: np.ndarray) -> torch.Tensor:
        """A ``[n, C, T]`` host slab (n ≤ the buffer's rows) → the device."""
        if self._device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(host, np.float32))
        n = host.shape[0]
        np.copyto(self._buf[:n], host)
        return torch.from_numpy(self._buf[:n]).to(self._device,
                                                  non_blocking=True)

    def close(self) -> None:
        if self._buf is not None:
            _sync(self._device)            # no copy may still read it
            rt = torch.cuda.cudart()
            rt.cudaHostUnregister(self._buf.ctypes.data)
            self._buf = self._mem = None


# ---------------------------------------------------------------------------
# results (host code, copied from the JAX package, whose module imports jax)
# ---------------------------------------------------------------------------

@dataclass
class QueryResult:
    """Top-k hits of one query: parallel arrays ``[num_files, k]``."""

    sims: np.ndarray
    frames: np.ndarray
    files: List[str]
    #: boost factor of each hit window (reference Match.boostIn); ones when
    #: the producing kernel predates boost gathering
    boosts: Optional[np.ndarray] = None

    def matches(self, punch_len: int, step_size: int, k_total: int = 10,
                num_per_file: Optional[int] = None,
                min_spacing: int = 0) -> List[Match]:
        """Best ``k_total`` :class:`Match`es across files, carrying each
        window's boost (boostOut = 1 as in the reference's punch-in-only
        mode, FeatureCorrelationImpl.scala:236).

        With the defaults (``num_per_file=None``, ``min_spacing=0``) this is
        a plain flat top-k — the serving convenience.  Passing
        ``num_per_file`` (or a ``min_spacing``) switches to the *exact
        replay* of the reference's stateful selection
        (:func:`~strugatzki_tpu.analysis.topk.replay_selection`): candidates
        are offered per file in ascending window order through the same
        entry-queue / spacing-collapse / merge machinery FeatureCorrelation
        uses, so the result equals the full reference search whenever the
        device top-k contains every candidate that selection touches (raise
        the query ``k`` accordingly).  NaN sims (degenerate zero-variance
        windows) are dropped by the finite gate — ``skip_nan=True``
        semantics; the reference's default NaN-first ordering lives on the
        ``FeatureCorrelation`` path (docs/PARITY.md §6)."""
        def mk(i, j):
            t = int(self.frames[i, j])
            return Match(float(self.sims[i, j]), self.files[i],
                         Span(feat_to_full(t, step_size),
                              feat_to_full(t + punch_len, step_size)),
                         float(self.boosts[i, j])
                         if self.boosts is not None else 1.0, 1.0)

        if num_per_file is None and min_spacing == 0:
            flat = [(float(self.sims[i, j]), i, j)
                    for i in range(self.sims.shape[0])
                    for j in range(self.sims.shape[1])
                    if np.isfinite(self.sims[i, j])]
            flat.sort(key=lambda t: -t[0])
            return [mk(i, j) for _, i, j in flat[:k_total]]

        from strugatzki_tpu.analysis.topk import replay_selection
        per_file = []
        for i in range(self.sims.shape[0]):
            cands = [mk(i, j) for j in range(self.sims.shape[1])
                     if np.isfinite(self.sims[i, j])]
            cands.sort(key=lambda m: m.punch.start)
            per_file.append(cands)
        return replay_selection(per_file, k_total,
                                num_per_file if num_per_file is not None
                                else k_total, min_spacing)


@dataclass
class PunchQueryResult:
    """Top-k punch-in × punch-out hits: parallel arrays ``[num_files, k]``.

    ``frames``: punch-in window start (feature frames); ``punch_lens``:
    matched punch length − ``min_punch`` (feature frames); ``boosts_in`` /
    ``boosts_out``: the two boost factors of the reference's Match.
    """

    sims: np.ndarray
    frames: np.ndarray
    punch_lens: np.ndarray
    boosts_in: np.ndarray
    boosts_out: np.ndarray
    files: List[str]
    min_punch: int
    #: punch-in-only sim per candidate — drives the reference's
    #: ``inSim > low²`` scan gate in the exact selection replay
    #: (FeatureCorrelationImpl.scala:342); None for legacy producers
    in_sims: Optional[np.ndarray] = None

    def matches(self, step_size: int, k_total: int = 10,
                num_per_file: Optional[int] = None,
                min_spacing: int = 0) -> List[Match]:
        """Best ``k_total`` :class:`Match`es across files with the
        reference's span convention ``[start, start + minPunch + k)``
        (FeatureCorrelationImpl.scala:370-374).

        With the defaults (``num_per_file=None``, ``min_spacing=0``) this
        is a plain flat top-k — the serving convenience.  Passing
        ``num_per_file`` (or a ``min_spacing``) runs the *exact replay* of
        the reference's stateful selection
        (:func:`~strugatzki_tpu.analysis.topk.replay_selection`) over the
        returned candidates, offered per file in ascending punch-in-offset
        order exactly like FeatureCorrelationImpl's combine pass — so the
        result equals the full reference search whenever the device top-k
        contains every candidate that selection touches (raise the query
        ``k`` when ``k_total·num_per_file`` approaches it).  The kernel
        already keeps only the best punch length per offset, which is what
        the reference's always-on overlap collapse reduces same-offset
        candidates to.  NaN sims are dropped by the finite gate
        (``skip_nan=True`` semantics — docs/PARITY.md §6)."""
        def mk(i, j):
            t = int(self.frames[i, j])
            kl = int(self.punch_lens[i, j])
            return Match(float(self.sims[i, j]), self.files[i],
                         Span(feat_to_full(t, step_size),
                              feat_to_full(t + self.min_punch + kl,
                                           step_size)),
                         float(self.boosts_in[i, j]),
                         float(self.boosts_out[i, j]))

        if num_per_file is None and min_spacing == 0:
            flat = [(float(self.sims[i, j]), i, j)
                    for i in range(self.sims.shape[0])
                    for j in range(self.sims.shape[1])
                    if np.isfinite(self.sims[i, j])]
            flat.sort(key=lambda t: -t[0])
            return [mk(i, j) for _, i, j in flat[:k_total]]

        from strugatzki_tpu.analysis.topk import _Candidate, replay_selection
        per_file = []
        for i in range(self.sims.shape[0]):
            cands = [_Candidate(mk(i, j),
                                None if self.in_sims is None
                                else float(self.in_sims[i, j]))
                     for j in range(self.sims.shape[1])
                     if np.isfinite(self.sims[i, j])]
            cands.sort(key=lambda c: c.punch.start)
            per_file.append(cands)
        kept = replay_selection(per_file, k_total,
                                num_per_file if num_per_file is not None
                                else k_total, min_spacing)
        return [c.match for c in kept]


# ---------------------------------------------------------------------------
# device functions: the files axis is the leading batch dimension
# ---------------------------------------------------------------------------

def _topk(x: torch.Tensor, k: int):
    """Top-k of float32 ``x`` along the last axis in ``jax.lax.top_k``'s
    order: descending in the IEEE total order (+inf > … > +0.0 > −0.0 > …
    > −inf), equal values in ascending index order, and every NaN last.

    ``lax.top_k`` orders NaN by its sign bit (+NaN first, −NaN after
    −inf).  The NaN that arithmetic makes is −NaN on x86 and +NaN on an
    NVIDIA card, and FFT libraries differ in the sign they carry through,
    so the port ranks every NaN as x86's −NaN: the CPU and the card agree,
    and a degenerate window never displaces a real candidate.
    ``torch.topk`` promises no order among ties, which are common here
    (every boost-gated window is exactly 0, every masked window −inf), and
    ``torch.sort`` ranks NaN first: so the bits are mapped to integers of
    the same total order and sorted stably."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = torch.where(torch.isnan(x), torch.iinfo(torch.int32).min, key)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def _topk_epilogue(sims, boosts, lens, L: int, k: int):
    """Mask windows at or past ``lens − L + 1`` (which also silences
    zero-length tombstoned and padding rows) to −inf, take the per-file
    top-k, gather each hit's boost.  ``sims``/``boosts``: ``[B, W]``;
    ``lens``: ``[B]``."""
    w_valid = (lens - (L - 1))[:, None]
    t_idx = torch.arange(sims.shape[-1], device=sims.device)
    masked = torch.where(t_idx < w_valid, sims, -math.inf)
    vals, idx = _topk(masked, k)
    return vals, idx, torch.gather(boosts, -1, idx)


def _trace(X, aux, use_sums: bool, t_padded: int, tmpl: "InputTemplate",
           shifts_t, temp_weight: float, max_boost: float,
           num_temporal: int):
    """One template's (sims, boosts) ``[B, W]`` from the files' spectra:
    ``aux`` is the group-power spectra ``Xsq`` (FFT window sums), or with
    ``use_sums`` a :func:`~..kernels.corr.window_sum_table` (the compact
    cache's 2-irfft trace)."""
    dev = X.device
    fn = (K.correlation_trace_from_sums if use_sums
          else K.correlation_trace_from_spectra)
    return fn(X, aux, t_padded, tmpl.device_temporal(dev),
              tmpl.device_spectral(dev), tmpl.temporal_std,
              tmpl.spectral_std, tmpl.ln_avg_loudness, shifts_t,
              temp_weight, max_boost, num_temporal=num_temporal)


def _shift_left(x: torch.Tensor, sh: int, fill) -> torch.Tensor:
    """``x[..., sh:]`` refilled to full width with ``fill``."""
    sh = min(sh, x.shape[-1])
    return torch.cat([x[..., sh:], torch.full_like(x[..., :sh], fill)], -1)


def _window(x: torch.Tensor, start: int, width: int) -> torch.Tensor:
    """``x[..., start:start + width]`` with the start clamped into range,
    as ``lax.dynamic_slice`` clamps it."""
    start = min(max(start, 0), x.shape[-1] - width)
    return x[..., start:start + width]


def _punch_from_spectra(X, aux, use_sums: bool, t_padded: int, punch_in,
                        punch_out, shifts_t, lens, tw_in: float,
                        tw_out: float, max_boost: float, min_punch: int,
                        scan_span: int, num_temporal: int = 1, k: int = 4):
    """Punch-in × punch-out combine for a block of files (the reference's
    three hot loops, FeatureCorrelationImpl.scala:190-389).  ``aux`` and
    ``use_sums`` as in :func:`_trace`; on the sums path both punch
    templates share one window-sum table.

    Per file: both sliding traces, then for every punch-in offset ``t`` the
    best punch-out start in the band ``t + min_punch + [0, scan_span)``,
    scored ``√(inSim·outSim)`` (:370) and gated on ``inSim > 0`` (:342 with
    ``low ≥ 0``), then a masked top-k over ``t``.  Because the gate makes
    ``inSim`` a positive factor, the best length is the band's sliding
    maximum of ``outSim``, taken by sparse-table doubling: ⌊log2 S⌋ passes
    of (max, earliest argmax), then the larger of the two overlapping power
    blocks.  Every comparison is a strict ``>``, so ties keep the earliest
    out index, like the reference's scan.  ``min_punch``/``scan_span`` are
    host ints.  Returns ``(sims, t_idx, punch_len_k, boost_in, boost_out,
    in_sims)``, each ``[B, k]``.
    """
    L_in, L_out = punch_in.num_frames, punch_out.num_frames
    Tp = t_padded
    W_in = Tp - L_in + 1
    W_out = Tp - L_out + 1
    dev = X.device
    sims_in, boosts_in = _trace(X, aux, use_sums, Tp, punch_in, shifts_t,
                                tw_in, max_boost, num_temporal)
    sims_out, boosts_out = _trace(X, aux, use_sums, Tp, punch_out, shifts_t,
                                  tw_out, max_boost, num_temporal)

    # validity: punch-in scan runs over len − minPunch frames (:183);
    # punch-out windows must fit the file
    t_ix = torch.arange(W_in, device=dev)
    w_in_valid = (lens - min_punch - (L_in - 1))[:, None]
    in_valid = (t_ix < w_in_valid) & (sims_in > 0.0)
    o_ix = torch.arange(W_out, device=dev)
    out_ok = o_ix < (lens - (L_out - 1))[:, None]
    # pad the out trace so every banded read is in range
    pad = W_in + Tp - W_out
    B = sims_out.shape[0]
    out_vals = torch.cat(
        [torch.where(out_ok, sims_out, -math.inf),
         torch.full((B, pad), -math.inf, dtype=sims_out.dtype, device=dev)],
        -1)
    out_boosts_p = torch.cat(
        [boosts_out, torch.ones((B, pad), dtype=boosts_out.dtype,
                                device=dev)], -1)
    w_pad = out_vals.shape[-1]

    n_levels = max(1, int(np.ceil(np.log2(w_pad))) + 1)
    # exact integer ⌊log2 S⌋ (float log2 can misround at powers of two)
    j_sel = min(max(scan_span, 1).bit_length() - 1, n_levels - 1)
    p = 1 << j_sel
    lv = out_vals
    la = torch.arange(w_pad, dtype=torch.int32, device=dev).expand(B, w_pad)
    for j in range(j_sel):
        sh = 1 << j
        v2 = _shift_left(lv, sh, -math.inf)
        a2 = _shift_left(la, sh, 0)
        take = v2 > lv
        lv, la = torch.where(take, v2, lv), torch.where(take, a2, la)
    # block 1 at offset min_punch, block 2 at min_punch + scan_span − p
    v1, a1 = _window(lv, min_punch, W_in), _window(la, min_punch, W_in)
    off2 = min_punch + scan_span - p
    v2, a2 = _window(lv, off2, W_in), _window(la, off2, W_in)
    take2 = v2 > v1
    out_best = torch.where(take2, v2, v1)
    o_best = torch.where(take2, a2, a1)             # absolute out index
    best_j = (o_best - min_punch - t_ix).to(torch.int32)

    best = torch.where(in_valid & (out_best > -math.inf),
                       sims_in * out_best, -math.inf)
    band_sim = torch.where(best > 0.0, torch.sqrt(torch.clamp_min(best, 0.0)),
                           -math.inf)
    vals, t_idx = _topk(band_sim, k)
    j_k = torch.gather(best_j, -1, t_idx)
    b_in = torch.gather(boosts_in, -1, t_idx)
    o_k = (t_idx + min_punch + j_k).clamp(0, w_pad - 1)
    b_out = torch.gather(out_boosts_p, -1, o_k)
    # each candidate's punch-in-only sim: the exact selection replay needs
    # it for the reference's ``inSim > low²`` scan gate (:342)
    si = torch.gather(sims_in, -1, t_idx)
    return vals, t_idx, j_k, b_in, b_out, si


def _rerank_window_math(xs_b, shifts_t, file_idx, frames, tmpl_t, tmpl_s,
                        a_std_t: float, a_std_s: float, ln_avg: float,
                        temp_weight: float, max_boost: float,
                        num_temporal: int = 1):
    """Exact re-scoring of candidate windows on the device.

    Gathers the ``[M, C, L]`` windows at ``(file_idx[m], frames[m])`` from
    the resident float32 features (a window start is clamped so the window
    fits, as ``lax.dynamic_slice`` clamps it) and scores each with the trace
    kernels' cancellation-free algebra: the pre-centered template's dot at
    full float32 (TF32 is off, ``runtime/device.py``) over the window's
    shifted group statistics.  Mirrors FeatureCorrelationImpl.scala:414-421
    with the gates of :func:`~..kernels.corr.correlation_trace`; the host
    float64 mirror is :meth:`FeatureDatabase._exact_window_scores`.
    Returns ``(sims[M], boosts[M])`` float32.
    """
    nt = num_temporal
    L = tmpl_t.shape[1]
    C, T = xs_b.shape[1], xs_b.shape[2]
    dev = xs_b.device
    start = frames.clamp(0, T - L)
    cols = start[:, None, None] + torch.arange(L, device=dev)
    rows = torch.arange(C, device=dev)[None, :, None]
    win = xs_b[file_idx[:, None, None], rows, cols].to(torch.float32)

    def group(g, tmpl, a_std, n_cells):
        s = g.sum(dim=(1, 2))
        q = (g * g).sum(dim=(1, 2))
        mu = s / n_cells
        var = torch.clamp_min(q / n_cells - mu * mu, 0.0)
        dot = torch.einsum("mcl,cl->m", g, tmpl)
        return dot / (K._f32(a_std) * torch.sqrt(var) * n_cells)

    # a group with zero weight is never evaluated (the JAX package computes
    # it and selects 0 with ``where``: the same values)
    w = K._f32(temp_weight)
    zeros = torch.zeros(win.shape[0], dtype=torch.float32, device=dev)
    sim_t = group(win[:, :nt], tmpl_t, a_std_t, nt * L) if w > 0.0 else zeros
    sim_s = group(win[:, nt:], tmpl_s, a_std_s, (C - nt) * L) \
        if w < 1.0 else zeros
    sim = sim_t * w + sim_s * K._f32(np.float32(1.0) - np.float32(w))
    # boost averages channel 0 only (FeatureCorrelationImpl.scala:73-78);
    # the per-file temporal shift restores the unshifted loudness mean
    loud_mean = win[:, 0].sum(dim=1) / L + shifts_t[file_idx]
    boost = torch.exp((K._f32(ln_avg) - torch.log(loud_mean)) / 0.6)
    # `<=` is false for a NaN boost: such windows are gated to 0
    sim = torch.where(boost <= K._f32(max_boost), sim, 0.0)
    return sim.to(torch.float32), boost.to(torch.float32)


def _pad_rows_of(count: int) -> int:
    """Files-axis padding (zero rows, lens 0 — masked everywhere) to a
    :data:`_QUERY_CHUNK` multiple once the database spans several query
    ranges.  Idempotent: a count that is already padded pads by 0, so a
    pre-padded ``_prestacked`` store passes through unchanged."""
    if count > _QUERY_CHUNK:
        return -count % _QUERY_CHUNK
    return 0


class FeatureDatabase:
    """Normalized, group-shifted feature matrices resident on one device.

    ``entries``: ``(name, features[C, T])`` pairs (e.g. loaded from
    ``*_feat.aif``).  ``norm``: the ``feat_norms.aif`` matrix or ``None``.
    ``device``: ``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"``; every
    device tensor of the database lives there, and asking for CUDA without
    a card raises.  ``storage_dtype``, ``cache_spectra``, ``raw_store`` and
    ``time_capacity``: the capacity modes of the module docstring.
    """

    def __init__(self, entries: Sequence[Tuple[str, np.ndarray]],
                 norm: Optional[np.ndarray], step_size: int = 512,
                 mesh=None, pad_multiple: int = 512,
                 storage_dtype=None, cache_spectra=False,
                 rerank_device: Optional[bool] = None,
                 progress=None, check_aborted=None,
                 raw_store: str = "memory", time_capacity=None,
                 num_temporal: int = 1, device="cuda",
                 _prestacked=None) -> None:
        _reject_unported(mesh)
        if raw_store not in ("memory", "memmap"):
            raise ValueError(f"raw_store {raw_store!r}")
        store_dtype = torch.float32 if storage_dtype is None \
            else _real_dtype(storage_dtype, "storage_dtype")
        pack = _spectra_pack(cache_spectra)
        dev = resolve(device)
        # observer protocol for minutes-long stagings (the reference's
        # checkAborted/progress pattern, FeatureCorrelationImpl.scala:164,
        # 402): ``progress`` receives fractions in [0, 1]; ``check_aborted``
        # may raise to cancel — construction then fails cleanly, and
        # _restage adopts a fresh instance only on success.  Use
        # :meth:`stage` for the full Processor/observer surface.
        progress = progress if progress is not None else (lambda f: None)
        check_aborted = check_aborted if check_aborted is not None \
            else (lambda: None)
        check_aborted()
        if num_temporal < 1:
            raise ValueError(f"num_temporal {num_temporal} < 1")
        # the temporal/spectral channel split (the reference's numTemporal,
        # FeatureCorrelation.scala:279-289) is a DATABASE property: staging
        # group-shifts and every query must agree with the template's split
        self._num_temporal = num_temporal
        if _prestacked is not None:
            raw, lens = _prestacked
            self.files = list(entries)
            pad_rows = _pad_rows_of(raw.shape[0])
            if pad_rows:
                raw = np.concatenate(
                    [raw, np.zeros((pad_rows,) + raw.shape[1:], raw.dtype)])
                lens = np.concatenate([lens, np.zeros(pad_rows, lens.dtype)])
        elif raw_store == "memmap":
            # streamed, disk-backed raw store: host RSS stays O(one file)
            # through staging and for the life of the database (entries may
            # be a one-shot generator when time_capacity is given)
            raw, lens, self.files = _stack_memmap(
                entries, pad_multiple, time_capacity, _pad_rows_of,
                check_aborted=check_aborted)
        else:
            self.files = [name for name, _ in entries]
            mats = [np.asarray(f, np.float32) for _, f in entries]
            if not mats:
                raise ValueError("empty database")
            # pad_stack with the files-axis padding rows allocated up front
            # (one host copy of the stack, not two)
            raw, lens = pad_stack(
                mats + [mats[0][:, :0]] * _pad_rows_of(len(mats)),
                multiple=pad_multiple)
            del mats
        if num_temporal >= raw.shape[1]:
            raise ValueError(
                f"num_temporal {num_temporal} leaves no spectral channel "
                f"(database has {raw.shape[1]})")
        self.step_size = step_size
        self._raw = raw
        self._lens = np.asarray(lens, np.int32)
        self.norm = norm
        self._device = dev
        # retained for incremental add_files/remove_files and restaging
        self._pad_multiple = pad_multiple
        self._raw_store = raw_store
        self._storage_dtype = storage_dtype
        self._cache_spectra_mode = cache_spectra
        self._lens_dev = self._put_lens()

        # slab-wise staging: each ≤ _QUERY_CHUNK-file slab is uploaded
        # through one page-locked buffer, prepared by the prep kernel in
        # float32 and copied in place into the preallocated resident tensor
        # (a reduced storage dtype rounds to nearest even in that copy, as
        # XLA's cast does) — peak device memory ≈ the database + one slab's
        # input and output
        B, C, T = raw.shape
        w_feat = 0.7 if cache_spectra else 1.0
        self._xs = torch.empty((B, C, T), dtype=store_dtype, device=dev)
        self._shifts = torch.empty(B, dtype=torch.float32, device=dev)
        slab = _HostSlab((min(B, _QUERY_CHUNK), C, T), dev)
        try:
            for o in range(0, B, _QUERY_CHUNK):
                check_aborted()
                s = slice(o, min(o + _QUERY_CHUNK, B))
                xs_p, sh_p = prepare_database(
                    slab.upload(raw[s]), norm, self._lens_dev[s],
                    num_temporal=num_temporal, device=dev)
                self._xs[s].copy_(xs_p)
                self._shifts[s].copy_(sh_p)
                del xs_p, sh_p
                _sync(dev)             # one slab in flight at a time
                _drop_memmap_pages(raw)   # keep a memmap store's RSS flat
                progress(w_feat * min(1.0, s.stop / B))
        finally:
            slab.close()

        # cache_spectra: every file's spectra resident, filled chunk-wise,
        # so each query pays only its inverse FFTs.  True: complex64 X and
        # Xsq, (C + 2)·(N/2 + 1)·8 bytes per file (~1.7× f32 features).  A
        # real dtype: the compact cache, X alone as planar (re, im) of that
        # dtype, C·(N/2 + 1)·4 bytes per file at bf16; its window sums come
        # from tables computed per query step (never stored)
        self._spectra = None
        self._spectra_pack = pack
        self._spectra_reduced = pack is not None
        if cache_spectra:
            bins = K._fft_len(T) // 2 + 1
            shapes = [((B, C, bins), torch.complex64),
                      ((B, 2, bins), torch.complex64)] if pack is None \
                else [((B, C, bins), pack)] * 2
            bufs = tuple(torch.empty(shape, dtype=dt, device=dev)
                         for shape, dt in shapes)
            for o in range(0, B, _SPECTRA_CHUNK):
                check_aborted()
                s = slice(o, min(o + _SPECTRA_CHUNK, B))
                for buf, part in zip(bufs, self._spectra_of(self._xs[s])):
                    if part.dtype != buf.dtype:
                        raise TypeError(f"spectra cache must be {buf.dtype}, "
                                        f"got {part.dtype}")
                    buf[s].copy_(part)
                _sync(dev)
                progress(0.7 + 0.3 * min(1.0, s.stop / B))
            self._spectra = bufs
        # exact re-rank backend: candidate windows re-score on the device
        # whenever the resident features are f32 (the compact cache
        # included); bf16 features take the host f64 mirror.  Explicit
        # ``rerank_device=True`` on an ineligible configuration is an error
        # (a reduced-precision "exact" re-rank would not be exact).
        eligible = self._xs.dtype == torch.float32
        if rerank_device is None:
            self._rerank_device = eligible
        else:
            if rerank_device and not eligible:
                raise ValueError(
                    "rerank_device=True needs float32 features "
                    f"(got dtype {self._xs.dtype})")
            self._rerank_device = bool(rerank_device)
        # construction reports staging errors here, not at query time
        _sync(dev)
        progress(1.0)

    @property
    def num_files(self) -> int:
        """Live file count (tombstoned entries excluded)."""
        return sum(1 for n in self.files if n is not None)

    def _spectra_of(self, xs: torch.Tensor):
        """Spectra-cache rows of prepared features ``xs``: complex64 ``(X,
        Xsq)``, or the compact cache's planar ``(re, im)``."""
        if self._spectra_pack is None:
            return K.trace_spectra(xs, num_temporal=self._num_temporal)
        return K.pack_spectra(K.forward_spectra(xs), self._spectra_pack)

    @property
    def _reduced(self) -> bool:
        """Reduced-precision resident data (bf16 features or the compact
        spectra cache), which turns the exact re-rank on by default."""
        return self._xs.dtype != torch.float32 or self._spectra_reduced

    # -- incremental updates -----------------------------------------------

    def remove_files(self, names: Sequence[str]) -> None:
        """Drop files from the resident database without restaging.

        Rows are tombstoned: length masked to 0 on the device (every query
        treats a zero-length file as "no valid window" → −inf sims, the same
        masking the staging padding uses) and the name slot set to None.
        :meth:`add_files` reuses tombstoned rows; :meth:`save` compacts them
        away.  No feature data moves.
        """
        pos = {n: i for i, n in enumerate(self.files) if n is not None}
        idxs = []
        for n in names:
            if n not in pos:
                raise KeyError(f"{n!r} is not in the database")
            idxs.append(pos[n])
        for i in idxs:
            self.files[i] = None
            self._lens[i] = 0
            self._raw[i] = 0.0
        self._lens_dev = self._put_lens()

    def add_files(self, entries: Sequence[Tuple[str, np.ndarray]],
                  progress=None, check_aborted=None) -> None:
        """Stage additional files into the resident database.

        New rows fill tombstoned slots (see :meth:`remove_files`) and the
        staging padding; only the new files are uploaded and prepared (one
        prep kernel launch).  When the free slots run out, or a file exceeds
        the current time capacity, the whole database restages.

        ``progress``/``check_aborted`` follow the staging observer
        protocol.  Abort points sit BEFORE anything is mutated, the device
        is synchronized before the commit (so an asynchronous failure
        surfaces first), and the restage path adopts a fresh instance only
        on success: a failed or aborted add leaves the previous state fully
        usable.
        """
        progress = progress if progress is not None else (lambda f: None)
        check_aborted = check_aborted if check_aborted is not None \
            else (lambda: None)
        if not entries:
            return
        check_aborted()
        entries = self._dedup_new(entries)
        names = [n for n, _ in entries]
        feats = [np.asarray(f, np.float32) for _, f in entries]
        C, t_cap = self._raw.shape[1], self._raw.shape[2]
        if any(f.shape[0] != C for f in feats):
            raise ValueError(f"channel count mismatch (database has {C})")
        if max(f.shape[1] for f in feats) > t_cap:
            return self._restage(entries, progress=progress,
                                 check_aborted=check_aborted)

        slots = [i for i, n in enumerate(self.files) if n is None]
        tail = list(range(len(self.files), self._raw.shape[0]))
        free = slots + tail
        if len(free) < len(entries):
            return self._restage(entries, progress=progress,
                                 check_aborted=check_aborted)

        raw_new, lens_new = pad_stack(feats, multiple=1)
        if raw_new.shape[2] < t_cap:
            raw_new = np.pad(
                raw_new, ((0, 0), (0, 0), (0, t_cap - raw_new.shape[2])))
        dev = self._device
        slab = _HostSlab(raw_new.shape, dev)
        try:
            xs_p, sh_p = prepare_database(
                slab.upload(raw_new), self.norm,
                torch.as_tensor(lens_new, device=dev),
                num_temporal=self._num_temporal, device=dev)
            # the resident dtype, rounded as staging rounds it
            xs_p = xs_p.to(self._xs.dtype)
            sp_p = self._spectra_of(xs_p) \
                if self._spectra is not None else None
            # surface any asynchronous device failure BEFORE anything
            # mutates — past the abort point the commit must be
            # all-or-nothing
            _sync(dev)
        finally:
            slab.close()
        progress(0.8)
        # last abort point: past here the commit runs to its end
        check_aborted()

        used = free[:len(entries)]
        slots_dev = torch.as_tensor(used, dtype=torch.int64, device=dev)
        # in-place row writes into the resident tensors; the rows stay
        # masked (lens 0 on the device) until the lens vector ships last
        self._xs.index_copy_(0, slots_dev, xs_p)
        self._shifts.index_copy_(0, slots_dev, sh_p)
        if sp_p is not None:
            for buf, p in zip(self._spectra, sp_p):
                buf.index_copy_(0, slots_dev, p)
        for j, slot in enumerate(used):
            if slot < len(self.files):
                self.files[slot] = names[j]      # tombstone reuse
            else:
                self.files.append(names[j])      # tail slots are in order
            self._lens[slot] = lens_new[j]
            self._raw[slot] = raw_new[j]
        self._lens_dev = self._put_lens()
        _sync(dev)
        progress(1.0)

    def _dedup_new(self, entries):
        """Validate an add batch: no name may collide with a live entry or
        repeat within the batch."""
        live = {n for n in self.files if n is not None}
        seen = set()
        for n, _ in entries:
            if n in live:
                raise ValueError(f"{n!r} is already in the database")
            if n in seen:
                raise ValueError(f"{n!r} appears twice in this add batch")
            seen.add(n)
        return list(entries)

    def _put_lens(self) -> torch.Tensor:
        """Host lens vector → the device."""
        return torch.as_tensor(self._lens, dtype=torch.int32,
                               device=self._device)

    def _restage(self, new_entries: Sequence[Tuple[str, np.ndarray]],
                 progress=None, check_aborted=None) -> None:
        """Full rebuild with the surviving entries plus ``new_entries`` —
        the path when an add outgrows the time or files capacity.  A FRESH
        instance is built first and adopted only on success: an abort (or
        any staging failure) mid-restage leaves the old resident database
        fully usable."""
        live = [(i, n) for i, n in enumerate(self.files) if n is not None]
        new_entries = list(new_entries)
        # every mode carries across; time_capacity is recomputed from the
        # live lens and the new entries (the restage may exist precisely
        # because the old capacity was outgrown)
        kwargs = dict(
            step_size=self.step_size, pad_multiple=self._pad_multiple,
            storage_dtype=self._storage_dtype,
            cache_spectra=self._cache_spectra_mode,
            rerank_device=self._rerank_device, raw_store=self._raw_store,
            num_temporal=self._num_temporal, device=self._device,
            progress=progress, check_aborted=check_aborted)
        if self._raw_store == "memmap":
            # stream the old rows lazily AND drop the old mapping's pages as
            # the copy walks it, or the read loop faults the whole old store
            # resident
            import itertools

            cap = max([int(self._lens[i]) for i, _ in live]
                      + [int(np.asarray(f).shape[1])
                         for _, f in new_entries])

            def old_rows():
                for j, (i, n) in enumerate(live):
                    yield (n, self._raw[i][:, :int(self._lens[i])])
                    if j % 64 == 63:
                        _drop_memmap_pages(self._raw)
                _drop_memmap_pages(self._raw)

            fresh = FeatureDatabase(
                itertools.chain(old_rows(), new_entries), self.norm,
                time_capacity=cap, **kwargs)
        else:
            old = [(n, self._raw[i][:, :int(self._lens[i])])
                   for i, n in live]
            fresh = FeatureDatabase(old + new_entries, self.norm, **kwargs)
        self.__dict__.update(fresh.__dict__)

    # -- queries -------------------------------------------------------------

    def _chunks(self):
        """Query ranges of the files axis (one range when unchunked)."""
        b = self._xs.shape[0]
        if b <= _QUERY_CHUNK:
            return [slice(0, b)]
        return [slice(o, min(o + _QUERY_CHUNK, b))
                for o in range(0, b, _QUERY_CHUNK)]

    def _spectra_steps(self, lanes: int):
        """Yield ``(files slice, X, aux, use_sums)`` (see :func:`_trace`)
        over the whole files axis, each step within :data:`_STEP_BYTES` of
        transients for ``lanes`` traces per file: the resident cache's rows,
        the compact cache's rows unpacked beside a window-sum table of the
        step's resident features (computed here, never stored), or spectra
        computed here."""
        nt = self._num_temporal
        compact = self._spectra_reduced
        step = _files_step(self._xs.shape[1], self._xs.shape[2], lanes,
                           compact, nt)
        for sl in self._chunks():
            for o in range(sl.start, sl.stop, step):
                s = slice(o, min(o + step, sl.stop))
                if self._spectra is None:
                    yield (s,) + K.trace_spectra(
                        self._xs[s], num_temporal=nt) + (False,)
                elif compact:
                    yield (s, K.unpack_spectra(*(b[s] for b in self._spectra)),
                           K.window_sum_table(self._xs[s], nt), True)
                else:
                    yield (s,) + tuple(b[s] for b in self._spectra) + (False,)

    def _query_all(self, templates, temp_weight: float, max_boost: float,
                   k: int, with_traces: bool = False):
        """Every template (all of one length) against every row, sharing
        each step's spectra → per template the host arrays ``(vals, idx,
        boosts_k[, sims, boosts])`` over all rows."""
        t_padded = self._xs.shape[2]
        parts = [[] for _ in templates]
        for s, X, aux, use_sums in self._spectra_steps(lanes=1):
            shifts, lens = self._shifts[s], self._lens_dev[s]
            for q, t in enumerate(templates):
                sims, boosts = _trace(X, aux, use_sums, t_padded, t, shifts,
                                      temp_weight, max_boost,
                                      self._num_temporal)
                out = _topk_epilogue(sims, boosts, lens, t.num_frames, k)
                parts[q].append(out + (sims, boosts) if with_traces else out)
        return [tuple(_host(torch.cat(col)) for col in zip(*p))
                for p in parts]

    def _punch_all(self, pairs, tw_in: float, tw_out: float,
                   max_boost: float, k: int):
        """Every ``(punch_in, punch_out, min_punch, max_punch)`` pair (all of
        one shape) against every row, sharing each step's spectra → per
        pair the six host arrays of :func:`_punch_from_spectra`."""
        t_padded = self._xs.shape[2]
        parts = [[] for _ in pairs]
        for s, X, aux, use_sums in self._spectra_steps(lanes=2):
            shifts, lens = self._shifts[s], self._lens_dev[s]
            for q, (p_in, p_out, mp, xp) in enumerate(pairs):
                parts[q].append(_punch_from_spectra(
                    X, aux, use_sums, t_padded, p_in, p_out, shifts, lens,
                    tw_in, tw_out, max_boost, int(mp), int(xp) - int(mp) + 1,
                    num_temporal=self._num_temporal, k=k))
        return [tuple(_host(torch.cat(col)) for col in zip(*p))
                for p in parts]

    def _trim(self, *arrays, axis: int = 0):
        """Drop the staging-padding rows beyond the real file count."""
        n = len(self.files)
        out = tuple(np.asarray(a)[(slice(None),) * axis + (slice(0, n),)]
                    for a in arrays)
        return out if len(out) > 1 else out[0]

    def query(self, template: "InputTemplate", temp_weight: float = 0.5,
              max_boost: float = 8.0, k: int = 4,
              with_traces: bool = False,
              exact_rerank: Optional[bool] = None):
        """Top-k windows of every file for one punch template →
        :class:`QueryResult` (and optionally the dense (sims, boosts) traces
        for exact host-side replay; rows of tombstoned files — see
        :meth:`remove_files` — carry no valid windows and surface as −inf
        there like the staging padding).

        ``exact_rerank`` recomputes the returned top-k candidates' sims and
        boosts exactly (on the device over the resident float32 features,
        or through the host float64 mirror with ``rerank_device=False`` or
        bf16 features) and re-sorts each file's hits.  It defaults to on
        for reduced-precision data, whose device sims carry bf16 noise; the
        device top-k is then inflated 4× so the re-rank can recover
        candidates that noise pushed just outside the top-k.
        """
        self._check_template(template)
        reduced = self._reduced
        if exact_rerank is None:
            exact_rerank = reduced
        k_dev = self._inflated_k(k, template.num_frames) \
            if (exact_rerank and reduced) else k
        k_dev = self._k_clamp(k_dev, template.num_frames)
        if k_dev == 0:
            if with_traces:
                raise ValueError(
                    f"template ({template.num_frames} frames) exceeds the "
                    f"database's padded time capacity "
                    f"{self._xs.shape[2]} — no file can contain it, and "
                    "there is no trace to return")
            return self._masked_query_result(k)
        got = self._query_all([template], temp_weight, max_boost, k_dev,
                              with_traces)[0]
        vals, idx, boosts_k = self._trim(got[0], got[1], got[2])
        res = QueryResult(vals, idx, list(self.files), boosts_k)
        if exact_rerank:
            self._rerank_exact(res, template, temp_weight, max_boost)
        if k_dev != k:
            res.sims = self._fit_k_cols(res.sims, k, -np.inf)
            res.frames = self._fit_k_cols(res.frames, k, 0)
            if res.boosts is not None:
                res.boosts = self._fit_k_cols(res.boosts, k, 1.0)
        if with_traces:
            sims, boosts = self._trim(got[3], got[4])
            return res, (sims, boosts, self._lens[:len(self.files)])
        return res

    def _inflated_k(self, k: int, tmpl_frames: int) -> int:
        """Device top-k for reduced-precision data: 4× the requested k
        (bounded by the window count) so the exact re-rank can pull back
        candidates the lossy device sims pushed just outside the top-k.
        May still exceed the window count when ``k`` itself does —
        :meth:`_k_clamp` bounds the final device k in every query path."""
        return max(k, min(4 * k, self._xs.shape[2] - tmpl_frames + 1))

    def _k_clamp(self, k_dev: int, *tmpl_frames: int) -> int:
        """Largest device top-k the queries can take: their window axis has
        ``t_cap − L + 1`` slots (padded time capacity).  Returns 0 when some
        template is longer than the capacity itself — i.e. longer than EVERY
        file — where the serving rule (files shorter than the template are
        excluded from results) leaves nothing to search: callers
        short-circuit to an all-masked result."""
        w = min(self._xs.shape[2] - L + 1 for L in tmpl_frames)
        return max(0, min(k_dev, w))

    def _check_template(self, *templates: "InputTemplate") -> None:
        """Every query template must carry the database's channel layout:
        the same channel count and the same temporal/spectral split
        (``num_temporal``) the staging group-shift was computed with — a
        mismatched split would silently score channels against the wrong
        group statistics (the host exact mirror honors the template's
        split, so the two backends would disagree without this gate)."""
        C = self._raw.shape[1]
        for t in templates:
            tc = t.temporal_block.shape[0] + t.spectral_block.shape[0]
            if tc != C:
                raise ValueError(
                    f"template has {tc} channels, database has {C}")
            if t.num_temporal != self._num_temporal:
                raise ValueError(
                    f"template num_temporal {t.num_temporal} != database "
                    f"num_temporal {self._num_temporal}")

    @staticmethod
    def _fit_k_cols(arr: np.ndarray, k: int, fill) -> np.ndarray:
        """Return exactly ``k`` result columns: trim an inflated device k,
        or pad a capacity-clamped one with masked values (−inf sims are
        dropped by ``matches``'s finite gate like the staging padding)."""
        if arr.shape[1] >= k:
            return arr[:, :k]
        pad = np.full((arr.shape[0], k - arr.shape[1]), fill, arr.dtype)
        return np.concatenate([arr, pad], axis=1)

    def _masked_query_result(self, k: int) -> QueryResult:
        """All-masked ``[num_rows, k]`` result (template fits no window)."""
        B = len(self.files)
        return QueryResult(np.full((B, k), -np.inf, np.float32),
                           np.zeros((B, k), np.int32), list(self.files),
                           np.ones((B, k), np.float32))

    def _masked_punch_result(self, k: int, min_punch: int
                             ) -> PunchQueryResult:
        """All-masked punch result (some template fits no window)."""
        B = len(self.files)
        ones = np.ones((B, k), np.float32)
        return PunchQueryResult(
            np.full((B, k), -np.inf, np.float32),
            np.zeros((B, k), np.int32), np.zeros((B, k), np.int32),
            ones, ones.copy(), list(self.files), min_punch,
            np.full((B, k), -np.inf, np.float32))

    # -- exact re-rank -------------------------------------------------------

    #: exact-re-rank budget: only the globally best (by device sim)
    #: candidates are re-scored.  Every candidate `.matches()` can surface
    #: for any sane ``k_total·num_per_file`` lies far inside this.
    RERANK_LIMIT = 4096

    def _rerank_exact(self, res: QueryResult, template: "InputTemplate",
                      temp_weight: float, max_boost: float) -> None:
        """Replace each returned candidate's (sim, boost) with the exact
        value and re-sort every file's k hits.  Candidates beyond the
        ``RERANK_LIMIT`` globally best keep their device sims (they cannot
        reach the match lists those limits are sized for)."""
        res.sims = np.array(res.sims)
        res.frames = np.array(res.frames)
        if res.boosts is not None:
            res.boosts = np.array(res.boosts)
        cand = self._rerank_candidates(res.sims)
        if cand.size:
            sims, boosts = self._window_scores(
                cand[:, 0], res.frames[cand[:, 0], cand[:, 1]],
                template, temp_weight, max_boost)
            res.sims[cand[:, 0], cand[:, 1]] = sims
            if res.boosts is not None:
                res.boosts[cand[:, 0], cand[:, 1]] = boosts
        order = np.argsort(-np.nan_to_num(res.sims, nan=-np.inf), axis=1)
        res.sims = np.take_along_axis(res.sims, order, axis=1)
        res.frames = np.take_along_axis(res.frames, order, axis=1)
        if res.boosts is not None:
            res.boosts = np.take_along_axis(res.boosts, order, axis=1)

    def _rerank_candidates(self, sims: np.ndarray) -> np.ndarray:
        """(i, j) indices to re-score exactly: all finite candidates, or —
        past ``RERANK_LIMIT`` of them — the globally best by device sim."""
        finite = np.isfinite(sims)
        n_finite = int(finite.sum())
        if n_finite <= self.RERANK_LIMIT:
            return np.argwhere(finite)
        flat = np.where(finite.ravel(), sims.ravel(), -np.inf)
        top = np.argpartition(-flat, self.RERANK_LIMIT - 1)[:self.RERANK_LIMIT]
        return np.stack(np.unravel_index(top, sims.shape), axis=1)

    def _window_scores(self, file_idx: np.ndarray, frames: np.ndarray,
                       template: "InputTemplate", temp_weight: float,
                       max_boost: float):
        """Re-rank backend dispatch: the device re-rank over the resident
        float32 features, or the host float64 mirror."""
        if self._rerank_device:
            return self._device_window_scores(file_idx, frames, template,
                                              temp_weight, max_boost)
        return self._exact_window_scores(file_idx, frames, template,
                                         temp_weight, max_boost)

    def _device_window_scores_async(self, file_idx: np.ndarray,
                                    frames: np.ndarray,
                                    template: "InputTemplate",
                                    temp_weight: float, max_boost: float):
        """Launch the device re-rank and return the DEVICE ``(sims,
        boosts)`` tensors without fetching, so callers with several
        independent re-ranks (the punch in+out pair) launch them all, then
        fetch."""
        dev = self._device
        return _rerank_window_math(
            self._xs, self._shifts,
            torch.as_tensor(np.asarray(file_idx, np.int64), device=dev),
            torch.as_tensor(np.asarray(frames, np.int64), device=dev),
            template.device_temporal(dev), template.device_spectral(dev),
            template.temporal_std, template.spectral_std,
            template.ln_avg_loudness, temp_weight, max_boost,
            num_temporal=self._num_temporal)

    def _device_window_scores(self, file_idx: np.ndarray, frames: np.ndarray,
                              template: "InputTemplate", temp_weight: float,
                              max_boost: float):
        """:meth:`_device_window_scores_async` + fetch."""
        sims, boosts = self._device_window_scores_async(
            file_idx, frames, template, temp_weight, max_boost)
        return _host(sims), _host(boosts)

    #: candidates per block of the host f64 re-rank: a block's float64
    #: windows (~12 MB for 14 × 861 frames) stay in cache across its ~10
    #: elementwise passes; one block of 4,096 windows takes 3× as long.
    #: Every reduction runs per candidate, so blocks give identical bits,
    #: and they run on a thread per core (NumPy releases the GIL in its
    #: passes).
    _EXACT_BLOCK = 128

    def _exact_window_scores(self, file_idx: np.ndarray,
                             frames: np.ndarray, template: "InputTemplate",
                             temp_weight: float, max_boost: float):
        """Exact (sims, boosts) of ``template`` at windows
        ``(file_idx[m], frames[m])`` — a batched mirror of
        analysis.correlation._single_window_trace with the same float
        widths (f32 normalization, f64 accumulation, f32 results), run in
        blocks of :data:`_EXACT_BLOCK` candidates."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        b = self._EXACT_BLOCK
        starts = range(0, max(1, len(file_idx)), b)

        def block(o):
            return self._exact_window_block(file_idx[o:o + b],
                                            frames[o:o + b], template,
                                            temp_weight, max_boost)

        workers = min(len(starts), os.cpu_count() or 1)
        if workers > 1:
            with ThreadPoolExecutor(workers) as ex:
                parts = list(ex.map(block, starts))
        else:
            parts = [block(o) for o in starts]
        return tuple(np.concatenate(col) for col in zip(*parts))

    def _exact_window_block(self, file_idx: np.ndarray,
                            frames: np.ndarray, template: "InputTemplate",
                            temp_weight: float, max_boost: float):
        """One block of :meth:`_exact_window_scores`: the JAX package's
        ``_exact_window_scores`` op for op (the same bits), without its
        redundant passes — the centered window is formed once, squared in
        place, and a tail is masked only where one exists."""
        L = template.num_frames
        C = self._raw.shape[1]
        nt = template.num_temporal
        n = len(file_idx)
        wins = np.zeros((n, C, L), np.float32)
        valid_len = np.empty(n, np.int64)
        for m in range(n):
            i, t = int(file_idx[m]), int(frames[m])
            stop = min(t + L, int(self._lens[i]))
            wins[m, :, :stop - t] = self._raw[i][:, t:stop]
            valid_len[m] = stop - t
        if self.norm is not None:
            mins = np.asarray(self.norm[:, 0:1], np.float32)
            rng = (np.asarray(self.norm[:, 1:2], np.float32) - mins)
            with np.errstate(divide="ignore", invalid="ignore"):
                normed = (wins - mins) / rng
            # only the read frames are normalized; a zero tail stays 0
            # (the freshly-allocated buffer, _single_window_trace)
            tail = np.arange(L)[None, :] >= valid_len[:, None]
            if tail.any():
                normed[np.broadcast_to(tail[:, None, :], normed.shape)] = 0.0
            wins = normed
        w64 = wins.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            avg32 = (w64[:, 0, :].sum(axis=1) / L).astype(np.float32)
            boosts = np.exp(
                (template.ln_avg_loudness
                 - np.log(avg32.astype(np.float64))) / 0.6
            ).astype(np.float32)

            def group_sim(lo, hi, block, a_mean, a_std):
                g = w64[:, lo:hi, :]
                size = (hi - lo) * L
                bm = g.reshape(n, -1).sum(axis=1) / size
                d = g - bm[:, None, None]
                # the RAW normalized template block (reconstructing it as
                # centered + f32(mean) costs 1 ulp per cell and can flip
                # exact-compare selection gates), widened like M.correlate
                a64 = np.asarray(block, np.float32).astype(np.float64)
                num = ((a64[None] - a_mean) * d).reshape(n, -1).sum(axis=1)
                var = np.square(d, out=d).reshape(n, -1).sum(axis=1) / size
                bs = np.sqrt(var)
                return (num / (a_std * bs * size)).astype(np.float32)

            sim_t = group_sim(0, nt, template.temporal_block,
                              template.temporal_mean,
                              template.temporal_std) \
                if temp_weight > 0 else np.zeros(n, np.float32)
            sim_s = group_sim(nt, C, template.spectral_block,
                              template.spectral_mean,
                              template.spectral_std) \
                if temp_weight < 1 else np.zeros(n, np.float32)
        sims = (sim_t * np.float32(temp_weight)
                + sim_s * np.float32(1 - temp_weight)).astype(np.float32)
        sims = np.where(boosts <= max_boost, sims, np.float32(0.0))
        return sims, boosts

    def _rerank_exact_punch(self, res: PunchQueryResult,
                            punch_in: "InputTemplate",
                            punch_out: "InputTemplate",
                            tw_in: float, tw_out: float,
                            max_boost: float) -> None:
        """Exact re-scoring of a punch result's candidates: both windows per
        candidate, recombined as ``√(inSim·outSim)`` with the combine's
        gates (inSim > 0, positive product), then each file's k hits
        re-sorted.  The device's *choice* of best punch length per offset
        is kept (re-picking it would need the whole band)."""
        res.sims = np.array(res.sims)
        res.frames = np.array(res.frames)
        res.punch_lens = np.array(res.punch_lens)
        res.boosts_in = np.array(res.boosts_in)
        res.boosts_out = np.array(res.boosts_out)
        if res.in_sims is not None:
            res.in_sims = np.array(res.in_sims)
        cand = self._rerank_candidates(res.sims)
        if cand.size:
            fi, fj = cand[:, 0], cand[:, 1]
            t_in = res.frames[fi, fj]
            t_out = t_in + res.min_punch + res.punch_lens[fi, fj]
            if self._rerank_device:
                # launch both window re-ranks before fetching either
                d_in = self._device_window_scores_async(
                    fi, t_in, punch_in, tw_in, max_boost)
                d_out = self._device_window_scores_async(
                    fi, t_out, punch_out, tw_out, max_boost)
                (in_sims, b_in), (out_sims, b_out) = (
                    tuple(_host(t) for t in d) for d in (d_in, d_out))
            else:
                in_sims, b_in = self._window_scores(
                    fi, t_in, punch_in, tw_in, max_boost)
                out_sims, b_out = self._window_scores(
                    fi, t_out, punch_out, tw_out, max_boost)
            # the reference's inSim * outSim is a Java Float multiply —
            # round the product to f32 BEFORE the sqrt (an f64 product can
            # land 1 ulp away and flip downstream selection gates)
            prod = (in_sims * out_sims).astype(np.float32)
            sims = np.where((in_sims > 0) & (prod > 0),
                            np.sqrt(np.maximum(prod, 0)),
                            -np.inf).astype(np.float32)
            res.sims[fi, fj] = sims
            res.boosts_in[fi, fj] = b_in
            res.boosts_out[fi, fj] = b_out
            if res.in_sims is not None:
                res.in_sims[fi, fj] = in_sims
        order = np.argsort(-np.nan_to_num(res.sims, nan=-np.inf), axis=1)
        for name in ("sims", "frames", "punch_lens", "boosts_in",
                     "boosts_out", "in_sims"):
            arr = getattr(res, name)
            if arr is not None:
                setattr(res, name, np.take_along_axis(arr, order, axis=1))

    # -- punch queries and batches ------------------------------------------

    def query_punch(self, punch_in: "InputTemplate",
                    punch_out: "InputTemplate", min_punch: int,
                    max_punch: int, temp_weight_in: float = 0.5,
                    temp_weight_out: float = 0.5,
                    max_boost: float = 8.0, k: int = 4,
                    exact_rerank: Optional[bool] = None) -> PunchQueryResult:
        """Punch-in × punch-out search (the reference's three hot loops,
        FeatureCorrelationImpl.scala:190-389): per file, the best punch
        length in ``[min_punch, max_punch]`` (feature frames) is found for
        every punch-in offset and the top-k offsets returned with
        ``√(inSim·outSim)`` scores and both boosts.

        Deliberate divergence from the reference's *stateful* search: the
        reference only opens a file's punch-in trace when some in-similarity
        alone exceeds the current lowest kept match
        (FeatureCorrelationImpl.scala:213), an order-dependent pruning; this
        search covers the full candidate space.  Use ``FeatureCorrelation``
        for faithful stateful selection.

        ``exact_rerank`` re-scores the candidates' in/out windows exactly,
        recombines, and re-sorts."""
        if min_punch > max_punch:
            raise ValueError(f"min_punch {min_punch} > max_punch {max_punch}")
        self._check_template(punch_in, punch_out)
        reduced = self._reduced
        if exact_rerank is None:
            exact_rerank = reduced
        k_dev = self._inflated_k(k, punch_in.num_frames) \
            if (exact_rerank and reduced) else k
        if self._k_clamp(1, punch_in.num_frames, punch_out.num_frames) == 0:
            return self._masked_punch_result(k, min_punch)
        k_dev = self._k_clamp(k_dev, punch_in.num_frames)
        got = self._punch_all([(punch_in, punch_out, min_punch, max_punch)],
                              temp_weight_in, temp_weight_out, max_boost,
                              k_dev)[0]
        vals, t_idx, j_k, b_in, b_out, in_sims = self._trim(*got)
        res = PunchQueryResult(vals, t_idx, j_k, b_in, b_out,
                               list(self.files), min_punch, in_sims)
        if exact_rerank:
            self._rerank_exact_punch(res, punch_in, punch_out,
                                     temp_weight_in, temp_weight_out,
                                     max_boost)
        if k_dev != k:
            self._fit_punch_cols(res, k)
        return res

    def _fit_punch_cols(self, res: PunchQueryResult, k: int) -> None:
        """Trim/pad every punch result array to exactly ``k`` columns
        (see :meth:`_fit_k_cols`)."""
        for name, fill in (("sims", -np.inf), ("frames", 0),
                           ("punch_lens", 0), ("boosts_in", 1.0),
                           ("boosts_out", 1.0), ("in_sims", -np.inf)):
            arr = getattr(res, name)
            if arr is not None:
                setattr(res, name, self._fit_k_cols(arr, k, fill))

    def query_batch(self, templates: Sequence["InputTemplate"],
                    temp_weight: float = 0.5, max_boost: float = 8.0,
                    k: int = 4,
                    exact_rerank: Optional[bool] = None) -> List[QueryResult]:
        """Many punch templates against the resident database.

        Templates are bucketed by frame length; a bucket shares each files
        step's spectra (computed once when the cache is off), so Q templates
        cost one pass over the database, not Q.  Results come back in input
        order and equal the corresponding :meth:`query`."""
        self._check_template(*templates)
        reduced = self._reduced
        if exact_rerank is None:
            exact_rerank = reduced
        buckets: dict = {}
        for qi, t in enumerate(templates):
            buckets.setdefault(t.num_frames, []).append(qi)
        results: List[Optional[QueryResult]] = [None] * len(templates)
        for frames_len, idxs in sorted(buckets.items()):
            k_dev = self._inflated_k(k, frames_len) \
                if (exact_rerank and reduced) else k
            k_dev = self._k_clamp(k_dev, frames_len)
            if k_dev == 0:
                for qi in idxs:
                    results[qi] = self._masked_query_result(k)
                continue
            group = [templates[qi] for qi in idxs]
            outs = self._query_all(group, temp_weight, max_boost, k_dev)
            for q, qi in enumerate(idxs):
                vals, idx, boosts = self._trim(*outs[q])
                res = QueryResult(vals, idx, list(self.files), boosts)
                if exact_rerank:
                    self._rerank_exact(res, group[q], temp_weight, max_boost)
                if k_dev != k:
                    res.sims = self._fit_k_cols(res.sims, k, -np.inf)
                    res.frames = self._fit_k_cols(res.frames, k, 0)
                    if res.boosts is not None:
                        res.boosts = self._fit_k_cols(res.boosts, k, 1.0)
                results[qi] = res
        return results

    def query_punch_batch(self, pairs: Sequence[tuple],
                          temp_weight_in: float = 0.5,
                          temp_weight_out: float = 0.5,
                          max_boost: float = 8.0, k: int = 4,
                          exact_rerank: Optional[bool] = None
                          ) -> List[PunchQueryResult]:
        """Many punch-in × punch-out searches against the resident
        database.

        ``pairs``: sequence of ``(punch_in, punch_out, min_punch,
        max_punch)`` tuples (templates are ``InputTemplate``s of the port,
        the band in feature frames).  Pairs are bucketed by ``(len_in,
        len_out)``; a bucket shares each files step's spectra.  Results come
        back in input order and each equals the corresponding
        :meth:`query_punch`."""
        reduced = self._reduced
        if exact_rerank is None:
            exact_rerank = reduced
        for q, (p_in, p_out, mp, xp) in enumerate(pairs):
            if mp > xp:
                raise ValueError(
                    f"pair {q}: min_punch {mp} > max_punch {xp}")
            self._check_template(p_in, p_out)
        buckets: dict = {}
        for q, (p_in, p_out, *_band) in enumerate(pairs):
            buckets.setdefault((p_in.num_frames, p_out.num_frames),
                               []).append(q)
        results: List[Optional[PunchQueryResult]] = [None] * len(pairs)
        for (l_in, l_out), idxs in sorted(buckets.items()):
            if self._k_clamp(1, l_in, l_out) == 0:
                for q in idxs:
                    results[q] = self._masked_punch_result(
                        k, int(pairs[q][2]))
                continue
            k_dev = self._inflated_k(k, l_in) \
                if (exact_rerank and reduced) else k
            k_dev = self._k_clamp(k_dev, l_in)
            group = [pairs[q] for q in idxs]
            outs = self._punch_all(group, temp_weight_in, temp_weight_out,
                                   max_boost, k_dev)
            for g, q in enumerate(idxs):
                p_in, p_out, mp, _xp = pairs[q]
                res = PunchQueryResult(
                    *self._trim(*outs[g][:5]), list(self.files), int(mp),
                    self._trim(outs[g][5]))
                if exact_rerank:
                    self._rerank_exact_punch(res, p_in, p_out,
                                             temp_weight_in,
                                             temp_weight_out, max_boost)
                if k_dev != k:
                    self._fit_punch_cols(res, k)
                results[q] = res
        return results

    # -- persistence ---------------------------------------------------------

    def save(self, path, progress=None, check_aborted=None,
             compresslevel=None) -> None:
        """Persist the stacked database (raw features + lengths + norm +
        file names) so serving restarts skip the per-file AIFF parsing —
        reload with :meth:`load`.  Tombstoned rows are compacted away.

        The archive is byte-compatible with ``np.savez_compressed`` and with
        the JAX package's archives (same members; ``np.load`` reads it).
        The ``raw`` member streams row by row with periodic page drops, so a
        ``raw_store="memmap"`` database saves without materializing its raw
        stack in host memory, and the write goes to a same-directory temp
        file renamed into place on success, so an abort (honored between
        rows) or crash never leaves a torn archive at ``path``.
        ``compresslevel``: 1–9, default zlib's 6."""
        import os
        import tempfile
        import zipfile
        from numpy.lib import format as npf

        progress = progress if progress is not None else (lambda f: None)
        check_aborted = check_aborted if check_aborted is not None \
            else (lambda: None)
        check_aborted()
        progress(0.0)
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"                       # np.savez semantics
        keep = [i for i, n in enumerate(self.files) if n is not None]
        small = {
            "lens": self._lens[keep],
            "norm": (self.norm if self.norm is not None
                     else np.zeros((0, 2), np.float32)),
            "files": np.array([self.files[i] for i in keep]),
            "step_size": np.asarray(self.step_size),
            "num_temporal": np.asarray(self._num_temporal),
        }
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path) or ".", suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as fh, \
                    zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED,
                                    allowZip64=True,
                                    compresslevel=compresslevel) as zf:
                with zf.open("raw.npy", "w", force_zip64=True) as f:
                    npf.write_array_header_1_0(f, {
                        "descr": npf.dtype_to_descr(self._raw.dtype),
                        "fortran_order": False,
                        "shape": (len(keep),) + self._raw.shape[1:]})
                    for j, i in enumerate(keep):
                        check_aborted()
                        f.write(np.ascontiguousarray(
                            self._raw[i]).tobytes())
                        if j % 64 == 63:
                            _drop_memmap_pages(self._raw)
                            progress(0.9 * (j + 1) / len(keep))
                _drop_memmap_pages(self._raw)
                for name, arr in small.items():
                    with zf.open(name + ".npy", "w",
                                 force_zip64=True) as f:
                        npf.write_array(f, np.asanyarray(arr),
                                        allow_pickle=False)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        progress(1.0)

    @staticmethod
    def load(path, mesh=None, **stage_kwargs) -> "FeatureDatabase":
        """Re-stage a :meth:`save`d database (from either package).
        ``stage_kwargs`` pass through to the constructor (e.g. ``device=``,
        ``cache_spectra="bf16"``, or ``progress=``/``check_aborted=`` for
        the staging observer protocol).

        With ``raw_store="memmap"`` the archive's ``raw`` member streams row
        by row straight into the unlinked temp-file store: peak host RSS
        stays O(one row + the deflate window) instead of the decompressed
        stack, the bound :meth:`save` keeps on the way out."""
        _reject_unported(mesh)
        if stage_kwargs.get("raw_store") == "memmap":
            return FeatureDatabase._load_memmap(path, stage_kwargs)
        with np.load(path, allow_pickle=False) as z:
            norm = z["norm"] if z["norm"].size else None
            # plain np.savez archives / pre-round-4 saves lack the member
            stage_kwargs.setdefault(
                "num_temporal",
                int(z["num_temporal"]) if "num_temporal" in z.files else 1)
            return FeatureDatabase(
                [str(f) for f in z["files"]], norm,
                step_size=int(z["step_size"]),
                _prestacked=(z["raw"], z["lens"]), **stage_kwargs)

    @staticmethod
    def _load_memmap(path, stage_kwargs) -> "FeatureDatabase":
        """Streamed :meth:`load` for ``raw_store="memmap"``: decompress the
        ``raw.npy`` member row by row from the zip into a fresh
        :func:`_stack_memmap` store (files-axis padding included, so the
        constructor's idempotent :func:`_pad_rows_of` adds none and adopts
        the memmap as it is; a concatenate would materialize the stack).
        Reads archives of either package and of ``np.savez_compressed``."""
        import os
        import zipfile
        from numpy.lib import format as npf

        check_aborted = stage_kwargs.get("check_aborted") or (lambda: None)
        with zipfile.ZipFile(os.fspath(path)) as zf:
            def member(name):
                with zf.open(name + ".npy") as f:
                    return npf.read_array(f, allow_pickle=False)

            lens = member("lens")
            norm = member("norm")
            files = [str(f) for f in member("files")]
            step_size = int(member("step_size"))
            # plain np.savez archives and early saves lack the member
            stage_kwargs.setdefault(
                "num_temporal",
                int(member("num_temporal"))
                if "num_temporal.npy" in zf.namelist() else 1)
            with zf.open("raw.npy") as f:
                version = npf.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = npf.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = npf.read_array_header_2_0(f)
                else:
                    raise ValueError(f"unsupported npy version {version}")
                if fortran or len(shape) != 3 or shape[0] != len(files):
                    raise ValueError(f"unexpected raw layout {shape}")
                n, C, t_cap = shape
                row_bytes = C * t_cap * dtype.itemsize

                def rows():
                    for i in range(n):
                        check_aborted()
                        buf = f.read(row_bytes)
                        if len(buf) != row_bytes:
                            raise ValueError("truncated raw member")
                        a = np.frombuffer(buf, dtype).reshape(C, t_cap)
                        yield files[i], a[:, :int(lens[i])]

                # pad_multiple=1 + time_capacity=t_cap keeps the stored
                # frame capacity exact (it already carries the save-time
                # padding)
                raw, lens_p, names = _stack_memmap(
                    rows(), 1, t_cap, _pad_rows_of,
                    check_aborted=check_aborted)
        return FeatureDatabase(
            names, norm if norm.size else None, step_size=step_size,
            _prestacked=(raw, lens_p), **stage_kwargs)

    @staticmethod
    def stage(entries, norm, observer=None, name: str = "database staging",
              **kwargs):
        """Stage a database under the full observer protocol, like the
        analysis factories: returns a started
        :class:`~strugatzki_tpu.runtime.processor.Processor` whose result
        is the :class:`FeatureDatabase`; the observer receives
        :class:`Progress` events during staging and ``abort()`` cancels
        cooperatively (the reference's processor pattern)."""
        from strugatzki_tpu.runtime.processor import Processor

        def body(proc):
            return FeatureDatabase(entries, norm,
                                   progress=proc.set_progress,
                                   check_aborted=proc.check_aborted,
                                   **kwargs)

        return Processor(body, name=name, observer=observer).start()

    @staticmethod
    def from_folder(folder: str, num_coeffs: int = 13, step_size: int = 512,
                    normalize: bool = True, mesh=None,
                    device="cuda") -> "FeatureDatabase":
        """Load every ``*_feat.xml`` entry in a database folder."""
        import os

        from strugatzki_tpu.analysis.common import load_norm, read_features

        _reject_unported(mesh)
        norm = load_norm(folder, num_coeffs) if normalize else None
        entries = []
        for name in sorted(os.listdir(folder)):
            if not name.endswith("_feat.xml"):
                continue
            meta = ExtractionConfig.from_xml_file(os.path.join(folder, name))
            if meta.num_coeffs != num_coeffs or meta.step_size != step_size:
                continue
            entries.append((meta.audio_input, read_features(meta)))
        return FeatureDatabase(entries, norm, step_size, device=device)
