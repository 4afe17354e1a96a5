"""Database correlation search (punch-in/punch-out matcher) in PyTorch.

Port of ``strugatzki_tpu/analysis/correlation.py`` (a re-implementation of
the reference's impl/FeatureCorrelationImpl.scala).  The two sliding
correlations become batched FFT traces over 32-file chunks, each chunk
prepared on the device by the fused normalize+shift kernel
(``kernels/prep.py``); the data-dependent match selection is replayed on
the host in the reference's exact iteration order, copied verbatim from the
JAX package together with its f32 rounding points.  See the JAX module for
the divergence note on the reference's out-of-range combine reads.
"""

from __future__ import annotations

import math
import os
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from strugatzki_tpu.analysis.common import (feat_to_full, full_to_feat,
                                            load_norm, read_features)
from strugatzki_tpu.analysis.topk import SimSortedSet
from strugatzki_tpu.config import CorrelationConfig, ExtractionConfig, Match
from strugatzki_tpu.kernels import mathref as M
from strugatzki_tpu.runtime.processor import Processor, ProcessorFactory
from strugatzki_tpu.span import Span, spacing

from ..kernels import corr as K
from ..kernels.prep import prepare_database
from ..parallel.sweep import _batched_traces, pad_stack
from ..runtime.device import resolve

__all__ = ["FeatureCorrelation", "InputTemplate", "sliding_traces",
           "correlate_database"]


# Padding buckets keep chunk widths to a few shapes (copied from the JAX
# package so that shapes, and so selection, match).
_BUCKET_GROWTH = 1.25
_BUCKET_MIN = 1024

#: files per prep + trace pass
CHUNK_SIZE = 32


def _bucket(n: int) -> int:
    b = _BUCKET_MIN
    while b < n:
        b = int(math.ceil(b * _BUCKET_GROWTH))
    return b


class InputTemplate:
    """A punch template: normalized feature block with per-group statistics
    (reference ``InputMatrix``/``FeatureMatrix``, FeatureCorrelation.scala:279-289)."""

    def __init__(self, block: np.ndarray, num_temporal: int = 1) -> None:
        self.num_frames = block.shape[1]
        self.num_temporal = num_temporal
        # the RAW normalized groups, for host-exact paths
        self.temporal_block = np.asarray(block[:num_temporal],
                                         np.float32).copy()
        self.spectral_block = np.asarray(block[num_temporal:],
                                         np.float32).copy()
        self.temporal_centered, self.temporal_mean, self.temporal_std = \
            K.prepare_template(block[:num_temporal])
        self.spectral_centered, self.spectral_mean, self.spectral_std = \
            K.prepare_template(block[num_temporal:])
        # ln of the average (normalized) loudness (FeatureCorrelationImpl.scala:73)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.ln_avg_loudness = float(
                np.log(np.float64(M.avg(block[0], 0, self.num_frames))))
        self._staged: dict = {}

    def _stage(self, which: str, arr: np.ndarray, device) -> torch.Tensor:
        dev = resolve(device)
        key = (which, dev)
        t = self._staged.get(key)
        if t is None:
            t = torch.as_tensor(arr, dtype=torch.float32, device=dev)
            self._staged[key] = t
        return t

    def device_temporal(self, device) -> torch.Tensor:
        """The centered temporal group on ``device`` (staged once)."""
        return self._stage("t", self.temporal_centered, device)

    def device_spectral(self, device) -> torch.Tensor:
        """The centered spectral group on ``device`` (staged once)."""
        return self._stage("s", self.spectral_centered, device)

    @staticmethod
    def from_features(features: np.ndarray, norm: Optional[np.ndarray],
                      start: int, stop: int) -> "InputTemplate":
        """Reference ``readInBuffer`` (:83-98): slice feature frames
        ``[start, stop)``, zero-padded at EOF like a partial read, normalize,
        compute stats."""
        if start < 0:
            raise ValueError(f"punch span starts before the file "
                             f"(feature frame {start})")
        frame_num = stop - start
        block = np.zeros((features.shape[0], frame_num), np.float32)
        avail = features[:, start:min(stop, features.shape[1])]
        block[:, :avail.shape[1]] = avail
        M.normalize(norm, block, 0, frame_num)
        return InputTemplate(block)


def sliding_traces(xs_shifted: np.ndarray, shift_t: float, shift_s: float,
                   template: InputTemplate, scan_len: int,
                   temp_weight: float, max_boost: float, device="cuda"):
    """(sim, boost) for windows ``t = 0 .. scan_len − L`` (or the single
    zero-padded window when ``scan_len < L``) of a prepared feature matrix.

    ``xs_shifted``: group-shifted normalized features (``shift_per_group``),
    full file.  ``scan_len`` is the reference's initial ``left`` (numFrames,
    minus minPunch in punch-out mode, FeatureCorrelationImpl.scala:182-184).
    """
    dev = resolve(device)
    L = template.num_frames
    if scan_len <= 0:
        empty = np.zeros(0, np.float32)
        return empty, empty
    num_windows = scan_len - L + 1 if scan_len >= L else 1

    pad_to = _bucket(num_windows - 1 + L)
    # never read past scan_len: in the scan_len < L single-window case the
    # reference correlates scan_len real frames + a zero tail
    xs = xs_shifted[:, :min(scan_len, num_windows - 1 + L)]
    if xs.shape[1] < pad_to:
        # padding represents literal zeros of the reference's freshly
        # allocated buffer (normalized space), i.e. −shift in shifted space
        pad = np.zeros((xs.shape[0], pad_to - xs.shape[1]), np.float32)
        pad[:template.num_temporal] = -shift_t
        pad[template.num_temporal:] = -shift_s
        xs = np.concatenate([xs, pad], axis=1)

    sims, boosts = K.correlation_trace(
        torch.as_tensor(xs, dtype=torch.float32, device=dev),
        template.device_temporal(dev), template.device_spectral(dev),
        template.temporal_std, template.spectral_std,
        template.ln_avg_loudness, shift_t, temp_weight, max_boost,
        num_temporal=template.num_temporal)
    return (sims[:num_windows].cpu().numpy().copy(),
            boosts[:num_windows].cpu().numpy().copy())


def _single_window_trace(avail: np.ndarray, norm, template: InputTemplate,
                         temp_weight: float, max_boost: float):
    """(sim, boost) arrays for ONE zero-tailed window: ``avail`` holds the
    frames the reference actually reads; the rest of the window is the
    freshly-allocated buffer's zeros (normalized space)."""
    L = template.num_frames
    win = np.zeros((avail.shape[0], L), np.float32)
    win[:, :avail.shape[1]] = avail
    M.normalize(norm, win, 0, avail.shape[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        boost = np.float32(np.exp(
            (template.ln_avg_loudness
             - np.log(np.float64(M.avg(win[0], 0, L)))) / 0.6))
    if boost <= max_boost:
        nt = template.num_temporal
        sim_t = np.float32(0.0)
        sim_s = np.float32(0.0)
        if temp_weight > 0:
            bm, bs = M.stat(win, 0, L, 0, nt)
            sim_t = M.correlate(
                template.temporal_block,
                template.temporal_mean, template.temporal_std, L, nt,
                win, bm, bs, 0, 0)
        if temp_weight < 1:
            bm, bs = M.stat(win, 0, L, nt, win.shape[0] - nt)
            sim_s = M.correlate(
                template.spectral_block,
                template.spectral_mean, template.spectral_std, L,
                win.shape[0] - nt, win, bm, bs, 0, nt)
        sim = np.float32(sim_t * np.float32(temp_weight)
                         + sim_s * np.float32(1 - temp_weight))
    else:
        sim = np.float32(0.0)
    return (np.array([sim], np.float32), np.array([boost], np.float32))


def correlate_database(meta_in: ExtractionConfig, db_entries, norm,
                       config: CorrelationConfig,
                       check_aborted=lambda: None,
                       progress=lambda f: None,
                       verbose: bool = False,
                       skip_nan: bool = False,
                       device="cuda") -> List[Match]:
    """Run the full search on ``device``.  ``db_entries`` is a list of
    ``(ExtractionConfig, features_loader)`` pairs.

    ``skip_nan`` (off by default, as in the reference) keeps NaN
    similarity candidates out instead of letting them rank first and
    poison the ``inSim > low²`` gate (see the JAX package)."""
    dev = resolve(device)
    cfg = config
    step = meta_in.step_size

    f2f = lambda n: full_to_feat(n, step)
    t2f = lambda i: feat_to_full(i, step)

    # --- input templates (reference :80-107) --------------------------------
    in_feats = read_features(meta_in)
    pi = cfg.punch_in
    matrix_in = InputTemplate.from_features(
        in_feats, norm, f2f(pi.span.start), f2f(pi.span.stop))
    matrix_out = None
    if cfg.punch_out is not None:
        po = cfg.punch_out
        matrix_out = InputTemplate.from_features(
            in_feats, norm, f2f(po.span.start), f2f(po.span.stop))

    punch_in_len = matrix_in.num_frames
    punch_out_len = matrix_out.num_frames if matrix_out else 0
    in_temp_weight = pi.temporal_weight
    min_punch = f2f(cfg.min_punch)
    max_punch = f2f(cfg.max_punch)

    all_prio: SimSortedSet[Match] = SimSortedSet(descending=True)

    # --- chunked batched traces ---------------------------------------------
    # Both punch traces are computed over EVERY window start of every file
    # (the replay slices the per-file valid prefixes), so whole chunks go
    # through one prep kernel + one batched FFT-trace pass each, ahead of
    # the sequential host replay.
    chunk_size = CHUNK_SIZE

    def _trace_batch(xs_dev, shifts_dev, template: InputTemplate,
                     temp_weight: float):
        return _batched_traces(
            xs_dev, template.device_temporal(dev),
            template.device_spectral(dev), template.temporal_std,
            template.spectral_std, template.ln_avg_loudness, shifts_dev,
            temp_weight, cfg.max_boost)

    def dispatch_chunk(chunk_entries):
        """Host prep + device launch of one chunk's traces; the fetch
        happens in :func:`collect_chunk`, so the NEXT chunk's device work
        is queued while the host replays the current one."""
        if not chunk_entries:
            return None
        feats_list = [load() for _, load in chunk_entries]
        lens = [f.shape[1] for f in feats_list]
        # pad the batch to a fixed chunk size and bucketed width (the JAX
        # package's shapes: selection then sees the same traces)
        while len(feats_list) < chunk_size:
            feats_list.append(np.zeros((feats_list[0].shape[0], 1), np.float32))
            lens.append(0)
        raw, lens_arr = pad_stack(feats_list)
        # the device width must cover the TEMPLATE too: a chunk whose files
        # are all shorter than the punch would otherwise feed the trace a
        # Tp < L input
        t_pad = _bucket(max(raw.shape[2], punch_in_len, punch_out_len))
        if raw.shape[2] < t_pad:
            raw = np.pad(raw, ((0, 0), (0, 0), (0, t_pad - raw.shape[2])))
        if verbose:
            import sys as _sys
            print(f"  chunk: {len(chunk_entries)} files dispatched "
                  f"(device width {t_pad})", file=_sys.stderr)
        xs_dev, shifts_dev = prepare_database(raw, norm, lens_arr, device=dev)
        in_b = _trace_batch(xs_dev, shifts_dev, matrix_in, in_temp_weight)
        out_b = None
        if matrix_out is not None:
            out_b = _trace_batch(xs_dev, shifts_dev, matrix_out,
                                 cfg.punch_out.temporal_weight)
        return (chunk_entries, feats_list, lens, in_b, out_b)

    def collect_chunk(pending_chunk):
        chunk_entries, feats_list, lens, in_b, out_b = pending_chunk
        # fetch once per chunk; slice per-file valid prefixes
        sims_in_b = in_b[0].cpu().numpy()
        boosts_in_b = in_b[1].cpu().numpy()
        if out_b is not None:
            sims_out_b = out_b[0].cpu().numpy()
            boosts_out_b = out_b[1].cpu().numpy()
        items = []
        scan_delta = min_punch if matrix_out is not None else 0
        for i, (entry, t_i) in enumerate(zip(chunk_entries, lens)):
            scan = t_i - scan_delta
            w_in = scan - punch_in_len + 1 if scan >= punch_in_len \
                else (1 if scan > 0 else 0)
            h_in = (sims_in_b[i, :w_in].copy(), boosts_in_b[i, :w_in].copy())
            if matrix_out is not None and 0 < scan < punch_in_len:
                # reference edge case: the punch-in loop reads only `scan`
                # frames even though the file holds more
                # (FeatureCorrelationImpl.scala:183-195); recompute the
                # single window host-side with the buffer's zero tail
                h_in = _single_window_trace(
                    feats_list[i][:, :scan], norm, matrix_in,
                    in_temp_weight, cfg.max_boost)
            h_out = None
            if matrix_out is not None:
                w_outv = max(t_i - punch_out_len + 1, 0)
                h_out = (sims_out_b[i, :w_outv].copy(),
                         boosts_out_b[i, :w_outv].copy())
            items.append((entry[0], t_i, h_in, h_out))
        return items

    queue = deque()
    entries_list = list(db_entries)
    chunk_iter = (entries_list[o:o + chunk_size]
                  for o in range(0, len(entries_list), chunk_size))
    pending = dispatch_chunk(next(chunk_iter, None))

    def refill():
        # launch chunk k+1 BEFORE fetching chunk k
        nonlocal pending
        if not queue and pending is not None:
            cur = pending
            pending = dispatch_chunk(next(chunk_iter, None))
            queue.extend(collect_chunk(cur))

    refill()
    idx = -1
    while queue:
        idx += 1
        check_aborted()
        extr_db, num_frames, h_in, h_out = queue.popleft()
        refill()

        entry_prio: SimSortedSet[Match] = SimSortedSet(descending=True)
        last_entry_match: Optional[Match] = None

        def entry_has_space() -> bool:
            max_sz = min(cfg.num_matches - len(all_prio), cfg.num_per_file)
            return len(entry_prio) < max_sz

        def lowest_sim() -> float:
            if len(entry_prio):
                return entry_prio.last_sim
            if len(all_prio):
                return all_prio.last_sim
            return 0.0

        def add_match(m: Match) -> None:
            nonlocal last_entry_match
            if (last_entry_match is not None
                    and spacing(m.punch, last_entry_match.punch) < cfg.min_spacing):
                if last_entry_match.sim < m.sim:
                    entry_prio.remove_sim(last_entry_match.sim)
                    entry_prio.add(m.sim, m)
                    last_entry_match = m
            else:
                entry_prio.add(m.sim, m)
                if len(entry_prio) > cfg.num_per_file:
                    entry_prio.drop_last()
                last_entry_match = m

        sims_in, boosts_in = h_in
        check_aborted()

        if matrix_out is None:
            # matches added inline during the punch-in scan (:233-240).
            # While the entry queue is full, `lowestSim` is non-decreasing,
            # so windows failing `sim > low` can be skipped with a vector
            # scan — identical selection, not O(W) Python steps.
            w_in = len(sims_in)
            t = 0
            while t < w_in:
                if entry_has_space():
                    sim = float(sims_in[t])
                elif sims_in[t] > (low := lowest_sim()):
                    sim = float(sims_in[t])   # scalar fast path: no O(W) scan
                else:
                    rel = int(np.argmax(sims_in[t:] > low))
                    sim = float(sims_in[t + rel])
                    if not sim > low:
                        break  # no further candidate in this file
                    t += rel
                if not (skip_nan and math.isnan(sim)):
                    if entry_has_space() or sim > lowest_sim():
                        add_match(Match(sim, extr_db.audio_input,
                                        Span(t2f(t), t2f(t + punch_in_len)),
                                        float(boosts_in[t]), 1.0))
                t += 1
        else:
            # trace-open gate (:213-223): hs/lowestSim are constant during the
            # punch-in scan (no matches are added until the combine pass)
            if entry_has_space():
                t_in_off = 0
            else:
                low0 = lowest_sim()
                above = np.nonzero(sims_in > low0)[0]
                t_in_off = int(above[0]) if above.size else -1

            if t_in_off >= 0 and len(sims_in) > t_in_off:
                tin_sims = sims_in[t_in_off:]

                po_off0 = t_in_off + min_punch
                t_out_size = num_frames - po_off0
                if t_out_size >= punch_out_len:
                    # the prefetched punch-out trace covers EVERY window
                    # start of the file; the reference's tout index j maps
                    # to full index poOff0 + j (:273-315)
                    tout_full, tout_boosts_full = h_out
                    check_aborted()

                    w_out = len(tout_full) - po_off0
                    scan_span = max_punch - min_punch + 1
                    n_in = len(tin_sims)
                    i = 0
                    while i < n_in:
                        low = lowest_sim()
                        hs = entry_has_space()
                        # skip piOffs failing the inSim > low² gate with a
                        # vector scan — no state changes at skipped
                        # positions, so the replay is exact (:342).  low² is
                        # a Java Float multiply: round to f32 (the f64
                        # product can sit 1 ulp away and flip the gate)
                        low2 = np.float32(low * low)
                        if not tin_sims[i] > low2:   # scalar-first: the
                            # suffix scan is O(n) and runs per candidate
                            rel = int(np.argmax(tin_sims[i:] > low2))
                            if not tin_sims[i + rel] > low2:
                                break
                            i += rel
                        in_sim = float(tin_sims[i])
                        boost_in = float(boosts_in[t_in_off + i])
                        seek = i
                        n2 = min(t_out_size - seek, scan_span, w_out - seek)
                        if n2 > 0:
                            base = po_off0 + seek
                            seg = tout_full[base:base + n2]
                            with np.errstate(invalid="ignore"):
                                # NaN for negative products is the
                                # reference's own behavior (:370)
                                sims_c = np.sqrt(
                                    np.float32(in_sim) * seg).astype(np.float32)
                            pi_off = t_in_off + i
                            k = 0
                            while k < n2:
                                if not hs and not sims_c[k] > low:
                                    # jump to the next candidate above `low`
                                    rel = int(np.argmax(sims_c[k:] > low))
                                    if not sims_c[k + rel] > low:
                                        break
                                    k += rel
                                sim = float(sims_c[k])
                                if skip_nan and math.isnan(sim):
                                    k += 1
                                    continue
                                if hs or sim > low:
                                    add_match(Match(
                                        sim, extr_db.audio_input,
                                        Span(t2f(pi_off),
                                             t2f(pi_off + min_punch + k)),
                                        boost_in,
                                        float(tout_boosts_full[base + k])))
                                    low = lowest_sim()
                                    hs = entry_has_space()
                                k += 1
                        i += 1
                        if i % 8192 == 0:
                            check_aborted()

        # merge entry results (:399-400)
        all_prio.update(entry_prio)
        all_prio.truncate(cfg.num_matches)
        progress((idx + 1) / max(len(entries_list), 1))

    return all_prio.items()


class FeatureCorrelation(ProcessorFactory):
    """``FeatureCorrelation.run(config, observer) -> Processor[list[Match]]``."""

    name = "correlation"
    Config = CorrelationConfig
    #: extension: reject NaN similarities instead of the reference's
    #: NaN-ranks-first-and-poisons-gates behavior (see correlate_database)
    skip_nan = False
    #: the device the search runs on (process state, not config)
    device = "cuda"

    @classmethod
    def _make_body(cls, config: CorrelationConfig):
        cfg = config.build()
        device = cls.device

        def body(proc: Processor):
            meta_in = ExtractionConfig.from_xml_file(cfg.meta_input)
            step = meta_in.step_size

            # scan database folder (:42-55)
            folder = cfg.database_folder
            meta_abs = os.path.abspath(cfg.meta_input)
            names = sorted(n for n in os.listdir(folder)
                           if n.endswith("_feat.xml"))
            paths = [os.path.join(folder, n) for n in names]
            paths = [p for p in paths if os.path.abspath(p) != meta_abs]
            if cls.verbose:
                print(f"Number of files in database : {len(paths)}")

            entries = []
            for p in paths:
                e = ExtractionConfig.from_xml_file(p)
                if (e.num_coeffs == meta_in.num_coeffs
                        and e.step_size == step):
                    entries.append(
                        (e, (lambda e_=e: read_features(e_))))
            if cls.verbose:
                print(f"Number of compatible files in database : {len(entries)}")

            norm = load_norm(folder, meta_in.num_coeffs) if cfg.normalize else None

            return correlate_database(
                meta_in, entries, norm, cfg,
                check_aborted=proc.check_aborted,
                progress=proc.set_progress,
                verbose=cls.verbose,
                skip_nan=cls.skip_nan, device=device)

        return body
