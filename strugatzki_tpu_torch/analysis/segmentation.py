"""Novelty-based segmentation in PyTorch.

Port of ``strugatzki_tpu/analysis/segmentation.py`` (a re-implementation of
the reference's impl/FeatureSegmentationImpl.scala): the sliding
half-window correlation loop becomes one dense novelty curve on the device
(``kernels/corr.py::novelty_trace``), and the break selection — bounded
sorted set, minSpacing collapse, duplicate-sim dedup — is replayed on the
host in the reference's exact iteration order, copied verbatim from the JAX
package.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..analysis.common import (FeatureSource, feat_to_full,
                               full_to_feat, load_norm,
                               normalized)
from ..analysis.topk import SimSortedSet
from ..config import Break, SegmentationConfig
from ..runtime.processor import Processor, ProcessorFactory
from ..kernels import corr as K
from ..parallel.sweep import (batched_novelty_traces,
                              sharded_long_novelty_trace)
from ..runtime.device import resolve
from .correlation import _bucket

__all__ = ["FeatureSegmentation", "segment_features",
           "segment_features_batch"]


# copied verbatim from the JAX package, whose module imports jax
def _select_breaks(sims: np.ndarray, af_start: int, half_win: int,
                   step_size: int, cfg: SegmentationConfig,
                   check_aborted=lambda: None,
                   progress=lambda f: None) -> List[Break]:
    """Host replay of the reference's break selection over a novelty curve
    (FeatureSegmentationImpl.scala:55-83, :121-124): bounded sorted set,
    minSpacing collapse, duplicate-sim dedup, in window order."""
    num_windows = len(sims)
    prio: SimSortedSet[Break] = SimSortedSet(descending=False)
    last_break: Break = None

    def add_break(b: Break) -> None:
        nonlocal last_break
        if last_break is not None and (b.pos - last_break.pos) < cfg.min_spacing:
            if last_break.sim > b.sim:
                prio.remove_sim(last_break.sim)
                prio.add(b.sim, b)
                last_break = b
        else:
            prio.add(b.sim, b)
            if len(prio) > cfg.num_breaks:
                prio.drop_last()
            last_break = b

    for t in range(num_windows):
        sim = float(sims[t])
        if len(prio) < cfg.num_breaks or sim < (prio.last_sim if len(prio) else 0.0):
            pos = feat_to_full(af_start + t + half_win, step_size)
            add_break(Break(sim, pos))
        if t % 4096 == 0:
            check_aborted()
            # reference quirk: progress DECREASES (left/afLen,
            # FeatureSegmentationImpl.scala:132); we report increasing done
            progress((t + 1) / num_windows)
    progress(1.0)
    return prio.items()


def _novelty_prep(features: np.ndarray, norm, step_size: int,
                  cfg: SegmentationConfig):
    """Span/window/pad prep of the novelty input: returns ``(xs,
    num_windows, af_start, half_win)`` or ``None`` for an empty span.

    The op order is the JAX package's: the span is normalized, zero-padded
    to the bucketed width, and only then group-shifted, so the shift means
    include the padded zeros (shifting first changes every sim at the f32
    level)."""
    num_frames = features.shape[1]
    af_start = max(0, full_to_feat(cfg.span.start, step_size)) \
        if cfg.span.has_start else 0
    af_stop = min(num_frames, full_to_feat(cfg.span.stop, step_size)) \
        if cfg.span.has_stop else num_frames
    af_len = af_stop - af_start
    half_win = full_to_feat(cfg.corr_len, step_size)
    win_len = half_win * 2
    if af_len <= 0 or half_win <= 0:
        return None
    # number of window evaluations: the reference's ring loop consumes
    # winLen frames up-front then 1/step (FeatureSegmentationImpl.scala:101-129)
    num_windows = af_len - win_len + 1 if af_len >= win_len else 1
    # normalized span data, zero-padded like the reference's freshly-
    # allocated buffer when afLen < winLen, then group-shifted
    xs = normalized(features[:, af_start:af_stop], norm)
    pad_to = _bucket((num_windows - 1) + win_len)
    if xs.shape[1] < pad_to:
        xs = np.pad(xs, ((0, 0), (0, pad_to - xs.shape[1])))
    xs, _, _ = K.shift_per_group(xs)
    return xs, num_windows, af_start, half_win


def segment_features_batch(feature_mats, norm, step_size: int,
                           config: SegmentationConfig, mesh=None,
                           check_aborted=lambda: None,
                           progress=lambda f: None,
                           device="cuda") -> List[List[Break]]:
    """Segment many files/spans in one batched novelty pass on ``device``.

    All inputs share ``config``; each entry is a ``[C, T]`` feature matrix.
    Curves are padded to one common bucketed width; the break-selection
    replay then runs per file on the host, identical to
    :func:`segment_features` up to the batch's shared FFT plan (break
    positions match; sims within the 2e-5 plan budget).  ``mesh`` shards
    the batch over its devices (which it then decides)."""
    mats = [np.asarray(f, np.float32) for f in feature_mats]
    if mats and any(m.shape[0] != mats[0].shape[0] for m in mats):
        raise ValueError(
            "channel count mismatch across the batch: "
            f"{sorted({m.shape[0] for m in mats})}")
    preps = [_novelty_prep(f, norm, step_size, config) for f in mats]
    live = [(i, p) for i, p in enumerate(preps) if p is not None]
    results: List[List[Break]] = [[] for _ in mats]
    if not live:
        return results
    half_win = live[0][1][3]
    pad_to = max(p[0].shape[1] for _, p in live)
    xs_b = np.zeros((len(live), live[0][1][0].shape[0], pad_to),
                    np.float32)
    for j, (_, (xs, _nw, _a, _h)) in enumerate(live):
        xs_b[j, :, :xs.shape[1]] = xs
    check_aborted()
    sims_b = batched_novelty_traces(xs_b, half_win, config.temporal_weight,
                                    mesh=mesh, device=device)
    for j, (i, (_xs, num_windows, af_start, _h)) in enumerate(live):
        check_aborted()
        results[i] = _select_breaks(
            sims_b[j][:num_windows], af_start, half_win, step_size, config,
            check_aborted=check_aborted)
        progress((j + 1) / len(live))
    return results


def segment_features(features: np.ndarray, norm, step_size: int,
                     config: SegmentationConfig, mesh=None,
                     check_aborted=lambda: None,
                     progress=lambda f: None, device="cuda") -> List[Break]:
    """Core segmentation on an in-memory feature matrix ``[C, T]``, with
    the novelty curve computed on ``device``.

    With ``mesh`` (and enough windows to give every shard at least one) the
    curve is computed time-sharded over the mesh's devices
    (:func:`~..parallel.sweep.sharded_long_novelty_trace`): its sims carry
    the plan budget against the single-device curve, so break positions
    match while near-tie sims could reorder at ~1e-7."""
    prep = _novelty_prep(features, norm, step_size, config)
    if prep is None:
        return []
    xs, num_windows, af_start, half_win = prep
    check_aborted()
    if mesh is not None and num_windows >= mesh.size:
        # the whole-file bucket's tail goes: the sharded path re-buckets at
        # the (much smaller) per-shard slab width
        sims = sharded_long_novelty_trace(
            xs[:, :num_windows - 1 + 2 * half_win], half_win,
            config.temporal_weight, mesh)
    else:
        dev = resolve(device if mesh is None else mesh.devices[0])
        sims = K.novelty_trace(torch.as_tensor(xs, device=dev), half_win,
                               config.temporal_weight)
        sims = sims[:num_windows].cpu().numpy()
    check_aborted()
    return _select_breaks(sims, af_start, half_win, step_size, config,
                          check_aborted=check_aborted, progress=progress)


class FeatureSegmentation(ProcessorFactory):
    """``FeatureSegmentation.run(config, observer) -> Processor[list[Break]]``."""

    name = "segmentation"
    Config = SegmentationConfig
    #: the device the novelty curve runs on (process state, not config)
    device = "cuda"
    #: a :class:`~..parallel.sweep.FilesMesh` to time-shard the novelty
    #: curve over (process state, not config); it decides the devices
    mesh = None

    @classmethod
    def _make_body(cls, config: SegmentationConfig):
        cfg = config.build()
        device = cls.device
        mesh = cls.mesh

        def body(proc: Processor):
            src = FeatureSource(cfg.meta_input)
            norm = load_norm(cfg.database_folder, src.meta.num_coeffs) \
                if cfg.normalize else None
            return segment_features(
                src.features, norm, src.step_size, cfg, mesh=mesh,
                check_aborted=proc.check_aborted,
                progress=proc.set_progress, device=device)

        return body
