"""Batched correlation and novelty sweeps over a files axis.

Port of the single-device half of ``strugatzki_tpu/parallel/sweep.py``:
the per-file sliding correlation and the per-file novelty curve run over a
leading files dimension in one batched pass (``vmap`` in the JAX package).
The mesh paths are not ported yet (ROADMAP queue 1, item 14): a ``mesh``
argument other than ``None`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels import corr as K
from ..runtime.device import resolve

__all__ = ["batched_correlation_traces", "batched_novelty_traces",
           "pad_stack"]


def reject_mesh(mesh) -> None:
    """Raise for a ``mesh``: the sharded paths are not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: the sharded multi-device paths are not ported yet "
            "(ROADMAP queue 1, item 14)")


def pad_stack(mats: Sequence[np.ndarray], pad_value: float = 0.0,
              multiple: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ``[C, T_i]`` matrices into ``[B, C, T_max]`` plus lengths."""
    t_max = max(m.shape[1] for m in mats)
    t_max = ((t_max + multiple - 1) // multiple) * multiple
    out = np.full((len(mats), mats[0].shape[0], t_max), pad_value, np.float32)
    lens = np.zeros(len(mats), np.int32)
    for i, m in enumerate(mats):
        out[i, :, :m.shape[1]] = m
        lens[i] = m.shape[1]
    return out, lens


def _batched_traces(xs_b: torch.Tensor, tmpl_t: torch.Tensor,
                    tmpl_s: torch.Tensor, a_std_t: float, a_std_s: float,
                    ln_avg: float, shifts_t: torch.Tensor, temp_weight: float,
                    max_boost: float, num_temporal: int = 1):
    """:func:`kernels.corr.correlation_trace` over the files axis.

    ``xs_b``: ``[B, C, Tp]`` prepared features; ``shifts_t``: ``[B]``
    per-file temporal shifts.  Returns ``(sims [B, W], boosts [B, W])``."""
    return K.correlation_trace(xs_b, tmpl_t, tmpl_s, a_std_t, a_std_s,
                               ln_avg, shifts_t, temp_weight, max_boost,
                               num_temporal=num_temporal)


def batched_correlation_traces(xs_b, shifts_t, template, temp_weight: float,
                               max_boost: float, device="cuda"):
    """Dense traces for a whole padded batch on ``device`` → NumPy
    ``(sims [B, W], boosts [B, W])``.  ``template`` is an
    ``analysis.correlation.InputTemplate`` of the port."""
    dev = resolve(device)
    xs = torch.as_tensor(np.asarray(xs_b), dtype=torch.float32, device=dev)
    shifts = torch.as_tensor(np.asarray(shifts_t, dtype=np.float32),
                             device=dev)
    sims, boosts = _batched_traces(
        xs, template.device_temporal(dev), template.device_spectral(dev),
        template.temporal_std, template.spectral_std,
        template.ln_avg_loudness, shifts, temp_weight, max_boost,
        num_temporal=template.num_temporal)
    return sims.cpu().numpy(), boosts.cpu().numpy()


def _batched_novelty(xs_b: torch.Tensor, half_win: int, temp_weight: float,
                     num_temporal: int = 1) -> torch.Tensor:
    """:func:`kernels.corr.novelty_trace` over a files/spans axis."""
    return K.novelty_trace(xs_b, half_win, temp_weight,
                           num_temporal=num_temporal)


def batched_novelty_traces(xs_b, half_win: int, temp_weight: float,
                           mesh=None, device="cuda") -> np.ndarray:
    """Novelty curves for a padded batch of prepared feature matrices
    ``[B, C, Tp]`` on ``device`` — the segmentation hot loop
    (FeatureSegmentationImpl.scala:107-133) batched over files/spans.  Each
    curve is independent.  Returns NumPy ``sims [B, W]``,
    ``W = Tp − 2·half_win + 1``."""
    reject_mesh(mesh)
    xs = torch.as_tensor(np.asarray(xs_b), dtype=torch.float32,
                         device=resolve(device))
    return _batched_novelty(xs, half_win, temp_weight).cpu().numpy()
