"""Shared analysis helpers: frame mapping, norm-file loading, feature prep."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import NORMALIZE_NAME, ExtractionConfig
from ..io import audiofile as af
from ..kernels import mathref

__all__ = ["full_to_feat", "feat_to_full", "load_norm", "read_features",
           "normalized", "FeatureSource"]


def full_to_feat(n: int, step_size: int) -> int:
    """Audio frame → feature frame: ``(n + step/2) / step`` (round-to-nearest,
    reference FeatureCorrelationImpl.scala:38).  Java long division truncates
    toward zero, so negative positions map like the JVM (−744/512 = −1, not
    Python floor's −2)."""
    q = int(n) + (step_size >> 1)
    return q // step_size if q >= 0 else -((-q) // step_size)


def feat_to_full(i: int, step_size: int) -> int:
    """Feature frame → audio frame (reference FeatureCorrelationImpl.scala:39)."""
    return int(i) * step_size


def load_norm(database_folder: str, num_coeffs: int) -> np.ndarray:
    """Load ``feat_norms.aif`` → ``[numCoeffs+1, 2]`` (min, max) rows.

    Requires exactly ``numCoeffs + 1`` channels × 2 frames
    (reference FeatureCorrelationImpl.scala:61-71).
    """
    path = os.path.join(database_folder, NORMALIZE_NAME)
    data, spec = af.read(path)
    if spec.num_channels != num_coeffs + 1 or spec.num_frames != 2:
        raise ValueError(
            f"norm file {path}: expected {num_coeffs + 1} channels x 2 frames, "
            f"got {spec.num_channels} x {spec.num_frames}")
    return data  # [C, 2]


def read_features(meta: ExtractionConfig) -> np.ndarray:
    """Read the full feature matrix referenced by a meta sidecar → [C, T]."""
    data, _spec = af.read(meta.feature_output)
    return data


def normalized(features: np.ndarray, norm: Optional[np.ndarray]) -> np.ndarray:
    """Copy of ``features`` normalized per channel (no-op when ``norm`` is
    None), mirroring MathUtil.normalize semantics including unclipped values
    and inf/NaN on degenerate ranges."""
    out = features.astype(np.float32).copy()
    mathref.normalize(norm, out, 0, out.shape[1])
    return out


class FeatureSource:
    """A meta sidecar + its feature matrix, lazily loaded."""

    def __init__(self, meta_path: str) -> None:
        self.meta_path = os.fspath(meta_path)
        self.meta = ExtractionConfig.from_xml_file(self.meta_path)
        self._features: Optional[np.ndarray] = None

    @property
    def step_size(self) -> int:
        return self.meta.step_size

    @property
    def features(self) -> np.ndarray:
        if self._features is None:
            self._features = read_features(self.meta)
        return self._features
