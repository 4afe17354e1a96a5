"""strugatzki_tpu_torch — the PyTorch/CUDA port of strugatzki_tpu.

The port runs the README's quick-start path on a :class:`torch.device`:
feature extraction (``-f``), database statistics (``--stats``) and the
punch-in/punch-out correlation search (``-c``), and the resident
``FeatureDatabase`` serving layer.  The database preparation
kernel is hand-written CUDA for Hopper (``csrc/prep.cu``); the rest is plain
PyTorch.  Configs, XML sidecars, feature files and match selection are the
JAX package's own host-only modules, so both packages read and write the
same artifacts.  The package imports torch, never jax.
"""

from strugatzki_tpu.config import (NORMALIZE_NAME, ChannelsBehavior,
                                   CorrelationConfig, ExtractionConfig, Match,
                                   Punch)
from strugatzki_tpu.runtime.processor import Aborted, Processor, Progress, Result
from strugatzki_tpu.span import Span

__version__ = "0.1.0"

__all__ = [
    "NORMALIZE_NAME", "Span", "Punch", "Match", "ChannelsBehavior",
    "ExtractionConfig", "CorrelationConfig",
    "Aborted", "Processor", "Progress", "Result",
    "FeatureExtraction", "FeatureCorrelation", "FeatureStats",
    "FeatureDatabase",
    "extract_features", "prepare_database",
]


def __getattr__(name):
    # Lazy imports: keep config/XML usable without importing torch's
    # compute modules.
    if name == "FeatureExtraction":
        from .analysis.extraction import FeatureExtraction
        return FeatureExtraction
    if name == "FeatureCorrelation":
        from .analysis.correlation import FeatureCorrelation
        return FeatureCorrelation
    if name == "FeatureStats":
        from .analysis.feature_stats import FeatureStats
        return FeatureStats
    if name == "FeatureDatabase":
        from .parallel.database import FeatureDatabase
        return FeatureDatabase
    if name == "extract_features":
        from .dsp.frontend import extract_features
        return extract_features
    if name == "prepare_database":
        from .kernels.prep import prepare_database
        return prepare_database
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
