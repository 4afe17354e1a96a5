"""strugatzki_tpu_torch — the PyTorch/CUDA port of strugatzki_tpu.

The port runs the six analyses on a :class:`torch.device`: feature
extraction (``-f``), database statistics (``--stats``), the
punch-in/punch-out correlation search (``-c``), novelty segmentation
(``-s``), the self-similarity image (``-x``) and the cross-similarity vector
(``-y``), plus the resident ``FeatureDatabase`` serving layer, all on one
device.  The database preparation kernel is hand-written CUDA for Hopper
(``csrc/prep.cu``); the rest is plain PyTorch.  Configs, XML sidecars,
feature files and the host selection replays are the JAX package's own
host-only modules or verbatim copies, so both packages read and write the
same artifacts.  The package imports torch, never jax.
"""

from strugatzki_tpu.config import (NORMALIZE_NAME, Break, ChannelsBehavior,
                                   ColorScheme, CorrelationConfig,
                                   CrossSimilarityConfig, ExtractionConfig,
                                   Match, Punch, SegmentationConfig,
                                   SelfSimilarityConfig)
from strugatzki_tpu.runtime.processor import Aborted, Processor, Progress, Result
from strugatzki_tpu.span import Span

__version__ = "0.1.0"

__all__ = [
    "NORMALIZE_NAME", "Span", "Punch", "Match", "Break",
    "ChannelsBehavior", "ColorScheme",
    "ExtractionConfig", "CorrelationConfig", "SegmentationConfig",
    "SelfSimilarityConfig", "CrossSimilarityConfig",
    "Aborted", "Processor", "Progress", "Result",
    "FeatureExtraction", "FeatureCorrelation", "FeatureSegmentation",
    "SelfSimilarity", "CrossSimilarity", "FeatureStats",
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
    if name == "FeatureSegmentation":
        from .analysis.segmentation import FeatureSegmentation
        return FeatureSegmentation
    if name == "SelfSimilarity":
        from .analysis.self_similarity import SelfSimilarity
        return SelfSimilarity
    if name == "CrossSimilarity":
        from .analysis.cross_similarity import CrossSimilarity
        return CrossSimilarity
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
