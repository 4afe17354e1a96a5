"""Feature database statistics: the JAX package's NumPy implementation,
re-exported (it runs on the host and needs no port)."""

from strugatzki_tpu.analysis.feature_stats import FeatureStats, stats_for_file

__all__ = ["FeatureStats", "stats_for_file"]
