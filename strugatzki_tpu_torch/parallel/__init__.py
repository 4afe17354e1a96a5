"""Serving and sweeps over a files axis: the resident feature database, its
planted-match canary, and batched correlation traces."""

from .canary import format_report, run_batch_canary
from .database import FeatureDatabase, PunchQueryResult, QueryResult
from .sweep import batched_correlation_traces, pad_stack

__all__ = [
    "FeatureDatabase", "QueryResult", "PunchQueryResult",
    "run_batch_canary", "format_report",
    "batched_correlation_traces", "pad_stack",
]
