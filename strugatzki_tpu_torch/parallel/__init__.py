"""Serving and sweeps over a files axis: the resident feature database (on
one device or sharded over a files mesh), its planted-match canary, batched
and sharded correlation and novelty traces, sequence-parallel long-file
paths, and multi-process groups."""

from .canary import format_report, run_batch_canary
from .database import FeatureDatabase, PunchQueryResult, QueryResult
from .multihost import global_files_mesh, initialize, process_allgather
from .sweep import (FilesMesh, batched_correlation_traces,
                    batched_novelty_traces, env_mesh, make_files_mesh,
                    pad_stack, sharded_extract_long, sharded_long_file_trace,
                    sharded_long_novelty_trace, sharded_sweep_step)

__all__ = [
    "FeatureDatabase", "QueryResult", "PunchQueryResult",
    "run_batch_canary", "format_report",
    "FilesMesh", "make_files_mesh", "env_mesh", "global_files_mesh",
    "initialize", "process_allgather",
    "batched_correlation_traces", "batched_novelty_traces",
    "sharded_sweep_step", "pad_stack",
    "sharded_long_file_trace", "sharded_long_novelty_trace",
    "sharded_extract_long",
]
