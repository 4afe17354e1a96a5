"""Structured logging and profiling hooks.

Port of ``strugatzki_tpu/runtime/logging.py``.  The reference's only
observability is per-module ``var verbose`` flags gating ``println``s
(FeatureCorrelation.scala:28).  The port keeps the ``verbose`` semantics on
every factory and adds:

* a ``strugatzki`` :mod:`logging` logger for structured events, with its
  own handler and no propagation, its level from ``STRUGATZKI_LOG``
  (a level name or number; default WARNING);
* :func:`trace` — a span timer context manager that logs at DEBUG;
* :func:`profile` — a :mod:`torch.profiler` span that writes a Chrome trace
  when ``STRUGATZKI_PROFILE`` names a directory (``jax.profiler`` in the
  JAX package).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

__all__ = ["logger", "trace", "profile"]

logger = logging.getLogger("strugatzki")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    # own handler + no propagation: embedding apps that configure the root
    # logger must not see every record twice
    logger.propagate = False
    _lvl = os.environ.get("STRUGATZKI_LOG", "WARNING").upper()
    try:
        logger.setLevel(int(_lvl) if _lvl.isdigit() else _lvl)
    except ValueError:
        logger.setLevel(logging.WARNING)
        logger.warning("STRUGATZKI_LOG=%r is not a logging level; "
                       "defaulting to WARNING", _lvl)


@contextlib.contextmanager
def trace(name: str, **fields):
    """Time a span and log it at DEBUG: ``trace('correlate', file=path)``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        logger.debug("%s took %.3fs %s", name, dt, extra)


@contextlib.contextmanager
def profile(name: str = "strugatzki"):
    """:mod:`torch.profiler` span over the host and, where CUDA is
    present, the device; writes ``<STRUGATZKI_PROFILE>/<name>.json`` (a
    Chrome trace) when ``STRUGATZKI_PROFILE`` is set to a directory path,
    otherwise a no-op."""
    out = os.environ.get("STRUGATZKI_PROFILE")
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield
    path = os.path.join(out, f"{name}.json")
    prof.export_chrome_trace(path)
    logger.debug("profile %s written to %s", name, path)
