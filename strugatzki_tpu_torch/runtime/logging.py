"""Structured logging, the port's span and counter recorder, and profiling.

Port of ``strugatzki_tpu/runtime/logging.py``.  The reference's only
observability is per-module ``var verbose`` flags gating ``println``s
(FeatureCorrelation.scala:28).  The port keeps the ``verbose`` semantics on
every factory and adds:

* a ``strugatzki`` :mod:`logging` logger for structured events, with its
  own handler and no propagation, its level from ``STRUGATZKI_LOG``
  (a level name or number; default WARNING);
* :func:`trace` — a span at a layer boundary (:func:`traced` makes a
  whole call one), :func:`count` — a counter,
  and :func:`snapshot` / :func:`records` / :func:`reset` to read and clear
  what they recorded (below);
* :func:`profile` — a :mod:`torch.profiler` span that writes a Chrome trace
  when ``STRUGATZKI_PROFILE`` names a directory (``jax.profiler`` in the
  JAX package).

**The recorder** is on while a :mod:`torch.profiler` session records
anywhere in the process, or while the logger is enabled for DEBUG; off,
``trace`` and ``count`` cost one check.  On, a span is a
``record_function("strugatzki.<name>")`` (which places it on the device
trace's clock), logs ``"<name> took <s>s <fields>"`` at DEBUG, and keeps a
record: name, id, parent id, request id (the id of its outermost span),
thread, and start and end on :func:`time.perf_counter`.  The parent is the
span open in the current :mod:`contextvars` context, which a
:class:`~.processor.Processor` thread inherits from the thread that started
it.  The newest :data:`RING` records are kept; per name, the count, the
total seconds and the self seconds (the span's duration less the union of
its children's intervals) grow with the number of names only.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import logging
import os
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _autograd_profiler

__all__ = ["logger", "trace", "traced", "count", "snapshot", "records",
           "reset", "profile", "SpanRecord", "RING"]

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

#: span records kept (the newest)
RING = 65_536
#: the prefix of a span's ``record_function`` event
PREFIX = "strugatzki."


class SpanRecord(NamedTuple):
    """One closed span; ``parent`` is 0 for a root, ``request`` the id of
    its root; ``start``/``end`` are :func:`time.perf_counter` seconds."""

    name: str
    id: int
    parent: int
    request: int
    thread: int
    start: float
    end: float


class _Recorder:
    """What the spans and counters recorded, behind one lock."""

    def __init__(self, capacity: int = RING) -> None:
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._spans: dict = {}          # name → [count, total s, self s]
        self._counters: dict = {}

    def close(self, rec: SpanRecord, self_s: float) -> None:
        with self._lock:
            self._ring.append(rec)
            agg = self._spans.get(rec.name)
            if agg is None:
                agg = self._spans[rec.name] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += rec.end - rec.start
            agg[2] += self_s

    def count(self, name: str, n) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return {"spans": {k: {"count": c, "total_s": t, "self_s": s}
                              for k, (c, t, s) in self._spans.items()},
                    "counters": dict(self._counters)}

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._spans.clear()
            self._counters.clear()


_RECORDER = _Recorder()
_IDS = itertools.count(1)
#: the innermost open span of the current context
_OPEN: contextvars.ContextVar = contextvars.ContextVar("strugatzki_span",
                                                       default=None)


def _covered(intervals, t0: float, t1: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[t0, t1]``."""
    total, end = 0.0, t0
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return total


class _Span:
    __slots__ = ("name", "fields", "fn", "parent", "id", "request",
                 "children", "token", "t0")

    def __init__(self, name: str, fields: dict) -> None:
        self.name = name
        self.fields = fields

    def __enter__(self) -> None:
        self.fn = _autograd_profiler.record_function(PREFIX + self.name)
        self.fn.__enter__()
        self.parent = _OPEN.get()
        self.id = next(_IDS)
        self.request = self.id if self.parent is None else self.parent.request
        self.children = []
        self.token = _OPEN.set(self)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        _OPEN.reset(self.token)
        self.fn.__exit__(*exc)
        parent = self.parent
        if parent is not None:
            parent.children.append((self.t0, t1))
        _RECORDER.close(SpanRecord(
            self.name, self.id, 0 if parent is None else parent.id,
            self.request, threading.get_ident(), self.t0, t1),
            t1 - self.t0 - _covered(self.children, self.t0, t1))
        if logger.isEnabledFor(logging.DEBUG):
            extra = " ".join(f"{k}={v}" for k, v in self.fields.items())
            logger.debug("%s took %.3fs %s", self.name, t1 - self.t0, extra)


_OFF = contextlib.nullcontext()


def _on() -> bool:
    """Whether the recorder records: a profiler session, or DEBUG."""
    return (_autograd_profiler._is_profiler_enabled
            or logger.isEnabledFor(logging.DEBUG))


def trace(name: str, **fields):
    """A span at a layer boundary: ``with trace("f.read", file=path):``.
    Off (no profiler recording, logger above DEBUG) it is a shared no-op
    context."""
    return _Span(name, fields) if _on() else _OFF


def traced(name: str):
    """Decorator: the whole call is the span ``name``, with the same one
    check per call as :func:`trace` when off."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on():
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` (while the recorder is on)."""
    if _on():
        _RECORDER.count(name, n)


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: n}}`` of everything recorded since the last :func:`reset`."""
    return _RECORDER.snapshot()


def records() -> list:
    """The newest :data:`RING` :class:`SpanRecord` s, in closing order."""
    return _RECORDER.records()


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _RECORDER.reset()


def _trace_path(out: str, name: str) -> str:
    """``<out>/<name>.json``, or ``<name>-<n>.json`` with the first free
    ``n``, so that each call keeps its own trace."""
    path = os.path.join(out, f"{name}.json")
    n = 0
    while os.path.exists(path):
        n += 1
        path = os.path.join(out, f"{name}-{n}.json")
    return path


@contextlib.contextmanager
def profile(name: str = "strugatzki"):
    """:mod:`torch.profiler` span over the host (every thread) and, where
    CUDA is present, the device; writes a Chrome trace
    ``<STRUGATZKI_PROFILE>/<name>.json`` (``<name>-1.json``, … when taken)
    when ``STRUGATZKI_PROFILE`` is set to a directory path, otherwise a
    no-op.  The recorder is on inside it."""
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
    # every thread: a factory's processor thread records too
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch_profile(activities=activities,
                       experimental_config=every_thread) as prof:
        yield
    path = _trace_path(out, name)
    prof.export_chrome_trace(path)
    logger.debug("profile %s written to %s", name, path)
