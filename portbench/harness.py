"""The benchmark's general runner.

Everything particular to a configuration, a traffic mix or a metric is
found by name: the cell's entry in ``BENCHMARK.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``workloads/<traffic>.json``); the mix names its driver
(``traffic/<family>.py``); each metric is read by ``metrics/<name>.py``.
A driver module provides::

    setup(ctx) -> state        data from the seed, staging, warm-up
    unit(state, i) -> output   one timed request, pass or search
    facts(state) -> dict       sizes the metric readers need
    release(state)             free the program's state
    check(state, outputs, ctx) -> [(name, value, limit)]
    close(state)               remove what set-up wrote

A run: set-up, then whole units back to back for ``seconds`` (and, with
``trace``, a profiled stretch of ``mix["profile_units"]`` units after the
first), then the peak memory, then the program's state is freed and the
outputs are held to the plain reference.

A cell runs on its ``chips`` cards, ``cuda:0`` … ``cuda:<chips - 1>``
(``Ctx.devices``; one card is ``"cuda"``).  The result's ``device.count``
is the cell's cards and ``memory_peak_bytes`` the fullest card's peak;
device busy time is each card's own union, averaged over the cell's cards.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

from portbench import traces

__all__ = ["BASE", "Ctx", "load_parts", "run_cell", "result_line",
           "BANNED", "cards"]

BASE = os.path.dirname(os.path.abspath(__file__))
#: top-level module names the process that prints a result may not hold
BANNED = ("jax", "jaxlib", "flax", "strugatzki_tpu")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_parts(bench: dict, cell_name: str, base: str = BASE):
    """``(cell, config, mix, driver, readers)`` of one cell, each found by
    name under ``base``; ``readers`` maps every metric the cell reports,
    end-to-end and per-layer, to its reader module."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    config = _json(os.path.join(base, "configs", f"{cell['config']}.json"))
    mix = _json(os.path.join(base, "workloads", f"{cell['traffic']}.json"))
    driver = _module(os.path.join(base, "traffic", f"{mix['family']}.py"),
                     f"portbench_traffic_{mix['family']}")
    readers = {}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if cell_name in m.get("workloads", [cell_name]):
                readers[m["name"]] = (kind, m, _module(
                    os.path.join(base, "metrics", f"{m['name']}.py"),
                    "portbench_metric_" + m["name"].replace(".", "_")))
    return cell, config, mix, driver, readers


@dataclass
class Ctx:
    """What a driver and a metric reader see of a run."""

    cell: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    variant: str | None = None
    chips: int = 1
    devices: tuple = ()                            # the cell's cards
    tmp: str = ""
    setup_s: float = 0.0
    units: list = field(default_factory=list)      # [(t0, t1, ok)]
    window: tuple = (0.0, 0.0)
    peak_bytes: int = 0
    facts: dict = field(default_factory=dict)
    summary: traces.Summary | None = None
    platform: str = ""
    card: str = ""

    def span(self, name: str):
        """A benchmark span around a call into the program (traced runs)."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(traces.SPAN_PREFIX + name)


def _device_info(device: str):
    import torch
    if device.startswith("cuda"):
        return "gpu", torch.cuda.get_device_name(0)
    return "cpu", "cpu"


def _cell_devices(device: str, chips: int) -> tuple:
    """The cell's cards: ``device`` alone for one, ``cuda:0`` … for more
    (``cpu`` repeated on the CPU)."""
    if chips == 1:
        return (device,)
    if device.startswith("cuda"):
        return tuple(f"cuda:{i}" for i in range(chips))
    return (device,) * chips


def cards(devices) -> list:
    """The distinct CUDA devices among ``devices``, in order."""
    return list(dict.fromkeys(d for d in devices if d.startswith("cuda")))


def _peak(devices) -> int:
    """The fullest card's ``max_memory_allocated`` (0 on the CPU)."""
    import torch
    return max((int(torch.cuda.max_memory_allocated(d))
                for d in cards(devices)), default=0)


def _profiled(ctx: Ctx, driver, state, i: int, unit_span: str):
    """Run units ``i …`` under torch.profiler; returns the next index."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if ctx.device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    n = ctx.mix["profile_units"]
    with profile(activities=acts) as prof:
        for _ in range(n):
            _one(ctx, driver, state, i, unit_span)
            i += 1
        for d in cards(ctx.devices):
            torch.cuda.synchronize(d)
    fd, path = tempfile.mkstemp(suffix=".json", dir=ctx.tmp)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        ctx.summary = traces.summarize(traces.load(path), unit_span,
                                       ctx.chips)
    finally:
        os.unlink(path)
    return i


def _one(ctx: Ctx, driver, state, i: int, unit_span: str):
    t0 = time.perf_counter()
    ok = True
    try:
        with ctx.span(unit_span):
            out = driver.unit(state, i)
    except Exception:                     # noqa: BLE001 - counted as failed
        if not any(not u[2] for u in ctx.units):
            traceback.print_exc()
        ok, out = False, None
    ctx.units.append((t0, time.perf_counter(), ok))
    state.outputs.append(out)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             variant: str | None = None, base: str = BASE, devices=None):
    """One run of a cell → ``(result line dict, checks)``.  ``devices``
    replaces the cell's cards (one device may repeat, as a test's
    ``["cpu"] * 4`` does)."""
    cell, config, mix, driver, readers = load_parts(bench, cell_name, base)
    devices = tuple(devices or _cell_devices(device, cell["chips"]))
    if len(devices) != cell["chips"]:
        raise ValueError(f"{cell_name} runs on {cell['chips']} devices, "
                         f"not {len(devices)}")
    if device.startswith("cuda"):
        import torch
        torch.cuda.init()               # before a card is named by index
        for d in cards(devices):
            torch.cuda.reset_peak_memory_stats(d)
    ctx = Ctx(cell_name, config, mix, seed, seconds, trace, devices[0],
              variant, chips=cell["chips"], devices=devices)
    ctx.platform, ctx.card = _device_info(device)
    ctx.tmp = tempfile.mkdtemp(prefix="portbench_")
    state = None
    try:
        state = driver.setup(ctx)
        state.outputs = []
        ctx.setup_s = time.perf_counter() - t_start
        unit_span = mix["span"]
        w0 = time.perf_counter()
        i = 0
        while time.perf_counter() - w0 < seconds or i == 0:
            if trace and i == 1:
                i = _profiled(ctx, driver, state, i, unit_span)
                continue
            _one(ctx, driver, state, i, unit_span)
            i += 1
        if trace and ctx.summary is None:
            i = _profiled(ctx, driver, state, i, unit_span)
        ctx.window = (w0, ctx.units[-1][1])
        ctx.peak_bytes = _peak(devices)
        ctx.facts = driver.facts(state)
        driver.release(state)
        checks = driver.check(state, state.outputs, ctx)
    finally:
        if state is not None:
            driver.close(state)
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, (k, spec, reader) in readers.items():
        if k != kind:
            continue
        v = reader.read(ctx)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": spec["unit"]}
    return result_line(ctx, metrics, checks), checks


def result_line(ctx: Ctx, metrics: dict, checks) -> dict:
    failed = sum(1 for u in ctx.units if not u[2])
    correct = (bool(ctx.units) and failed == 0
               and all(v <= lim for _, v, lim in checks))
    device = {"platform": ctx.platform, "kind": ctx.card,
              "count": ctx.chips, "memory_peak_bytes": ctx.peak_bytes}
    line = {"correct": correct, "attempted": len(ctx.units),
            "failed": failed, "metrics": metrics, "device": device}
    if ctx.trace and ctx.summary is not None:
        s = ctx.summary
        device["busy_s"] = s.busy_s
        device["window_s"] = s.window_s
        line["breakdown"] = {"device_ops": [list(o) for o in s.ops],
                             "idle_gaps": [list(g) for g in s.gaps]}
    line["checks"] = {n: {"value": _num(v), "limit": lim}
                      for n, v, lim in checks}
    return line


def _num(v: float):
    """A number for JSON; a non-finite one as its name."""
    return v if math.isfinite(v) else str(v)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
