"""Reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics read: each card's busy time as the union of its kernel, copy and
set intervals (never their sum, which counts overlapping streams twice),
averaged over the cell's cards; the idle gaps, when no card of the cell
is busy, labelled by what the host was doing; the device time by
operation; and the device events per unit of work."""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["DEVICE_CATS", "Summary", "summarize", "load", "union",
           "SPAN_PREFIX"]

#: Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host categories that say what the host was doing
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: the benchmark's own spans are named ``portbench.<name>``
SPAN_PREFIX = "portbench."


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union(intervals):
    """Merged, sorted ``[(start, end)]`` of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Summary:
    """One traced stretch of ``units`` whole units of work (seconds)."""

    units: int
    window_s: float
    busy_s: float                                  # a card, on average
    device_events: int
    ops: list = field(default_factory=list)        # [(name, seconds)]
    gaps: list = field(default_factory=list)       # [(label, seconds)]
    kernels: dict = field(default_factory=dict)    # name → seconds
    card_busy_s: list = field(default_factory=list)   # by card, in order

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of kernels whose name contains ``part``, a card's
        on average: summed over the cards, divided by the cell's cards."""
        return sum(s for n, s in self.kernels.items() if part in n) \
            / max(len(self.card_busy_s), 1)


def _x(e):
    return e.get("ph") == "X" and "ts" in e and "dur" in e


def _card(e) -> int:
    """The card a device event ran on: its ``args.device``, else its
    ``pid``."""
    return int(e.get("args", {}).get("device", e.get("pid", 0)))


def summarize(events, unit_span: str, chips: int = 1,
              top: int = 10) -> Summary | None:
    """Summary of the stretch spanned by the events named
    ``SPAN_PREFIX + unit_span``, for a cell on ``chips`` cards (a card with
    no events was idle); None when the trace holds none."""
    name = SPAN_PREFIX + unit_span
    units = [e for e in events if _x(e) and e.get("name") == name
             and e.get("cat") == "user_annotation"]
    if not units:
        return None
    ws = min(e["ts"] for e in units)
    we = max(e["ts"] + e["dur"] for e in units)
    dev = [e for e in events if _x(e) and e.get("cat") in DEVICE_CATS
           and e["ts"] < we and e["ts"] + e["dur"] > ws]
    on = defaultdict(list)
    for e in dev:
        on[_card(e)].append((max(e["ts"], ws), min(e["ts"] + e["dur"], we)))
    card_us = [sum(b - a for a, b in union(on[c])) for c in sorted(on)]
    card_us += [0.0] * (chips - len(card_us))
    busy = union(iv for c in on for iv in on[c])
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    holes, t = [], ws
    for a, b in busy:
        if a > t:
            holes.append((t, a))
        t = max(t, b)
    if we > t:
        holes.append((t, we))
    holes = sorted(holes, key=lambda h: h[0] - h[1])[:top]
    host = [e for e in events if _x(e) and e.get("cat") in HOST_CATS]
    gaps = [(_label(host, (a + b) / 2), (b - a) / 1e6) for a, b in holes]
    return Summary(units=len(units), window_s=(we - ws) / 1e6,
                   busy_s=sum(card_us) / len(card_us) / 1e6,
                   device_events=len(dev),
                   ops=[(n[:120], s) for n, s in ops], gaps=gaps,
                   kernels=dict(by_name),
                   card_busy_s=[u / 1e6 for u in card_us])


def _label(host, t: float) -> str:
    """The innermost benchmark span open at ``t``, and the innermost other
    host event open then (``-`` for none)."""
    span = op = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"]:
            if e["name"].startswith(SPAN_PREFIX):
                if span is None or e["dur"] < span["dur"]:
                    span = e
            elif op is None or e["dur"] < op["dur"]:
                op = e
    s = span["name"][len(SPAN_PREFIX):] if span else "outside"
    return f"{s}/{op['name'][:80] if op else '-'}"
