"""Shares of the card's published peaks (``peaks.json``), and the device
idle share, for the per-layer metric readers."""

from __future__ import annotations

import json
import os

__all__ = ["peak", "share_pct", "idle_pct"]

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def peak(card: str, key: str):
    """The card's published ``key``, or None for a card not in the table."""
    with open(_PEAKS) as f:
        return json.load(f).get(card, {}).get(key)


def share_pct(ctx, bytes_moved: float, seconds: float):
    """100 × (bytes at the memory rate of the cell's cards together) /
    measured seconds, ``seconds`` being a card's on average (as
    ``Summary.busy_s`` is): the bytes set against the card-seconds summed
    over the cell's cards.  None when there is nothing measured or no peak
    for the card."""
    rate = peak(ctx.card, "hbm_bytes_per_s")
    if rate is None or not seconds or seconds <= 0:
        return None
    return 100.0 * bytes_moved / (ctx.chips * rate) / seconds


def idle_pct(ctx):
    """100 × (1 − device busy ÷ wall) over the traced stretch, busy being
    a card's on average."""
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.device_events == 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
