"""Intensity color palette.

Re-creation of the ``de.sciss.intensitypalette.IntensityPalette`` ramp the
reference uses for self-similarity images (SelfSimilarityImpl.scala:109-110):
a psycho-optically even gradient "from black over violet towards yellow and
finally white" (SelfSimilarity.scala:48-54), originally from Niklas Werner's
Sonasound.  The exact table is not in the reference repository (and this
build environment has no network to fetch the public
``de.sciss.intensitypalette`` source), so the default is a perceptually
equivalent piecewise-linear reconstruction over the same hue trajectory.

Byte-exact calibration is a drop-in swap: point ``STRUGATZKI_PALETTE`` at
(or call :func:`load_palette` with) the verbatim table — one ``0xRRGGBB``
value per entry, as hex lines or a JSON array, exactly as it appears in
IntensityPalette.scala — and every palette lookup uses it unchanged.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["intensity_rgb", "apply_palette", "load_palette",
           "reset_palette", "lookup", "NUM_COLORS"]

NUM_COLORS = 1024

# anchor points (position, (r, g, b)): black → violet → magenta/red →
# orange → yellow → white
_ANCHORS = [
    (0.00, (0, 0, 0)),
    (0.15, (50, 0, 100)),
    (0.30, (120, 0, 160)),
    (0.45, (190, 40, 110)),
    (0.60, (230, 110, 40)),
    (0.75, (250, 180, 20)),
    (0.90, (255, 240, 80)),
    (1.00, (255, 255, 255)),
]


def _build_table() -> np.ndarray:
    xs = np.array([a[0] for a in _ANCHORS])
    cols = np.array([a[1] for a in _ANCHORS], dtype=np.float64)
    t = np.linspace(0.0, 1.0, NUM_COLORS)
    rgb = np.stack([np.interp(t, xs, cols[:, c]) for c in range(3)], axis=1)
    return np.clip(rgb + 0.5, 0, 255).astype(np.uint8)


_TABLE = _build_table()


def reset_palette() -> None:
    """Return to the built-in reconstruction table."""
    global _TABLE, NUM_COLORS
    NUM_COLORS = 1024
    _TABLE = _build_table()


def load_palette(values) -> None:
    """Install an exact palette table: a sequence of ``0xRRGGBB`` ints (or
    hex strings), used verbatim as the lookup table from then on."""
    global _TABLE, NUM_COLORS
    vals = [int(v, 16) if isinstance(v, str) else int(v) for v in values]
    if len(vals) < 2:
        raise ValueError("palette table needs at least 2 entries")
    arr = np.array(vals, dtype=np.int64)
    _TABLE = np.stack([(arr >> 16) & 0xFF, (arr >> 8) & 0xFF, arr & 0xFF],
                      axis=1).astype(np.uint8)
    NUM_COLORS = len(vals)


def _load_palette_file(path: str) -> None:
    with open(path) as f:
        text = f.read()
    try:
        load_palette(json.loads(text))
        return
    except (json.JSONDecodeError, ValueError, TypeError):
        pass
    lines = [ln.strip().rstrip(",") for ln in text.splitlines()]
    vals = [ln for ln in lines if ln and not ln.startswith(("#", "//"))]
    load_palette([int(v, 16) if v.lower().startswith("0x") else int(v)
                  for v in vals])


if os.environ.get("STRUGATZKI_PALETTE"):
    try:
        _load_palette_file(os.environ["STRUGATZKI_PALETTE"])
    except Exception as e:  # surface the cause, not a bare traceback
        raise RuntimeError(
            f"STRUGATZKI_PALETTE: cannot load palette table from "
            f"{os.environ['STRUGATZKI_PALETTE']!r}: {e}") from e


def intensity_rgb(value: float) -> tuple:
    """Single value in [0, 1] → (r, g, b); out-of-range clamps
    (cf. IntensityPalette.apply)."""
    return tuple(int(v) for v in apply_palette(np.float32(value)))


def apply_palette(values: np.ndarray) -> np.ndarray:
    """Vectorized map: float array [..] in [0,1] → uint8 rgb [.., 3].

    Index quantization runs in float32 — the reference's
    ``IntensityPalette.apply`` takes a Java ``Float`` and does float
    arithmetic — and this exact op sequence is mirrored by the device
    colorization epilogue (analysis/self_similarity.py), so device-quantized
    indices are bit-identical to this host path."""
    v = np.nan_to_num(np.asarray(values, dtype=np.float32), nan=0.0)
    idx = (np.clip(v, np.float32(0.0), np.float32(1.0))
           * np.float32(NUM_COLORS - 1) + np.float32(0.5)).astype(np.int32)
    # same table-swap race clamp as lookup(): NUM_COLORS was read before
    # a concurrent load_palette could have installed a shorter table
    return _TABLE[np.minimum(idx, len(_TABLE) - 1)]


def lookup(indices: np.ndarray) -> np.ndarray:
    """Table gather for precomputed palette indices (the device
    colorization path ships uint16 indices over the link instead of float32
    sims; the RGB expansion happens here).  Clamped so a `load_palette`
    swap racing an in-flight render cannot index past a smaller table."""
    idx = np.minimum(np.asarray(indices), len(_TABLE) - 1)
    return _TABLE[idx]
