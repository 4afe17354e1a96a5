"""The slice's sound folder, made from the seed.

``noise`` is a copy of ``chip_smoke.py``'s ``_sound`` (noise re-coloured
every second); the planting follows ``chip_smoke.py``'s ``write_sounds``,
with the target file drawn from the seed.  Copied, not imported, so that
edits to the smoke script cannot move the benchmark."""

from __future__ import annotations

import os

import numpy as np

from portbench.aiff import write_pcm16

__all__ = ["noise", "write_folder", "to_pcm16"]


def noise(rng, seconds: int, rate: int) -> np.ndarray:
    """Noise re-coloured every second (random spectral tilt and level), so
    both the loudness row and the MFCC rows move."""
    seg = rng.standard_normal((seconds, rate))
    spec = np.fft.rfft(seg, axis=1)
    f = np.arange(spec.shape[1]) / spec.shape[1]
    tilt = rng.uniform(0.0, 2.0, (seconds, 1))
    gain = rng.uniform(0.02, 0.25, (seconds, 1))
    spec *= gain * (1.0 + f / 0.02) ** -tilt
    x = np.fft.irfft(spec, n=rate, axis=1).reshape(-1)
    return (x / max(1.0, np.abs(x).max() / 0.9)).astype(np.float32)


def to_pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def write_folder(cfg: dict, seed: int, folder: str):
    """Write ``query.aif`` and ``db00.aif`` … into ``folder``; the query's
    planted punches (``cfg["planted"]``) are copied into one database file
    drawn from the seed, shifted by whole feature frames.  Returns
    ``(pcm by file name, target file name)``."""
    rate, step = cfg["sample_rate"], cfg["extraction"]["step"]
    plant = cfg["planted"]
    rng = np.random.default_rng([seed, 1])
    target = int(rng.integers(cfg["files"]))
    query = noise(rng, cfg["seconds"], rate)
    pcm = {"query.aif": to_pcm16(query)}
    for i in range(cfg["files"]):
        x = noise(rng, cfg["seconds"], rate)
        if i == target:
            for (s0, s1), shift in ((plant["in_s"], plant["shift_in"]),
                                    (plant["out_s"], plant["shift_out"])):
                a = int(s0 * rate) - plant["margin"]
                b = int(s1 * rate) + plant["margin"]
                d = shift * step
                x[a + d:b + d] = query[a:b]
        pcm[f"db{i:02d}.aif"] = to_pcm16(x)
    for name, samples in pcm.items():
        write_pcm16(os.path.join(folder, name), samples, rate)
    return pcm, f"db{target:02d}.aif"
