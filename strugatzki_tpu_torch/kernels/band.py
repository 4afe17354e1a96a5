"""The punch's band maximum: a hand-written CUDA kernel plus its plain
PyTorch version.

For every punch-in offset ``t`` of a files step, the best punch-out start in
the band ``t + min_punch + [0, scan_span)`` and its score.  Given the two
sliding traces ``sims_in [B, W_in]`` and ``sims_out [B, W_out]`` (float32)
and the files' lengths ``lens [B]`` (int32), it returns ``band_sim [B, W_in]``
float32, ``√(inSim·outSim)`` where the punch-in gate passes and −inf
elsewhere, and ``best_j [B, W_in]`` int32, the best start's offset in the
band.  The band's maximum is the sparse-table doubling of
:func:`band_max_reference` (strict ``>``, so ties keep the earliest start and
a NaN never wins from the right), then the larger of two power blocks.

:func:`band_max` launches the kernels of ``csrc/band.cu`` for CUDA tensors
and takes :func:`band_max_reference` for CPU tensors only; a build or launch
failure raises.  A files step is one ``band_max_kernel`` launch, the levels
in shared memory; a band whose halo does not fit there (over ~28,700
frames) takes the wide path, the levels through a global scratch,
``j_sel + 2`` launches (:func:`band_plan` chooses by the shapes).  The JAX
package computes this as XLA ops in
``strugatzki_tpu/parallel/database.py::_punch_one_from_spectra``.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ._build import check, raise_on

__all__ = ["band_max", "band_max_cuda", "band_max_reference", "band_plan",
           "BandPlan"]

# Read the counters as ``band.KERNEL_LAUNCHES``: a ``from`` import copies
# the int.
#: kernel launches of :func:`band_max_cuda`: one a call, ``j_sel + 2`` on
#: the wide path
KERNEL_LAUNCHES = 0
#: calls of the plain PyTorch version
REFERENCE_CALLS = 0

#: punch-in offsets one CTA takes at most
BAND_TILE = 4096
#: the fewest it takes before a band takes the wide path
BAND_MIN_TILE = 256
#: (value, index) pairs of 8 bytes that a CTA's shared memory holds: the
#: 227 KB an H100 gives one block
BAND_PAIRS = 232448 // 8


def _levels(w_pad: int, scan_span: int) -> int:
    """The doubling levels ``j_sel``, ⌊log2 S⌋ capped by the padded width."""
    n_levels = max(1, int(np.ceil(np.log2(w_pad))) + 1)
    # exact integer ⌊log2 S⌋ (float log2 can misround at powers of two)
    return min(max(scan_span, 1).bit_length() - 1, n_levels - 1)


def _shift_left(x: torch.Tensor, sh: int, fill) -> torch.Tensor:
    """``x[..., sh:]`` refilled to full width with ``fill``."""
    sh = min(sh, x.shape[-1])
    return torch.cat([x[..., sh:], torch.full_like(x[..., :sh], fill)], -1)


def _window(x: torch.Tensor, start: int, width: int) -> torch.Tensor:
    """``x[..., start:start + width]`` with the start clamped into range,
    as ``lax.dynamic_slice`` clamps it."""
    start = min(max(start, 0), x.shape[-1] - width)
    return x[..., start:start + width]


def band_max_reference(sims_in, sims_out, lens, L_in: int, L_out: int,
                       Tp: int, min_punch: int, scan_span: int):
    """Plain PyTorch version: validity, the out trace padded to ``w_pad =
    W_in + Tp``, ``j_sel`` levels of (max, earliest argmax) doubling, the
    two power blocks at ``min_punch`` and ``min_punch + scan_span − p``
    (starts clamped as ``_window`` clamps them), the gate and ``sqrt`` →
    ``(band_sim [B, W_in] f32, best_j [B, W_in] int32)``."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    W_in = Tp - L_in + 1
    W_out = Tp - L_out + 1
    dev = sims_in.device
    # validity: punch-in scan runs over len − minPunch frames (:183);
    # punch-out windows must fit the file
    t_ix = torch.arange(W_in, device=dev)
    w_in_valid = (lens - min_punch - (L_in - 1))[:, None]
    in_valid = (t_ix < w_in_valid) & (sims_in > 0.0)
    o_ix = torch.arange(W_out, device=dev)
    out_ok = o_ix < (lens - (L_out - 1))[:, None]
    # pad the out trace so every banded read is in range
    pad = W_in + Tp - W_out
    B = sims_out.shape[0]
    out_vals = torch.cat(
        [torch.where(out_ok, sims_out, -math.inf),
         torch.full((B, pad), -math.inf, dtype=sims_out.dtype, device=dev)],
        -1)
    w_pad = out_vals.shape[-1]

    j_sel = _levels(w_pad, scan_span)
    p = 1 << j_sel
    lv = out_vals
    la = torch.arange(w_pad, dtype=torch.int32, device=dev).expand(B, w_pad)
    for j in range(j_sel):
        sh = 1 << j
        v2 = _shift_left(lv, sh, -math.inf)
        a2 = _shift_left(la, sh, 0)
        take = v2 > lv
        lv, la = torch.where(take, v2, lv), torch.where(take, a2, la)
    # block 1 at offset min_punch, block 2 at min_punch + scan_span − p
    v1, a1 = _window(lv, min_punch, W_in), _window(la, min_punch, W_in)
    off2 = min_punch + scan_span - p
    v2, a2 = _window(lv, off2, W_in), _window(la, off2, W_in)
    take2 = v2 > v1
    out_best = torch.where(take2, v2, v1)
    o_best = torch.where(take2, a2, a1)             # absolute out index
    best_j = (o_best - min_punch - t_ix).to(torch.int32)

    best = torch.where(in_valid & (out_best > -math.inf),
                       sims_in * out_best, -math.inf)
    band_sim = torch.where(best > 0.0, torch.sqrt(torch.clamp_min(best, 0.0)),
                           -math.inf)
    return band_sim, best_j


class BandPlan(NamedTuple):
    """The work plan of :func:`band_max_cuda` (``csrc/band.cu``)."""
    j_sel: int     # doubling levels
    s1: int        # clamped start of power block 1 (≤ Tp)
    s2: int        # clamped start of power block 2 (≤ Tp)
    tile: int      # punch-in offsets a CTA (a row's last may take fewer)
    tiles: int     # CTAs a row
    pairs: int     # (value, index) pairs of a CTA's shared memory
    wide: bool     # the levels through a global scratch (tile, tiles and
                   # pairs 0): the halo does not fit shared memory


def band_plan(W_in: int, Tp: int, min_punch: int,
              scan_span: int) -> BandPlan:
    """The plan of :func:`band_max_cuda` for punch-in traces of ``W_in``
    offsets at padded length ``Tp``.

    A CTA takes a tile of offsets ``[t0, t0 + n)`` of one row.  Its halo is
    the out positions ``[t0 + lo, t0 + n + hi + p − 1)``, ``lo``/``hi`` the
    smaller/larger block start and ``p = 2^j_sel``: the level-``j_sel``
    entries at both blocks' offsets cover exactly that.  The halo lies in
    shared memory as (value, index) pairs, plus up to three pairs before it
    for the 16-byte alignment of its loads.  The tile is the largest power
    of two up to ``BAND_TILE`` whose halo fits ``BAND_PAIRS``, then split
    evenly over the row's CTAs.  Where not even ``BAND_MIN_TILE`` fits, the
    plan is the wide path."""
    w_pad = W_in + Tp
    j_sel = _levels(w_pad, scan_span)
    p = 1 << j_sel
    s1 = min(max(min_punch, 0), Tp)
    s2 = min(max(min_punch + scan_span - p, 0), Tp)
    halo = abs(s2 - s1) + p - 1

    def pairs(n: int) -> int:
        return -(-(n + halo + 3) // 4) * 4

    cap = BAND_TILE
    while pairs(cap) > BAND_PAIRS:
        cap //= 2
        if cap < BAND_MIN_TILE:
            return BandPlan(j_sel, s1, s2, 0, 0, 0, True)
    tiles = -(-W_in // cap)
    per = -(-W_in // tiles)
    return BandPlan(j_sel, s1, s2, per, tiles, pairs(per), False)


@lru_cache(maxsize=1)
def _band_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("band")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.band_max_launch.argtypes = [p] * 5 + [i] * 14 + [p]
    lib.band_max_launch.restype = i
    lib.band_max_wide_launch.argtypes = [p] * 6 + [i] * 11 + [p]
    lib.band_max_wide_launch.restype = i
    lib.band_error_string.argtypes = [i]
    lib.band_error_string.restype = ctypes.c_char_p
    return lib


def band_max_cuda(sims_in, sims_out, lens, L_in: int, L_out: int, Tp: int,
                  min_punch: int, scan_span: int):
    """Launch the kernels of ``csrc/band.cu`` on the tensors' device and
    its current stream, as :func:`band_plan` plans them.  ``sims_in [B,
    W_in]`` and ``sims_out [B, W_out]`` float32 and ``lens [B]`` int32 on
    one CUDA device; raises on anything else.  A build or launch failure
    raises; nothing is retried."""
    global KERNEL_LAUNCHES
    dev = sims_in.device
    if dev.type != "cuda":
        raise ValueError(f"sims_in on {dev}: the kernel takes CUDA tensors")
    W_in, W_out = Tp - L_in + 1, Tp - L_out + 1
    B = sims_in.shape[0]
    if W_in < 1 or W_out < 1 or (W_in + Tp) >= 2**31:
        raise ValueError(f"unsupported widths W_in {W_in}, W_out {W_out}")
    sims_in, sims_out, lens = (t.contiguous()
                               for t in (sims_in, sims_out, lens))
    check(sims_in, "sims_in", torch.float32, dev, (B, W_in))
    check(sims_out, "sims_out", torch.float32, dev, (B, W_out))
    check(lens, "lens", torch.int32, dev, (B,))
    plan = band_plan(W_in, Tp, min_punch, scan_span)
    band_sim = torch.empty((B, W_in), dtype=torch.float32, device=dev)
    best_j = torch.empty((B, W_in), dtype=torch.int32, device=dev)
    if B == 0:
        return band_sim, best_j
    if B * plan.tiles >= 2**31:
        raise ValueError(f"{B} rows of {plan.tiles} tiles: too many CTAs")
    lib = _band_lib()
    ptrs = (sims_in.data_ptr(), sims_out.data_ptr(), lens.data_ptr(),
            band_sim.data_ptr(), best_j.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.wide:
        # two [B, w_pad] rows of (value, index) pairs
        scratch = torch.empty((2, B, W_in + Tp), dtype=torch.int64,
                              device=dev)
        err = lib.band_max_wide_launch(
            *ptrs, scratch.data_ptr(), B, W_in, W_out, W_in + Tp, L_in,
            L_out, min_punch, plan.j_sel, plan.s1, plan.s2, dev.index,
            stream)
        launches = plan.j_sel + 2
    else:
        err = lib.band_max_launch(
            *ptrs, B, W_in, W_out, W_in + Tp, L_in, L_out, min_punch,
            plan.j_sel, plan.s1, plan.s2, plan.tile, plan.tiles, plan.pairs,
            dev.index, stream)
        launches = 1
    raise_on(err, lib.band_error_string, "band maximum launch", plan)
    KERNEL_LAUNCHES += launches
    return band_sim, best_j


def band_max(sims_in, sims_out, lens, L_in: int, L_out: int, Tp: int,
             min_punch: int, scan_span: int):
    """``(band_sim [B, W_in] f32, best_j [B, W_in] int32)`` of a files step.
    CUDA runs :func:`band_max_cuda`, CPU :func:`band_max_reference`."""
    if sims_in.device.type == "cuda":
        return band_max_cuda(sims_in, sims_out, lens, L_in, L_out, Tp,
                             min_punch, scan_span)
    return band_max_reference(sims_in, sims_out, lens, L_in, L_out, Tp,
                              min_punch, scan_span)
