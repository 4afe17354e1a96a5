"""Fused feature-database preparation: a hand-written CUDA kernel plus its
plain PyTorch version.

Port of ``strugatzki_tpu/kernels/pallas_prep.py``.  Per file of a
``[B, C, T]`` stack: per-channel min/max normalization (unclipped, inf/NaN
on degenerate ranges), subtraction of the masked per-group mean (temporal
rows ``< num_temporal``, spectral rows the rest) so downstream f32 window
sums are cancellation-free, and the temporal shift kept for the loudness
boost.  Frames at or past a file's length become ``−shift``.

:func:`prepare_database` launches the kernel of ``csrc/prep.cu`` for CUDA
tensors and takes :func:`prepare_database_reference` for CPU tensors; a
CUDA tensor never reaches the reference through it, and a build or launch
failure raises.  The TPU kernel's VMEM cap and XLA fallback are gone:
one kernel, ``prep_long``, takes files of every length in one persistent
launch over an ordered queue of row tiles (:func:`long_plan` builds its
work plan, :func:`long_queue` its queue).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..runtime.device import resolve
from ._build import check, raise_on

__all__ = ["prepare_database", "prepare_database_cuda",
           "prepare_database_reference", "long_plan", "long_queue"]

# Read the counters as ``prep.KERNEL_LAUNCHES``: a ``from`` import copies
# the int.
#: launches of ``prep_long`` (one per :func:`prepare_database_cuda` call)
KERNEL_LAUNCHES = 0
#: calls of the plain PyTorch version
REFERENCE_CALLS = 0

#: frames of a row one ``prep_long`` tile holds at most: 48 KiB of shared
#: memory, so four CTAs share a SM of an H100 (its 63 registers a thread
#: allow no more)
LONG_TILE = 12288


class LongPlan(NamedTuple):
    """The work plan of one ``prep_long`` launch (``csrc/prep.cu``)."""
    tile: int            # frames of a row per tile (a row's last may be less)
    tiles_per_row: int
    resident: bool       # a file's tiles all fit the grid: x is read once
    grid: int            # CTAs, all resident at once


def long_plan(B: int, C: int, T: int, ctas: int,
              tile: int = LONG_TILE) -> LongPlan:
    """The plan of ``prep_long`` over ``B`` files of ``[C, T]`` on a card
    that holds ``ctas`` of its CTAs at once.  Each row is cut into
    ``tiles_per_row`` tiles of at most ``tile`` frames.  The grid is the
    resident CTAs, or fewer where there are fewer tiles.  Where a file's
    ``C·tiles_per_row`` tiles fit the grid, each tile of valid frames is
    held in shared memory from its read to its write; otherwise it is read
    a second time for its write (:func:`long_queue` gives the queue)."""
    per_row = -(-T // -(-T // tile))
    tiles_per_row = -(-T // per_row)
    grid = min(ctas, B * C * tiles_per_row)
    return LongPlan(per_row, tiles_per_row, C * tiles_per_row <= grid, grid)


#: the kinds of :func:`long_queue`, as ``SlotKind`` in ``csrc/prep.cu``:
#: reduce a tile of valid frames, wait for the file's shifts and write it;
#: reduce it only (the re-read plan); write a tile of padding alone as
#: ``-shift``; read a tile of valid frames again and write it
HOLD, REDUCE, TAIL, REREAD = range(4)


def long_queue(plan: LongPlan, C: int, T: int, lens):
    """``prep_long``'s queue for files of lengths ``lens``, every ticket as
    the kernel decodes it (``long_slot`` in ``csrc/prep.cu``): int64 arrays
    ``(kind, file, row, tile of the row)`` in ticket order.  ``prefix[b]``,
    the reduce tiles of the files before ``b``, orders the queue: every
    file's reduce tiles (file by file, row-major), then every file's tiles
    of padding alone, then in the re-read plan the reduce tiles once more.
    ``searchsorted`` is the kernel's binary search for the last file whose
    range starts at or before the ticket."""
    lens = np.asarray(lens, np.int64)
    B, NT = len(lens), plan.tiles_per_row
    nv = -(-np.clip(lens, 0, T) // plan.tile)
    prefix = np.concatenate([[0], np.cumsum(C * nv)])
    R, CN = int(prefix[-1]), C * NT
    t = np.arange(B * CN + (0 if plan.resident else R))
    tail = (t >= R) & (t < B * CN)
    kind = np.where(t < R, HOLD if plan.resident else REDUCE,
                    np.where(tail, TAIL, REREAD))
    u = np.where(tail, t - R, np.where(t < R, t, t - B * CN))
    tails = np.arange(B + 1) * CN - prefix
    f = np.where(tail, np.searchsorted(tails, u, side="right"),
                 np.searchsorted(prefix, u, side="right")) - 1
    o = u - np.where(tail, tails[f], prefix[f])
    per = np.where(tail, NT - nv[f], nv[f])
    return kind, f, o // per, o % per + np.where(tail, nv[f], 0)


def _identity_norm(C: int, device: torch.device) -> torch.Tensor:
    return torch.stack([torch.zeros(C), torch.ones(C)], dim=1).to(
        device=device, dtype=torch.float32)


def prepare_database_reference(feats: torch.Tensor, norm: torch.Tensor,
                               lens: torch.Tensor, num_temporal: int = 1):
    """Plain PyTorch transcription of ``prepare_database_xla`` with the same
    op order: ``[B, C, T]`` f32, ``[C, 2]`` f32, ``[B]`` i32 on one device →
    (prepared ``[B, C, T]``, temporal shifts ``[B]``)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    nt = num_temporal
    B, C, T = feats.shape
    mins = norm[:, 0:1]
    rng = norm[:, 1:2] - mins
    y = (feats - mins) / rng
    t_idx = torch.arange(T, device=feats.device)
    valid = t_idx[None, None, :] < lens[:, None, None]          # [B, 1, T]
    yt = torch.where(valid, y[:, :nt], 0.0)
    ys = torch.where(valid, y[:, nt:], 0.0)
    shift_t = yt.sum(dim=(1, 2)) / torch.clamp_min(
        lens * nt, 1).to(torch.float32)
    shift_s = ys.sum(dim=(1, 2)) / torch.clamp_min(
        lens * (C - nt), 1).to(torch.float32)
    st = shift_t[:, None, None]
    ss = shift_s[:, None, None]
    out = torch.cat([y[:, :nt] - st, y[:, nt:] - ss], dim=1)
    out = torch.where(valid, out, torch.cat(
        [(-st).expand(B, nt, T), (-ss).expand(B, C - nt, T)], dim=1))
    return out, shift_t


@lru_cache(maxsize=1)
def _prep_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("prep")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.prep_long_launch.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.prep_long_launch.restype = i
    lib.prep_long_ctas.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.prep_long_ctas.restype = i
    lib.prep_error_string.argtypes = [i]
    lib.prep_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=None)
def long_ctas(tile: int, device: int) -> int:
    """How many ``prep_long`` CTAs for tiles of ``tile`` frames card
    ``device`` holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    times its SMs)."""
    lib = _prep_lib()
    n = ctypes.c_int(0)
    raise_on(lib.prep_long_ctas(tile, device, ctypes.byref(n)),
             lib.prep_error_string,
             "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return n.value


def prepare_database_cuda(feats: torch.Tensor, norm: torch.Tensor,
                          lens: torch.Tensor, num_temporal: int = 1):
    """Launch ``prep_long`` of ``csrc/prep.cu`` on the current stream.
    ``feats`` ``[B, C, T]`` f32, ``norm`` ``[C, 2]`` f32 and ``lens`` ``[B]``
    i32, all contiguous on one CUDA device; raises on anything else.  The
    kernel takes ``feats`` on a 16-byte boundary, as a fresh tensor lies: a
    view off one is copied to one first.  Its plan (:func:`long_plan`) cuts
    rows into tiles of at most ``LONG_TILE`` frames over the CTAs the card
    holds at once.  A build or launch failure raises; nothing is retried."""
    global KERNEL_LAUNCHES
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"feats on {dev}: the kernel takes CUDA tensors")
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, C, T], got {tuple(feats.shape)}")
    B, C, T = feats.shape
    if min(B, C, T) == 0 or C * T >= 2**31:
        raise ValueError(f"unsupported feats shape {tuple(feats.shape)}")
    if not 0 <= num_temporal <= C:
        raise ValueError(f"num_temporal {num_temporal} outside [0, {C}]")
    check(feats, "feats", torch.float32, dev, (B, C, T))
    check(norm, "norm", torch.float32, dev, (C, 2))
    check(lens, "lens", torch.int32, dev, (B,))

    lib = _prep_lib()
    if feats.data_ptr() % 16:
        feats = feats.clone()
    out = torch.empty_like(feats)
    shift_t = torch.empty(B, dtype=torch.float32, device=dev)
    shift_s = torch.empty(B, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = long_plan(B, C, T, long_ctas(min(LONG_TILE, T), dev.index))
    if 2 * B * C * plan.tiles_per_row >= 2**31:
        raise ValueError(f"{tuple(feats.shape)}: too many tiles for 32-bit "
                         f"ticket offsets")
    partial = torch.empty(B * C * plan.tiles_per_row, dtype=torch.float64,
                          device=dev)
    # the ticket (two words), one arrival counter a file, the prefix
    scratch = torch.zeros(2 * B + 3, dtype=torch.int32, device=dev)
    raise_on(lib.prep_long_launch(
        feats.data_ptr(), norm.data_ptr(), lens.data_ptr(), out.data_ptr(),
        shift_t.data_ptr(), shift_s.data_ptr(), partial.data_ptr(),
        scratch.data_ptr(), B, C, T, num_temporal, plan.tile,
        plan.tiles_per_row, int(plan.resident), plan.grid, dev.index,
        stream), lib.prep_error_string, "prep_long launch", plan)
    KERNEL_LAUNCHES += 1
    return out, shift_t


def prepare_database(feats, norm, lens, num_temporal: int = 1,
                     device="cuda"):
    """``[B, C, T]`` raw features (+ ``[C, 2]`` norm, ``[B]`` lengths; arrays
    or tensors) → (prepared ``[B, C, T]``, temporal shifts ``[B]``) on
    ``device``.  ``norm`` may be None (identity).  CUDA runs the hand
    kernel; CPU runs :func:`prepare_database_reference`."""
    dev = resolve(device)
    feats = torch.as_tensor(feats, dtype=torch.float32, device=dev)
    C = feats.shape[1]
    if norm is None:
        norm_t = _identity_norm(C, dev)
    else:
        norm_t = torch.as_tensor(norm, dtype=torch.float32, device=dev)
    lens_t = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        return prepare_database_cuda(feats.contiguous(), norm_t.contiguous(),
                                     lens_t.contiguous(), num_temporal)
    return prepare_database_reference(feats, norm_t, lens_t, num_temporal)
