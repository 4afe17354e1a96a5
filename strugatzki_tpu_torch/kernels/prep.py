"""Fused feature-database preparation: a hand-written CUDA kernel plus its
plain PyTorch version.

Port of ``strugatzki_tpu/kernels/pallas_prep.py``.  Per file of a
``[B, C, T]`` stack: per-channel min/max normalization (unclipped, inf/NaN
on degenerate ranges), subtraction of the masked per-group mean (temporal
rows ``< num_temporal``, spectral rows the rest) so downstream f32 window
sums are cancellation-free, and the temporal shift kept for the loudness
boost.  Frames at or past a file's length become ``−shift``.

:func:`prepare_database` launches the kernel in ``csrc/prep.cu`` for CUDA
tensors and takes :func:`prepare_database_reference` for CPU tensors; a
CUDA tensor never reaches the reference through it, and a build or launch
failure raises.  The TPU kernel's VMEM cap and XLA fallback are gone: the
kernel tiles T and takes any length.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from ..runtime.device import resolve

__all__ = ["prepare_database", "prepare_database_cuda",
           "prepare_database_reference"]

# Read the counters as ``prep.KERNEL_LAUNCHES``: a ``from`` import copies
# the int.
#: launches of the CUDA kernel (one per :func:`prepare_database_cuda` call)
KERNEL_LAUNCHES = 0
#: calls of the plain PyTorch version
REFERENCE_CALLS = 0

#: CUDA grid limit on the file and channel axes (gridDim.y / gridDim.z)
_MAX_GRID_YZ = 65535


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
    lib.prep_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.prep_launch.restype = i
    lib.prep_error_string.argtypes = [i]
    lib.prep_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           device: torch.device, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def prepare_database_cuda(feats: torch.Tensor, norm: torch.Tensor,
                          lens: torch.Tensor, num_temporal: int = 1):
    """Launch the kernel of ``csrc/prep.cu`` on the current stream.
    ``feats`` ``[B, C, T]`` f32, ``norm`` ``[C, 2]`` f32 and ``lens`` ``[B]``
    i32, all contiguous on one CUDA device; raises on anything else."""
    global KERNEL_LAUNCHES
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"feats on {dev}: the kernel takes CUDA tensors")
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, C, T], got {tuple(feats.shape)}")
    B, C, T = feats.shape
    if min(B, C, T) == 0 or max(B, C) > _MAX_GRID_YZ:
        raise ValueError(f"unsupported feats shape {tuple(feats.shape)}")
    if not 0 <= num_temporal <= C:
        raise ValueError(f"num_temporal {num_temporal} outside [0, {C}]")
    _check(feats, "feats", torch.float32, dev, (B, C, T))
    _check(norm, "norm", torch.float32, dev, (C, 2))
    _check(lens, "lens", torch.int32, dev, (B,))

    lib = _prep_lib()
    out = torch.empty_like(feats)
    shift_t = torch.empty(B, dtype=torch.float32, device=dev)
    shift_s = torch.empty(B, dtype=torch.float32, device=dev)
    # T-segments per file for the shift pass: enough blocks for two per SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    segs = max(1, min(math.ceil(T / 256), math.ceil(2 * sms / B)))
    seg_len = math.ceil(T / segs)
    partial = torch.empty((B, math.ceil(T / seg_len), 2),
                          dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.prep_launch(
        feats.data_ptr(), norm.data_ptr(), lens.data_ptr(), out.data_ptr(),
        shift_t.data_ptr(), shift_s.data_ptr(), partial.data_ptr(),
        B, C, T, num_temporal, seg_len, dev.index, stream)
    if err != 0:
        raise RuntimeError("prep kernel launch failed: "
                           + lib.prep_error_string(err).decode())
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
