"""Batched sweeps over a files axis, single-device or sharded over a mesh.

Port of ``strugatzki_tpu/parallel/sweep.py``.  The per-file sliding
correlation and the per-file novelty curve run over a leading files
dimension in one batched pass (``vmap`` in the JAX package).

The JAX package's mesh is one axis, ``files``, over a list of devices, and
every sharded path either splits a batch of files into contiguous row
blocks, one per device, after zero-padding it to a multiple of the device
count (``P("files")``), or splits one long file's time axis into contiguous
slabs with a halo, so that no collective sits on the hot path.  Here the
mesh is a :class:`FilesMesh`, an explicit tuple of :class:`torch.device`s:
the host splits the batch, each shard's work is launched on its own device,
and the per-shard results are gathered to the host in shard order
(:func:`fetch`).  Without a mesh a path runs the same loop over one shard
on ``device`` (:func:`mesh_or_device`).  A mesh may name one
device more than once (``make_files_mesh(["cpu"] * 8)``, ``["cuda:0"] *
4``): the shards then run one after the other on that device, with the same
row split and the same per-shard shapes as on distinct devices.  The tests
use it as the JAX tests use their 8 virtual CPU devices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import corr as K
from ..runtime.device import resolve

__all__ = ["FilesMesh", "make_files_mesh", "env_mesh", "fetch",
           "batched_correlation_traces", "sharded_sweep_step", "pad_stack",
           "sharded_long_file_trace", "sharded_extract_long",
           "batched_novelty_traces", "sharded_long_novelty_trace"]

#: ``STRUGATZKI_MESH`` values that leave the mesh off
_OFF = ("", "0", "false", "no", "off")


@dataclass(frozen=True)
class FilesMesh:
    """The ``files`` axis over ``devices``, shard ``d`` on ``devices[d]``.

    ``owners`` names the process (rank) that holds each shard when the mesh
    spans processes (:func:`~.multihost.global_files_mesh`), and ``rank`` is
    this process; a mesh of one process leaves ``owners`` empty."""

    devices: Tuple[torch.device, ...]
    owners: Tuple[int, ...] = ()
    rank: int = 0

    @property
    def size(self) -> int:
        """Shard count (``mesh.devices.size`` in the JAX package)."""
        return len(self.devices)

    @property
    def local(self) -> List[int]:
        """The shards this process holds, in shard order."""
        return [d for d in range(self.size)
                if not self.owners or self.owners[d] == self.rank]

    @property
    def spans_processes(self) -> bool:
        return len(set(self.owners)) > 1

    def pad_rows(self, count: int) -> int:
        """Zero rows that pad ``count`` to a multiple of the shard count."""
        return -count % self.size

    def split(self, rows: int) -> List[slice]:
        """The contiguous row block of each shard of a ``rows``-row batch
        (a multiple of the shard count): the split ``P("files")`` gives."""
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split over {self.size} "
                             "shards")
        per = rows // self.size
        return [slice(d * per, (d + 1) * per) for d in range(self.size)]


def _local_devices() -> List[torch.device]:
    """Every CUDA device of this process (none without CUDA)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_files_mesh(devices: Optional[Sequence] = None) -> FilesMesh:
    """A :class:`FilesMesh` over the given devices (names or
    :class:`torch.device`s, repeats allowed), or over every CUDA device."""
    devices = _local_devices() if devices is None else list(devices)
    if not devices:
        raise ValueError("a files mesh needs at least one device")
    return FilesMesh(tuple(resolve(d) for d in devices))


def env_mesh() -> Optional[FilesMesh]:
    """``STRUGATZKI_MESH=1``: a files mesh over every CUDA device when this
    host has more than one — the CLI's opt-in multi-device gate.  ``None``
    (the default, the "off" spellings ``0``/``false``/``no``/``off``, and
    always on a host with at most one CUDA device) keeps the single-device
    paths."""
    if os.environ.get("STRUGATZKI_MESH", "").strip().lower() in _OFF:
        return None
    devices = _local_devices()
    if len(devices) <= 1:
        return None
    return make_files_mesh(devices)


def mesh_or_device(mesh: Optional[FilesMesh], device="cuda") -> FilesMesh:
    """``mesh``, or a mesh of one shard on ``device``."""
    return FilesMesh((resolve(device),)) if mesh is None else mesh


def fetch(parts) -> np.ndarray:
    """A device result, or a sequence of per-shard results, → one host
    array, concatenated along the leading axis in shard order (the
    gather of the JAX package's fetch)."""
    if isinstance(parts, torch.Tensor):
        return parts.cpu().numpy()
    return np.concatenate([p.cpu().numpy() for p in parts])


def _pad_to(x: np.ndarray, rows: int) -> np.ndarray:
    """``x`` with zero rows appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return np.concatenate([x, np.zeros((rows - x.shape[0],) + x.shape[1:],
                                       x.dtype)])


def pad_stack(mats: Sequence[np.ndarray], pad_value: float = 0.0,
              multiple: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ``[C, T_i]`` matrices into ``[B, C, T_max]`` plus lengths."""
    t_max = max(m.shape[1] for m in mats)
    t_max = ((t_max + multiple - 1) // multiple) * multiple
    out = np.full((len(mats), mats[0].shape[0], t_max), pad_value, np.float32)
    lens = np.zeros(len(mats), np.int32)
    for i, m in enumerate(mats):
        out[i, :, :m.shape[1]] = m
        lens[i] = m.shape[1]
    return out, lens


def _batched_traces(xs_b: torch.Tensor, tmpl_t: torch.Tensor,
                    tmpl_s: torch.Tensor, a_std_t: float, a_std_s: float,
                    ln_avg: float, shifts_t: torch.Tensor, temp_weight: float,
                    max_boost: float, num_temporal: int = 1):
    """:func:`kernels.corr.correlation_trace` over the files axis.

    ``xs_b``: ``[B, C, Tp]`` prepared features; ``shifts_t``: ``[B]``
    per-file temporal shifts.  Returns ``(sims [B, W], boosts [B, W])``."""
    return K.correlation_trace(xs_b, tmpl_t, tmpl_s, a_std_t, a_std_s,
                               ln_avg, shifts_t, temp_weight, max_boost,
                               num_temporal=num_temporal)


def _template_traces(xs: torch.Tensor, shifts: torch.Tensor, template,
                     temp_weight: float, max_boost: float):
    """:func:`_batched_traces` of an ``InputTemplate`` on ``xs``'s device."""
    dev = xs.device
    return _batched_traces(
        xs, template.device_temporal(dev), template.device_spectral(dev),
        template.temporal_std, template.spectral_std,
        template.ln_avg_loudness, shifts, temp_weight, max_boost,
        num_temporal=template.num_temporal)


def batched_correlation_traces(xs_b, shifts_t, template, temp_weight: float,
                               max_boost: float, mesh=None, device="cuda"):
    """Dense traces for a whole padded batch → NumPy ``(sims [B, W], boosts
    [B, W])``, on ``device`` or sharded over ``mesh`` (a batch that does not
    divide the shard count is zero-padded to a multiple and the pad rows
    trimmed).  ``template`` is an ``analysis.correlation.InputTemplate`` of
    the port."""
    mesh = mesh_or_device(mesh, device)
    xs_b = np.asarray(xs_b, np.float32)
    shifts = np.asarray(shifts_t, np.float32)
    b = xs_b.shape[0]
    rows = b + mesh.pad_rows(b)
    xs_b, shifts = _pad_to(xs_b, rows), _pad_to(shifts, rows)
    outs = [_template_traces(torch.as_tensor(xs_b[s], device=dev),
                             torch.as_tensor(shifts[s], device=dev),
                             template, temp_weight, max_boost)
            for dev, s in zip(mesh.devices, mesh.split(rows))]
    return (fetch([o[0] for o in outs])[:b],
            fetch([o[1] for o in outs])[:b])


def _as_host(x, dtype) -> np.ndarray:
    """An array, a tensor or a scalar → a host array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def sharded_sweep_step(mesh: FilesMesh, num_temporal: int = 1):
    """The full sweep step over a mesh: prepared features in, per-file
    device top-k out — the pattern of the 10k-file north-star sweep.

    Returns ``step(xs_b, tmpl_t, tmpl_s, a_std_t, a_std_s, ln_avg,
    shifts_t, lens, temp_weight, max_boost, k=4) → (vals [B, k], idx [B, k])``
    as host arrays.  ``xs_b`` ``[B, C, Tp]``, ``shifts_t`` and ``lens``
    ``[B]`` are the rows of this process's shards (every row when the mesh
    does not span processes), split evenly over them; the centered template
    groups and the scalars are replicated.  Windows past a file's length are
    masked to −inf, and each shard takes its files' top-k with the
    tie-stable order of ``jax.lax.top_k`` (ties in index order, NaN last).
    Gather a mesh's results across processes with
    :func:`~.multihost.process_allgather`."""
    from .database import _topk

    local = mesh.local

    def step(xs_b, tmpl_t, tmpl_s, a_std_t, a_std_s, ln_avg, shifts_t,
             lens, temp_weight, max_boost, k: int = 4):
        xs_b = _as_host(xs_b, np.float32)
        shifts = _as_host(shifts_t, np.float32)
        lens = _as_host(lens, np.int32)
        tmpl_t = _as_host(tmpl_t, np.float32)
        tmpl_s = _as_host(tmpl_s, np.float32)
        if xs_b.shape[0] % len(local):
            raise ValueError(f"{xs_b.shape[0]} rows do not split over "
                             f"{len(local)} local shards")
        per = xs_b.shape[0] // len(local)
        L = tmpl_t.shape[1]
        vals, idx = [], []
        for j, d in enumerate(local):
            dev, s = mesh.devices[d], slice(j * per, (j + 1) * per)
            sims, _ = _batched_traces(
                torch.as_tensor(xs_b[s], device=dev),
                torch.as_tensor(tmpl_t, device=dev),
                torch.as_tensor(tmpl_s, device=dev), float(a_std_t),
                float(a_std_s), float(ln_avg),
                torch.as_tensor(shifts[s], device=dev), float(temp_weight),
                float(max_boost), num_temporal=num_temporal)
            # windows past each file's true length are degenerate
            w_valid = torch.as_tensor(lens[s], device=dev)[:, None] - (L - 1)
            t_idx = torch.arange(sims.shape[1], device=dev)[None, :]
            v, i = _topk(torch.where(t_idx < w_valid, sims, -np.inf), k)
            vals.append(v)
            idx.append(i.to(torch.int32))
        return fetch(vals), fetch(idx)

    return step


def sharded_long_file_trace(xs: np.ndarray, shift_t: float, template,
                            temp_weight: float, max_boost: float,
                            mesh: FilesMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Correlation trace of ONE very long file, its time axis sharded over
    the mesh: window starts split into contiguous per-shard ranges, and
    each shard receives its slab plus the ``L − 1``-frame halo, so every
    window is computed locally and only the trace is gathered.

    The slab width is the JAX package's, ``_bucket(per + L − 1)``, so each
    shard's FFT length equals the JAX package's; against the unsharded trace
    the FFT length differs (tests budget 3e-5).  ``xs``: prepared
    (normalized, group-shifted) features ``[C, T]``.  Returns ``(sims[W],
    boosts[W])``, ``W = T − L + 1``."""
    from ..analysis.correlation import _bucket

    n_dev = mesh.size
    L = template.num_frames
    C, T = xs.shape
    W = T - L + 1
    if W <= 0:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    per = -(-W // n_dev)                     # window starts per shard
    slab = _bucket(per + L - 1)              # frames per shard incl. halo
    sims, boosts = batched_correlation_traces(
        _slabs(xs, per, slab, n_dev), np.full(n_dev, np.float32(shift_t)),
        template, temp_weight, max_boost, mesh=mesh)
    # per-shard W' = slab − L + 1 ≥ per: keep each shard's first `per`
    # window starts, then trim the tail shard's overhang past W
    return (sims[:, :per].reshape(-1)[:W].copy(),
            boosts[:, :per].reshape(-1)[:W].copy())


def _slabs(xs: np.ndarray, per: int, slab: int, n_dev: int) -> np.ndarray:
    """``[n_dev, C, slab]``: shard ``d`` holds ``xs[:, d·per : d·per +
    slab]``, zero-padded past the file's end."""
    out = np.zeros((n_dev, xs.shape[0], slab), np.float32)
    for d in range(n_dev):
        src = xs[:, d * per:d * per + slab]
        out[d, :, :src.shape[1]] = src
    return out


def sharded_extract_long(audio: np.ndarray, sample_rate: float,
                         mesh: FilesMesh, num_coeffs: int = 13,
                         fft_size: int = 1024, fft_overlap: int = 2,
                         smask: Optional[float] = None,
                         tmask: Optional[float] = None) -> np.ndarray:
    """Feature extraction of ONE very long file, its time axis sharded over
    the mesh.

    Output frames split into contiguous per-shard ranges.  The pipeline's
    only cross-frame state is temporal masking, and the masking floor of
    frame ``t`` is the spectral excitation of frame ``t − 1`` (no
    recursion), so each shard recomputes exactly one halo frame to seed its
    carry and every frame equals the sequential path's; shard 0's halo frame
    is the zero-padded pre-signal window, the silence the sequential carry
    encodes.  No collective: the features are gathered on fetch.

    ``audio``: mono float32 (±1) or raw int16.  Returns ``[C, F]``
    features, ``F = ceil(len(audio)/step) − 1``, within the plan budget
    (2e-5) of ``dsp.frontend.extract_features``."""
    from ..dsp import frontend as FE
    from ..dsp.ml_tables import ERB_BANDS

    # the one-halo-frame trick holds for the shipped prev_frame masking
    # only; the 'feedback' form is recursive across all history, which no
    # finite halo can reconstruct
    if FE.C.TMASK_FORM != "prev_frame":
        raise NotImplementedError(
            f"sharded_extract_long requires TMASK_FORM == 'prev_frame' "
            f"(got {FE.C.TMASK_FORM!r}): the recursive feedback form "
            "cannot be seeded from one halo frame — use "
            "dsp.frontend.extract_features")
    if smask is None:
        smask = FE.C.SPECTRAL_MASK_DEFAULT
    if tmask is None:
        tmask = FE.C.TEMPORAL_MASK_DEFAULT

    audio = np.asarray(audio).reshape(-1)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32, copy=False)
    step = fft_size // fft_overlap
    total = FE.num_output_frames(len(audio), step)
    C = num_coeffs + 1
    if total == 0:
        return np.zeros((C, 0), np.float32)

    n_dev = mesh.size
    per = -(-total // n_dev)                 # result frames per shard
    block, nb = FE._plan_shapes(per + 1, FE.BLOCK_FRAMES)   # + the halo
    slab_len = nb * block * step + fft_size - step

    # global sample layout: window of frame g is padded[g·step : g·step+fft]
    left_pad = fft_size - step
    lead = left_pad + step                   # shard 0's halo frame is g = −1
    padded = np.zeros(lead + max(len(audio), n_dev * per * step + fft_size),
                      audio.dtype)
    padded[lead:lead + len(audio)] = audio
    outs = []
    for d, dev in enumerate(mesh.devices):
        s0 = lead + (d * per - 1) * step - left_pad     # first frame: halo
        slab = np.zeros((1, slab_len), audio.dtype)
        src = padded[s0:s0 + slab_len]
        slab[0, :len(src)] = src
        feats, _ = FE._extract_scan_batch(
            torch.as_tensor(slab, device=dev),
            torch.zeros((1, ERB_BANDS), dtype=torch.float32, device=dev),
            *FE._device_consts(float(sample_rate), fft_size, num_coeffs,
                               float(smask), float(tmask), dev),
            num_blocks=nb, block=block, fft_size=fft_size, step=step)
        outs.append(feats)
    out = fetch(outs)                        # [n_dev, nb, C, block]
    out = out.transpose(0, 2, 1, 3).reshape(n_dev, C, -1)
    out = out[:, :, 1:per + 1]               # drop each shard's halo frame
    return np.concatenate(list(out), axis=1)[:, :total].copy()


def batched_novelty_traces(xs_b, half_win: int, temp_weight: float,
                           mesh=None, device="cuda") -> np.ndarray:
    """Novelty curves for a padded batch of prepared feature matrices
    ``[B, C, Tp]`` — the segmentation hot loop
    (FeatureSegmentationImpl.scala:107-133) batched over files/spans — on
    ``device`` or sharded over ``mesh`` (zero-padded to a multiple of the
    shard count, the pad rows trimmed).  Each curve is independent, so a
    sharded batch equals the unsharded one within the FFT batch's rounding
    (the 2e-5 plan budget).  Every shard's FFT sums are launched before
    the first shard's exact step synchronizes its device
    (:func:`kernels.corr.novelty_finish`).  Returns NumPy ``sims [B, W]``,
    ``W = Tp − 2·half_win + 1``."""
    mesh = mesh_or_device(mesh, device)
    xs_b = np.asarray(xs_b, np.float32)
    b = xs_b.shape[0]
    rows = b + mesh.pad_rows(b)
    xs_b = _pad_to(xs_b, rows)
    sums = [K.novelty_sums(torch.as_tensor(xs_b[s], device=dev), half_win,
                           temp_weight)
            for dev, s in zip(mesh.devices, mesh.split(rows))]
    return fetch([K.novelty_finish(p) for p in sums])[:b]


def sharded_long_novelty_trace(xs: np.ndarray, half_win: int,
                               temp_weight: float,
                               mesh: FilesMesh) -> np.ndarray:
    """Novelty curve of ONE very long file, its time axis sharded over the
    mesh — :func:`sharded_long_file_trace`'s counterpart for the
    segmentation window: each shard receives its slab plus the
    ``2·half_win − 1``-frame halo.  The slab width is the JAX package's,
    ``_bucket(per + 2·half_win − 1)``.  Values hold the plan budget (2e-5)
    against :func:`kernels.corr.novelty_trace` on the same input, NaN where
    it has NaN.  ``xs``: prepared features ``[C, T]``.  Returns ``sims[W]``,
    ``W = T − 2·half_win + 1``."""
    from ..analysis.correlation import _bucket

    n_dev = mesh.size
    win = 2 * half_win
    W = xs.shape[1] - win + 1
    if W <= 0:
        return np.zeros(0, np.float32)
    per = -(-W // n_dev)                     # window starts per shard
    slab = _bucket(per + win - 1)            # frames per shard incl. halo
    sims = batched_novelty_traces(_slabs(xs, per, slab, n_dev), half_win,
                                  temp_weight, mesh=mesh)
    # keep each shard's first `per` window starts, trim the overhang past W
    return sims[:, :per].reshape(-1)[:W].copy()
