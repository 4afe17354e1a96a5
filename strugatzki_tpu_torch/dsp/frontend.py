"""Feature-extraction front-end (framed STFT → MFCC + sones) in PyTorch.

Port of ``strugatzki_tpu/dsp/frontend.py``: the same block pipeline, frame
timing and shape plans, run eagerly on a :class:`torch.device`
(``torch.fft.rfft`` for the spectrum, ``torch.matmul`` at full f32 for the
band projections).  ``lax.scan`` over blocks becomes a Python loop that
threads the 42-band temporal-masking carry, and ``vmap`` over files becomes
a leading batch dimension: every function below accepts ``[..., samples]``
audio and ``[..., bands]`` carries.

The output frame count is ``ceil(inFrames/step) − 1`` and output frame ``j``
is the window covering samples ``[(j+1)·step − fftSize, (j+1)·step)``
(zero-padded at the signal edges), exactly as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..dsp import constants as C
from ..dsp import ml_tables as T
from ..convert import basis_to_torch
from ..runtime.device import resolve

__all__ = ["FrontendBasis", "make_basis", "extract_features",
           "extract_features_batch", "extract_features_streaming",
           "finalize_features", "num_output_frames", "stage_resident_batch",
           "BLOCK_FRAMES"]

#: Frames per block (≈ 24s of audio at the default resolution).
BLOCK_FRAMES = 2048


def num_output_frames(in_frames: int, step_size: int) -> int:
    """Feature-file frame count: ``ceil(inFrames/step) − 1``
    (NonRealtimeProcessor.scala:93 with the first frame dropped :107-109)."""
    out = (in_frames + step_size - 1) // step_size
    return max(out - 1, 0)


# ---------------------------------------------------------------------------
# host-side basis construction (float64, cached) — copied verbatim from
# strugatzki_tpu/dsp/frontend.py, whose module imports jax
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FrontendBasis:
    """Per-(sample_rate, fft_size, num_coeffs) constant matrices (float32)."""

    sample_rate: float
    fft_size: int
    num_coeffs: int
    hann: np.ndarray          # [fft_size]
    mel_fb: np.ndarray        # [bins, MEL_BANDS]  power → mel energies
    dct: np.ndarray           # [MEL_BANDS, num_coeffs]
    erb_fb: np.ndarray        # [bins, ERB_BANDS]  0/1 band partition
    power_cal_db: float       # calibration: full-scale 1kHz sine band → 90 dB
    contours_ext: np.ndarray  # [ERB_BANDS, 12] dB of each phon contour (+extrap)
    phons_ext: np.ndarray     # [12] phon levels matching contours_ext
    thresh_db: np.ndarray     # [ERB_BANDS] audibility threshold (2-phon row)


@lru_cache(maxsize=32)
def make_basis(sample_rate: float, fft_size: int, num_coeffs: int) -> FrontendBasis:
    bins = fft_size // 2 + 1
    freqs = np.arange(bins) * (sample_rate / fft_size)

    # Hann window (SC FFT winType 1, FeatureExtractionImpl.scala:38)
    n = np.arange(fft_size)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / fft_size)

    # --- MFCC mel filterbank: 42 triangles equally spaced in mel over
    # [0, Nyquist] (44 edges at i·mel(nyq)/43), peak 1 — ML.cpp's layout
    mel_hi = C.mel_of_hz(sample_rate / 2.0)
    edges = C.hz_of_mel(np.linspace(C.mel_of_hz(C.MEL_FMIN), mel_hi,
                                    C.MEL_BANDS + 2))
    mel_fb = np.zeros((bins, C.MEL_BANDS))
    for b in range(C.MEL_BANDS):
        lo, ctr, hi = edges[b], edges[b + 1], edges[b + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - freqs) / max(hi - ctr, 1e-9)
        mel_fb[:, b] = np.clip(np.minimum(up, down), 0.0, 1.0)

    # --- DCT-II, coefficients DCT_FIRST_COEFF .. (+num_coeffs) --------------
    b_idx = np.arange(C.MEL_BANDS)
    j_idx = np.arange(C.DCT_FIRST_COEFF, C.DCT_FIRST_COEFF + num_coeffs)
    dct = np.sqrt(2.0 / C.MEL_BANDS) * np.cos(
        np.pi / C.MEL_BANDS * np.outer(b_idx + 0.5, j_idx))

    # --- Loudness ERB band partition (ML.cpp eqlbandbins) --------------------
    band_edges = T.erb_band_edges(float(sample_rate), fft_size)
    erb_fb = np.zeros((bins, T.ERB_BANDS))
    for k in range(T.ERB_BANDS):
        erb_fb[band_edges[k]:band_edges[k + 1], k] = 1.0

    # --- equal-loudness contours at band centres, + linear extrapolation
    # point above the 100-phon contour so loud signals keep a defined slope
    contours = T.contour_table(float(sample_rate), fft_size)
    ext = contours[:, -1] + 4.0 * (contours[:, -1] - contours[:, -2])
    contours_ext = np.concatenate([contours, ext[:, None]], axis=1)
    phons_ext = np.concatenate([T.PHONS, [140.0]])

    # --- calibration: the ERB band containing a full-scale 1 kHz sine reads
    # FULL_SCALE_DB (→ ~90 phon → 32 sones, the /32 headroom)
    k = 1000.0 * fft_size / sample_rate
    phase = 2.0 * np.pi * k * n / fft_size
    spec_pow = np.abs(np.fft.rfft(np.sin(phase) * hann)) ** 2
    band_1k = int(np.searchsorted(band_edges, k, side="right")) - 1
    band_1k = min(max(band_1k, 0), T.ERB_BANDS - 1)
    peak_band_power = float(
        spec_pow[band_edges[band_1k]:band_edges[band_1k + 1]].sum())
    power_cal_db = C.FULL_SCALE_DB - 10.0 * np.log10(peak_band_power)

    return FrontendBasis(
        sample_rate=float(sample_rate), fft_size=fft_size, num_coeffs=num_coeffs,
        hann=hann.astype(np.float32),
        mel_fb=mel_fb.astype(np.float32),
        dct=dct.astype(np.float32),
        erb_fb=erb_fb.astype(np.float32),
        power_cal_db=float(power_cal_db),
        contours_ext=contours_ext.astype(np.float32),
        phons_ext=phons_ext.astype(np.float32),
        thresh_db=contours[:, 0].astype(np.float32),
    )


# ---------------------------------------------------------------------------
# device pipeline
# ---------------------------------------------------------------------------

def _frame_block(audio: torch.Tensor, num_frames: int, fft_size: int,
                 step: int) -> torch.Tensor:
    """Slice ``audio`` (``[..., (num_frames−1)·step + fft_size]``) into
    ``[..., num_frames, fft_size]`` hop-``step`` windows (a strided view)."""
    return audio.unfold(-1, fft_size, step)[..., :num_frames, :]


@lru_cache(maxsize=8)
def _dft_matrices(fft_size: int, device: torch.device):
    """cos/sin DFT matrices ``[fft_size, bins]`` for the ``use_fft=False``
    path (the JAX package's GEMM-native DFT)."""
    bins = fft_size // 2 + 1
    wn = (2.0 * np.pi / fft_size) * np.outer(np.arange(fft_size),
                                             np.arange(bins))
    return (torch.as_tensor(np.cos(wn), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(wn), dtype=torch.float32, device=device))


def _block_pipeline(audio: torch.Tensor, carry: torch.Tensor,
                    hann, mel_fb, dct, erb_fb, power_cal_db,
                    contours_ext, phons_ext, thresh_db, smask, tmask,
                    num_frames: int, fft_size: int, step: int,
                    use_fft: bool = True,
                    valid_frames=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block: audio ``[..., span]`` → ``[..., num_coeffs+1, num_frames]``
    features.

    ``carry``: the previous frame's spectrally-masked band excitation (dB,
    ``[..., ERB_BANDS]``) — temporal masking's only state; returns the
    updated carry.

    ``valid_frames`` (int, optional): real frames in this block.  When
    given, the returned carry is the excitation at the last VALID frame
    (padded-silence frames pass the state through), so carries stay exact
    under any padded shape plan.
    """
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) * (1.0 / 32768.0)
    frames = _frame_block(audio, num_frames, fft_size, step) * hann
    if use_fft:
        spec = torch.fft.rfft(frames, dim=-1)
        power = spec.real.square() + spec.imag.square()
    else:  # GEMM-native DFT
        cos_m, sin_m = _dft_matrices(fft_size, frames.device)
        re = torch.matmul(frames, cos_m)
        im = torch.matmul(frames, sin_m)
        power = re * re + im * im

    # ---- MFCC (ML.cpp, Dan Stowell) ----------------------------------------
    band_in = power if C.MEL_BAND_INPUT == "power" else torch.sqrt(power)
    mel_e = torch.matmul(band_in, mel_fb)                    # [..., F, 42]
    log_e = torch.log10(torch.clamp_min(mel_e, C.MEL_LOG_FLOOR))
    coeffs = (torch.matmul(log_e, dct)
              * C.MFCC_SCALE + C.MFCC_OFFSET)                # [..., F, nc]

    # ---- Loudness (ML.cpp, Nick Collins) -----------------------------------
    band_p = torch.matmul(power, erb_fb)                     # [..., F, 42]
    band_db = torch.clamp_min(
        10.0 * torch.log10(torch.clamp_min(band_p, 1e-30)) + power_cal_db,
        0.0)

    # spectral masking: e_k = max(db_k, e_{k-1}·smask) ("factor_db") or
    # e_k = max(db_k, e_{k-1} + 10·log10 smask) ("factor_intensity"),
    # a serial chain over the 42 bands
    cols = []
    prev = torch.zeros_like(band_db[..., 0])
    if C.SMASK_FORM == "factor_db":
        for k in range(T.ERB_BANDS):
            prev = torch.maximum(band_db[..., k], prev * smask)
            cols.append(prev)
    else:  # factor_intensity
        skirt = 10.0 * torch.log10(torch.clamp_min(smask, 1e-10))
        for k in range(T.ERB_BANDS):
            prev = torch.maximum(band_db[..., k], prev + skirt)
            cols.append(prev)
    exc = torch.stack(cols, dim=-1)                          # [..., F, 42]

    def _carry_at_valid(rows, full_last):
        if valid_frames is None:
            return full_last
        if valid_frames <= 0:
            return carry
        last = min(valid_frames - 1, rows.shape[-2] - 1)
        return rows[..., last, :]

    # temporal masking: "prev_frame" m_t = max(e_t, e_{t-1}·tmask), or
    # "feedback" m_t = max(e_t, m_{t-1}·tmask) (a serial loop over frames)
    if C.TMASK_FORM == "prev_frame":
        prev_exc = torch.cat([carry[..., None, :], exc[..., :-1, :]], dim=-2)
        masked = torch.maximum(exc, prev_exc * tmask)
        new_carry = _carry_at_valid(exc, exc[..., -1, :])
    else:  # feedback
        m = carry
        outs = []
        for f in range(exc.shape[-2]):
            m = torch.maximum(exc[..., f, :], m * tmask)
            outs.append(m)
        masked = torch.stack(outs, dim=-2)
        new_carry = _carry_at_valid(masked, m)

    # dB → phon via the band's equal-loudness contour: the JAX package's
    # branchless sum of clipped segments, same op order
    dc = contours_ext[:, 1:] - contours_ext[:, :-1]          # [42, S]
    dp = phons_ext[1:] - phons_ext[:-1]                      # [S]
    seg = torch.clamp((masked[..., None] - contours_ext[:, :-1]) / dc,
                      0.0, 1.0)                              # [..., F, 42, S]
    phon = phons_ext[0] + (seg * dp).sum(dim=-1)
    sones = torch.where(masked > thresh_db,
                        torch.exp2((phon - C.SONE_PIVOT_PHON) * 0.1), 0.0)
    loud = sones.sum(dim=-1) / 32.0                          # [..., F]

    feats = torch.cat([loud[..., None], coeffs], dim=-1).transpose(-1, -2)
    return feats, new_carry


def _extract_scan(padded_audio: torch.Tensor, carry0: torch.Tensor,
                  hann, mel_fb, dct, erb_fb, power_cal_db, contours_ext,
                  phons_ext, thresh_db, smask, tmask,
                  num_blocks: int, block: int, fft_size: int, step: int,
                  use_fft: bool = True, total_frames=None):
    """Whole file (or chunk): a loop over fixed-size blocks with the
    temporal-masking carry threaded through.  ``padded_audio`` is
    ``[..., num_blocks·block·step + fft_size − step]``.  Returns
    (``[..., num_blocks, C, block]`` features — trim on host — , carry).

    ``total_frames`` (int, optional): the real frame count — makes the
    returned carry the excitation at frame ``total_frames − 1`` regardless
    of the plan's padding."""
    span = (block - 1) * step + fft_size
    if padded_audio.dtype == torch.int16:
        padded_audio = padded_audio.to(torch.float32) * (1.0 / 32768.0)
    carry = carry0
    outs = []
    for i in range(num_blocks):
        off = i * (block * step)
        vf = None if total_frames is None else \
            min(max(total_frames - i * block, 0), block)
        feats, carry = _block_pipeline(
            padded_audio[..., off:off + span], carry, hann, mel_fb, dct,
            erb_fb, power_cal_db, contours_ext, phons_ext, thresh_db,
            smask, tmask, num_frames=block, fft_size=fft_size, step=step,
            use_fft=use_fft, valid_frames=vf)
        outs.append(feats)
    return torch.stack(outs, dim=-3), carry


def _extract_scan_batch(padded_b: torch.Tensor, carry_b: torch.Tensor,
                        hann, mel_fb, dct, erb_fb, power_cal_db, contours_ext,
                        phons_ext, thresh_db, smask, tmask,
                        num_blocks: int, block: int, fft_size: int,
                        step: int, use_fft: bool = True):
    """:func:`_extract_scan` over a files axis: ``padded_b`` ``[B, Tp]`` →
    (``[B, num_blocks, C, block]``, carries ``[B, bands]``)."""
    return _extract_scan(padded_b, carry_b, hann, mel_fb, dct, erb_fb,
                         power_cal_db, contours_ext, phons_ext, thresh_db,
                         smask, tmask, num_blocks=num_blocks, block=block,
                         fft_size=fft_size, step=step, use_fft=use_fft)


_TORCH_DTYPES = {np.dtype(np.int16): torch.int16,
                 np.dtype(np.float32): torch.float32}


def _host_buffer(shape, dtype: np.dtype, device: torch.device):
    """An uninitialised host buffer for an upload to ``device``: pinned
    when the target is a CUDA device (so the copy can be ``non_blocking``).
    Returns (tensor, numpy view of the same memory)."""
    t = torch.empty(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)],
                    pin_memory=device.type == "cuda")
    return t, t.numpy()


def stage_resident_batch(audios, sample_rate: float, num_coeffs: int = 13,
                         fft_size: int = 1024, fft_overlap: int = 2,
                         smask: float = C.SPECTRAL_MASK_DEFAULT,
                         tmask: float = C.TEMPORAL_MASK_DEFAULT,
                         block_frames: int = BLOCK_FRAMES,
                         device="cuda", mesh=None):
    """Stage a batch for :func:`_extract_scan_batch`: padded rows uploaded
    from pinned host memory, zero carries, device constants, and the shape
    plan — ``(x_dev, carry0, consts, block, num_blocks)``, where ``x_dev``,
    ``carry0`` and ``consts`` are lists with one entry per shard of ``mesh``
    (a :class:`~..parallel.sweep.FilesMesh`; one shard on ``device``
    without it), its contiguous rows on its device.  The batch is padded
    with 1-sample silent rows to a multiple of the shard count (callers
    slice their real rows)."""
    from ..parallel.sweep import mesh_or_device

    mesh = mesh_or_device(mesh, device)
    step = fft_size // fft_overlap
    audios = [np.asarray(a) for a in audios]
    pad_b = mesh.pad_rows(len(audios))
    if pad_b:
        pad_dtype = np.int16 if all(
            a.dtype == np.int16 for a in audios) else np.float32
        audios += [np.zeros(1, pad_dtype)] * pad_b
    total_max = max(num_output_frames(len(a), step) for a in audios)
    block, num_blocks = _plan_shapes(total_max, block_frames)
    left_pad = fft_size - step
    padded_len = num_blocks * block * step + fft_size - step
    dtype = np.int16 if all(a.dtype == np.int16 for a in audios) else np.float32
    host, padded = _host_buffer((len(audios), padded_len), np.dtype(dtype),
                                mesh.devices[0])
    padded[:, :left_pad] = 0
    for i, a in enumerate(audios):
        if dtype == np.float32 and a.dtype == np.int16:
            a = a.astype(np.float32) / 32768.0  # dequantize mixed batches
        n = min(len(a), padded_len - left_pad)
        padded[i, left_pad:left_pad + n] = a[:n]
        padded[i, left_pad + n:] = 0
    staged = [(host[s].to(dev, non_blocking=True),
               torch.zeros((s.stop - s.start, T.ERB_BANDS),
                           dtype=torch.float32, device=dev),
               _device_consts(float(sample_rate), fft_size, num_coeffs,
                              float(smask), float(tmask), dev))
              for dev, s in zip(mesh.devices, mesh.split(len(audios)))]
    x_dev, carry0, consts = (list(col) for col in zip(*staged))
    return x_dev, carry0, consts, block, num_blocks


def extract_features_batch(audios, sample_rate: float, num_coeffs: int = 13,
                           fft_size: int = 1024, fft_overlap: int = 2,
                           smask: float = C.SPECTRAL_MASK_DEFAULT,
                           tmask: float = C.TEMPORAL_MASK_DEFAULT,
                           block_frames: int = BLOCK_FRAMES,
                           as_device: bool = False, device="cuda",
                           mesh=None):
    """Batch extraction: list of equal-rate mono signals → ``[B, C, F_max]``
    features (each file's valid length is ``num_output_frames(len_i, step)``;
    the tail beyond it holds silence features), one batched pass.

    With ``as_device=True`` returns (the list of per-shard ``[B/n, nb, C,
    block]`` device tensors, per-file frame totals): gather it with
    :func:`~..parallel.sweep.fetch` and finish each file with
    :func:`finalize_features`.

    With ``mesh`` the files axis shards over the mesh's devices (data
    parallel; one shard on ``device`` without it): the batch is padded with
    silent rows to a multiple of the shard count, each shard's rows run on
    its device, and the host result is trimmed back to ``len(audios)``
    rows.  The ``as_device`` handle keeps the padded rows, while ``totals``
    keeps one entry per real file."""
    from ..parallel.sweep import fetch, mesh_or_device

    mesh = mesh_or_device(mesh, device)
    step = fft_size // fft_overlap
    audios = [np.asarray(a) for a in audios]
    totals = [num_output_frames(len(a), step) for a in audios]
    if max(totals, default=0) == 0:
        if as_device:
            # block-shaped like the device result so finalize_features works
            return [torch.zeros((len(audios), 1, num_coeffs + 1, 0),
                                dtype=torch.float32,
                                device=mesh.devices[0])], totals
        return np.zeros((len(audios), num_coeffs + 1, 0), np.float32)
    total_max = max(totals)
    x_dev, carry0, consts, block, num_blocks = stage_resident_batch(
        audios, sample_rate, num_coeffs=num_coeffs, fft_size=fft_size,
        fft_overlap=fft_overlap, smask=smask, tmask=tmask,
        block_frames=block_frames, mesh=mesh)

    def run(x, c, k):
        return _extract_scan_batch(x, c, *k, num_blocks=num_blocks,
                                   block=block, fft_size=fft_size,
                                   step=step)[0]

    feats = [run(x, c, k) for x, c, k in zip(x_dev, carry0, consts)]
    if as_device:
        return feats, totals
    out = fetch(feats)  # [B, nb, C, block]
    out = out.transpose(0, 2, 1, 3).reshape(out.shape[0], num_coeffs + 1, -1)
    return out[:len(audios), :, :total_max].copy()


def _bucket_blocks(n: int) -> int:
    """Round block counts up geometrically (the JAX package's plan)."""
    b = 1
    while b < n:
        b = max(b + 1, int(b * 1.3))
    return b


def _plan_shapes(total: int, block_frames: int):
    """Choose (block, num_blocks) minimizing padded frames ≥ total."""
    best = None
    for block in (block_frames, block_frames // 2, block_frames // 4,
                  block_frames // 8):
        block = max(block, 256)
        nb = _bucket_blocks((total + block - 1) // block)
        padded = nb * block
        if best is None or padded < best[2]:
            best = (block, nb, padded)
    return best[0], best[1]


@lru_cache(maxsize=64)
def _device_consts(sample_rate: float, fft_size: int, num_coeffs: int,
                   smask: float, tmask: float, device: torch.device):
    """Basis tensors + f32 scalars staged on ``device`` once per process."""
    basis = make_basis(sample_rate, fft_size, num_coeffs)
    f32 = dict(dtype=torch.float32, device=device)
    return basis_to_torch(basis, device) + (torch.tensor(smask, **f32),
                                            torch.tensor(tmask, **f32))


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

def extract_features(audio: np.ndarray, sample_rate: float,
                     num_coeffs: int = 13, fft_size: int = 1024,
                     fft_overlap: int = 2,
                     smask: float = C.SPECTRAL_MASK_DEFAULT,
                     tmask: float = C.TEMPORAL_MASK_DEFAULT,
                     block_frames: int = BLOCK_FRAMES,
                     progress=None, as_device: bool = False,
                     carry=None, return_carry: bool = False,
                     device="cuda"):
    """Extract ``[num_coeffs+1, F]`` features (row 0 = loudness/32, rows 1.. =
    MFCC) from a mono float32 (values in ±1) or raw int16 PCM signal on
    ``device``.  ``progress`` is called once with 1.0 after the fetch.

    With ``as_device=True`` returns (``[num_blocks, C, block]`` tensor,
    frame count[, carry]); finish with :func:`finalize_features`."""
    dev = resolve(device)
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32, copy=False)
    audio = audio.reshape(-1)
    step = fft_size // fft_overlap
    if carry is None:
        carry = torch.zeros((T.ERB_BANDS,), dtype=torch.float32, device=dev)
    total = num_output_frames(len(audio), step)
    if total == 0:
        empty = np.zeros((num_coeffs + 1, 0), dtype=np.float32)
        return (empty, carry) if return_carry else empty

    consts = _device_consts(float(sample_rate), fft_size, num_coeffs,
                            float(smask), float(tmask), dev)
    block, num_blocks = _plan_shapes(total, block_frames)

    # window j covers [(j+1)·step − fft_size, (j+1)·step): left-pad by
    # fft_size − step so window j = padded[j·step : j·step + fft_size]
    left_pad = fft_size - step
    padded_len = num_blocks * block * step + fft_size - step
    host, padded = _host_buffer((padded_len,), audio.dtype, dev)
    padded[:left_pad] = 0
    n_copy = min(len(audio), padded_len - left_pad)
    padded[left_pad:left_pad + n_copy] = audio[:n_copy]
    padded[left_pad + n_copy:] = 0

    feats, carry_out = _extract_scan(
        host.to(dev, non_blocking=True), carry, *consts,
        num_blocks=num_blocks, block=block, fft_size=fft_size, step=step,
        total_frames=total if return_carry else None)
    if as_device:
        return (feats, total, carry_out) if return_carry else (feats, total)
    out = finalize_features(feats, total)
    if progress is not None:
        progress(1.0)
    return (out, carry_out) if return_carry else out


def finalize_features(feats, total: int) -> np.ndarray:
    """Fetch + reshape a ``[num_blocks, C, block]`` result (tensor or
    array) into ``[C, total]``."""
    if isinstance(feats, torch.Tensor):
        feats = feats.cpu().numpy()
    out = np.asarray(feats).transpose(1, 0, 2).reshape(feats.shape[1], -1)
    return out[:, :total].copy()


def extract_features_streaming(read_samples, num_samples: int,
                               sample_rate: float,
                               emit, num_coeffs: int = 13,
                               fft_size: int = 1024, fft_overlap: int = 2,
                               smask: float = C.SPECTRAL_MASK_DEFAULT,
                               tmask: float = C.TEMPORAL_MASK_DEFAULT,
                               chunk_frames: int = 16384,
                               progress=None, device="cuda") -> int:
    """Bounded-memory extraction for arbitrarily long inputs.

    ``read_samples(n)`` returns the next ≤ n mono samples (float32 or raw
    int16; short reads are fine, an empty return means EOF and the rest is
    silence); ``emit(feats)`` receives consecutive ``[C, nc]`` chunks.  The
    temporal-masking carry is threaded across chunks and ``chunk_frames``
    is kept a multiple of 1024 so the NaN-fixup resets land on the same
    boundaries as the whole-file path.  Returns the number of frames
    produced (``ceil(num_samples/step) − 1``).
    """
    dev = resolve(device)
    step = fft_size // fft_overlap
    total = num_output_frames(num_samples, step)
    if total == 0:
        return 0
    chunk_frames = max(1024, (chunk_frames // 1024) * 1024)
    consts = _device_consts(float(sample_rate), fft_size, num_coeffs,
                            float(smask), float(tmask), dev)
    carry = torch.zeros((T.ERB_BANDS,), dtype=torch.float32, device=dev)

    overlap = fft_size - step          # samples shared between chunks
    tail = None                        # zeros: scsynth's initial buffer
    done = 0
    consumed = 0                        # samples pulled from read_samples
    eof = False

    def _read_exact(n: int):
        """Gather exactly ``n`` samples across short reads; zero-pad past
        EOF so chunk alignment never drifts."""
        nonlocal consumed, eof, tail
        parts = []
        got = 0
        while got < n and not eof:
            piece = np.asarray(read_samples(n - got))
            if piece.size == 0:
                eof = True
                break
            if piece.dtype != np.int16:
                piece = piece.astype(np.float32, copy=False)
            if parts and piece.dtype != parts[0].dtype or (
                    tail is not None and piece.dtype != tail.dtype):
                # mid-stream int16→float switch: move everything to the
                # float domain (dequantize raw PCM by 1/32768)
                def to_f32(a):
                    return (a.astype(np.float32) / 32768.0
                            if a.dtype == np.int16
                            else a.astype(np.float32, copy=False))
                parts = [to_f32(p) for p in parts]
                piece = to_f32(piece)
                if tail is not None:
                    tail = to_f32(tail)
            parts.append(piece)
            got += len(piece)
        consumed += got
        if not parts:
            dtype = tail.dtype if tail is not None else np.float32
            return np.zeros(0, dtype)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    while done < total:
        nc = min(chunk_frames, total - done)
        need_to = (done + nc) * step
        fresh = _read_exact(need_to - consumed)
        if tail is None:
            tail = np.zeros(overlap, fresh.dtype)

        block, num_blocks = _plan_shapes(nc, chunk_frames)
        padded_len = num_blocks * block * step + fft_size - step
        host, padded = _host_buffer((padded_len,), tail.dtype, dev)
        padded[:overlap] = tail
        padded[overlap:overlap + len(fresh)] = fresh
        padded[overlap + len(fresh):] = 0

        feats, carry = _extract_scan(
            host.to(dev, non_blocking=True), carry, *consts,
            num_blocks=num_blocks, block=block, fft_size=fft_size, step=step,
            total_frames=nc)   # exact carry for the next chunk
        emit(finalize_features(feats, nc))

        # the next chunk's first window needs the last `overlap` samples
        # before need_to (see the JAX package for the short-read cases)
        span = nc * step + overlap
        if len(fresh) >= nc * step and nc * step >= overlap:
            tail = fresh[nc * step - overlap:nc * step].copy()
        else:
            joined = np.concatenate(
                [tail, fresh, np.zeros(max(0, span - len(tail) - len(fresh)),
                                       tail.dtype)])
            tail = joined[span - overlap:span].copy()
        done += nc
        if progress is not None:
            progress(done / total)
    return total
