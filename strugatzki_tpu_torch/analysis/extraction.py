"""Feature extraction processor in PyTorch.

Port of ``strugatzki_tpu/analysis/extraction.py``: channel collapse, the
front-end on a :class:`torch.device`, NaN fixup with the reference's
per-1024-frame state reset, float32 AIFC output and the XML sidecar.  Files
above :data:`STREAMING_THRESHOLD` samples stream through bounded-memory
chunks; the CLI's ``-f`` groups smaller files into batched passes.
"""

from __future__ import annotations

import os
import traceback

import numpy as np

from ..config import ChannelsBehavior, ExtractionConfig
from ..io import audiofile as af
from ..parallel.sweep import env_mesh, fetch
from ..runtime.logging import trace
from ..runtime.processor import Processor, ProcessorFactory
from ..dsp.frontend import (extract_features, extract_features_batch,
                            extract_features_streaming, finalize_features,
                            num_output_frames)

__all__ = ["FeatureExtraction", "extract_batch_cli", "fix_nans"]

#: files longer than this many samples stream through bounded-memory chunks
STREAMING_THRESHOLD = 1 << 24  # ~6.3 min mono at 44.1k
#: grouped CLI extraction: flush a group at this many files or this many
#: projected staged bytes (B × longest row × item size), whichever first
_GROUP_MAX_FILES = 64
_GROUP_MAX_BYTES = 32 << 20


def _group_staged_bytes(group) -> int:
    """Projected staged bytes for a pending group: B × longest row × the
    staged item size (int16 rows stay 2 B only when the WHOLE batch is
    int16 — mixed batches widen to f32, as in stage_resident_batch)."""
    max_len = max(len(t[3]) for t in group)
    item = 2 if all(t[3].dtype == np.int16 for t in group) else 4
    return len(group) * max_len * item


# fix_nans and _collapse_mono are copied verbatim from
# strugatzki_tpu/analysis/extraction.py, whose module imports jax.

def fix_nans(features: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """Replace NaNs with the last non-NaN per channel, resetting the carried
    value to 0 at every ``chunk`` boundary (NonRealtimeProcessor.scala:178-190:
    ``lasts`` is re-allocated per temp-file chunk)."""
    out = np.array(features, dtype=np.float32, order="C")  # one copy
    from ..io import native as _native
    if _native.fix_nans(out, chunk):
        return out
    num_ch, total = out.shape
    for start in range(0, total, chunk):
        blk = out[:, start:start + chunk]
        mask = np.isnan(blk)
        if not mask.any():
            continue
        n = blk.shape[1]
        # vectorized forward fill: index of the last non-NaN at or before i,
        # −1 (→ fill value 0.0) when none yet in this chunk
        idx = np.where(~mask, np.arange(n)[None, :], -1)
        np.maximum.accumulate(idx, axis=1, out=idx)
        padded = np.concatenate(
            [np.zeros((num_ch, 1), blk.dtype), blk], axis=1)
        out[:, start:start + chunk] = np.take_along_axis(padded, idx + 1, axis=1)
    return out


def _collapse_mono(block: np.ndarray, spec, cfg) -> np.ndarray:
    """Channel collapse (Mix = SUM / First / Last,
    FeatureExtractionImpl.scala:45-49) + the lossless raw-int16 shipping
    path for PCM16 sources (halves the upload bytes, dsp/frontend.py)."""
    if cfg.channels_behavior == ChannelsBehavior.MIX:
        mono = block.sum(axis=0)
    elif cfg.channels_behavior == ChannelsBehavior.FIRST:
        mono = block[0]
    else:
        mono = block[spec.num_channels - 1]
    if (spec.sample_format == af.SampleFormat.INT16
            and (spec.num_channels == 1
                 or cfg.channels_behavior != ChannelsBehavior.MIX)):
        mono = np.round(mono * 32768.0).astype(np.int16)
    return mono


def _stream_body(proc: Processor, cfg: ExtractionConfig, spec,
                 device) -> None:
    """Bounded-memory path: chunked read → streaming extraction → incremental
    feature-file write (NonRealtimeProcessor.scala:98-200)."""
    step = cfg.step_size
    feat_rate = spec.sample_rate / step

    reader = af.open_read(cfg.audio_input)
    writer = af.open_write(cfg.feature_output,
                           af.feature_spec(cfg.num_features, feat_rate))
    try:
        def read_samples(n):
            proc.check_aborted()
            return _collapse_mono(reader.read_frames(n), spec, cfg)

        def emit(feats):
            writer.write_frames(fix_nans(feats))

        with proc.sub(0.95):
            extract_features_streaming(
                read_samples, spec.num_frames, spec.sample_rate, emit,
                num_coeffs=cfg.num_coeffs, fft_size=cfg.fft_size,
                fft_overlap=cfg.fft_overlap,
                progress=proc.set_progress, device=device)
    finally:
        reader.close()
        writer.close()

    if cfg.meta_output:
        cfg.save_xml(cfg.meta_output)
    proc.set_progress(1.0)
    return None


def extract_batch_cli(in_files, target_dir: str, chan_mode: int,
                      device="cuda") -> int:
    """Batch extraction for the CLI ``-f`` sweep on ``device``.

    Small files are grouped (same sample rate, to a file-count/byte budget)
    into batched passes, while large files take the streaming path.  The
    transcript interleaves per file exactly like the reference's sequential
    chain (Strugatzki.scala:495-511, :610-631): ``Starting extraction…`` /
    25-# bar + ``  Success.`` / ``success = … - tail? …``.  The chain aborts
    on the first failure.

    ``STRUGATZKI_MESH=1`` on a host with several CUDA devices shards each
    group's batch over all of them (:func:`~..parallel.sweep.env_mesh`; data
    parallel over files), whatever ``device`` says.
    """
    in_files = list(in_files)
    group: list = []           # (index, head, cfg, mono, sr)
    mesh = env_mesh()

    def report(idx: int, success: bool) -> None:
        # the reference's whenDone debug line (Strugatzki.scala:507)
        tail = idx + 1 < len(in_files)
        print(f"success = {'true' if success else 'false'} - "
              f"tail? {'true' if tail else 'false'}")

    def flush_group() -> bool:
        """Run and report the pending group; on a per-file failure, report
        it like the reference chain and abort (returns False).  Always
        leaves the group empty."""
        if not group:
            return True
        pending = list(group)
        group.clear()
        sr = pending[0][4]
        print(f"Starting extraction... {os.path.basename(pending[0][1])}")
        try:
            audios = [m for _, _, _, m, _ in pending]
            head_cfg = pending[0][2]
            with trace("f.frontend", files=len(pending)):
                feats_dev, _ = extract_features_batch(
                    audios, sr, num_coeffs=head_cfg.num_coeffs,
                    fft_size=head_cfg.fft_size,
                    fft_overlap=head_cfg.fft_overlap, as_device=True,
                    device=device, mesh=mesh)
                feats_host = fetch(feats_dev)  # ONE fetch per group
        except Exception as e:  # noqa: BLE001 - first file carries the failure
            print("  Failed: ")
            traceback.print_exception(type(e), e, e.__traceback__)
            report(pending[0][0], False)
            return False
        for i, (idx, head, cfg, mono, _) in enumerate(pending):
            if i > 0:
                print(f"Starting extraction... {os.path.basename(head)}")
            try:
                with trace("f.write"):
                    total = num_output_frames(len(mono), cfg.step_size)
                    feats = fix_nans(finalize_features(feats_host[i], total))
                    af.write(cfg.feature_output, feats,
                             af.feature_spec(cfg.num_features,
                                             sr / cfg.step_size))
                    if cfg.meta_output:
                        cfg.save_xml(cfg.meta_output)
            except Exception as e:  # noqa: BLE001 - abort chain at this file
                print("  Failed: ")
                traceback.print_exception(type(e), e, e.__traceback__)
                report(idx, False)
                return False
            print("#" * 25 + "  Success.")
            report(idx, True)
        return True

    ok = True
    for idx, head in enumerate(in_files):
        name1 = os.path.splitext(os.path.basename(head))[0]
        cfg = ExtractionConfig(
            audio_input=head,
            feature_output=os.path.join(target_dir, f"{name1}_feat.aif"),
            meta_output=os.path.join(target_dir, f"{name1}_feat.xml"),
            channels_behavior=chan_mode).build()
        announced = False
        try:
            with trace("f.read"):
                spec = af.read_spec(head)
                streamed = (spec.num_frames * spec.num_channels
                            > STREAMING_THRESHOLD)
                if not streamed:
                    audio, spec = af.read(head)
                    mono = _collapse_mono(audio, spec, cfg)
            if streamed:
                if not flush_group():
                    ok = False
                    break
                print(f"Starting extraction... {os.path.basename(head)}")
                announced = True
                with trace("f.stream"):
                    Processor(FeatureExtraction._make_body(cfg, device),
                              name=FeatureExtraction.name).start().result()
                print("#" * 25 + "  Success.")
                report(idx, True)
                continue
            entry = (idx, head, cfg, mono, spec.sample_rate)
            if group and group[0][4] != spec.sample_rate:
                if not flush_group():
                    ok = False
                    break
            # flush BEFORE appending a file that would blow the projected
            # staged-bytes budget
            if group and _group_staged_bytes(group + [entry]) \
                    >= _GROUP_MAX_BYTES:
                if not flush_group():
                    ok = False
                    break
            group.append(entry)
            if (len(group) >= _GROUP_MAX_FILES
                    or _group_staged_bytes(group) >= _GROUP_MAX_BYTES):
                if not flush_group():
                    ok = False
                    break
        except Exception as e:  # noqa: BLE001 - per-file failure ends the chain
            if not flush_group():
                ok = False
                break
            if not announced:
                print(f"Starting extraction... {os.path.basename(head)}")
            print("  Failed: ")
            traceback.print_exception(type(e), e, e.__traceback__)
            report(idx, False)
            ok = False
            break
    if ok:
        ok = flush_group()
    return 0 if ok else 1


class FeatureExtraction(ProcessorFactory):
    """``FeatureExtraction.run(config, observer) -> Processor[None]``."""

    name = "feature extraction"
    Config = ExtractionConfig
    #: the device extraction runs on (process state, not config)
    device = "cuda"

    @classmethod
    def _make_body(cls, config: ExtractionConfig, device=None):
        cfg = config.build()
        if device is None:
            device = cls.device

        def body(proc: Processor):
            spec = af.read_spec(cfg.audio_input)
            if spec.num_frames * spec.num_channels > STREAMING_THRESHOLD:
                return _stream_body(proc, cfg, spec, device)
            audio, spec = af.read(cfg.audio_input)
            proc.check_aborted()
            mono = _collapse_mono(audio, spec, cfg)

            step = cfg.step_size
            feat_rate = spec.sample_rate / step

            with proc.sub(0.8):
                # one batched pass: progress fires once at 1.0 (the
                # streaming path above is the chunk-granular one)
                feats = extract_features(
                    mono, spec.sample_rate,
                    num_coeffs=cfg.num_coeffs, fft_size=cfg.fft_size,
                    fft_overlap=cfg.fft_overlap,
                    progress=lambda f: (proc.check_aborted(),
                                        proc.set_progress(f)),
                    device=device)

            proc.check_aborted()
            feats = fix_nans(feats)

            with proc.sub(0.2):
                af.write(cfg.feature_output, feats,
                         af.feature_spec(cfg.num_features, feat_rate))
                proc.set_progress(1.0)

            if cfg.meta_output:
                cfg.save_xml(cfg.meta_output)
            return None

        return body
