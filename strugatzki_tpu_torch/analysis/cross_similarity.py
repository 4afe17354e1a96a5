"""Sliding cross-similarity vector in PyTorch.

Port of ``strugatzki_tpu/analysis/cross_similarity.py`` (a re-implementation
of the reference's impl/CrossSimilarityImpl.scala): the shorter feature span
becomes an in-memory template, slid across the longer span one frame per
step with the correlation matcher's sim/boost formulas
(``analysis/correlation.py::sliding_traces``); the per-step similarity is
written as a 1-channel float audio file at the feature rate of
``meta_input1``, taken before the shorter/longer swap.

Like the JAX package, the output holds the evident intent's ``len2 − len1 +
1`` windows, not the reference's ring-buffer defect (docs/PARITY.md).
"""

from __future__ import annotations

from strugatzki_tpu.analysis.common import (full_to_feat, load_norm,
                                            normalized, read_features)
from strugatzki_tpu.config import CrossSimilarityConfig, ExtractionConfig
from strugatzki_tpu.io import audiofile as af
from strugatzki_tpu.runtime.processor import Processor, ProcessorFactory
from strugatzki_tpu.span import Span

from ..kernels import corr as K
from .correlation import InputTemplate, sliding_traces

__all__ = ["CrossSimilarity"]


# copied verbatim from the JAX package, whose module imports jax
def _open_span(extr: ExtractionConfig, span: Span, num_frames: int):
    """Feature-frame [start, stop) for a span (CrossSimilarityImpl.scala:67-80)."""
    step = extr.step_size
    if span.is_closed:
        lo, hi = full_to_feat(span.start, step), full_to_feat(span.stop, step)
    elif span.has_start:
        lo, hi = full_to_feat(span.start, step), num_frames
    elif span.has_stop:
        lo, hi = 0, full_to_feat(span.stop, step)
    else:
        lo, hi = 0, num_frames
    stop = min(num_frames, hi)
    start = max(0, min(stop, lo))
    return start, stop


class CrossSimilarity(ProcessorFactory):
    """``CrossSimilarity.run(config, observer) -> Processor[None]``
    (writes the similarity audio file)."""

    name = "cross similarity"
    Config = CrossSimilarityConfig
    #: the device the sliding trace runs on (process state, not config)
    device = "cuda"

    @classmethod
    def _make_body(cls, config: CrossSimilarityConfig):
        cfg = config.build()
        device = cls.device

        def body(proc: Processor):
            extr1 = ExtractionConfig.from_xml_file(cfg.meta_input1)
            extr2 = ExtractionConfig.from_xml_file(cfg.meta_input2)
            if (extr1.fft_size != extr2.fft_size
                    or extr1.fft_overlap != extr2.fft_overlap
                    or extr1.num_coeffs != extr2.num_coeffs):
                raise ValueError(
                    f"Analysis settings for {cfg.meta_input1} and "
                    f"{cfg.meta_input2} differ.")

            norm = load_norm(cfg.database_folder, extr1.num_coeffs) \
                if cfg.normalize else None

            f1, spec1 = af.read(extr1.feature_output)
            f2 = read_features(extr2)
            s1, e1 = _open_span(extr1, cfg.span1, f1.shape[1])
            s2, e2 = _open_span(extr2, cfg.span2, f2.shape[1])
            a1, a2 = f1[:, s1:e1], f2[:, s2:e2]

            # output rate comes from input 1's feature file, pre-swap (:87-89)
            rate1 = spec1.sample_rate

            # shorter span becomes the template (:92-94)
            if a1.shape[1] < a2.shape[1]:
                tmpl_src, sig_src = a1, a2
            else:
                tmpl_src, sig_src = a2, a1
            if tmpl_src.shape[1] == 0 or sig_src.shape[1] == 0:
                raise ValueError("empty span")

            template = InputTemplate(normalized(tmpl_src, norm))
            xs, shift_t, shift_s = K.shift_per_group(
                normalized(sig_src, norm))
            proc.check_aborted()
            # the reference reports per-output-frame progress
            # (CrossSimilarityImpl.scala:169); the device computes the whole
            # trace in one pass, so stage the fractions around it
            proc.set_progress(0.1)
            sims, _boosts = sliding_traces(
                xs, shift_t, shift_s, template, sig_src.shape[1],
                cfg.temporal_weight, cfg.max_boost, device=device)
            proc.check_aborted()
            proc.set_progress(0.9)

            af.write(cfg.audio_output, sims[None, :],
                     af.AudioFileSpec(cfg.audio_output_type,
                                      af.SampleFormat.FLOAT, 1, rate1))
            proc.set_progress(1.0)
            return None

        return body
