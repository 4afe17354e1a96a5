"""Command-line interface of the PyTorch port.

The same switches and transcripts as ``strugatzki_tpu.cli`` (whose parser
helpers and formatting it reuses):

    python -m strugatzki_tpu_torch.cli -f [--device D] [-d dir] inputs...
    python -m strugatzki_tpu_torch.cli --stats -d dir
    python -m strugatzki_tpu_torch.cli -c [--device D] ... input_feat.xml
    python -m strugatzki_tpu_torch.cli -s [--device D] ... input_feat.xml
    python -m strugatzki_tpu_torch.cli -x [--device D] ... input_feat.xml out.png
    python -m strugatzki_tpu_torch.cli -y [--device D] ... in1_feat.xml in2_feat.xml out.aif

``--device`` is ``cuda`` (the default) or ``cpu``; CUDA is never replaced by
the CPU unless asked.  The port has no multi-device paths yet, so it does
not read ``STRUGATZKI_MESH``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from strugatzki_tpu.cli import (_USAGE, NAME, _fail, _go, _mk_span, _parser,
                                _secs_to_frames, to_db_str, to_percent_str)
from strugatzki_tpu.config import (NORMALIZE_NAME, ChannelsBehavior,
                                   CorrelationConfig, CrossSimilarityConfig,
                                   ExtractionConfig, Punch,
                                   SegmentationConfig, SelfSimilarityConfig)
from strugatzki_tpu.io import audiofile as af
from strugatzki_tpu.io.formats import AIFF
from strugatzki_tpu.span import Span

__all__ = ["main"]


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="Torch device (cuda|cpu ; defaults to 'cuda')")


def feature_pre(args) -> int:
    """Batch feature extraction (Strugatzki.scala:450-522)."""
    p = _parser(f"{NAME} -f")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--dir", required=True, help="Target directory")
    p.add_argument("-c", "--channels", default="mix",
                   help="Channel mode (mix|first|last ; defaults to 'mix')")
    _add_device(p)
    p.add_argument("inputs", nargs="+",
                   help="List of input files or directories")
    ns = p.parse_args(args)

    try:
        chan_mode = ChannelsBehavior.from_name(ns.channels)
    except ValueError:
        p.print_usage()
        return 1

    from .analysis.extraction import FeatureExtraction, extract_batch_cli
    FeatureExtraction.verbose = ns.verbose
    FeatureExtraction.device = ns.device

    in_files = []
    # the reference's scopt action prepends, so it processes the bare input
    # arguments in REVERSE command-line order (Strugatzki.scala:458, :475);
    # directory entries keep a stable sorted order
    for f in reversed(ns.inputs):
        if os.path.isfile(f):
            in_files.append(f)
        elif os.path.isdir(f):
            for child in sorted(os.listdir(f)):
                path = os.path.join(f, child)
                if os.path.isfile(path) and af.identify(path) is not None:
                    in_files.append(path)
        else:
            raise SystemExit(f"Not a valid input: {f}")

    return extract_batch_cli(in_files, ns.dir, chan_mode, device=ns.device)


def feature_corr(args) -> int:
    """Correlation search (Strugatzki.scala:101-213)."""
    p = _parser(f"{NAME} -c")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--dir", required=True, help="Database directory")
    p.add_argument("--in-start", type=float, required=True)
    p.add_argument("--in-stop", type=float, required=True)
    p.add_argument("--in-temp", type=float, default=0.5)
    p.add_argument("--out-start", type=float)
    p.add_argument("--out-stop", type=float)
    p.add_argument("--out-temp", type=float, default=0.5)
    p.add_argument("--dur-min", type=float, required=True)
    p.add_argument("--dur-max", type=float, required=True)
    p.add_argument("--boost-max", type=float, default=8.0)
    p.add_argument("-m", "--num-matches", type=int, default=1)
    p.add_argument("--num-per-file", type=int, default=1)
    p.add_argument("--spacing", type=float, default=0.0)
    p.add_argument("--no-norm", action="store_true")
    _add_device(p)
    p.add_argument("input", help="Meta file of input to process")
    ns = p.parse_args(args)

    meta_in = ExtractionConfig.from_xml_file(ns.input)
    sr = af.read_spec(meta_in.audio_input).sample_rate

    if (ns.out_start is None) != (ns.out_stop is None):
        p.print_usage()
        return 1
    punch_out = None
    if ns.out_start is not None:
        out_span = Span(_secs_to_frames(ns.out_start, sr),
                        _secs_to_frames(ns.out_stop, sr))
        if out_span.length <= 0:
            raise SystemExit("Punch out span is empty")
        punch_out = Punch(out_span, ns.out_temp)

    in_span = Span(_secs_to_frames(ns.in_start, sr),
                   _secs_to_frames(ns.in_stop, sr))
    if in_span.length <= 0:
        raise SystemExit("Punch in span is empty")
    min_frames = _secs_to_frames(ns.dur_min, sr)
    if min_frames <= 0:
        raise SystemExit("Minimum duration is zero")
    max_frames = _secs_to_frames(ns.dur_max, sr)
    if max_frames < min_frames:
        raise SystemExit("Maximum duration is smaller than minimum duration")

    from .analysis.correlation import FeatureCorrelation
    FeatureCorrelation.verbose = ns.verbose
    FeatureCorrelation.device = ns.device
    cfg = CorrelationConfig(
        database_folder=ns.dir, meta_input=ns.input,
        punch_in=Punch(in_span, ns.in_temp), punch_out=punch_out,
        min_punch=min_frames, max_punch=max_frames,
        normalize=not ns.no_norm, max_boost=ns.boost_max,
        num_matches=ns.num_matches, num_per_file=ns.num_per_file,
        min_spacing=_secs_to_frames(ns.spacing, sr))

    res = _go(FeatureCorrelation, cfg)
    if res.is_success:
        matches = res.value
        if matches:
            print("  Success.")
            for m in matches:
                print(f"\nFile      {os.path.abspath(m.file)}"
                      f"\nSimilarity: {to_percent_str(m.sim)}"
                      f"\nSpan start: {m.punch.start}"
                      f"\nBoost in  : {to_db_str(m.boost_in)}")
                if punch_out is not None:
                    print(f"Span stop : {m.punch.stop}"
                          f"\nBoost out : {to_db_str(m.boost_out)}")
            print()
        else:
            print("  No matches found.")
        return 0
    _fail(res)
    return 1


def feature_stats(args) -> int:
    """Database statistics → feat_norms.aif (Strugatzki.scala:400-443).
    Host-only NumPy: it takes no device."""
    p = _parser(f"{NAME} --stats")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--dir", required=True, help="Database directory")
    ns = p.parse_args(args)

    print("Starting stats... ")
    paths = sorted(os.path.join(ns.dir, n) for n in os.listdir(ns.dir)
                   if n.endswith("_feat.aif"))

    from .analysis.feature_stats import FeatureStats
    res = _go(FeatureStats, paths)
    if res.is_success:
        spans = res.value
        print("  Success.")
        # the CLI owns writing the norm file (:417-429)
        b = np.zeros((len(spans), 2), np.float32)
        for i, (mn, mx) in enumerate(spans):
            b[i, 0] = mn
            b[i, 1] = mx
        af.write(os.path.join(ns.dir, NORMALIZE_NAME), b,
                 af.AudioFileSpec(AIFF, af.SampleFormat.FLOAT,
                                  len(spans), 44100.0))
        print("Done.")
        return 0
    _fail(res)
    return 1


def feature_segm(args) -> int:
    """Segmentation (Strugatzki.scala:219-304)."""
    p = _parser(f"{NAME} -s")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--dir")
    p.add_argument("--length", type=float, default=0.5)
    p.add_argument("--temp", type=float, default=0.5)
    p.add_argument("--span-start", type=float)
    p.add_argument("--span-stop", type=float)
    p.add_argument("-m", "--num-breaks", type=int, default=1)
    p.add_argument("--spacing", type=float, default=0.2)
    p.add_argument("--no-norm", action="store_true")
    _add_device(p)
    p.add_argument("input", help="Meta file of input to process")
    ns = p.parse_args(args)

    meta_in = ExtractionConfig.from_xml_file(ns.input)
    sr = af.read_spec(meta_in.audio_input).sample_rate

    span = _mk_span(ns.span_start, ns.span_stop, sr)
    if not span.non_empty:
        # reference: require(span.nonEmpty, "Span is empty")
        raise SystemExit("requirement failed: Span is empty")
    corr_frames = _secs_to_frames(ns.length, sr)
    if corr_frames <= 0:
        raise SystemExit("Correlation duration is zero")

    normalize = not ns.no_norm
    if normalize and ns.dir is None:
        p.print_usage()
        return 1

    from .analysis.segmentation import FeatureSegmentation
    FeatureSegmentation.verbose = ns.verbose
    FeatureSegmentation.device = ns.device
    cfg = SegmentationConfig(
        database_folder=ns.dir or "database", meta_input=ns.input, span=span,
        corr_len=corr_frames, temporal_weight=ns.temp, normalize=normalize,
        num_breaks=ns.num_breaks,
        min_spacing=_secs_to_frames(ns.spacing, sr))

    res = _go(FeatureSegmentation, cfg)
    if res.is_success:
        breaks = res.value
        if breaks:
            print("  Success.")
            for b in breaks:
                print(f"\nSimilarity: {to_percent_str(b.sim)}"
                      f"\nPosition:   {b.pos}")
            print()
        else:
            print("  No breaks found.")
        return 0
    _fail(res)
    return 1


def feature_self(args) -> int:
    """Self-similarity image (Strugatzki.scala:306-398)."""
    p = _parser(f"{NAME} -x")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--dir")
    p.add_argument("--length", type=float, default=1.0)
    p.add_argument("--temp", type=float, default=0.5)
    p.add_argument("--span-start", type=float)
    p.add_argument("--span-stop", type=float)
    p.add_argument("-c", "--colors", default="psycho",
                   help="Color scale (gray|psycho ; defaults to 'psycho')")
    p.add_argument("--color-warp", type=float, default=1.0)
    p.add_argument("--color-ceil", type=float, default=1.0)
    p.add_argument("-i", "--color-inv", action="store_true")
    p.add_argument("-m", "--decim", type=int, default=1)
    p.add_argument("--input2", help="Second meta input for cross-similarity")
    p.add_argument("--no-norm", action="store_true")
    _add_device(p)
    p.add_argument("input", help="Meta file of input to process")
    p.add_argument("output", help="Image output file")
    ns = p.parse_args(args)

    meta_in = ExtractionConfig.from_xml_file(ns.input)
    sr = af.read_spec(meta_in.audio_input).sample_rate
    span = _mk_span(ns.span_start, ns.span_stop, sr)
    if not span.non_empty:
        # reference: require(span.nonEmpty, "Span is empty")
        raise SystemExit("requirement failed: Span is empty")
    corr_frames = _secs_to_frames(ns.length, sr)
    if corr_frames <= 0:
        raise SystemExit("Correlation duration is zero")

    normalize = not ns.no_norm
    if normalize and ns.dir is None:
        p.print_usage()
        return 1

    from .analysis.self_similarity import SelfSimilarity
    SelfSimilarity.verbose = ns.verbose
    SelfSimilarity.device = ns.device
    cfg = SelfSimilarityConfig(
        database_folder=ns.dir or "database", meta_input=ns.input,
        meta_input2=ns.input2, image_output=ns.output, span=span,
        corr_len=corr_frames, decimation=ns.decim, temporal_weight=ns.temp,
        colors=ns.colors, color_warp=ns.color_warp, color_ceil=ns.color_ceil,
        color_inv=ns.color_inv, normalize=normalize)

    res = _go(SelfSimilarity, cfg)
    if res.is_success:
        print("  Done.")
        print()
        return 0
    _fail(res)
    return 1


def feature_cross(args) -> int:
    """Cross-similarity vector (Strugatzki.scala:524-608)."""
    p = _parser(f"{NAME} -y")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--dir")
    p.add_argument("--temp", type=float, default=0.5)
    p.add_argument("--span1-start", type=float)
    p.add_argument("--span1-stop", type=float)
    p.add_argument("--span2-start", type=float)
    p.add_argument("--span2-stop", type=float)
    p.add_argument("--boost-max", type=float, default=8.0)
    p.add_argument("--no-norm", action="store_true")
    _add_device(p)
    p.add_argument("input1", help="Meta file of first input")
    p.add_argument("input2", help="Meta file of second input")
    p.add_argument("output", help="Audio output file")
    ns = p.parse_args(args)

    normalize = not ns.no_norm
    if normalize and ns.dir is None:
        print("Either choose --no-norm or specify a database --dir.",
              file=sys.stderr)
        return 1

    meta1 = ExtractionConfig.from_xml_file(ns.input1)
    sr1 = af.read_spec(meta1.audio_input).sample_rate
    meta2 = ExtractionConfig.from_xml_file(ns.input2)
    sr2 = af.read_spec(meta2.audio_input).sample_rate

    from .analysis.cross_similarity import CrossSimilarity
    CrossSimilarity.verbose = ns.verbose
    CrossSimilarity.device = ns.device
    cfg = CrossSimilarityConfig(
        database_folder=ns.dir or "database",
        meta_input1=ns.input1, meta_input2=ns.input2,
        span1=_mk_span(ns.span1_start, ns.span1_stop, sr1),
        span2=_mk_span(ns.span2_start, ns.span2_stop, sr2),
        temporal_weight=ns.temp, normalize=normalize,
        max_boost=ns.boost_max)
    cfg.set_audio_output(ns.output)  # output type inferred from extension

    res = _go(CrossSimilarity, cfg)
    if res.is_success:
        print("  Success.")
        return 0
    _fail(res)
    return 1


_SWITCHES = {
    "-f": feature_pre, "--feature": feature_pre,
    "-c": feature_corr, "--correlate": feature_corr,
    "-s": feature_segm, "--segmentation": feature_segm,
    "-x": feature_self, "--selfsimilarity": feature_self,
    "-y": feature_cross, "--crosssimilarity": feature_cross,
    "--stats": feature_stats,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in _SWITCHES:
        print(_USAGE, file=sys.stderr)
        return 1
    return _SWITCHES[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
