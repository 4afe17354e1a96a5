"""Configurations, result types, and their XML (de)serialization.

This is the persistence-compatible public surface of the framework: every
config and result type round-trips through the same XML element names and
field encodings as the reference, so meta sidecars (``*_feat.xml``), saved
searches and results written by either implementation are readable by both.

Reference citations (all into ``/root/reference/src/main/scala/de/sciss/strugatzki/``):

* ``<feature>``          — FeatureExtraction.scala:163-206
* ``<correlate>``        — FeatureCorrelation.scala:231-272, ``<punch>`` :84-100,
  ``<match>`` :36-63
* ``<segmentation>``     — FeatureSegmentation.scala:179-211, ``<break>`` :39-55
* ``<selfsimilarity>``   — SelfSimilarity.scala:223-282
* ``<crosssimilarity>``  — CrossSimilarity.scala:207-261

The reference's mutable ``ConfigBuilder`` → immutable ``Config`` pattern maps
to plain mutable dataclasses here; ``build()`` returns a frozen copy, and all
analysis entry points accept either (builders are built on the fly).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .io.formats import (AIFF, AudioFileType, audio_file_type_by_id,
                         audio_file_type_for_extension)
from .span import Span, span_from_xml, span_to_xml

__all__ = [
    "NORMALIZE_NAME", "tmp_dir",
    "ChannelsBehavior", "ExtractionConfig",
    "Punch", "Match", "CorrelationConfig",
    "Break", "SegmentationConfig",
    "ColorScheme", "SelfSimilarityConfig",
    "CrossSimilarityConfig",
    "fmt_f32", "parse_bool",
]

#: Name of the normalization file inside a database folder
#: (reference Strugatzki.scala:36).
NORMALIZE_NAME = "feat_norms.aif"

#: Directory for temporary feature files (reference Strugatzki.scala:37).
tmp_dir = tempfile.gettempdir()


# ---------------------------------------------------------------------------
# serde helpers
# ---------------------------------------------------------------------------

def fmt_f32(value: float) -> str:
    """Format a float with the shortest decimal that round-trips at f32.

    The reference writes Scala ``Float``s; we keep values exact at float32
    precision so re-parsing on either side yields the identical f32.
    Specials use Java spellings (``NaN``/``Infinity``) so the reference's
    ``.toFloat`` can parse them (NaN similarities are reachable, see
    analysis/topk.py).
    """
    f = np.float32(value)
    if np.isnan(f):
        return "NaN"
    if np.isinf(f):
        return "Infinity" if f > 0 else "-Infinity"
    return np.format_float_positional(f, unique=True, trim="-")


def _f32(value: float) -> float:
    """Round to float32 precision (all reference similarity/weight fields are
    Scala ``Float``s); keeps equality stable across XML round-trips."""
    return float(np.float32(value))


def parse_bool(text: str) -> bool:
    """Parse Scala ``String.toBoolean`` style booleans."""
    t = text.strip().lower()
    if t == "true":
        return True
    if t == "false":
        return False
    raise ValueError(f"not a boolean: {text!r}")


def _bool_str(b: bool) -> str:
    return "true" if b else "false"


def _text(xml: ET.Element, tag: str) -> str:
    el = xml.find(tag)
    return (el.text or "") if el is not None else ""


def _to_xml_string(elem: ET.Element) -> str:
    body = ET.tostring(elem, encoding="unicode")
    return "<?xml version='1.0' encoding='UTF-8'?>\n" + body


def _save_xml(elem: ET.Element, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(_to_xml_string(elem))


def _load_xml(path: str) -> ET.Element:
    try:
        return ET.parse(path).getroot()
    except (OSError, ET.ParseError) as e:
        raise IOError(f"In file: {path}: {e}") from e


def _fspath(p) -> str:
    return os.fspath(p) if p is not None else p


# ---------------------------------------------------------------------------
# FeatureExtraction
# ---------------------------------------------------------------------------

class ChannelsBehavior:
    """How multichannel inputs collapse to the mono analysis signal.

    Ids match reference FeatureExtraction.scala:45-51 (Mix=0, First=1, Last=2).
    """

    MIX = 0
    FIRST = 1
    LAST = 2

    _VALID = (0, 1, 2)
    _NAMES = {0: "mix", 1: "first", 2: "last"}

    @staticmethod
    def check(value: int) -> int:
        if value not in ChannelsBehavior._VALID:
            raise ValueError(f"illegal ChannelsBehavior id {value}")
        return value

    @staticmethod
    def from_name(name: str) -> int:
        for k, v in ChannelsBehavior._NAMES.items():
            if v == name.lower():
                return k
        raise ValueError(f"illegal ChannelsBehavior name {name!r}")


@dataclass
class ExtractionConfig:
    """Feature-extraction settings (reference FeatureExtraction.scala:112-174).

    ``feature_output`` defaults to a fresh temp file under :data:`tmp_dir`
    (reference :123-127); ``step size = fft_size // fft_overlap``.
    """

    audio_input: str = "input.aif"
    feature_output: Optional[str] = None
    meta_output: Optional[str] = None
    num_coeffs: int = 13
    fft_size: int = 1024
    fft_overlap: int = 2
    channels_behavior: int = ChannelsBehavior.MIX

    def __post_init__(self) -> None:
        self.audio_input = _fspath(self.audio_input)
        self.feature_output = _fspath(self.feature_output)
        self.meta_output = _fspath(self.meta_output)

    @property
    def step_size(self) -> int:
        return self.fft_size // self.fft_overlap

    @property
    def num_features(self) -> int:
        """Loudness + MFCCs (reference FeatureExtractionImpl.scala:37)."""
        return self.num_coeffs + 1

    def build(self) -> "ExtractionConfig":
        cfg = dataclasses.replace(self)
        if cfg.feature_output is None:
            # mint the temp path ONCE and cache it on this builder, like
            # the reference's lazy _featureOutput (FeatureExtraction.scala:
            # 123-127) — repeated build()/to_xml() must agree on the path
            # (a saved meta sidecar has to point at the file run() writes)
            fd, path = tempfile.mkstemp(prefix="features", suffix=".aif",
                                        dir=tmp_dir)
            os.close(fd)
            self.feature_output = path
            cfg.feature_output = path
        ChannelsBehavior.check(cfg.channels_behavior)
        return cfg

    # -- XML --------------------------------------------------------------------

    def to_xml(self) -> ET.Element:
        cfg = self.build()
        e = ET.Element("feature")
        ET.SubElement(e, "input").text = cfg.audio_input
        ET.SubElement(e, "output").text = cfg.feature_output
        ET.SubElement(e, "meta").text = cfg.meta_output or ""
        ET.SubElement(e, "numCoeffs").text = str(cfg.num_coeffs)
        ET.SubElement(e, "fftSize").text = str(cfg.fft_size)
        ET.SubElement(e, "fftOverlap").text = str(cfg.fft_overlap)
        ET.SubElement(e, "channels").text = str(cfg.channels_behavior)
        return e

    def to_xml_string(self) -> str:
        return _to_xml_string(self.to_xml())

    def save_xml(self, path: str) -> None:
        _save_xml(self.to_xml(), _fspath(path))

    @staticmethod
    def from_xml(xml: ET.Element) -> "ExtractionConfig":
        meta = _text(xml, "meta")
        channels = _text(xml, "channels")
        cfg = ExtractionConfig(
            audio_input=_text(xml, "input"),
            feature_output=_text(xml, "output"),
            meta_output=meta if meta else None,
            num_coeffs=int(_text(xml, "numCoeffs")),
            fft_size=int(_text(xml, "fftSize")),
            fft_overlap=int(_text(xml, "fftOverlap")),
            # absent <channels> tag defaults to Mix (reference :201-204)
            channels_behavior=int(channels) if channels else ChannelsBehavior.MIX,
        )
        return cfg.build()

    @staticmethod
    def from_xml_file(path) -> "ExtractionConfig":
        return ExtractionConfig.from_xml(_load_xml(_fspath(path)))


# ---------------------------------------------------------------------------
# FeatureCorrelation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Punch:
    """A punch span with temporal/spectral blending weight
    (reference FeatureCorrelation.scala:84-100)."""

    span: Span
    temporal_weight: float = 0.5

    def __post_init__(self) -> None:
        object.__setattr__(self, "temporal_weight", _f32(self.temporal_weight))

    def to_xml(self) -> ET.Element:
        e = ET.Element("punch")
        ET.SubElement(e, "start").text = str(self.span.start)
        ET.SubElement(e, "stop").text = str(self.span.stop)
        ET.SubElement(e, "weight").text = fmt_f32(self.temporal_weight)
        return e

    @staticmethod
    def from_xml(xml: ET.Element) -> "Punch":
        return Punch(
            span=Span(int(_text(xml, "start")), int(_text(xml, "stop"))),
            temporal_weight=float(np.float32(_text(xml, "weight"))),
        )


@dataclass(frozen=True)
class Match:
    """A correlation match result (reference FeatureCorrelation.scala:48-70).

    ``sim`` of 1.0 is an identical match; ``boost_in``/``boost_out`` are the
    estimated gain factors at punch start/stop.
    """

    sim: float
    file: str
    punch: Span
    boost_in: float
    boost_out: float

    def __post_init__(self) -> None:
        object.__setattr__(self, "sim", _f32(self.sim))
        object.__setattr__(self, "boost_in", _f32(self.boost_in))
        object.__setattr__(self, "boost_out", _f32(self.boost_out))

    def to_xml(self) -> ET.Element:
        e = ET.Element("match")
        ET.SubElement(e, "sim").text = fmt_f32(self.sim)
        ET.SubElement(e, "file").text = self.file
        ET.SubElement(e, "start").text = str(self.punch.start)
        ET.SubElement(e, "stop").text = str(self.punch.stop)
        ET.SubElement(e, "boostIn").text = fmt_f32(self.boost_in)
        ET.SubElement(e, "boostOut").text = fmt_f32(self.boost_out)
        return e

    @staticmethod
    def from_xml(xml: ET.Element) -> "Match":
        return Match(
            sim=float(np.float32(_text(xml, "sim"))),
            file=_text(xml, "file"),
            punch=Span(int(_text(xml, "start")), int(_text(xml, "stop"))),
            boost_in=float(np.float32(_text(xml, "boostIn"))),
            boost_out=float(np.float32(_text(xml, "boostOut"))),
        )


@dataclass
class CorrelationConfig:
    """Database correlation-search settings
    (reference FeatureCorrelation.scala:168-246).

    All spans/durations in audio sample frames.
    """

    database_folder: str = "database"
    meta_input: str = "input_feat.xml"
    punch_in: Punch = field(default_factory=lambda: Punch(Span(0, 44100), 0.5))
    punch_out: Optional[Punch] = None
    min_punch: int = 22050
    max_punch: int = 88200
    normalize: bool = True
    max_boost: float = 8.0
    num_matches: int = 1
    num_per_file: int = 1
    min_spacing: int = 0

    def __post_init__(self) -> None:
        self.database_folder = _fspath(self.database_folder)
        self.meta_input = _fspath(self.meta_input)
        self.max_boost = _f32(self.max_boost)

    def build(self) -> "CorrelationConfig":
        return dataclasses.replace(self)

    def to_xml(self) -> ET.Element:
        e = ET.Element("correlate")
        ET.SubElement(e, "database").text = self.database_folder
        ET.SubElement(e, "input").text = self.meta_input
        pi = ET.SubElement(e, "punchIn")
        pi.extend(list(self.punch_in.to_xml()))
        if self.punch_out is not None:
            po = ET.SubElement(e, "punchOut")
            po.extend(list(self.punch_out.to_xml()))
        ET.SubElement(e, "minPunch").text = str(self.min_punch)
        ET.SubElement(e, "maxPunch").text = str(self.max_punch)
        ET.SubElement(e, "normalize").text = _bool_str(self.normalize)
        ET.SubElement(e, "maxBoost").text = fmt_f32(self.max_boost)
        ET.SubElement(e, "numMatches").text = str(self.num_matches)
        ET.SubElement(e, "numPerFile").text = str(self.num_per_file)
        ET.SubElement(e, "minSpacing").text = str(self.min_spacing)
        return e

    def to_xml_string(self) -> str:
        return _to_xml_string(self.to_xml())

    def save_xml(self, path: str) -> None:
        _save_xml(self.to_xml(), _fspath(path))

    @staticmethod
    def from_xml(xml: ET.Element) -> "CorrelationConfig":
        po = xml.find("punchOut")
        return CorrelationConfig(
            database_folder=_text(xml, "database"),
            meta_input=_text(xml, "input"),
            punch_in=Punch.from_xml(xml.find("punchIn")),
            punch_out=Punch.from_xml(po) if po is not None else None,
            min_punch=int(_text(xml, "minPunch")),
            max_punch=int(_text(xml, "maxPunch")),
            normalize=parse_bool(_text(xml, "normalize")),
            max_boost=float(np.float32(_text(xml, "maxBoost"))),
            num_matches=int(_text(xml, "numMatches")),
            num_per_file=int(_text(xml, "numPerFile")),
            min_spacing=int(_text(xml, "minSpacing")),
        )

    @staticmethod
    def from_xml_file(path) -> "CorrelationConfig":
        return CorrelationConfig.from_xml(_load_xml(_fspath(path)))


# ---------------------------------------------------------------------------
# FeatureSegmentation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Break:
    """A segmentation breaking point (reference FeatureSegmentation.scala:47-55).

    ``sim`` is the (low) correlation at the break, ``pos`` the position in
    audio sample frames (window centre).
    """

    sim: float
    pos: int

    def __post_init__(self) -> None:
        object.__setattr__(self, "sim", _f32(self.sim))

    def to_xml(self) -> ET.Element:
        e = ET.Element("break")
        ET.SubElement(e, "sim").text = fmt_f32(self.sim)
        ET.SubElement(e, "pos").text = str(self.pos)
        return e

    @staticmethod
    def from_xml(xml: ET.Element) -> "Break":
        return Break(sim=float(np.float32(_text(xml, "sim"))), pos=int(_text(xml, "pos")))


@dataclass
class SegmentationConfig:
    """Novelty-segmentation settings (reference FeatureSegmentation.scala:134-191).

    ``database_folder`` is only used to locate the normalization file.
    """

    database_folder: str = "database"
    meta_input: str = "input_feat.xml"
    span: Span = field(default_factory=Span.all)
    corr_len: int = 22050
    temporal_weight: float = 0.5
    normalize: bool = True
    num_breaks: int = 1
    min_spacing: int = 22050

    def __post_init__(self) -> None:
        self.database_folder = _fspath(self.database_folder)
        self.meta_input = _fspath(self.meta_input)
        self.temporal_weight = _f32(self.temporal_weight)

    def build(self) -> "SegmentationConfig":
        return dataclasses.replace(self)

    def to_xml(self) -> ET.Element:
        e = ET.Element("segmentation")
        ET.SubElement(e, "database").text = self.database_folder
        ET.SubElement(e, "input").text = self.meta_input
        # <span> is always present, possibly empty (reference :183)
        sp = ET.SubElement(e, "span")
        span_to_xml(self.span, sp)
        ET.SubElement(e, "corr").text = str(self.corr_len)
        ET.SubElement(e, "weight").text = fmt_f32(self.temporal_weight)
        ET.SubElement(e, "normalize").text = _bool_str(self.normalize)
        ET.SubElement(e, "numBreaks").text = str(self.num_breaks)
        ET.SubElement(e, "minSpacing").text = str(self.min_spacing)
        return e

    def to_xml_string(self) -> str:
        return _to_xml_string(self.to_xml())

    def save_xml(self, path: str) -> None:
        _save_xml(self.to_xml(), _fspath(path))

    @staticmethod
    def from_xml(xml: ET.Element) -> "SegmentationConfig":
        return SegmentationConfig(
            database_folder=_text(xml, "database"),
            meta_input=_text(xml, "input"),
            span=span_from_xml(xml.find("span")),
            corr_len=int(_text(xml, "corr")),
            temporal_weight=float(np.float32(_text(xml, "weight"))),
            normalize=parse_bool(_text(xml, "normalize")),
            num_breaks=int(_text(xml, "numBreaks")),
            min_spacing=int(_text(xml, "minSpacing")),
        )

    @staticmethod
    def from_xml_file(path) -> "SegmentationConfig":
        return SegmentationConfig.from_xml(_load_xml(_fspath(path)))


# ---------------------------------------------------------------------------
# SelfSimilarity
# ---------------------------------------------------------------------------

class ColorScheme:
    """Image color schemes (reference SelfSimilarity.scala:30-56)."""

    GRAY_SCALE = "gray"
    PSYCHO_OPTICAL = "psycho"

    ALL = (GRAY_SCALE, PSYCHO_OPTICAL)

    @staticmethod
    def check(name: str) -> str:
        if name not in ColorScheme.ALL:
            raise ValueError(f"unknown color scheme {name!r}")
        return name


@dataclass
class SelfSimilarityConfig:
    """Self-/cross-similarity matrix image settings
    (reference SelfSimilarity.scala:153-239).

    ``meta_input2`` switches to cross-mode (two files, one matrix).
    """

    database_folder: str = "database"
    meta_input: str = "input_feat.xml"
    meta_input2: Optional[str] = None
    image_output: str = "output_selfsim.png"
    span: Span = field(default_factory=Span.all)
    corr_len: int = 44100
    decimation: int = 1
    temporal_weight: float = 0.5
    colors: str = ColorScheme.PSYCHO_OPTICAL
    color_warp: float = 1.0
    color_ceil: float = 1.0
    color_inv: bool = False
    normalize: bool = True

    def __post_init__(self) -> None:
        self.database_folder = _fspath(self.database_folder)
        self.meta_input = _fspath(self.meta_input)
        self.meta_input2 = _fspath(self.meta_input2)
        self.image_output = _fspath(self.image_output)
        self.temporal_weight = _f32(self.temporal_weight)
        self.color_warp = _f32(self.color_warp)
        self.color_ceil = _f32(self.color_ceil)

    def build(self) -> "SelfSimilarityConfig":
        ColorScheme.check(self.colors)
        return dataclasses.replace(self)

    def to_xml(self) -> ET.Element:
        e = ET.Element("selfsimilarity")
        ET.SubElement(e, "database").text = self.database_folder
        ET.SubElement(e, "input").text = self.meta_input
        if self.meta_input2 is not None:
            ET.SubElement(e, "input2").text = self.meta_input2
        ET.SubElement(e, "output").text = self.image_output
        if not self.span.is_all:
            sp = ET.SubElement(e, "span")
            span_to_xml(self.span, sp)
        ET.SubElement(e, "corr").text = str(self.corr_len)
        ET.SubElement(e, "decimation").text = str(self.decimation)
        ET.SubElement(e, "weight").text = fmt_f32(self.temporal_weight)
        ET.SubElement(e, "colors").text = self.colors
        ET.SubElement(e, "colorWarp").text = fmt_f32(self.color_warp)
        ET.SubElement(e, "colorCeil").text = fmt_f32(self.color_ceil)
        ET.SubElement(e, "colorInv").text = _bool_str(self.color_inv)
        ET.SubElement(e, "normalize").text = _bool_str(self.normalize)
        return e

    def to_xml_string(self) -> str:
        return _to_xml_string(self.to_xml())

    def save_xml(self, path: str) -> None:
        _save_xml(self.to_xml(), _fspath(path))

    @staticmethod
    def from_xml(xml: ET.Element) -> "SelfSimilarityConfig":
        input2 = _text(xml, "input2")
        return SelfSimilarityConfig(
            database_folder=_text(xml, "database"),
            meta_input=_text(xml, "input"),
            meta_input2=input2 if input2 else None,
            image_output=_text(xml, "output"),
            span=span_from_xml(xml.find("span")),
            corr_len=int(_text(xml, "corr")),
            decimation=int(_text(xml, "decimation")),
            temporal_weight=float(np.float32(_text(xml, "weight"))),
            colors=ColorScheme.check(_text(xml, "colors")),
            color_warp=float(np.float32(_text(xml, "colorWarp"))),
            color_ceil=float(np.float32(_text(xml, "colorCeil"))),
            color_inv=parse_bool(_text(xml, "colorInv")),
            normalize=parse_bool(_text(xml, "normalize")),
        )

    @staticmethod
    def from_xml_file(path) -> "SelfSimilarityConfig":
        return SelfSimilarityConfig.from_xml(_load_xml(_fspath(path)))


# ---------------------------------------------------------------------------
# CrossSimilarity
# ---------------------------------------------------------------------------

@dataclass
class CrossSimilarityConfig:
    """Sliding cross-similarity settings (reference CrossSimilarity.scala:115-221).

    ``audio_output``/``audio_output_type`` stay in sync the way the reference
    builder does (:138-156): changing one adjusts the other when extension and
    type currently agree.  Use :meth:`set_audio_output` /
    :meth:`set_audio_output_type` for that coupled behavior; plain attribute
    assignment is uncoupled.
    """

    database_folder: str = "database"
    meta_input1: str = "input1_feat.xml"
    meta_input2: str = "input2_feat.xml"
    audio_output: str = "output.aif"
    audio_output_type: AudioFileType = AIFF
    span1: Span = field(default_factory=Span.all)
    span2: Span = field(default_factory=Span.all)
    temporal_weight: float = 0.5
    normalize: bool = True
    max_boost: float = 8.0

    def __post_init__(self) -> None:
        self.database_folder = _fspath(self.database_folder)
        self.meta_input1 = _fspath(self.meta_input1)
        self.meta_input2 = _fspath(self.meta_input2)
        self.audio_output = _fspath(self.audio_output)
        self.temporal_weight = _f32(self.temporal_weight)
        self.max_boost = _f32(self.max_boost)

    # -- coupled output/type setters (reference :138-156) ---------------------------

    def _output_ext_matches(self) -> bool:
        ext = os.path.splitext(self.audio_output)[1].lstrip(".").lower()
        return ext in self.audio_output_type.extensions

    def set_audio_output(self, value) -> None:
        value = _fspath(value)
        if value == self.audio_output:
            return
        matched = self._output_ext_matches()
        self.audio_output = value
        if matched:
            ext = os.path.splitext(value)[1].lstrip(".").lower()
            tpe = audio_file_type_for_extension(ext)
            if tpe is not None:
                self.audio_output_type = tpe

    def set_audio_output_type(self, value: AudioFileType) -> None:
        if value == self.audio_output_type:
            return
        matched = self._output_ext_matches()
        self.audio_output_type = value
        if matched:
            root = os.path.splitext(self.audio_output)[0]
            self.audio_output = f"{root}.{value.extension}"

    def build(self) -> "CrossSimilarityConfig":
        return dataclasses.replace(self)

    def to_xml(self) -> ET.Element:
        e = ET.Element("crosssimilarity")
        ET.SubElement(e, "database").text = self.database_folder
        ET.SubElement(e, "input1").text = self.meta_input1
        ET.SubElement(e, "input2").text = self.meta_input2
        ET.SubElement(e, "output").text = self.audio_output
        ET.SubElement(e, "outputType").text = self.audio_output_type.id
        if not self.span1.is_all:
            sp = ET.SubElement(e, "span1")
            span_to_xml(self.span1, sp)
        if not self.span2.is_all:
            sp = ET.SubElement(e, "span2")
            span_to_xml(self.span2, sp)
        ET.SubElement(e, "weight").text = fmt_f32(self.temporal_weight)
        ET.SubElement(e, "normalize").text = _bool_str(self.normalize)
        ET.SubElement(e, "maxBoost").text = fmt_f32(self.max_boost)
        return e

    def to_xml_string(self) -> str:
        return _to_xml_string(self.to_xml())

    def save_xml(self, path: str) -> None:
        _save_xml(self.to_xml(), _fspath(path))

    @staticmethod
    def from_xml(xml: ET.Element) -> "CrossSimilarityConfig":
        return CrossSimilarityConfig(
            database_folder=_text(xml, "database"),
            meta_input1=_text(xml, "input1"),
            meta_input2=_text(xml, "input2"),
            audio_output=_text(xml, "output"),
            audio_output_type=audio_file_type_by_id(_text(xml, "outputType")),
            span1=span_from_xml(xml.find("span1")),
            span2=span_from_xml(xml.find("span2")),
            temporal_weight=float(np.float32(_text(xml, "weight"))),
            normalize=parse_bool(_text(xml, "normalize")),
            max_boost=float(np.float32(_text(xml, "maxBoost"))),
        )

    @staticmethod
    def from_xml_file(path) -> "CrossSimilarityConfig":
        return CrossSimilarityConfig.from_xml(_load_xml(_fspath(path)))


# ---------------------------------------------------------------------------
# FeatureStats
# ---------------------------------------------------------------------------

#: The stats "config" is simply a list of feature-file paths
#: (reference FeatureStats.scala:23); the product is a per-channel list of
#: (min, max) — actually robust p01/p99 — ranges.
StatsConfig = List[str]
