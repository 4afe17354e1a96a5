"""Audio file container types.

Covers the subset of ``de.sciss.synth.io.AudioFileType`` the reference uses:
AIFF (feature files, norm file — NonRealtimeProcessor.scala:164,
Strugatzki.scala:417), IRCAM (temp trace files — IOUtil.scala:23) and WAV /
NeXT / Wave64 / Raw as selectable cross-similarity output containers
(CrossSimilarity.scala:128, ``<outputType>`` id serde at :213).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["AudioFileType", "SampleFormat", "AIFF", "WAVE", "IRCAM", "NEXT", "WAVE64", "RAW",
           "WRITABLE_TYPES", "audio_file_type_by_id", "audio_file_type_for_extension"]


@dataclass(frozen=True)
class AudioFileType:
    """A container type with its serde id and recognised filename extensions.

    ``id`` matches ``de.sciss.synth.io.AudioFileType.id`` so that
    ``<outputType>`` XML fields interoperate (CrossSimilarity.scala:213).
    The first extension is the canonical one used when swapping a filename's
    suffix (CrossSimilarity.scala:152-156).
    """

    id: str
    extensions: Tuple[str, ...]

    @property
    def extension(self) -> str:
        return self.extensions[0]


AIFF = AudioFileType("aiff", ("aif", "aiff", "aifc"))
WAVE = AudioFileType("wav", ("wav", "wave"))
WAVE64 = AudioFileType("w64", ("w64",))
IRCAM = AudioFileType("ircam", ("irc", "sf"))
NEXT = AudioFileType("next", ("au", "snd"))
RAW = AudioFileType("raw", ("raw", "bin"))

WRITABLE_TYPES = (AIFF, WAVE, WAVE64, IRCAM, NEXT, RAW)

_BY_ID = {t.id: t for t in WRITABLE_TYPES}


class SampleFormat:
    """Sample encodings used by the framework (subset of synth.io SampleFormat)."""

    INT16 = "int16"
    INT24 = "int24"
    INT32 = "int32"
    FLOAT = "float"   # 32-bit IEEE float — the feature-file format
    DOUBLE = "double"


def audio_file_type_by_id(type_id: str) -> AudioFileType:
    try:
        return _BY_ID[type_id]
    except KeyError:
        raise ValueError(f"unknown audio file type id: {type_id!r}") from None


def audio_file_type_for_extension(ext: str):
    """Find the writable type owning a filename extension, or ``None``.

    Mirrors ``AudioFileType.writable.find(_.extensions.contains(ext))``
    (CrossSimilarity.scala:142).
    """
    ext = ext.lower().lstrip(".")
    for t in WRITABLE_TYPES:
        if ext in t.extensions:
            return t
    return None
