"""Audio and feature file I/O: the sample codec, the file types and the
AIFF/AIFC/WAV reader and writer the analyses use."""

from . import audiofile
from .audiofile import AudioFileSpec, SampleFormat
from .formats import AIFF

__all__ = ["audiofile", "AudioFileSpec", "SampleFormat", "AIFF"]
