"""Audio and feature file I/O: the JAX package's host-only modules,
re-exported so callers of the port need not import the JAX package."""

from strugatzki_tpu.io import audiofile
from strugatzki_tpu.io.audiofile import AudioFileSpec, SampleFormat
from strugatzki_tpu.io.formats import AIFF

__all__ = ["audiofile", "AudioFileSpec", "SampleFormat", "AIFF"]
