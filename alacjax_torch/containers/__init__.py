"""Container I/O — WAV, CAF, and MP4/M4A file handling plus PCM packing:
the port's copy of alacjax/containers/, names and behaviour unchanged.

Rebuild of the reference's L4 layer (convert-utility/: main.cpp WAV parse,
CAFFileALAC.{h,cpp} CAF chunks; SURVEY.md §2 rows 12-13), extended with
the ISO base media (.m4a) container ALAC actually ships in.  All
host-side numpy, fully vectorized (no per-sample python loops on the
file path).
"""

from .pcm import pack_pcm, unpack_pcm
from .wav import read_wav, write_wav
from .caf import read_caf, write_caf, CafFile, ber_decode, ber_encode
from .mp4 import read_m4a, write_m4a

__all__ = [
    "pack_pcm", "unpack_pcm", "read_wav", "write_wav",
    "read_caf", "write_caf", "CafFile", "ber_decode", "ber_encode",
    "read_m4a", "write_m4a",
]
