"""alacjax_torch — the PyTorch/CUDA port of alacjax's batched ALAC codec.

Ported so far: the encode of every element layout, depth 16/20/24/32,
partial tail and search mode (standard, fast, exhaustive) in
independent frames, with the standalone-predictor route as an option;
the stream encode with persistent coefficient banks (encode_streams,
encode_stream_device); the decode of every layout, depth and legal
predictor order (the 8 -> 16 -> 30-tap retry ladder); and the
multi-device frames axis (parallel.ShardedCodec, get_codec(devices=)).
Every scan runs in a hand-written CUDA kernel for Hopper
(``alacjax_torch/csrc``) on CUDA tensors, and in its plain torch version
(``alacjax_torch/ops``) on CPU tensors.  The package imports torch and
never jax; alacjax/ stays the reference it is held to, bit for bit.

Modules:
  * codec       — TorchCodec / get_codec: the batched device codec and
                  its host API (chunks pipelined one ahead),
                  encode_streams / encode_stream_device (persistent
                  banks), and the convert backend "torch"
  * parallel/   — ShardedCodec, frame_mesh: frame batches split across
                  devices
  * containers/ — WAV, CAF, M4A and PCM packing
  * convert     — WAV <-> CAF/M4A file conversion ("oracle", "torch")
  * batch       — convert_many: many files in shared device batches
  * reader      — AlacReader: sample-accurate random access
  * checkpoint  — resumable_encode / finalize: journaled encodes
  * cli         — ``python -m alacjax_torch.cli`` (alacconvert)
  * utils/      — the span recorder (span, readback, enable, drain)
                  and get_logger
  * kernels/, csrc/, ops/ — the CUDA kernels, their wrappers and their
                  plain torch versions
  * types, cookie, bitbuffer, oracle/, native/ — copies of alacjax's
                  host modules; the package exports alacjax's public names
                  (AlacError and its subclasses, ElementTag, parse_cookie,
                  serialize_cookie, BitBuffer, ALACEncoder, ALACDecoder,
                  __version__) from them
"""

from .types import (
    AlacConfig, AlacError, AlacParamError, AlacUnimplementedError,
    ElementTag,
)
from .cookie import parse_cookie, serialize_cookie
from .bitbuffer import BitBuffer
from .oracle import ALACDecoder, ALACEncoder
from .reader import AlacReader

from .codec import TorchCodec, encode_stream_device, encode_streams, get_codec
from .parallel import ShardedCodec

__version__ = "0.1.0"

__all__ = [
    "AlacConfig", "AlacError", "AlacParamError", "AlacUnimplementedError",
    "ElementTag", "parse_cookie", "serialize_cookie", "BitBuffer",
    "ALACEncoder", "ALACDecoder", "AlacReader", "__version__",
    "ShardedCodec", "TorchCodec", "encode_stream_device", "encode_streams",
    "get_codec",
]
