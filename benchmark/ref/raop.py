"""AirPlay 1 (RAOP) audio packets in plain torch: the uncompressed ALAC
packet that PulseAudio's RAOP sink writes for every packet it sends
(src/modules/raop/raop-client.c :: write_ALAC_data).

Every RAOP session announces its stream as
``a=fmtp:96 352 0 16 40 10 14 2 255 0 0 44100``: 352-sample packets of
16-bit stereo at 44.1 kHz.  PulseAudio compresses none of them.  Each
packet is one CPE element whose header sets the partial-frame field
(``hassize``: a 32-bit sample count follows the header) and the escape
flag (not compressed), then every sample pair, left then right, as
big-endian 16-bit words.  ``write_ALAC_data`` zeroes its buffer and
writes no END tag after the samples; a receiver stops once the stream's
channels are decoded.

Apple's own senders write compressed CPE packets: the benchmark's
``benchmark/lib/inputs.py :: write`` makes those, and
``benchmark/ref/codec.py :: decode`` reads both kinds.
"""

from __future__ import annotations

import torch

from . import alac
from .alac import I64
from .codec import Layout

HEADER_BITS = 3 + 4 + 12 + 1 + 2 + 1     # tag, instance, unused, flags
COUNT_BITS = 32                          # the sample count (hassize)
SAMPLE_BITS = 16


def packet_bits(n: int, end_tag: bool = False) -> int:
    """Bits of one packet of ``n`` sample pairs (the END tag's 3 with
    ``end_tag``)."""
    return HEADER_BITS + COUNT_BITS + 2 * SAMPLE_BITS * n + 3 * end_tag


# the packet's first 23 bits as write_ALAC_data writes them: tag CPE,
# instance 0, 12 zero bits, hassize 1, bytes shifted 0, not compressed 1
HEADER = ((alac.ID_CPE << 20) | (0 << 16) | (0 << 4) | (1 << 3) | (0 << 1)
          | 1)


def write_uncompressed(pcm, lay: Layout, end_tag: bool = False):
    """(F, 2, S) 16-bit stereo samples -> (F, W) int32 word images at
    ``lay.image_words()`` (big-endian words as int32 bit patterns), one
    PulseAudio packet each; ``end_tag`` appends ID_END after the samples,
    which ``write_ALAC_data`` does not."""
    if lay.bit_depth != 16 or tuple(lay.elements) != (("CPE", 2),):
        raise ValueError("PulseAudio's RAOP packets are 16-bit stereo, one "
                         f"CPE; the layout is {lay}")
    F, C, S = pcm.shape
    if C != 2 or S != lay.frame_length:
        raise ValueError(f"pcm must be (F, 2, {lay.frame_length}), not "
                         f"{tuple(pcm.shape)}")
    dev = pcm.device
    W = lay.image_words()
    if packet_bits(S, True) > 32 * W:
        raise ValueError(f"{S} sample pairs do not fit {W} words")
    img = torch.zeros((F, W), dtype=I64, device=dev)
    rows = torch.arange(F, device=dev)

    def put(pos, value, nbits):
        alac.put_bits(img, rows[:, None], torch.as_tensor(pos, device=dev),
                      torch.as_tensor(value, dtype=I64, device=dev),
                      torch.as_tensor(nbits, device=dev))

    put(torch.zeros((1,), dtype=I64), HEADER, HEADER_BITS)
    put(torch.full((1,), HEADER_BITS, dtype=I64), S, COUNT_BITS)
    j = torch.arange(2 * S, device=dev)
    # sample pair j // 2, channel j % 2: left then right
    words = pcm.to(I64).transpose(1, 2).reshape(F, 2 * S) & 0xFFFF
    put((HEADER_BITS + COUNT_BITS + SAMPLE_BITS * j)[None, :], words,
        SAMPLE_BITS)
    if end_tag:
        put(torch.full((1,), packet_bits(S), dtype=I64), alac.ID_END, 3)
    return torch.where(img >= (1 << 31), img - (1 << 32), img).to(torch.int32)
