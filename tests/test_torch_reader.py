"""The port's random-access reader (alacjax_torch/reader.py), after
tests/test_reader.py: range reads equal slices of the source over
packet-crossing, tail-touching and empty or clamped ranges, on CAF and
M4A, through the torch backend on the CPU and the oracle.
"""

import numpy as np
import pytest

from alacjax_torch import AlacReader
from alacjax_torch.containers.caf import write_caf
from alacjax_torch.containers.mp4 import write_m4a
from alacjax_torch.containers.pcm import pack_pcm
from alacjax_torch.containers.wav import WavFile
from alacjax_torch.convert import encode_wav_to_caf
from alacjax_torch.types import AlacParamError

S = 64
N = 5 * S + 17  # ends in a partial tail

RANGES = [
    (0, None),          # whole stream
    (0, S),             # exactly one packet
    (S - 5, 11),        # crosses one boundary
    (S + 3, 3 * S),     # interior, multi-packet, unaligned both ends
    (5 * S, 17),        # exactly the partial tail
    (5 * S + 10, 100),  # clamped at EOF
    (N, 4),             # at EOF -> empty
    (7, 0),             # empty count
]


def _fixture(tmp_path, ext: str):
    rng = np.random.default_rng(17)
    t = np.arange(N)
    pcm = np.clip((np.sin(t * 0.04)[None] * 800).astype(np.int64)
                  + rng.integers(-50, 50, (2, N)), -32768, 32767)
    wav = WavFile(44100, 16, 2, pack_pcm(pcm, 16))
    caf = encode_wav_to_caf(wav, frame_length=S, backend="torch",
                            device="cpu")
    path = str(tmp_path / ("f." + ext))
    (write_caf if ext == "caf" else write_m4a)(caf, path)
    return path, pcm


@pytest.mark.parametrize("backend", ["torch", "oracle"])
@pytest.mark.parametrize("ext", ["caf", "m4a"])
def test_reader_ranges(tmp_path, ext, backend):
    path, pcm = _fixture(tmp_path, ext)
    r = AlacReader(path, backend=backend, chunk=4, device="cpu")
    assert (len(r), r.num_channels, r.sample_rate, r.bit_depth) == (
        N, 2, 44100, 16)
    for start, count in RANGES:
        got = r.read(start, count)
        end = N if count is None else min(start + count, N)
        np.testing.assert_array_equal(got, pcm[:, start:end],
                                      err_msg=f"range {start}+{count}")
    with pytest.raises(AlacParamError):
        r.read(-1, 5)


def test_reader_from_bytes_and_seeded_ranges(tmp_path):
    path, pcm = _fixture(tmp_path, "m4a")
    r = AlacReader(open(path, "rb").read(), backend="torch", device="cpu")
    rng = np.random.default_rng(18)
    for _ in range(4):
        start = int(rng.integers(0, N))
        count = int(rng.integers(0, 2 * S))
        np.testing.assert_array_equal(r.read(start, count),
                                      pcm[:, start:start + count])
    assert r._codec.fallback_frames == 0
