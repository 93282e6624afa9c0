"""The port's whole encode slice == alacjax's, bit for bit.

Stereo 16-bit frames of 1024 samples that mix sine, silence, impulse and
one noise frame (which escapes), so both the per-element escape select
and the mixed-assembly arm run; then a batch in which every frame
escapes (the all-escape assembly arm).  The mixed batch's word images
and total bits equal alacjax.codec.encode_frames_device's, and
TorchCodec's packets equal the scalar oracle encoder's (independent
frames).
"""

import numpy as np
import pytest
import jax.numpy as jnp

# encode_frames_jit is jax.jit(encode_frames_device): the same function,
# compiled as one program (twice as fast as eager dispatch on the CPU)
from alacjax.codec import encode_frames_jit as jax_encode
from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig
from alacjax_torch import TorchCodec, get_codec
from conftest import gen_pcm
from torch_encode_cases import torch_config

KINDS = ["sine", "silence", "impulse", "noise", "sine", "sine", "impulse",
         "silence"]


class RecordingCodec(TorchCodec):
    """TorchCodec that keeps the device word image of its last chunk."""

    def _encode(self, pcm):
        self.last = super()._encode(pcm)
        return self.last


def _encode_both(cfg, pcm):
    codec = RecordingCodec(torch_config(cfg), chunk=len(pcm), device="cpu")
    packets = codec.encode_frames(pcm)
    words, bits = codec.last
    jw, jb = jax_encode(jnp.asarray(pcm.astype(np.int32)), cfg,
                        codec.num_words)
    return packets, words, bits, np.asarray(jw), np.asarray(jb)


@pytest.fixture(scope="module")
def mixed():
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=1024)
    rng = np.random.default_rng(1024)
    pcm = np.stack([gen_pcm(rng, k, 2, cfg.frame_length, 16) for k in KINDS])
    return (cfg, pcm) + _encode_both(cfg, pcm)


def test_encode_words_match_jax(mixed):
    _, _, _, words, bits, jw, jb = mixed
    np.testing.assert_array_equal(bits.numpy(), jb)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jw)


def test_encode_runs_both_assembly_arms(mixed):
    """The batch holds escaped and compressed frames."""
    cfg, pcm, _, _, bits, _, _ = mixed
    esc_bits = 23 + 2 * cfg.frame_length * 16 + 3
    escaped = bits.numpy() == esc_bits
    assert escaped[KINDS.index("noise")] and not escaped.all()


def test_codec_packets_match_oracle(mixed):
    cfg, pcm, packets, *_ = mixed
    enc = ALACEncoder(cfg, independent_frames=True)
    for i in range(len(pcm)):
        assert packets[i] == enc.encode_packet(pcm[i]), f"frame {i}"


def test_all_escape_batch_matches_oracle():
    """Every frame escapes: the assembly arm with no emission and no
    merge.  The image past each packet's last bit stays zero, as in
    alacjax's arm."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=256)
    rng = np.random.default_rng(256)
    pcm = np.stack([gen_pcm(rng, "noise", 2, 256, 16) for _ in range(3)])
    codec = RecordingCodec(torch_config(cfg), chunk=len(pcm), device="cpu")
    packets = codec.encode_frames(pcm)
    words, bits = codec.last
    n_bits = 23 + 2 * 256 * 16 + 3
    assert (bits.numpy() == n_bits).all()
    enc = ALACEncoder(cfg, independent_frames=True)
    assert packets == [enc.encode_packet(f) for f in pcm]
    full_words = n_bits // 32
    assert not words.numpy()[:, full_words + 1:].any()


def test_mono_packets_match_oracle_and_roundtrip():
    """The single-element mono layout (one SCE) takes the same path."""
    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=256)
    rng = np.random.default_rng(255)
    pcm = np.stack([gen_pcm(rng, k, 1, 256, 16)
                    for k in ("sine", "noise", "silence", "impulse")])
    codec = get_codec(torch_config(cfg), chunk=3, device="cpu")
    assert get_codec(torch_config(cfg), chunk=3, device="cpu") is codec
    packets = codec.encode_frames(pcm)
    enc = ALACEncoder(cfg, independent_frames=True)
    assert packets == [enc.encode_packet(f) for f in pcm]
    np.testing.assert_array_equal(codec.decode_frames(packets), pcm)
    assert codec.fallback_frames == 0
