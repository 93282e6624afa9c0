"""Shared by the tests/test_torch_encode_*.py files and
tests/test_torch_predict_legacy.py: a batch of frames from a numpy seed,
encoded once through alacjax_torch's TorchCodec (host API, keeping the
device word image) and once through alacjax's _encode_packet_chunks
compiled as one program, plus the scalar oracle's packets
(independent frames).  The port's calls take the port's own AlacConfig
(``torch_config``), alacjax's calls alacjax's."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from alacjax.codec import _encode_packet_chunks as jax_chunks
from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig
from alacjax_torch import TorchCodec
from alacjax_torch.types import AlacConfig as TorchAlacConfig
from conftest import gen_pcm

S = 1024
KINDS = ["sine", "noise", "impulse", "silence", "sine", "sine", "impulse",
         "sine"]


class RecordingCodec(TorchCodec):
    """TorchCodec that keeps the device word image of its last chunk."""

    def _encode(self, pcm, nums=None):
        self.last = super()._encode(pcm, nums)
        return self.last


def torch_config(cfg: AlacConfig) -> TorchAlacConfig:
    """The port's AlacConfig with the fields of alacjax's ``cfg``."""
    return TorchAlacConfig(**dataclasses.asdict(cfg))


def make_config(depth: int, nch: int, **kw) -> AlacConfig:
    return AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S,
                      **kw)


def make_frames(cfg, seed: int, kinds=KINDS, nums=None):
    """(B, C, S) int32 PCM from conftest.gen_pcm, zero past each frame's
    sample count."""
    rng = np.random.default_rng(seed)
    pcm = np.stack([gen_pcm(rng, k, cfg.num_channels, S, cfg.bit_depth)
                    for k in kinds]).astype(np.int32)
    if nums is not None:
        for b, n in enumerate(nums):
            pcm[b, :, n:] = 0
    return pcm


def torch_encode(cfg, pcm, nums=None, predict_legacy: bool = False):
    """(packets, words (B, W) uint32, bits (B,)) through TorchCodec on the
    CPU: encode_frames for full frames, encode_frames_ex with nums."""
    codec = RecordingCodec(torch_config(cfg), chunk=len(pcm), device="cpu",
                           predict_legacy=predict_legacy)
    packets = (codec.encode_frames(pcm) if nums is None
               else codec.encode_frames_ex(pcm, nums))
    words, bits = codec.last
    return packets, words.numpy().view(np.uint32), bits.numpy()


def jax_encode(cfg, pcm, nums=None):
    """(words (B, W) uint32, bits (B,)) of alacjax's
    _encode_packet_chunks(..., nums=nums)[:2], compiled as one program."""
    nw = (cfg.max_escape_packet_bytes(S) + 3) // 4 + 2
    if nums is None:
        words, bits = jax.jit(lambda p: jax_chunks(p, cfg, nw)[:2])(
            jnp.asarray(pcm))
    else:
        words, bits = jax.jit(lambda p, n: jax_chunks(p, cfg, nw, nums=n)[:2])(
            jnp.asarray(pcm), jnp.asarray(np.asarray(nums, np.int32)))
    return np.asarray(words), np.asarray(bits)


def oracle_packets(cfg, pcm, nums=None):
    enc = ALACEncoder(cfg, independent_frames=True)
    if nums is None:
        return [enc.encode_packet(f) for f in pcm]
    return [enc.encode_packet(f[:, :n]) for f, n in zip(pcm, nums)]


def encode_case(cfg, seed: int, kinds=KINDS, nums=None):
    """One configuration's batch through both packages and the oracle:
    a dict of pcm, nums, packets, words, bits, jwords, jbits, oracle."""
    pcm = make_frames(cfg, seed, kinds, nums)
    packets, words, bits = torch_encode(cfg, pcm, nums)
    jwords, jbits = jax_encode(cfg, pcm, nums)
    return dict(cfg=cfg, pcm=pcm, nums=nums, packets=packets, words=words,
                bits=bits, jwords=jwords, jbits=jbits,
                oracle=oracle_packets(cfg, pcm, nums))


def assert_case_matches(case):
    """Word image and total bits equal alacjax's; packets equal the
    oracle's."""
    np.testing.assert_array_equal(case["bits"], case["jbits"])
    np.testing.assert_array_equal(case["words"], case["jwords"])
    assert case["packets"] == case["oracle"]


def escape_bits(cfg, nums=None):
    """Per-frame bits of a packet whose every element escaped."""
    n = np.full(1, S) if nums is None else np.asarray(nums)
    partial = np.where(n < S, 32, 0)
    return sum(23 + partial + width * cfg.bit_depth * n
               for _, width in cfg.elements) + 3
