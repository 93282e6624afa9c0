"""The port's differential campaign (tools/torch_fuzz_soak.py) on the
CPU, held against alacjax: grammar batches of random legal header
parameters for every GRAMMAR_SHAPES entry, the DSE/FIL and
deviant-bytesShifted batches, and content rounds of adversarial frames
for every CONTENT_SHAPES entry at two seeds, through the plain torch
versions (TorchCodec(..., device="cpu") and decode_frames_device) at
S=256, B=8.  Tolerance zero: the port's PCM equals alacjax's ALACDecoder
and alacjax.native's decoder on every grammar packet, and its packets
equal alacjax's ALACEncoder(independent_frames=True) on every content
lane.  Also: a legal packet longer than the escape bound (a forced weak
predictor on noise) decodes through decode_frames_ex, a packet longer
than any legal one goes to the oracle without widening the word image,
an SCE tag where the layout has its LFE (FFmpeg's 5.1) decodes on the
device path, and the soak tool exits nonzero without a card.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from alacjax import native as jnative
from alacjax.oracle import ALACDecoder as JDecoder
from alacjax.oracle import ALACEncoder as JEncoder
from alacjax.types import AlacConfig as JConfig
from alacjax_torch import TorchCodec
from alacjax_torch.codec import (
    _max_packet_bytes, _num_words, packet_image_words,
)
from alacjax_torch.types import AlacConfig, ElementTag

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

SIZES = soak.CPU


def _cfgs(depth, nch, **kw):
    kw = dict(bit_depth=depth, num_channels=nch, frame_length=SIZES.S, **kw)
    return AlacConfig(**kw), JConfig(**kw)


@pytest.mark.parametrize("depth,nch", soak.GRAMMAR_SHAPES,
                         ids=lambda v: str(v))
def test_grammar_batch_matches_alacjax_decoders(depth, nch):
    cfg, jcfg = _cfgs(depth, nch)
    stats = soak.Stats()
    packets, src, pcm = soak.grammar_round(cfg, 10_000_000 + depth + nch,
                                           SIZES, "cpu", stats)
    assert stats.lanes == {"grammar": SIZES.B}
    dec = JDecoder(jcfg)
    nd = jnative.NativeDecoder(jcfg)
    pcm = pcm.numpy()
    for lane, p in enumerate(packets):
        y, got = dec.decode_packet(p)
        assert got == SIZES.S
        np.testing.assert_array_equal(pcm[lane], y, err_msg=f"lane {lane}")
        yn, gotn = nd.decode_packet(p)
        assert gotn == SIZES.S
        np.testing.assert_array_equal(pcm[lane], yn, err_msg=f"lane {lane}")


@pytest.mark.parametrize("depth,nch", soak.SPECIAL_SHAPES,
                         ids=lambda v: str(v))
def test_dse_fil_and_deviant_lanes_flag_and_fall_back(depth, nch):
    """The device flags exactly the DSE/FIL and deviant-bytesShifted
    lanes; decode_frames_ex gives alacjax's oracle PCM there and
    alacjax.native's everywhere."""
    cfg, jcfg = _cfgs(depth, nch)
    stats = soak.Stats()
    packets, flagged = soak.special_round(cfg, 10_500_000 + nch, SIZES,
                                          "cpu", stats)
    assert len(flagged) == 2 * SIZES.special
    assert stats.fallback == {"special": len(flagged)}
    out, nums = TorchCodec(cfg, chunk=SIZES.B, device="cpu") \
        .decode_frames_ex(packets)
    dec, nd = JDecoder(jcfg), jnative.NativeDecoder(jcfg)
    for lane, p in enumerate(packets):
        yn, got = nd.decode_packet(p)
        assert nums[lane] == got == SIZES.S
        np.testing.assert_array_equal(out[lane], yn)
        if lane in flagged:
            y, _ = dec.decode_packet(p)
            np.testing.assert_array_equal(out[lane], y)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("depth,nch", soak.CONTENT_SHAPES,
                         ids=lambda v: str(v))
def test_content_round_matches_alacjax_encoder(depth, nch, seed):
    cfg, jcfg = _cfgs(depth, nch)
    stats = soak.Stats()
    codec = TorchCodec(cfg, chunk=SIZES.B, device="cpu")
    x, nums, pkts = soak.content_round(cfg, codec, 20_000_000 + seed, SIZES,
                                       stats)
    enc = JEncoder(jcfg, independent_frames=True)
    for i in range(SIZES.B):
        assert pkts[i] == enc.encode_packet(x[i, :, :nums[i]]), f"lane {i}"
    assert stats.fallback == {"content": 0}


def test_decode_frames_ex_takes_a_packet_longer_than_the_escape_bound():
    """A forced weak predictor on hostile content makes a legal packet
    longer than the escape packet, which no encoder writes but every
    decoder reads: decode_frames_ex widens that chunk's word image, and
    the device decode returns alacjax's oracle PCM with no frame to the
    oracle."""
    cfg, jcfg = _cfgs(16, 2)
    rng = np.random.default_rng(3)
    pcm = [soak.gen_pcm(rng, k, 2, SIZES.S, 16)
           for k in ("noise", "sine", "noise", "impulse")]
    params = [soak.Params([31, 0], [7, 0], [0, 0], [0, 7], 10, -77),
              soak.Params([4, 8], [0, 0]),
              soak.Params([0, 31], [1, 2], [0, 0], [1, 5], 1, 1),
              soak.Params([8, 1], [0, 7], [15, 1], [3, 3], 4, 100)]
    packets = soak.build_packets(cfg, pcm, params)
    lens = [len(p) for p in packets]
    assert max(lens) > 4 * _num_words(cfg), lens
    codec = TorchCodec(cfg, chunk=SIZES.B, device="cpu")
    out, nums = codec.decode_frames_ex(packets)
    assert codec.fallback_frames == 0
    dec = JDecoder(jcfg)
    for lane, p in enumerate(packets):
        y, got = dec.decode_packet(p)
        assert nums[lane] == got
        np.testing.assert_array_equal(out[lane], y)


def test_decode_frames_ex_sends_a_packet_longer_than_any_legal_one_to_the_oracle():
    """A packet past the legal maximum (a legal one with trailing bytes,
    as a damaged packet table gives) stays out of the word image, whose
    width stays the chunk's longest legal packet's, and decodes on the
    oracle as alacjax's oracle decodes it."""
    cfg, jcfg = _cfgs(16, 2)
    rng = np.random.default_rng(4)
    pcm = [soak.gen_pcm(rng, k, 2, SIZES.S, 16)
           for k in ("noise", "sine", "impulse")]
    params = [soak.Params([31, 0], [7, 0], [0, 0], [0, 7], 10, -77),
              soak.Params([4, 8], [0, 0]),
              soak.Params([8, 1], [0, 7], [15, 1], [3, 3], 4, 100)]
    legal = soak.build_packets(cfg, pcm, params)
    cap = _max_packet_bytes(cfg)
    assert max(map(len, legal)) <= cap
    packets = legal + [legal[1] + bytes(cap + 1 - len(legal[1]))]
    width, over = packet_image_words(cfg, packets)
    assert over.tolist() == [False, False, False, True]
    assert width == max(_num_words(cfg),
                        -(-max(map(len, legal)) // 4) + 2)
    codec = TorchCodec(cfg, chunk=SIZES.B, device="cpu")
    out, nums = codec.decode_frames_ex(packets)
    assert codec.fallback_frames == 1
    dec = JDecoder(jcfg)
    for lane, p in enumerate(packets):
        y, got = dec.decode_packet(p)
        assert nums[lane] == got == SIZES.S
        np.testing.assert_array_equal(out[lane], y)


class _SceForLfe(AlacConfig):
    """A config whose packets carry an SCE where the layout has its LFE,
    as FFmpeg's encoder writes 5.1 (and 6.1, 7.1)."""

    @property
    def elements(self):
        return tuple((ElementTag.SCE if tag == ElementTag.LFE else tag, w)
                     for tag, w in super().elements)


@pytest.mark.parametrize("nch", [6, 7, 8])
def test_sce_in_the_lfe_slot_decodes_on_the_device_path(nch):
    """The oracle and the reference decoder take an SCE or an LFE tag for
    a mono element; the device parse does too, so no frame of such a
    stream goes to the oracle, and the PCM is alacjax's oracle's."""
    cfg, jcfg = _cfgs(16, nch)
    rng = np.random.default_rng(nch)
    pcm = [soak.gen_pcm(rng, k, nch, SIZES.S, 16)
           for k in ("sine", "noise", "impulse", "sine")]
    params = [soak.Params(*soak.rand_params(rng, nch, 8)) for _ in pcm]
    packets = soak.build_packets(
        _SceForLfe(bit_depth=16, num_channels=nch, frame_length=SIZES.S),
        pcm, params)
    codec = TorchCodec(cfg, chunk=SIZES.B, device="cpu")
    out, nums = codec.decode_frames_ex(packets)
    assert codec.fallback_frames == 0
    dec = JDecoder(jcfg)
    for lane, p in enumerate(packets):
        y, got = dec.decode_packet(p)
        assert nums[lane] == got == SIZES.S
        np.testing.assert_array_equal(out[lane], y)


def test_soak_exits_nonzero_without_a_card():
    """The tool's default device is the card: without one, and without
    --device cpu, it exits 2 and runs nothing."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_fuzz_soak.py"), "0.01",
         "0"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "--device cpu" in proc.stderr
    assert "[soak]" not in proc.stdout
