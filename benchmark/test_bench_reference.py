"""The benchmark's plain reference and packet writer at tiny sizes on the
CPU: the reference encoder writes the packets the repo's scalar oracle
encoder writes, and the writer's packets (with channels forced to order
8, partial frames, 24-bit shift blocks) decode through the reference
decoder, through the port's plain device decode and through the port's
scalar oracle to the PCM they were written from."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.lib import common, inputs
from benchmark.ref import codec as rc

CONFIGS = {
    "cd16": dict(bit_depth=16, num_channels=2, sample_rate=44100,
                 elements=[["CPE", 2]]),
    "surround24": dict(bit_depth=24, num_channels=6, sample_rate=48000,
                       elements=[["SCE", 1], ["CPE", 2], ["CPE", 2],
                                 ["LFE", 1]]),
}


def config(name: str, S: int) -> dict:
    return dict(CONFIGS[name], frame_length=S, mb=10, pb=40, kb=14,
                search="standard")


def corpus(name: str, S: int = 256, F: int = 6, seed: int = 11):
    cfg = config(name, S)
    lay = common.layout(cfg)
    pcm = inputs.music(F, lay, cfg["sample_rate"], seed, 1, "cpu")
    num = torch.full((F,), S, dtype=torch.int64)
    num[-1] = S // 3
    pcm[-1, :, S // 3:] = 0
    return cfg, lay, pcm, num


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_encoder_writes_the_oracles_packets(name):
    from alacjax_torch.oracle.encoder import ALACEncoder
    cfg, lay, pcm, num = corpus(name)
    img, bits, _ = rc.encode(pcm, lay, num=num)
    got = inputs.packet_bytes(inputs.as_i32(img), bits)
    enc = ALACEncoder(common.port_config(cfg), independent_frames=True)
    for f in range(pcm.shape[0]):
        want = enc.encode_packet(pcm[f, :, :int(num[f])].numpy())
        assert got[f] == want, f


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_writer_packets_decode_to_their_pcm(name):
    import alacjax_torch.codec as port
    from alacjax_torch.oracle import ALACDecoder
    cfg, lay, pcm, num = corpus(name)
    force8 = inputs.order8_mask(pcm.shape[0], lay.channels, 0.5, 3, 2, "cpu")
    force8[0] = True
    words, bits, stats = inputs.write(pcm, lay, force8, num=num)
    assert (stats["order"].T[force8] == 8).all()
    want = pcm.to(torch.int64)
    # the reference decoder
    out, n, err = rc.decode(inputs.as_u32(words), lay)
    assert not err.any() and torch.equal(n, num)
    assert torch.equal(out, want)
    # the port's plain device decode on the CPU
    pcfg = common.port_config(cfg)
    got, perr, pnum = port.decode_frames_device(words, pcfg, lay.frame_length)
    assert not perr.any() and torch.equal(pnum.to(torch.int64), num)
    assert torch.equal(got.to(torch.int64), want)
    # the port's scalar oracle
    dec = ALACDecoder(pcfg)
    for f, pk in enumerate(inputs.packet_bytes(words, bits)):
        y, k = dec.decode_packet(pk)
        assert k == int(num[f])
        assert np.array_equal(y, want[f, :, :k].numpy())


def test_decoder_flags_what_it_cannot_read():
    cfg, lay, pcm, num = corpus("cd16", F=2)
    words, _, _ = inputs.write(pcm, lay, None, num=num)
    img = inputs.as_u32(words)
    img[0, 0] ^= 0xE0000000          # the first element's tag
    _, _, err = rc.decode(img, lay)
    assert err.tolist() == [True, False]


def test_control_precision_changes_every_frame():
    cfg, lay, pcm, num = corpus("cd16", F=3)
    words, _, _ = inputs.write(pcm, lay, None)
    out, _, _ = rc.decode(inputs.as_u32(words), lay)
    assert (out != (out & ~1)).flatten(1).any(1).all()
