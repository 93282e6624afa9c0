"""The frames axis across devices, on the CPU: alacjax_torch's
ShardedCodec over [cpu] * 2 and [cpu] * 3 splits every chunk into one
share per "device" and must give the unsplit codec's bytes and samples
exactly (full frames, a partial tail, a chunk the device count does not
divide, a share left empty, a decode chunk that climbs the retry
ladder); roundtrip_step is lossless and sums the packets' bytes across
the shares; get_codec keys its cache by the device tuple and bounds its
default by ALACJAX_DEVICES; ``--devices 2`` in the CLI writes the files
``--devices 1`` writes.  Also the port's logger.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig
from alacjax_torch import ShardedCodec, TorchCodec, get_codec
from alacjax_torch import codec as tcodec
from alacjax_torch.cli import main
from alacjax_torch.containers.pcm import pack_pcm
from alacjax_torch.containers.wav import WavFile, write_wav
from alacjax_torch.kernels import decode as k_decode
from alacjax_torch.parallel import frame_mesh
from conftest import gen_pcm
from test_high_order_decode import build_packet
from torch_encode_cases import torch_config

REPO = pathlib.Path(__file__).resolve().parents[1]
S = 64
CPU = torch.device("cpu")
KINDS = ("sine", "noise", "impulse", "silence")


def frames(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([gen_pcm(rng, KINDS[i % 4], cfg.num_channels, S,
                             cfg.bit_depth) for i in range(n)]).astype(np.int32)


@pytest.fixture(params=[2, 3], ids=["cpu2", "cpu3"])
def n_dev(request):
    return request.param


@pytest.mark.parametrize("depth,nch", [(16, 2), (24, 6)])
def test_split_encode_equals_the_unsplit_codec(n_dev, depth, nch):
    """Seven frames in chunks of 5 (6 on the split codec: the chunk
    rounds up to a multiple of the device count), full frames and then
    with a partial tail; every packet equals the unsplit codec's and the
    oracle's."""
    cfg = torch_config(AlacConfig(bit_depth=depth, num_channels=nch,
                                  frame_length=S))
    sharded = ShardedCodec(cfg, [CPU] * n_dev, chunk=5)
    assert sharded.chunk == 6 and sharded.devices == (CPU,) * n_dev
    plain = TorchCodec(cfg, chunk=5, device="cpu")
    pcm = frames(cfg, 7, seed=depth + nch)
    assert sharded.encode_frames(pcm) == plain.encode_frames(pcm)
    nums = np.full(7, S, np.int32)
    nums[-1] = 23
    pcm[-1, :, 23:] = 0
    got = sharded.encode_frames_ex(pcm, nums)
    assert got == plain.encode_frames_ex(pcm, nums)
    enc = ALACEncoder(AlacConfig(bit_depth=depth, num_channels=nch,
                                 frame_length=S), independent_frames=True)
    assert got == [enc.encode_packet(f[:, :n]) for f, n in zip(pcm, nums)]
    out, got_nums = sharded.decode_frames_ex(got)
    np.testing.assert_array_equal(got_nums, nums)
    np.testing.assert_array_equal(out, pcm)


def test_a_share_may_be_empty():
    """Two frames over three devices: the third share holds none."""
    cfg = torch_config(AlacConfig(bit_depth=16, num_channels=2,
                                  frame_length=S))
    sharded = ShardedCodec(cfg, [CPU] * 3, chunk=3)
    plain = TorchCodec(cfg, chunk=3, device="cpu")
    x = torch.from_numpy(frames(cfg, 2, seed=5))
    for got, want in zip(sharded._encode(x), plain._encode(x)):
        assert torch.equal(got, want)
    words, _ = plain._encode(x)
    for got, want in zip(sharded._decode(words), plain._decode(words)):
        assert torch.equal(got, want)


def test_split_decode_climbs_the_ladder_on_the_whole_chunk(n_dev,
                                                           monkeypatch):
    """A chunk of 64 forced-order packets (orders 12 and 24): the 8-tap
    decode flags every lane, so the gathered flags of the whole chunk
    send it to 16 and then 30 taps, on every share; the result equals
    the unsplit codec's with no frame to the oracle."""
    seen = []
    wrapped = k_decode.decode_channel

    def recorder(*args, taps=8, **kwargs):
        seen.append(taps)
        return wrapped(*args, taps=taps, **kwargs)

    monkeypatch.setattr(k_decode, "decode_channel", recorder)
    acfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    rng = np.random.default_rng(1224)
    packets = [build_packet(acfg, gen_pcm(rng, "sine", 2, S, 16),
                            [12 + 12 * (b % 2)] * 2, [15 * (b % 3 == 0)] * 2)
               for b in range(64)]
    sharded = ShardedCodec(torch_config(acfg), [CPU] * n_dev, chunk=64)
    out, nums = sharded.decode_frames_ex(packets)
    assert sharded.fallback_frames == 0
    assert sorted(set(seen)) == [8, 16, 30]
    # two channels per share and rung: every share climbed every rung
    assert seen.count(30) == 2 * n_dev
    plain = TorchCodec(torch_config(acfg), chunk=64, device="cpu")
    want, want_nums = plain.decode_frames_ex(packets)
    np.testing.assert_array_equal(nums, want_nums)
    np.testing.assert_array_equal(out, want)


def test_roundtrip_step_is_lossless_and_sums_the_bytes(n_dev):
    cfg = torch_config(AlacConfig(bit_depth=16, num_channels=2,
                                  frame_length=S))
    sharded = ShardedCodec(cfg, [CPU] * n_dev, chunk=8)
    pcm = frames(cfg, 8, seed=9)
    decoded, words, bits, total, mismatch, err = sharded.roundtrip_step(pcm)
    np.testing.assert_array_equal(decoded.numpy(), pcm)
    assert int(mismatch) == 0 and not err.any()
    packets = sharded.encode_frames(pcm)
    assert int(total) == sum(map(len, packets))
    plain_words, plain_bits = TorchCodec(cfg, chunk=8,
                                         device="cpu")._encode(
        torch.from_numpy(pcm))
    assert torch.equal(words, plain_words) and torch.equal(bits, plain_bits)


def test_get_codec_keys_its_cache_by_the_device_tuple(monkeypatch):
    cfg = torch_config(AlacConfig(bit_depth=16, num_channels=2,
                                  frame_length=S))
    monkeypatch.setattr(tcodec, "_CODEC_CACHE", {})
    one = get_codec(cfg, device="cpu")
    assert type(one) is TorchCodec
    assert get_codec(cfg, device="cpu", devices=1) is one
    assert get_codec(cfg, device="cpu", devices=[CPU]) is one
    two = get_codec(cfg, device="cpu", devices=2)
    assert isinstance(two, ShardedCodec) and two.devices == (CPU, CPU)
    assert get_codec(cfg, device="cpu", devices=["cpu", "cpu"]) is two
    three = get_codec(cfg, device="cpu", devices=3)
    assert three is not two and three.devices == (CPU,) * 3
    assert len(tcodec._CODEC_CACHE) == 3


def test_default_devices_honour_alacjax_devices(monkeypatch):
    """devices=None on "cuda": every visible card, bounded by
    ALACJAX_DEVICES as it reads at lookup; an int takes the first
    cards, as many as there are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.delenv("ALACJAX_DEVICES", raising=False)
    assert tcodec._lookup_devices("cuda", None) == tuple(cards)
    monkeypatch.setenv("ALACJAX_DEVICES", "2")
    assert tcodec._lookup_devices("cuda", None) == tuple(cards[:2])
    monkeypatch.setenv("ALACJAX_DEVICES", "1")
    assert tcodec._lookup_devices("cuda", None) == tuple(cards[:1])
    assert tcodec._lookup_devices("cuda:3", None) == (cards[3],)
    assert tcodec._lookup_devices("cuda", 8) == tuple(cards)
    assert tcodec._lookup_devices("cuda", [cards[0]] * 2) == (cards[0],) * 2
    assert tcodec._lookup_devices("cpu", None) == (CPU,)


def test_sharded_codec_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = torch_config(AlacConfig(bit_depth=16, num_channels=2,
                                  frame_length=S))
    for devices in (None, ["cuda", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedCodec(cfg, devices)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frame_mesh()


def test_frame_mesh_takes_devices_of_one_type():
    assert frame_mesh(["cpu", CPU]) == (CPU, CPU)
    for bad in ([], ["cpu", "meta"]):
        with pytest.raises(ValueError, match="one type"):
            frame_mesh(bad)


def test_cli_devices_2_writes_the_files_of_devices_1(tmp_path):
    """Batch encode to M4A and decode back to WAV, split in two on the
    host and not split: the same bytes."""
    rng = np.random.default_rng(3)
    srcs = []
    for i, n in enumerate((5 * S + 7, 3 * S)):
        p = tmp_path / f"t{i}.wav"
        write_wav(WavFile(44100, 16, 2,
                          pack_pcm(rng.integers(-900, 900, (2, n)), 16)),
                  str(p))
        srcs.append(str(p))
    cpu = ["--frame-size", str(S), "--device", "cpu"]
    out = {}
    for nd in (1, 2):
        enc, dec = tmp_path / f"enc{nd}", tmp_path / f"dec{nd}"
        assert main(srcs + ["--outdir", str(enc), "--to", "m4a", "--check",
                            "--devices", str(nd)] + cpu) == 0
        m4as = sorted(str(p) for p in enc.iterdir())
        assert main(m4as + ["--outdir", str(dec), "--devices", str(nd)]
                    + cpu) == 0
        out[nd] = {p.name: p.read_bytes()
                   for d in (enc, dec) for p in sorted(d.iterdir())}
    assert len(out[1]) == 4 and out[2] == out[1]
    assert main(srcs[:1] + [str(tmp_path / "x.caf"), "--devices", "0"]
                + cpu) == 2


# ---------------------------------------------------------------------------
# utils: the port's logger behaves as alacjax's
# ---------------------------------------------------------------------------
def test_get_logger_reads_alacjax_log():
    code = ("from alacjax_torch.utils import get_logger\n"
            "log = get_logger('alacjax_torch.test')\n"
            "print(log.getEffectiveLevel())\n")
    levels = []
    for value in ("debug", None):
        env = {k: v for k, v in os.environ.items() if k != "ALACJAX_LOG"}
        if value:
            env["ALACJAX_LOG"] = value
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        levels.append(int(proc.stdout))
    assert levels == [10, 30]
