"""AirPlay 1 (RAOP) audio on the port's decode: 352-sample 16-bit stereo
packets (the stream every session announces as ``a=fmtp:96 352 0 16 40
10 14 2 255 0 0 44100``) from both kinds of sender, side by side in one
batch.  Apple's senders write compressed CPE packets (the benchmark's
writer, ``benchmark/lib/inputs.py :: write``); PulseAudio's RAOP sink
writes every packet uncompressed, with the sample count in the header
(the partial-frame field) and, as this repo reads ``write_ALAC_data``,
no END tag (``benchmark/ref/raop.py``).

On the CPU, at 64 lanes with a share of PulseAudio's packets of 0, 0.25
and 1, with and without their END tag: ``decode_frames_device`` (the
plain versions) gives back the PCM and equals the benchmark's reference
decoder, the port's scalar ``ALACDecoder`` and alacjax's decode; the
host API routes no frame to the oracle; the decode's counters
(``decode.lanes``, ``decode.escaped``, ``decode.sized``) equal the
lanes' kinds, and with the recorder off it records nothing; the cookie
built from the fmtp line's eleven fields round-trips.

The ``cuda`` test decodes the ``airplay16.receive`` cell's shape on the
card (B = 4096 here) against the CPU's decode, with one
``decode.flags.sync`` per element and the counters equal; on a machine
with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_airplay.py
"""

import json
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch

from alacjax_torch import codec, cookie, kernels
from alacjax_torch.oracle import ALACDecoder
from alacjax_torch.types import AlacConfig, AlacParamError
from alacjax_torch.utils import metrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmark.lib import common, inputs  # noqa: E402
from benchmark.ref import codec as rc  # noqa: E402
from benchmark.ref import raop  # noqa: E402

FMTP = "a=fmtp:96 352 0 16 40 10 14 2 255 0 0 44100"
CONFIG = json.loads((ROOT / "benchmark/configs/airplay16.json").read_text())
S = 352
B = 64
SEED = 2 ** 31 + 352
SHARES = [0.0, 0.25, 1.0]
CASES = [(share, end) for share in SHARES for end in (False, True)]
IDS = [f"pulse{share}-{'end' if end else 'noend'}" for share, end in CASES]


def batch(share: float, end: bool, n: int = B, device="cpu"):
    """(words (n, W) int32, pcm (n, 2, S) int32, pulse (n,) bool, packet
    bits (n,)): Apple's packets (order 4, or 8 on a quarter of the
    channels) and, where a draw from the seed is below ``share``,
    PulseAudio's, with their END tag or without."""
    lay = common.layout(CONFIG)
    pcm = inputs.music(n, lay, CONFIG["sample_rate"], SEED, 1, device)
    force8 = inputs.order8_mask(n, 2, 0.25, SEED, 2, device)
    apple, bits, _ = inputs.write(pcm, lay, force8)
    pulse = torch.rand((n,), generator=inputs.generator(SEED, 4, device),
                       device=device) < share
    words = torch.where(pulse[:, None],
                        raop.write_uncompressed(pcm, lay, end_tag=end), apple)
    bits = torch.where(pulse, raop.packet_bits(S, end), bits)
    return words.contiguous(), pcm, pulse, bits


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    share, end = request.param
    words, pcm, pulse, bits = batch(share, end)
    if share == 0.25:
        assert 0 < int(pulse.sum()) < B, "the mix holds both senders"
    else:
        assert bool(pulse.all()) == (share == 1.0)
    got = codec.decode_frames_device(words, common.port_config(CONFIG), S)
    return dict(end=end, words=words, pcm=pcm, pulse=pulse, bits=bits,
                got=got)


def test_decode_gives_back_the_pcm(case):
    pcm, err, num = case["got"]
    assert torch.equal(pcm, case["pcm"])
    assert not err.any()
    assert num.dtype == torch.int32 and bool((num == S).all())


def test_decode_equals_the_reference_decoder(case):
    """The reference reads both kinds; it requires an END tag, so it
    flags PulseAudio's lanes without one and no other lane."""
    want, n, err = rc.decode(inputs.as_u32(case["words"]),
                             common.layout(CONFIG))
    pcm, _, num = case["got"]
    assert torch.equal(pcm.to(torch.int64), want)
    assert torch.equal(num.to(torch.int64), n)
    assert torch.equal(err, case["pulse"] & ~case["end"])


def test_decode_equals_the_scalar_decoder(case):
    """The port's scalar ALACDecoder reads elements until END, as Apple's
    ALACDecoder does: it decodes every packet that has one, and refuses
    PulseAudio's without one (the bits run out before a tag), which the
    host API therefore never hands it."""
    dec = ALACDecoder(common.port_config(CONFIG))
    pcm = case["got"][0].numpy()
    packets = inputs.packet_bytes(case["words"], case["bits"])
    for b, pkt in enumerate(packets):
        if case["pulse"][b] and not case["end"]:
            with pytest.raises(AlacParamError, match="past end"):
                dec.decode_packet(pkt)
            continue
        x, n = dec.decode_packet(pkt)
        assert n == S
        np.testing.assert_array_equal(x, pcm[b], err_msg=f"lane {b}")


def test_decode_equals_alacjax(case):
    import jax.numpy as jnp
    from alacjax.codec import decode_frames_jit
    from alacjax.types import AlacConfig as JaxConfig
    cfg = common.port_config(CONFIG)
    jcfg = JaxConfig(bit_depth=cfg.bit_depth, num_channels=cfg.num_channels,
                     frame_length=cfg.frame_length,
                     sample_rate=cfg.sample_rate, mb=cfg.mb, pb=cfg.pb,
                     kb=cfg.kb)
    want = decode_frames_jit(
        jnp.asarray(case["words"].numpy().view(np.uint32)), jcfg, S, 8)
    for name, g, w in zip(("pcm", "err", "num"), case["got"], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_host_api_routes_no_frame_to_the_oracle(case, monkeypatch):
    def refuse(*_):
        raise AssertionError("a frame went to the scalar oracle")
    monkeypatch.setattr(codec.OracleDecoder, "decode_packet", refuse)
    tc = codec.TorchCodec(common.port_config(CONFIG), chunk=32,
                          device="cpu")
    pcm, nums = tc.decode_frames_ex(
        inputs.packet_bytes(case["words"], case["bits"]))
    np.testing.assert_array_equal(pcm, case["pcm"].numpy())
    np.testing.assert_array_equal(nums, np.full(B, S))
    assert tc.fallback_frames == 0


def counted_decode(words):
    """The spans and counts of one decode with the recorder on."""
    metrics.drain()
    metrics.drain_counts()
    metrics.enable()
    try:
        codec.decode_frames_device(words, common.port_config(CONFIG), S)
    finally:
        metrics.disable()
    return metrics.drain(), metrics.drain_counts()


def test_counters_equal_the_lanes_kinds(case):
    spans, counts = counted_decode(case["words"])
    call = [s[4] for s in spans if s[2] == "decode"]
    assert len(call) == 1
    n_pulse = int(case["pulse"].sum())
    assert counts == [("decode.lanes", B, call[0]),
                      ("decode.escaped", n_pulse, call[0]),
                      ("decode.sized", n_pulse, call[0])]


@pytest.mark.parametrize("share", SHARES)
def test_recorder_off_records_nothing(share):
    words = batch(share, False)[0]
    metrics.drain()
    metrics.drain_counts()
    codec.decode_frames_device(words, common.port_config(CONFIG), S)
    assert metrics.drain() == [] and metrics.drain_counts() == []


def test_a_count_outside_every_span_has_no_call():
    metrics.drain_counts()
    metrics.enable()
    try:
        metrics.count("lanes", 3)
        with metrics.span("call"):
            metrics.count("lanes", 4)
    finally:
        metrics.disable()
    (_, _, _, _, call, _), = metrics.drain()
    assert metrics.drain_counts() == [("lanes", 3, None), ("lanes", 4, call)]


def test_cookie_from_the_fmtp_line_round_trips():
    """The fmtp line's eleven fields are ALAC's cookie fields in cookie
    order; the configuration file holds them."""
    fields = [int(x) for x in FMTP.split()[1:]]
    names = ["frame_length", "compatible_version", "bit_depth", "pb", "mb",
             "kb", "num_channels", "max_run", "max_frame_bytes",
             "avg_bit_rate", "sample_rate"]
    assert len(fields) == 11
    cfg = AlacConfig(**dict(zip(names, fields)))
    blob = cookie.serialize_cookie(cfg)
    assert blob == struct.pack(">IBBBBBBHIII", *fields)
    assert cookie.parse_cookie(blob) == cfg
    assert {k: CONFIG[k] for k in names} == dict(zip(names, fields))
    assert CONFIG["fmtp"] == FMTP
    port = common.port_config(CONFIG)
    assert all(getattr(port, k) == getattr(cfg, k)
               for k in names if k not in ("max_run",))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the parse, decode and pcm kernels run "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("end", [False, True], ids=["noend", "end"])
def test_receive_shape_on_card(cuda, end):
    """4096 lanes of the cell's mix: the card's decode equals the CPU's
    and the PCM, one parse launch, one flags' sync, the counters equal
    the lanes' kinds."""
    n = 4096
    words, pcm, pulse, _ = batch(0.25, end, n, cuda)
    cfg = common.port_config(CONFIG)
    codec.decode_frames_device(words, cfg, S)           # builds and warms
    torch.cuda.synchronize()
    kernels.reset_launches()
    metrics.drain()
    metrics.drain_counts()
    metrics.enable()
    try:
        got = codec.decode_frames_device(words, cfg, S)
        torch.cuda.synchronize()
    finally:
        metrics.disable()
    spans, counts = metrics.drain(), metrics.drain_counts()
    assert torch.equal(got[0], pcm) and not got[1].any()
    assert bool((got[2] == S).all())
    want = codec.decode_frames_device(words.cpu(), cfg, S)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert [s[2] for s in spans if s[2].endswith(".sync")] == [
        "decode.flags.sync"]
    assert kernels.LAUNCHES["parse"] == 1 and kernels.LAUNCHES["pcm"] == 1
    assert kernels.LAUNCHES["decode"] == 2
    k = int(pulse.sum())
    assert [c[:2] for c in counts] == [("decode.lanes", n),
                                       ("decode.escaped", k),
                                       ("decode.sized", k)]
