"""The host API's chunk pipelining and the kernels' device guard.

TorchCodec runs one chunk ahead, as alacjax's JaxCodec does: chunk k+1
is queued before chunk k is serialized (encode) or read back and checked
(decode).  On the CPU the same loop runs without pinned buffers or
events, so its order of operations is tested here: for chunk sizes 1, 3
and nf (one chunk, nothing in flight) the packets, the decoded PCM, the
sample counts and fallback_frames are identical, with a partial tail, an
escaped frame and one packet in the second chunk of three that the
8-tap decode flags (order 24), which goes to the oracle.

Every kernel wrapper launches under ``torch.cuda.device`` of its input's
device: the launch path is monkeypatched (no card here) and each wrapper
must enter the guard with its tensor's device and call its kernel inside
it.
"""

import contextlib

import numpy as np
import pytest
import torch

from alacjax.types import AlacConfig as JaxConfig
from alacjax_torch import TorchCodec, kernels
from alacjax_torch.codec import bitpack
from alacjax_torch.kernels import _build
from alacjax_torch.kernels import cost, decode, emit, merge, predict
from alacjax_torch.oracle import ALACDecoder, ALACEncoder
from alacjax_torch.types import AlacConfig
from conftest import gen_pcm
from test_high_order_decode import build_packet

S = 64
NF = 8
TAIL = 29                 # the last frame's sample count
FLAGGED = 4               # a packet of order 24: in the second chunk of 3
CFG = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
KINDS = ["sine", "impulse", "noise", "sine", "sine", "silence", "sine",
         "sine"]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(88)
    pcm = np.stack([gen_pcm(rng, k, 2, S, 16) for k in KINDS])
    nums = np.full(NF, S, dtype=np.int32)
    nums[-1] = TAIL
    pcm[-1, :, TAIL:] = 0
    enc = ALACEncoder(CFG, independent_frames=True)
    want = [enc.encode_packet(f[:, :n]) for f, n in zip(pcm, nums)]
    jcfg = JaxConfig(bit_depth=16, num_channels=2, frame_length=S)
    flagged = build_packet(jcfg, pcm[FLAGGED], [24, 24], [0, 0])
    return pcm, nums, want, flagged


@pytest.fixture()
def order(monkeypatch):
    """The host API's steps in the order they ran: ("enc", rows) for each
    encode call, ("dec", taps) for each decode call, ("ready", n) for
    each readback of n frames, ("w2b", n) for each serialization."""
    log = []
    words_to_bytes = bitpack.words_to_bytes
    ready = TorchCodec._ready

    def w2b(words, bits):
        log.append(("w2b", len(words)))
        return words_to_bytes(words, bits)

    def rdy(host, event):
        log.append(("ready", len(host[0])))
        return ready(host, event)

    monkeypatch.setattr(bitpack, "words_to_bytes", w2b)
    monkeypatch.setattr(TorchCodec, "_ready", staticmethod(rdy))
    return log


class LoggingCodec(TorchCodec):
    def __init__(self, log, *a, **kw):
        super().__init__(*a, **kw)
        self.log = log

    def _encode(self, pcm, nums=None):
        self.log.append(("enc", pcm.shape[0]))
        return super()._encode(pcm, nums)

    def _decode(self, words, taps=8):
        self.log.append(("dec", taps))
        return super()._decode(words, taps)


@pytest.mark.parametrize("chunk", [1, 3, NF])
def test_chunkings_give_identical_packets_and_decode(corpus, order, chunk):
    pcm, nums, want, flagged = corpus
    codec = LoggingCodec(order, CFG, chunk=chunk, device="cpu")
    packets = codec.encode_frames_ex(pcm, nums)
    assert packets == want
    n_chunks = -(-NF // chunk)
    sizes = [min(chunk, NF - off) for off in range(0, NF, chunk)]
    # one chunk ahead: chunk k+1's encode is queued before chunk k's
    # words are read back and serialized
    expect = [("enc", chunk)]
    for k in range(n_chunks):
        if k + 1 < n_chunks:
            expect.append(("enc", chunk))
        expect += [("ready", sizes[k]), ("w2b", sizes[k])]
    assert order == expect
    order.clear()

    stream = list(want)
    stream[FLAGGED] = flagged
    out, got_nums = codec.decode_frames_ex(stream)
    expect = [("dec", 8)]
    for k in range(n_chunks):
        if k + 1 < n_chunks:
            expect.append(("dec", 8))
        expect.append(("ready", sizes[k]))
    assert order == expect
    assert codec.fallback_frames == 1
    np.testing.assert_array_equal(got_nums, nums)
    dec = ALACDecoder(CFG)
    oracle = np.stack([np.pad(y[:, :n], ((0, 0), (0, S - n)))
                       for y, n in map(dec.decode_packet, stream)])
    np.testing.assert_array_equal(out, oracle)
    np.testing.assert_array_equal(np.delete(out, FLAGGED, 0),
                                  np.delete(pcm, FLAGGED, 0))


def test_empty_stream():
    codec = TorchCodec(CFG, chunk=3, device="cpu")
    assert codec.encode_frames(np.zeros((0, 2, S), np.int32)) == []
    out, nums = codec.decode_frames_ex([])
    assert out.shape == (0, 2, S) and nums.shape == (0,)


# ---------------------------------------------------------------------------
# the device guard
# ---------------------------------------------------------------------------
def _i32(*shape, fill=0):
    return torch.full(shape, fill, dtype=torch.int32)


L, T = 4, 8
WRAPPER_CALLS = {
    "alac_cost": lambda: cost.pc_block_cost2(
        _i32(L, T), _i32(L, 16), (4, 8), 16, 9, 10, 40, 14, 16383),
    "alac_emit": lambda: emit.rice_encode_words(
        _i32(L, T), 16, 10, 40, 14, 16383, _i32(L)),
    "alac_merge": lambda: merge.merge_sorted_chunks(
        _i32(L, T), _i32(L, T, fill=-1), _i32(L, 2), _i32(L, 2, fill=-1),
        16),
    "alac_decode": lambda: decode.decode_channel(
        _i32(L, T), _i32(L), T, 16, 10, _i32(L), 14, 16383, _i32(L, 16),
        _i32(L), _i32(L), _i32(L)),
    "alac_predict": lambda: predict.pc_block(_i32(L, T), _i32(L, 16), 4,
                                             16, 9),
    "alac_rice_cost": lambda: predict.rice_cost(_i32(L, T), 16, 10, 40, 14,
                                                16383),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CALLS))
def test_every_wrapper_launches_under_a_device_guard(monkeypatch, name):
    entered, calls = [], []
    inside = [False]

    @contextlib.contextmanager
    def guard(device):
        entered.append(torch.device(device))
        inside[0] = True
        try:
            yield
        finally:
            inside[0] = False

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                calls.append((fn, inside[0]))
                return 0
            return call

    for mod in (cost, emit, merge, decode, predict):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(_build, "lib", Lib)
    before = dict(kernels.LAUNCHES)
    WRAPPER_CALLS[name]()
    assert calls == [(name, True)]
    assert entered == [torch.device("cpu")]
    key = {"alac_cost": "cost", "alac_emit": "emit", "alac_merge": "merge",
           "alac_decode": "decode", "alac_predict": "predict",
           "alac_rice_cost": "rice_cost"}[name]
    assert kernels.LAUNCHES[key] == before[key] + 1
    kernels.LAUNCHES.update(before)
