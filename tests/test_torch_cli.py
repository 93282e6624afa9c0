"""``python -m alacjax_torch.cli``, after tests/test_convert_routing.py
and tests/test_batch.py's CLI tests: the pipe round trip, --check and
batch mode on the torch backend with --device cpu, and the refusal to
run without a card: with the default device and no CUDA device the CLI
exits nonzero, names --backend oracle and --device cpu, and writes
nothing (no file, no stdout).
"""

import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from alacjax_torch.cli import main
from alacjax_torch.containers.caf import read_caf
from alacjax_torch.containers.pcm import pack_pcm, unpack_pcm
from alacjax_torch.containers.wav import WavFile, read_wav, write_wav
from alacjax_torch.convert import verify_lossless
from alacjax_torch.oracle import ALACEncoder
from alacjax_torch.types import AlacConfig, AlacParamError

REPO = pathlib.Path(__file__).resolve().parents[1]
S = 64
CPU = ["--frame-size", str(S), "--device", "cpu"]


def _wav(seed: int, n=3 * S + 5):
    pcm = np.random.default_rng(seed).integers(-500, 500, (2, n))
    return WavFile(44100, 16, 2, pack_pcm(pcm, 16))


class _Stdin:
    def __init__(self, data):
        self.buffer = io.BytesIO(data)


class _Stdout:
    def __init__(self):
        self.buffer = io.BytesIO()


def test_cli_pipe_roundtrip(monkeypatch, tmp_path):
    """'-' paths: wav bytes in -> m4a bytes out -> wav bytes back,
    content-sniffed, lossless, packets equal to the oracle's."""
    wav = _wav(1)
    wav_bytes = write_wav(wav)
    out1 = _Stdout()
    monkeypatch.setattr(sys, "stdin", _Stdin(wav_bytes))
    monkeypatch.setattr(sys, "stdout", out1)
    assert main(["-", "-", "--to", "m4a"] + CPU) == 0
    m4a_bytes = out1.buffer.getvalue()
    assert m4a_bytes[4:8] == b"ftyp"

    out2 = _Stdout()
    monkeypatch.setattr(sys, "stdin", _Stdin(m4a_bytes))
    monkeypatch.setattr(sys, "stdout", out2)
    assert main(["-", "-", "--device", "cpu"]) == 0
    assert out2.buffer.getvalue() == wav_bytes

    out3 = tmp_path / "p.caf"
    monkeypatch.setattr(sys, "stdin", _Stdin(wav_bytes))
    assert main(["-", str(out3), "--independent-frames"] + CPU) == 0
    pcm = unpack_pcm(wav.data, 16, 2)
    enc = ALACEncoder(AlacConfig(frame_length=S, bit_depth=16,
                                 num_channels=2), independent_frames=True)
    assert read_caf(str(out3)).packets == [
        enc.encode_packet(pcm[:, o:o + S]) for o in range(0, pcm.shape[1], S)]
    assert main(["-", "-", "--resume", "--device", "cpu"]) != 0


def test_cli_check_flag(monkeypatch, tmp_path, capsys):
    """--check decodes the output back through the torch backend; a
    source changed after the encode fails the check; --check on a
    decode is rejected."""
    wav = _wav(2)
    src = tmp_path / "c.wav"
    write_wav(wav, str(src))
    out = tmp_path / "c.m4a"
    assert main([str(src), str(out), "--check"] + CPU) == 0
    assert "--check OK" in capsys.readouterr().err

    out1 = _Stdout()
    monkeypatch.setattr(sys, "stdin", _Stdin(write_wav(wav)))
    monkeypatch.setattr(sys, "stdout", out1)
    assert main(["-", "-", "--to", "caf", "--check"] + CPU) == 0
    assert "--check OK" in capsys.readouterr().err

    assert main([str(out), str(tmp_path / "c2.wav"), "--check",
                 "--device", "cpu"]) != 0
    write_wav(_wav(3), str(src))
    with pytest.raises(AlacParamError, match="lossless check FAILED"):
        verify_lossless(str(src), str(out), backend="torch", device="cpu")


def test_cli_batch_mode(tmp_path, capsys):
    srcs, pcms = [], []
    for i, n in enumerate((S, S + 3, 2 * S + 1)):
        p = tmp_path / f"c{i}.wav"
        w = _wav(10 + i, n)
        write_wav(w, str(p))
        srcs.append(str(p))
        pcms.append(unpack_pcm(w.data, 16, 2))
    enc_dir, dec_dir = tmp_path / "enc", tmp_path / "dec"
    assert main(srcs + ["--outdir", str(enc_dir), "--to", "m4a",
                        "--check"] + CPU) == 0
    assert "3 files" in capsys.readouterr().err
    assert sorted(f.name for f in enc_dir.iterdir()) == [
        "c0.m4a", "c1.m4a", "c2.m4a"]
    assert main([str(enc_dir / f"c{i}.m4a") for i in range(3)]
                + ["--outdir", str(dec_dir), "--device", "cpu"]) == 0
    for i, pcm in enumerate(pcms):
        got = read_wav(str(dec_dir / f"c{i}.wav"))
        np.testing.assert_array_equal(unpack_pcm(got.data, 16, 2), pcm)


def test_cli_without_a_card_exits_nonzero_and_writes_nothing(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "x.wav"
    write_wav(_wav(4), str(src))
    out = tmp_path / "y.caf"
    assert main([str(src), str(out)]) != 0
    err = capsys.readouterr().err
    assert "--backend oracle" in err and "--device cpu" in err
    assert not out.exists()
    assert main([str(src), "--outdir", str(tmp_path / "o")]) != 0
    assert not (tmp_path / "o").exists()
    pipe = _Stdout()
    monkeypatch.setattr(sys, "stdin", _Stdin(src.read_bytes()))
    monkeypatch.setattr(sys, "stdout", pipe)
    assert main(["-", "-"]) != 0
    assert pipe.buffer.getvalue() == b""
    # the oracle needs no card
    assert main([str(src), str(out), "--backend", "oracle"]) == 0
    assert out.exists()


def test_cli_module_entry_point(tmp_path):
    """``python -m alacjax_torch.cli``: --help names the backends,
    --device and --devices (ported: no note says it is left out)."""
    proc = subprocess.run([sys.executable, "-m", "alacjax_torch.cli",
                           "--help"], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0
    assert "{oracle,torch}" in proc.stdout and "--device" in proc.stdout
    assert "--devices N" in proc.stdout
    assert "not ported" not in " ".join(proc.stdout.split())
