"""The port's bench family against the originals, on the CPU.

bench_torch.py, bench_configs_torch.py and bench_compression_torch.py
keep their own copies of bench.py's make_music, bench_configs.py's gen
and configs and bench_compression.py's configs and content generators:
here each equals its original on its seed.  bench_torch.measure prints
every key of bench.py's line (read from bench.py's source) plus the
spread of its repeats, and raises when a decode does not give the input
back; bench_configs_torch.run_config prints bench_configs.py's keys;
bench_compression_torch's rows equal bench_compression.py's exactly
(both run the same native C++ codec, each package its own copy).
"""

import ast
import json
import pathlib
import sys

import numpy as np
import pytest

import bench
import bench_compression
import bench_compression_torch
import bench_configs
import bench_configs_torch
import bench_torch
from alacjax_torch import codec as tcodec
from alacjax_torch.types import AlacConfig

REPO = pathlib.Path(__file__).resolve().parents[1]


def _dict_keys(path, is_target):
    """Keys of the first dict literal in ``path`` that ``is_target``
    picks, with the keys of its nested ``detail`` dict."""
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        d = is_target(node)
        if isinstance(d, ast.Dict):
            keys = {k.value for k in d.keys}
            detail = [v for k, v in zip(d.keys, d.values)
                      if k.value == "detail"]
            return keys, ({k.value for k in detail[0].keys} if detail
                          else set())
    raise AssertionError(f"no such dict in {path}")


def _result_dict(node):
    if isinstance(node, ast.Assign) and any(
            getattr(t, "id", None) == "result" for t in node.targets):
        return node.value
    return None


def _dumps_dict(node):
    if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
            == "dumps" and node.args and isinstance(node.args[0], ast.Dict)):
        return node.args[0]
    return None


@pytest.mark.parametrize("nf, S, seed", [(3, 256, 7), (2, 4096, 7),
                                         (5, 100, 11)])
def test_make_music_copy_equals_bench(nf, S, seed):
    a = bench_torch.make_music(nf, S, seed)
    b = bench.make_music(nf, S, seed)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_config_gen_copy_equals_bench_configs():
    assert bench_configs_torch.CONFIGS == bench_configs.CONFIGS
    for _, kw, kind in bench_configs.CONFIGS:
        nch, depth = kw["num_channels"], kw["bit_depth"]
        kind = "escape" if kind == "escape" else "music"
        np.testing.assert_array_equal(
            bench_configs_torch.gen(kind, 3, 128, nch, depth),
            bench_configs.gen(kind, 3, 128, nch, depth))


def test_compression_generators_copy_equals_bench_compression():
    assert bench_compression_torch.CONFIGS == bench_compression.CONFIGS
    assert (set(bench_compression_torch.GENERATORS)
            == set(bench_compression.GENERATORS))
    for name, kw, content in bench_compression.CONFIGS:
        depth, nch = kw["bit_depth"], kw["num_channels"]
        n = 3 * bench_compression.S + 17
        mine = bench_compression_torch.GENERATORS[content](
            np.random.default_rng(2026), nch, n, depth)
        theirs = bench_compression.GENERATORS[content](
            np.random.default_rng(2026), nch, n, depth)
        np.testing.assert_array_equal(mine, theirs, err_msg=name)


def _small_config():
    return AlacConfig(bit_depth=16, num_channels=2, frame_length=256,
                      sample_rate=44100)


def test_measure_line_has_bench_keys_and_the_spread():
    keys, detail_keys = _dict_keys("bench.py", _result_dict)
    line = bench_torch.measure(_small_config(), B=4, iters=1, repeats=2,
                               device="cpu")
    json.dumps(line)
    assert keys <= set(line)
    assert detail_keys <= set(line["detail"])
    d = line["detail"]
    assert d["repeats"] == 2 and len(d["repeat_frames_per_sec"]) == 2
    rates = d["repeat_frames_per_sec"]
    assert line["value"] == pytest.approx(float(np.median(rates)))
    assert d["spread"] == pytest.approx((max(rates) - min(rates))
                                        / line["value"])
    assert d["device"] == "cpu" and d["mesh_devices"] is None
    assert line["metric"] == bench_torch.metric_name(_small_config())
    assert "native C++" in d["baseline_note"]


def test_metric_at_bench_configuration_is_bench_metric():
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=4096,
                     sample_rate=44100)
    src = (REPO / "bench.py").read_text()
    assert f'"metric": "{bench_torch.metric_name(cfg)}"' in src


def test_measure_raises_when_a_sample_differs(monkeypatch):
    """The losslessness gate: a decode that returns one sample off voids
    the measurement."""
    real = tcodec.TorchCodec._decode

    def flipped(self, words, *args, **kwargs):
        pcm, err, num = real(self, words, *args, **kwargs)
        pcm = pcm.clone()
        pcm[0, 0, 0] += 1
        return pcm, err, num

    monkeypatch.setattr(tcodec.TorchCodec, "_decode", flipped)
    with pytest.raises(bench_torch.NotLossless):
        bench_torch.measure(_small_config(), B=4, iters=1, repeats=1,
                            device="cpu")


def test_cuda_bench_without_a_card_exits_nonzero(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_torch.main([]) == 1
    assert bench_configs_torch.main([]) == 1
    assert capsys.readouterr().out == ""


def test_run_config_has_bench_configs_keys():
    keys, _ = _dict_keys("bench_configs.py", _dumps_dict)
    name, kw, kind = bench_configs_torch.CONFIGS[1]
    assert name == "mono 16-bit"
    line = bench_configs_torch.run_config(name, kw, kind, B=2, iters=1,
                                          device="cpu", S=256)
    json.dumps(line)
    assert set(line) == keys
    assert line["config"] == name and line["lossless"] is True


def test_compression_rows_equal_bench_compression(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench_compression.py", "--frames",
                                      "24", "--json"])
    rc = bench_compression.main()
    theirs = json.loads(capsys.readouterr().out)
    assert bench_compression_torch.main(["--frames", "24", "--json"]) == rc
    mine = json.loads(capsys.readouterr().out)
    assert mine == theirs
    assert len(mine["rows"]) == len(bench_compression.CONFIGS)
