"""The benchmark's manifest, its discovery of parts by name, and its
import rules (CPU; no card needed)."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.lib import harness, manifest

BENCH = manifest.BENCH_DIR
ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_keys_and_names(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in man["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert len(c["source"]) <= 200
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(man)) < 64 * 1024


def test_every_cell_reports_what_it_must(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        got = [m["name"] for m in man["end_to_end"]
               if manifest.reports(m, w["name"])]
        assert "setup_s" in got and len(got) >= 2, w["name"]
        assert any(manifest.reports(m, w["name"]) for m in man["per_layer"])
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert manifest.reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {m["layer"] for m in man["per_layer"]}
    assert layers <= {"host API", "device program", "kernels", "device"}


def test_every_part_resolves_to_a_file(man):
    for w in man["workloads"]:
        cell = manifest.cell(man, w["name"])
        assert os.path.exists(cell["kind"])
        for m in cell["per_layer"]:
            assert hasattr(manifest.load_module(m["reader"]), "read")
        for c in man["configs"]:
            assert json.load(open(os.path.join(ROOT, c["file"])))


def test_new_parts_are_found_without_edits(tmp_path):
    """A cell, configuration, traffic mix and metric added as files (and
    entries) in a copy are found by name."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(tmp_path / "benchmark/configs/cd16.json"))
    cfg["name"] = "hires96"
    cfg.update(bit_depth=24, sample_rate=96000)
    json.dump(cfg, open(tmp_path / "benchmark/configs/hires96.json", "w"))
    mix = dict(json.load(open(tmp_path / "benchmark/traffic/playback.json")),
               batch=16384)
    json.dump(mix, open(tmp_path / "benchmark/traffic/playback-B16384.json",
                        "w"))
    (tmp_path / "benchmark/metrics/calls.decode.py").write_text(
        "def read(t):\n    return t.calls\n")
    man["configs"].append({"name": "hires96", "source": "x",
                           "file": "benchmark/configs/hires96.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "hires96.playback-B16384",
                             "config": "hires96",
                             "traffic": "playback-B16384", "chips": 1,
                             "why": "x"})
    man["per_layer"].append({"name": "calls.decode", "unit": "calls",
                             "better": "higher", "source": "program_counter",
                             "layer": "device program",
                             "moves": "decode_fps",
                             "workloads": ["hires96.playback-B16384"]})
    json.dump(man, open(tmp_path / "BENCHMARK.json", "w"))
    cell = manifest.cell(manifest.load(str(tmp_path)),
                         "hires96.playback-B16384", root=str(tmp_path))
    assert cell["config"]["sample_rate"] == 96000
    assert cell["traffic"]["batch"] == 16384
    assert cell["kind"].endswith("kinds/bulk_decode.py")
    names = [m["name"] for m in cell["per_layer"]]
    assert "calls.decode" in names and "decode_roofline" not in names

    class T:
        calls = 7
    reader = [m for m in cell["per_layer"] if m["name"] == "calls.decode"][0]
    assert manifest.load_module(reader["reader"]).read(T()) == 7


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for ok in ("alacjax_torch", "alacjax_torch.codec", "jaxtyping",
               "flaxen"):
        monkeypatch.setitem(sys.modules, ok, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "alacjax.codec", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["alacjax", "jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module":
            yield node.args[0].value


def _files(sub=""):
    for d, _, fs in os.walk(os.path.join(BENCH, sub)):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    for path in _files():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _files("ref"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "dataclasses",
                                          "__future__", "benchmark"), name


def test_a_run_without_a_card_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cd16.playback", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_loads_no_jax(tmp_path):
    """A whole CPU rehearsal in a fresh process loads neither jax nor
    alacjax (alacjax_torch is loaded)."""
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from benchmark import test_bench_faults as t\n"
            "r = t.rehearse('cd16.playback')\n"
            "from benchmark.lib import harness\n"
            "assert r['correct']\n"
            "assert 'alacjax_torch' in sys.modules\n"
            "print(harness.forbidden_modules())\n") % ROOT
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
