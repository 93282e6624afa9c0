"""tools/torch_reference_parity.py on the CPU: its self-test (the port's
converter on the torch backend against ``python -m alacjax_torch.cli
--backend oracle --independent-frames`` in the reference binary's place)
on every third corpus file at 64-sample frames is bit-exact and
cross-decodes losslessly; with no reference directory, or an empty one,
it prints the SKIP line and exits 0; without a card it stops unless
--device cpu; the reference build writes only into its work directory.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "torch_reference_parity.py"


def _run(*args):
    return subprocess.run([sys.executable, str(TOOL), *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)


def test_self_test_on_the_cpu_is_bit_exact(tmp_path):
    proc = _run("--self-test", "--device", "cpu", "--frame-length", "64",
                "--every", "3")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["mode"] == "self-test" and out["device"] == "cpu"
    assert out["files"] == 7 and out["value"] == 1.0
    assert out["cross_decode_lossless"] and out["divergent"] == []


def test_empty_reference_prints_skip(tmp_path):
    proc = _run("--reference", str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == "SKIP" and str(tmp_path) in out["reason"]


def test_no_reference_prints_skip():
    proc = _run()
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == "SKIP" and "--reference" in out["reason"]


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_reference_build_leaves_its_sources_alone(tmp_path):
    sys.path.insert(0, str(TOOL.parent))
    try:
        import torch_reference_parity as tool
    finally:
        sys.path.remove(str(TOOL.parent))
    src, work = tmp_path / "ref", tmp_path / "work"
    src.mkdir()
    work.mkdir()
    (src / "main.c").write_text("int main(void) { return 0; }\n")
    binp = tool.build_reference(str(src), str(work))
    assert os.path.commonpath([binp, str(work)]) == str(work)
    assert sorted(os.listdir(src)) == ["main.c"]
    assert subprocess.run([binp]).returncode == 0


def test_no_card_without_device_cpu():
    proc = _run("--self-test")
    assert proc.returncode == 2
    assert "--device cpu" in proc.stderr
