"""One short run of each cell on the card, as the benchmark's command
runs it (``python -m pytest --noconftest -m cuda benchmark/`` on a
machine with the card); skips here, where there is none."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.lib import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", str(2 ** 31 + 5), "--seconds", "1",
                        "--trace", "0"], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    want = {m["name"] for m in manifest.cell(manifest.load(),
                                              name)["end_to_end"]}
    assert set(r["metrics"]) == want
    assert list(r)[-1] == "checks"
