#!/usr/bin/env python3
"""The benchmark of alacjax_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Runs the cell named in BENCHMARK.json
once: set-up (the CUDA context, the kernels' library, the inputs made
from the seed on the card, one warm-up call of each batch), a closed
loop of calls for ``--seconds``, then the check of the window's outputs
against the plain reference under benchmark/ref/.  The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, breakdown with --trace 1, checks); the last lines of standard
error give each compared number beside its limit.  Without a card it
exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", "benchmark", _sub)

from benchmark.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
