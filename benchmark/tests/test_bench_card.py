"""One short run of each cell on the card, as the benchmark is run: its
last line has the contract's keys and reads correct."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.load_spec()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace",
         str(trace)], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
