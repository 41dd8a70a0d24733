"""On the card: one short run of two cells through the command
as `BENCHMARK.json` gives it. Skips without a CUDA device (decided inside the
test)."""

import json
import subprocess
import sys

import pytest

from bench_toy import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vae_celeba64.jpeg_cached",
                                  "betavaegan_celeba64.synthetic"])
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "3", "--trace", "0"], cwd=str(REPO),
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
