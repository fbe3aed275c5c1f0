"""On the card: one short run of each cell's command prints the contract's
last line.  Marked ``gpu``; skips where no card is found."""

import json
import subprocess
import sys

import pytest

import smoke

CELLS = ["q7b.decode.k24", "q3b.decode.k24", "q7b.prefill.k24",
         "q7b.longctx.k24"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2718281828459", "--seconds", "5", "--trace", "0"],
        cwd=smoke.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu"
