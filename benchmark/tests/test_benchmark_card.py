"""On a card: one short run of each one-card cell through the real command.
Skips without a CUDA device."""
import json
import os
import subprocess
import sys

import pytest

from conftest import BIG_SEED, REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def one_card_cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", one_card_cells())
def test_command_on_card(card, cell):
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(BIG_SEED), "--seconds", "2", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
