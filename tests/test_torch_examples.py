"""The port's distributed examples run as programs: ``examples/torch/``'s
example 4 (Cannon, 2.5D and SUMMA across processes) and example 7 (the
sharded at-rest loop and a per-process checkpoint), each at two processes
on the CPU over gloo. Each example asserts against its own oracle (a dense
product, the local pipeline) and prints an OK line on its I/O process."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,ok", [
    ("example_4_distributed.py", "OK — every process holds the product"),
    ("example_7_sharded_storage.py", "OK — the sharded loop matches the local one"),
])
def test_distributed_example(script, ok):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", script),
         "--nprocs", "2", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=180, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert ok in res.stdout
    assert res.stdout.count(ok) == 1  # the logger prints on the I/O process only
