"""The result line of a run: its keys, the device block, the compared
numbers last; and the real command without a card."""
import json
import os
import subprocess
import sys

from conftest import BIG_SEED, REPO

from benchmark.harness import run


def test_line_fields(tiny):
    root, here = tiny
    out = run("water2048.plain_step", BIG_SEED, 0.5, False, root=root, here=here, device="cpu")
    assert list(out)[-1] == "compared"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"step_ms", "step_p95_ms", "setup_s"}  # no device peak on a CPU
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    c = out["compared"]["block_err"]
    assert 0 <= c["value"] <= c["limit"]
    json.dumps(out)


def test_traced_line(tiny):
    root, here = tiny
    out = run("water2048.oneshot", BIG_SEED, 0.5, True, root=root, here=here, device="cpu")
    assert out["correct"] is True
    assert out["attempted"] == 4
    assert out["device"]["busy_s"] >= 0  # no device operations on the CPU
    assert set(out["metrics"]) <= {"host_plan.ms", "host_exec.ms", "device.idle_pct.oneshot"}
    assert out["metrics"]["host_plan.ms"]["value"] > 0
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_command_without_card_prints_no_result():
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "water2048.filtered_step", "--seed", str(BIG_SEED), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_command_in_bare_directory(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    (no program) gives no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "water2048.filtered_step", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
