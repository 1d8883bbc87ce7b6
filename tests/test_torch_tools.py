"""The port's planner-scale tools (``tools/torch/``) against the JAX tools
(``tools/``), on the CPU.

- ``large_scale_check``: at 3,000 rows, band 8, the port's structural
  counts (blocks, tiles, store MB, C blocks, effective flops) equal the JAX
  tool's (the same numpy pattern, draw for draw), and the port's C agrees
  with a dense float64 product to 1e-4 of its largest entry (float32 data
  drawn on the device, so not the JAX tool's data);
- ``weak_scaling``: on 1 and 4 CPU ranks in one process and on 2 processes
  over gloo, the JAX tool's readings are there (``virtual_mesh`` under its
  new name ``shared_device``), the efficiency is positive and finite, and
  the two-process n-rank product is bit for bit the one-process product
  over two virtual ranks.

The JAX tools run as programs (``tools/_bootstrap.py`` sets JAX's platform
at import), never in the test process.
"""
import ast
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_example_runner import REPO, finish_jax, load, start_jax

torch.set_num_threads(1)

large_scale_check = load("tools/torch/large_scale_check.py", "torch_large_scale_check")
weak_scaling = load("tools/torch/weak_scaling.py", "torch_weak_scaling")


def test_large_scale_check_counts_equal_the_jax_tools():
    jax = start_jax("large_scale_check.py", "3000", "8", runner=False)
    port = large_scale_check.run(3000, 8, device="cpu")
    jlines, _ = finish_jax(jax)
    ref = ast.literal_eval(jlines[-1])
    for key in ("blocks", "n_tiles", "store_mb", "c_blocks", "eff_flops"):
        assert port[key] == ref[key], key
    assert port["clock"] == "host perf_counter" and port["device_peak_mb"] is None
    assert port["launches"] == {} and port["tuned_class"] is None  # CPU: no table
    # sampled while the tool ran: never above the process's high-water mark
    assert 0 < port["host_peak_rss_mb"] <= port["host_hwm_mb"] * 1.01


def test_large_scale_check_product_against_dense_float64():
    import dbcsr_tpu_torch as dt

    a, b, _ = large_scale_check.build(3000, 8, "cpu")
    for driver in ("auto", "stack"):
        leg, fn, c_index, prod = large_scale_check.measure(a, b, driver)
        assert leg["route"] == fn.plan.route
        c = dt.BCSRMatrix(name="C", index=c_index, data=prod)
        ref = a.to_dense().double() @ b.to_dense().double()
        err = float((c.to_dense().double() - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (driver, err)
    assert leg["route"] == "stack"


def test_large_scale_check_without_cuda_names_the_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        large_scale_check.main(["3000"])


def _check_readings(out: dict, jax_keys: set, n: int) -> None:
    assert (jax_keys - {"virtual_mesh"}) | {"shared_device"} <= set(out)
    assert out["devices"] == n and out["shared_device"] is True
    assert 0 < out["weak_scaling_efficiency_median"] < math.inf
    assert len(out["efficiency_rounds"]) == out["rounds"]


@pytest.fixture(scope="module")
def jax_weak_scaling_keys():
    jax = start_jax("weak_scaling.py", "4", "2", "1", devices=4, runner=False)
    jlines, _ = finish_jax(jax)
    return set(ast.literal_eval(jlines[-1]))


@pytest.mark.parametrize("ranks", [1, 4])
def test_weak_scaling_on_cpu_ranks(jax_weak_scaling_keys, ranks):
    out = weak_scaling.run(8, 3, 1, devices=["cpu"], ranks=ranks)
    _check_readings(out, jax_weak_scaling_keys, ranks)
    assert out["grid"] == ([1, 1] if ranks == 1 else [2, 2])
    assert "efficiency_x_n_median" in out and "orchestration only" in out["note"]


def test_weak_scaling_across_two_gloo_processes(jax_weak_scaling_keys):
    one = weak_scaling.run(8, 3, 1, devices=["cpu"], ranks=2)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch", "weak_scaling.py"),
         "8", "3", "1", "--nprocs", "2", "--device", "cpu", "--backend", "gloo"],
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True, text=True,
        timeout=180, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    two = json.loads(res.stdout.splitlines()[-1])
    _check_readings(two, jax_weak_scaling_keys, 2)
    assert two["processes"] == 2 and two["grid"] == one["grid"] == [1, 2]
    assert two["product_digest"] == one["product_digest"]
    assert np.isfinite(two["t_ndev_median_s"])


chunk_work = load("tools/torch/chunk_work.py", "torch_chunk_work")


def test_chunk_work_counts_what_the_executor_issues():
    """``chunk_work`` on the benchmark's water pattern at 2 × 2 × 2 cells
    (the fewest its 8 Å cutoff admits): its tile figure, its 8-deep figure
    and its effective flops are the float64 executor's ``padded_flops``,
    ``hw_flops`` and effective flops on the same pattern, and each finer
    granularity issues no more than the coarser."""
    import dbcsr_tpu_torch as dt

    out = chunk_work.main(["--replicas", "2", "2", "2"])
    w, t = out["work"], out["tile"]
    assert w["tile"] == 2.0 * out["entries"] * t**3
    assert 0 < w["skip8"] <= w["skip16"] < w["tile"]
    assert out["tile_util_pct"]["skip8"] == 100.0 * out["eff_flops"] / w["skip8"]

    from benchmark.operands import pattern_of
    from dbcsr_tpu_torch.block.index import build_index
    from dbcsr_tpu_torch.block.store import store_layout

    with open(os.path.join(REPO, "benchmark", "configs", "water_2048.json")) as f:
        cfg = json.load(f)
    cfg["replicas"] = [2, 2, 2]
    blocks = pattern_of(cfg).blocks
    sizes = blocks.row_sizes.astype(np.int32)
    index, _ = build_index(blocks.rows.astype(np.int32), blocks.cols.astype(np.int32),
                           sizes, sizes)
    n_tiles = store_layout(index, t).n_tiles
    a = dt.BCSRMatrix(name="A", index=index,
                      data=torch.zeros((n_tiles, t, t), dtype=torch.float64))
    # at 2 × 2 × 2 the tile pattern is dense enough for "auto" to take the
    # dense class; the benchmark's 4 × 4 × 4 takes the stack under "auto"
    fn, _, eff = dt.build_multiply_executor("N", "N", a, a, driver="stack")
    assert fn.plan.route == "f64_stack"
    assert (fn.plan.padded_flops, fn.plan.hw_flops, eff) == (w["tile"], w["skip8"],
                                                            out["eff_flops"])


def test_chunk_work_over_a_grid():
    """``chunk_work --grid 2 2`` on the four-card configuration at 2 × 2 × 2
    cells: the plane ranks' tile and 8-deep figures and effective flops sum
    to the one-card counts of the same pattern, and each rank issues less
    than its tile figure at 8-deep masks."""
    cfg = os.path.join(REPO, "benchmark", "configs", "water_4000_2x2.json")
    one = chunk_work.main(["--config", cfg, "--replicas", "2", "2", "2"])
    out = chunk_work.main(["--config", cfg, "--replicas", "2", "2", "2", "--grid", "2", "2"])
    assert out["grid"] == [2, 2] and len(out["ranks"]) == 4
    assert out["entries"] == one["entries"] and out["eff_flops"] == one["eff_flops"]
    for k in ("tile", "skip8"):
        assert out["work"][k] == one["work"][k]
        assert sum(r["work"][k] for r in out["ranks"]) == one["work"][k]
    assert sum(r["eff_flops"] for r in out["ranks"]) == pytest.approx(one["eff_flops"],
                                                                      rel=1e-12)
    for r in out["ranks"]:
        assert 0 < r["work"]["skip8"] < r["work"]["tile"]
        assert r["tile_util_pct"]["skip8"] == 100.0 * r["eff_flops"] / r["work"]["skip8"]
        assert isinstance(r["split_runs"], int) and r["split_runs"] >= 0


def test_chunk_work_ri_counts_what_the_step_issues(tmp_path):
    """``chunk_work --ri`` on the RI configuration cut to one 8-molecule
    cell (its ranges under half of it), T = 64, two batches: the issued
    work of its products, batch by batch, sums to what one step of the
    benchmark's call issues on the CPU (``hardware_flops``); K's few C tiles
    hold every run's work; the segment plan's schedule is no longer than
    one block a run's and no shorter than the balanced one."""
    import dbcsr_tpu_torch as dt
    from benchmark.calls import rihfx_step
    from benchmark.operands import make_operands, pattern_of
    from dbcsr_tpu_torch.core.stats import get_stats, reset_stats

    with open(os.path.join(REPO, "benchmark", "configs", "rihfx_water_64.json")) as f:
        cfg = json.load(f)
    cfg.update({"cell_angstrom": 6.207, "cell_molecules": 8, "pair_angstrom": 3.0,
                "ri_angstrom": 1.5, "eps": math.exp(-1.44 * 3.0), "n_batches": 2, "tile": 64})
    path = tmp_path / "ri_small.json"
    path.write_text(json.dumps(cfg))
    out = chunk_work.main(["--ri", "--config", str(path), "--sms", "132"])
    assert len(out["batches"]) == 2 and out["sms"] == 132
    for b in out["batches"]:
        for k in ("X", "K"):
            m = b[k]["makespan_ms"]
            assert m["balanced"] <= m["segments"] + 1e-12 <= m["one_block_a_run"] + 2e-12
            assert b[k]["longest_run_gflop"] >= b[k]["mean_run_gflop"] > 0
        assert b["K"]["c_tiles"] < b["X"]["c_tiles"] and b["K"]["split_runs"] > 0
    issued = sum(out["step"][k]["issued_gflop"] for k in ("X", "K"))

    dt.init_lib()
    ops = make_operands(cfg, pattern_of(cfg), 7, 1, torch.device("cpu"))
    prog = rihfx_step.Program(cfg, ops)
    reset_stats()
    prog(ops.a[0])
    assert get_stats().hardware_flops / 1e9 == pytest.approx(issued, rel=1e-12)
    prog.release()
