"""The readers of the program's own spans and counters: ``tileops.norms.ms``,
``tileops.mask.ms``, ``tileops.align.ms`` (device time of the
``filtered/norms``, ``filtered/mask`` and ``executor/align`` spans a step)
and ``kernel.tile_util`` (effective over tile flops), on synthetic
contexts, on a program without the spans or counters, and in traced runs
of the tiny cells; and the executor's flop count against the benchmark's
own work count."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import BIG_SEED, REPO, TINY

from benchmark import spec
from benchmark.harness import Context, run
from benchmark.operands import make_operands, pattern_of
from benchmark.products import matrices
from benchmark.workcount import product_work

SPAN_READERS = {"tileops.norms.ms": "filtered/norms", "tileops.mask.ms": "filtered/mask",
                "tileops.align.ms": "executor/align"}
NEW = sorted(list(SPAN_READERS) + ["kernel.tile_util"])


def ctx(calls: int = 4) -> Context:
    return Context(job=None, kind="cpu", chips=1, pattern=None, setup_s=1.0, calls=calls,
                   elapsed_s=2.0, call_s=[0.5] * calls, peak_bytes=0)


@pytest.fixture
def clean():
    from dbcsr_tpu_torch.core.stats import reset_stats
    from dbcsr_tpu_torch.core.timing import reset_timers

    reset_timers()
    reset_stats()
    yield
    reset_timers()
    reset_stats()


def test_declared():
    bench = spec.benchmark(REPO)
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert sorted(got) == NEW
    for name, m in got.items():
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", f"{name}.py"))
        assert m["moves"] == "step_ms"
    assert got["tileops.norms.ms"]["workloads"] == ["water2048.filtered_step"]
    assert got["tileops.mask.ms"]["workloads"] == ["water2048.filtered_step"]
    assert len(got["tileops.align.ms"]["workloads"]) == 2


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader_on_synthetic_context(clean, name):
    from dbcsr_tpu_torch.core import timing

    read = spec.reader(name)
    assert read(ctx()) is None  # no span in the window
    timing._env.stats[SPAN_READERS[name]] = timing.RoutineStat(
        calls=4, total_time=0.01, device_time=0.2, device_calls=4)
    assert read(ctx(4)) == pytest.approx(50.0)  # 0.2 s over 4 steps
    assert read(ctx(0)) is None
    timing._env.stats[SPAN_READERS[name]] = timing.RoutineStat(calls=4, total_time=0.01)
    assert read(ctx()) is None  # host time only: no profiler or no CUDA


class OldStat:
    """A routine's stat as a program without device time has it."""

    calls, total_time, self_time, max_total = 4, 0.5, 0.5, 0.2


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader_on_program_without_device_time(clean, name):
    from dbcsr_tpu_torch.core import timing

    timing._env.stats[SPAN_READERS[name]] = OldStat()
    assert spec.reader(name)(ctx()) is None


def test_tile_util_reader(clean):
    from dbcsr_tpu_torch.core.stats import get_stats

    read = spec.reader("kernel.tile_util")
    assert read(ctx()) is None  # nothing counted
    st = get_stats()
    st.hardware_flops = 2.0 * 128**3 * 1000
    assert read(ctx()) is None  # tiles without effective flops
    st.total_flops = 0.014 * st.hardware_flops
    assert read(ctx()) == pytest.approx(1.4)


def test_existing_readers_unchanged_by_the_new_spans(clean):
    """The readers that were there read the same with the program's new
    spans and counters filled in."""
    from dbcsr_tpu_torch.core import timing
    from dbcsr_tpu_torch.core.stats import get_stats

    bench = spec.benchmark(REPO)
    old = [m["name"] for m in bench["per_layer"] + bench["end_to_end"] if m["name"] not in NEW]
    c = ctx()
    c.timers = {"multiply/plan": (4, 0.2), "multiply/exec": (4, 0.1)}
    before = {n: spec.reader(n)(c) for n in old}
    for span in SPAN_READERS.values():
        timing._env.stats[span] = timing.RoutineStat(calls=4, device_time=0.1, device_calls=4)
    get_stats().total_flops, get_stats().hardware_flops = 1.0, 70.0
    assert {n: spec.reader(n)(c) for n in old} == before


def tiny_cfg() -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", "water_2048.json")) as f:
        return dict(json.load(f), **TINY)


def test_eff_flops_equal_the_work_count():
    import dbcsr_tpu_torch as dt

    cfg = tiny_cfg()
    assert cfg["dtype"] == "float64"
    pattern = pattern_of(cfg)
    ops = make_operands(cfg, pattern, BIG_SEED, 1, torch.device("cpu"))
    a, b = matrices(cfg, ops)
    with dt.config_override(tile_size=int(cfg["tile"])):
        _, _, eff = dt.build_multiply_executor("N", "N", a, b)
        ex = dt.build_filtered_executor("N", "N", a, b, float(cfg["eps"]))
    work = product_work(pattern.blocks, cfg["dtype"])
    assert eff == ex.eff_flops == work.flops > 0


@pytest.mark.parametrize("cell", ["water2048.filtered_step", "water2048.plain_step"])
def test_traced_tiny_cell_reports_tile_util(tiny, clean, cell):
    """On the CPU the spans have no device time, so only the counter's
    metric is reported; it is the plan's effective over tile flops."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.stats import get_stats

    root, here = tiny
    out = run(cell, BIG_SEED, 0.2, True, root=root, here=here, device="cpu")
    assert out["correct"] is True
    got = out["metrics"]
    assert not set(SPAN_READERS) & set(got)
    st = get_stats()
    assert st.num_multiplications == out["attempted"] + 1  # the window and set-up's call
    cfg = spec.config("water_2048", here)
    pattern = pattern_of(cfg, here)
    ops = make_operands(cfg, pattern, BIG_SEED, 1, torch.device("cpu"))
    a, b = matrices(cfg, ops)
    with dt.config_override(tile_size=int(cfg["tile"])):
        fn, _, eff = dt.build_multiply_executor("N", "N", a, b)
    assert got["kernel.tile_util"]["value"] == 100.0 * eff / fn.plan.hw_flops
    assert got["kernel.tile_util"]["unit"] == "%"
    assert 0 < got["kernel.tile_util"]["value"] <= 100
    assert np.isfinite(got["kernel.tile_util"]["value"])
