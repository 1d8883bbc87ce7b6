"""The port's spans inside the plan-once executors and their counters:
``executor/*`` and ``filtered/*`` timers under the right parents, device
time on CUDA events only while a profiler records, the executor's flops in
``get_stats()``, and ``timer_report``/the callgrind exporter as before when
no device time exists."""
import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core import timing
from dbcsr_tpu_torch.core.config import config_override
from dbcsr_tpu_torch.core.stats import get_stats, print_statistics, reset_stats
from dbcsr_tpu_torch.core.timing import (
    RoutineStat,
    reset_timers,
    timed,
    timer_report,
    timer_stats,
    timings_report_callgraph,
)

T = 8
EPS = 1e-2
#: span -> its parent in a filtered executor's build and steps (None: a root)
FILTERED_TREE = {
    "filtered/build": None,
    "filtered/prep": "filtered/build",
    "executor/build": "filtered/build",
    "executor/symbolic": "executor/build",
    "multiply/route": "executor/build",
    "executor/align": None,
    "filtered/norms": None,
    "filtered/mask": None,
}


def operands(seed: int, dtype=np.float64, n: int = 24):
    rng = np.random.default_rng(seed)
    rbs = dtt.random_block_sizes(n, [2, 3, 5], rng)
    a = dtt.random_matrix(rbs, rbs, 0.3, rng, device="cpu", dtype=dtype, tile=T, name="A")
    b = dtt.random_matrix(rbs, rbs, 0.3, rng, device="cpu", dtype=dtype, tile=T, name="B")
    return a, b


def new_data(m, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(m.data.shape, generator=g, dtype=m.data.dtype) * (m.data != 0)


def edges() -> dict:
    return {k: tuple(v) for k, v in timing._env.edges.items()}


def check_tree(tree: dict) -> None:
    stats, es = timer_stats(), edges()
    assert set(tree) <= set(stats), sorted(stats)
    for name, parent in tree.items():
        callers = {c for c, e in es if e == name}
        assert callers == ({parent} if parent else set()), (name, callers)
    for name, st in stats.items():
        children = sum(t for (c, _), (_, t) in es.items() if c == name)
        assert st.total_time >= children, name


@pytest.mark.parametrize("driver", ["stack", "auto"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_filtered_spans_under_their_parents(driver, dtype):
    a, b = operands(1, dtype)
    reset_timers()
    with config_override(tile_size=T):
        ex = dtt.build_filtered_executor("N", "N", a, b, EPS, driver=driver)
        for i in range(3):
            ex.step(new_data(a, i), b.data)
    check_tree(FILTERED_TREE)
    stats = timer_stats()
    for name in ("filtered/build", "filtered/prep", "executor/build", "executor/symbolic"):
        assert stats[name].calls == 1
    for name in ("executor/align", "filtered/norms", "filtered/mask"):
        assert stats[name].calls == 3


def test_plain_executor_spans():
    a, b = operands(2)
    reset_timers()
    with config_override(tile_size=T):
        fn, _, _ = dtt.build_multiply_executor("N", "N", a, b)
        fn(a.data, b.data)
        fn(new_data(a, 5), b.data)
    check_tree({"executor/build": None, "executor/symbolic": "executor/build",
                "multiply/route": "executor/build", "executor/align": None})
    stats = timer_stats()
    assert stats["executor/align"].calls == 2
    assert not {"filtered/build", "filtered/norms", "filtered/mask"} & set(stats)


class Forbidden:
    def __init__(self, *a, **k):
        raise AssertionError("a CUDA event or synchronise")


def test_no_event_without_cuda(monkeypatch):
    """On the CPU no CUDA event is made, with a profiler recording or not,
    and no span synchronises."""
    monkeypatch.setattr(torch.cuda, "Event", Forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", Forbidden)
    a, b = operands(3)
    reset_timers()
    with config_override(tile_size=T):
        ex = dtt.build_filtered_executor("N", "N", a, b, EPS)
        ex.step(a.data, b.data)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            ex.step(new_data(a, 1), b.data)
    stats = timer_stats()
    assert all(st.device_calls == 0 and st.device_time == 0.0 for st in stats.values())
    assert "device[s]" not in timer_report()


class FakeEvent:
    """``torch.cuda.Event`` on the CPU: each record takes the next tick of
    a fake device clock (ms); ``query`` says what ``done`` says."""

    made = []
    clock = [0.0]
    done = [True]
    waits = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        FakeEvent.made.append(self)

    def record(self, stream=None):
        assert stream is FAKE_STREAM
        FakeEvent.clock[0] += 1.0
        self.t = FakeEvent.clock[0]

    def query(self):
        return FakeEvent.done[0]

    def synchronize(self):
        FakeEvent.waits.append(len(timing._env.stack))

    def elapsed_time(self, end):
        return end.t - self.t


FAKE_STREAM = object()


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.made, FakeEvent.clock, FakeEvent.done, FakeEvent.waits = [], [0.0], [True], []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: FAKE_STREAM)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", Forbidden)
    reset_timers()
    yield FakeEvent
    reset_timers()


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_no_event_without_profiler(fake_cuda):
    with timed("outer"):
        with timed("inner"):
            pass
    assert fake_cuda.made == []
    assert timer_stats()["outer"].device_calls == 0


def test_events_under_a_profiler(fake_cuda):
    with profiled():
        with timed("outer"):  # ticks 1 .. 6
            with timed("inner"):  # ticks 2, 3
                pass
            with timed("inner"):  # ticks 4, 5
                pass
    assert len(fake_cuda.made) == 6
    assert not timing._env.pending  # resolved as each range closed (query)
    stats = timer_stats()
    assert stats["inner"].device_calls == 2 and stats["outer"].device_calls == 1
    assert stats["inner"].device_time == pytest.approx(2e-3)
    assert stats["outer"].device_time == pytest.approx(5e-3)
    assert fake_cuda.waits == []


def test_pending_events_wait_for_the_report_outside_spans(fake_cuda):
    fake_cuda.done[0] = False  # the device has not reached the end events yet
    with profiled():
        for _ in range(4):
            with timed("step"):
                pass
    assert len(timing._env.pending) == 4
    assert fake_cuda.waits == []  # no span waited
    fake_cuda.done[0] = True
    with profiled():
        with timed("step"):
            pass
    assert not timing._env.pending  # completed ones resolve as ranges close
    fake_cuda.done[0] = False
    with profiled():
        with timed("step"):
            pass
    st = timer_stats()["step"]  # waits for the last one, outside any span
    assert fake_cuda.waits == [0]
    assert st.device_calls == 6 and st.device_time == pytest.approx(6e-3)
    assert "device[s]" in timer_report()


def test_reset_drops_pending_events(fake_cuda):
    fake_cuda.done[0] = False
    with profiled():
        with timed("x"):
            pass
    reset_timers()
    assert not timing._env.pending and timer_stats() == {}


def test_filtered_step_device_spans_under_a_profiler(fake_cuda):
    a, b = operands(4)
    with config_override(tile_size=T):
        ex = dtt.build_filtered_executor("N", "N", a, b, EPS)
        assert fake_cuda.made == []  # set-up runs with no profiler
        with profiled():
            for i in range(2):
                ex.step(new_data(a, i), b.data)
    stats = timer_stats()
    for name in ("executor/align", "filtered/norms", "filtered/mask"):
        assert stats[name].device_calls == 2 and stats[name].device_time > 0
    for name in ("filtered/build", "executor/build"):
        assert stats[name].device_calls == 0
    assert len(fake_cuda.made) == 2 * 3 * 2
    assert fake_cuda.waits == []


@pytest.mark.parametrize("filtered", [True, False], ids=["filtered", "plain"])
@pytest.mark.parametrize("n", [1, 4])
def test_executor_counts_its_work(filtered, n):
    a, b = operands(5)
    reset_stats()
    with config_override(tile_size=T):
        if filtered:
            ex = dtt.build_filtered_executor("N", "N", a, b, EPS)
            fn, eff, call = ex.fn, ex.eff_flops, lambda x: ex.step(x, b.data)
        else:
            fn, _, eff = dtt.build_multiply_executor("N", "N", a, b)
            call = lambda x: fn(x, b.data)  # noqa: E731
        assert get_stats().num_multiplications == 0  # building counts nothing
        for i in range(n):
            call(new_data(a, i))
    st = get_stats()
    assert st.num_multiplications == n
    assert st.total_flops == n * eff > 0
    assert st.hardware_flops == n * fn.plan.hw_flops >= st.total_flops
    assert f" multiplications          {n}" in print_statistics()
    reset_stats()


def test_eff_flops_are_the_block_triples():
    a, b = operands(6)
    with config_override(tile_size=T):
        _, _, eff = dtt.build_multiply_executor("N", "N", a, b)
    ai, bi = a.index, b.index
    rbs, cbs = ai.row_block_sizes, bi.col_block_sizes
    kbs = ai.col_block_sizes
    want = 0.0
    for i, k in zip(ai.blk_rows, ai.col_idx):
        for p in range(bi.row_ptr[k], bi.row_ptr[k + 1]):
            want += 2.0 * rbs[i] * kbs[k] * cbs[bi.col_idx[p]]
    assert eff == want


def old_report(stats: dict, max_rows: int = 40) -> str:
    """``timer_report`` as it was before device time."""
    rows = sorted(stats.items(), key=lambda kv: -kv[1].self_time)[:max_rows]
    lines = [f"{'routine':<44} {'calls':>7} {'self[s]':>10} {'total[s]':>10} {'max[s]':>10}"]
    for name, st in rows:
        lines.append(f"{name:<44} {st.calls:>7} {st.self_time:>10.4f} "
                     f"{st.total_time:>10.4f} {st.max_total:>10.4f}")
    return "\n".join(lines)


def timed_tree() -> None:
    reset_timers()
    with timed("outer"):
        for _ in range(2):
            with timed("inner"):
                with timed("leaf"):
                    pass


def test_report_unchanged_without_device_time():
    timed_tree()
    assert timer_report() == old_report(timer_stats())
    assert "device[s]" not in timer_report()


def test_report_device_column_and_callgraph_unchanged(tmp_path):
    timed_tree()
    before = tmp_path / "before.callgrind"
    timings_report_callgraph(str(before))
    plain = timer_report().splitlines()
    timing._env.stats["inner"].device_time = 0.25
    timing._env.stats["inner"].device_calls = 2
    rep = timer_report().splitlines()
    assert rep[0].split() == plain[0].split() + ["device[s]"]
    for old, new in zip(plain[1:], rep[1:]):
        assert new.startswith(old)  # the old row, then the device column
    devs = {r.split()[0]: float(r.split()[-1]) for r in rep[1:]}
    assert devs == {"outer": 0.0, "inner": 0.25, "leaf": 0.0}
    after = tmp_path / "after.callgrind"
    timings_report_callgraph(str(after))
    assert after.read_text() == before.read_text()
    assert "fn=outer" in after.read_text() and "cfn=inner" in after.read_text()
    reset_timers()


def test_routine_stat_defaults():
    st = RoutineStat()
    assert (st.device_time, st.device_calls) == (0.0, 0)


def test_span_cost_tool_on_cpu(tmp_path):
    """``tools/torch/span_cost.py`` at a tiny water box: set-up split by the
    build spans, three loops with the profiler off and three on; no device
    time on the CPU."""
    import importlib.util
    import json
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "benchmark", "configs", "water_2048.json")) as f:
        cfg = dict(json.load(f), replicas=[2, 2, 1], decay_per_angstrom=2.5)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    spec = importlib.util.spec_from_file_location(
        "torch_span_cost", os.path.join(repo, "tools", "torch", "span_cost.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tool.main(["--config", str(path), "--steps", "1", "--device", "cpu"])
    assert [r["executor"] for r in out] == ["filtered", "plain"]
    for r in out:
        assert len(r["step_ms"]["off"]) == len(r["step_ms"]["on"]) == 3
        assert r["device_ms_per_step"] == {} and r["card"] == {"name": "cpu"}
        assert 0 < r["eff_flops"] <= r["hw_flops"]
        s = r["setup"]
        assert s["executor/build"] >= s["executor/symbolic"] + s["multiply/route"]
    assert out[0]["setup"]["filtered/build"] >= (out[0]["setup"]["executor/build"]
                                                 + out[0]["setup"]["filtered/prep"])
    assert "filtered/build" not in out[1]["setup"]
