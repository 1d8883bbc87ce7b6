"""The four-card cell ``water4000.2x2_filtered_step`` end to end on the CPU:
its configuration, traffic and call found by name in a tiny copy of the
benchmark, four spawned processes over ``gloo``, each judged over its own
C tiles (``reference/shards.py``). A sound run is correct; a step that
returns its state unchanged, half of A left out, an answer altered where
it is produced and the exchange between processes left out are not, and
neither is the control (the reference in float32 in the program's place)."""
import numpy as np
import pytest
import torch

from conftest import BIG_SEED, tiny_copy

from benchmark import spec
from benchmark.harness import Context, Job, run
from benchmark.operands import make_operands, pattern_of
from benchmark.reference.layout import tile_keys
from benchmark.reference.product import superset
from benchmark.reference.shards import Held, RowsProduct, held_block_err

CELL = "water4000.2x2_filtered_step"
#: two 32-molecule cells (blocks to 4.6 Å): 192 atoms, 1,472 rows, a 12² tile grid
SMALL = {"replicas": [2, 1, 1]}


@pytest.fixture
def small(tmp_path):
    return tiny_copy(str(tmp_path), **SMALL)


def test_cell_is_found_by_name(small):
    root, here = small
    bench = spec.benchmark(root)
    cell = spec.workload(bench, CELL)
    cfg = spec.config(cell["config"], here)
    mix = spec.traffic(cell["traffic"], here)
    assert cell["chips"] == 4 and cfg["grid"] == [2, 2] and mix["call"] == "cannon_filtered_step"
    names = {m["name"] for m in spec.metrics_of(bench, CELL, "per_layer")}
    assert {"comm.gb_per_step", "comm.shift.ms", "kernel.ms", "tileops.norms.ms",
            "tileops.mask.ms", "kernel.tile_util"} <= names
    assert "kernel_roofline" not in names and "tileops.align.ms" not in names


@pytest.mark.parametrize("fault", [None, "stale", "half", "altered", "exchange"])
def test_four_processes(small, fault):
    root, here = small
    out = run(CELL, BIG_SEED + 3, 0.3, False, root=root, here=here, device="cpu", fault=fault)
    assert out["device"]["count"] == 4
    assert out["correct"] is (fault is None), out["compared"]
    if fault is not None:
        assert out["failed"] >= 1


def test_control_is_not_correct(small):
    root, here = small
    out = run(CELL, BIG_SEED, 0.1, False, root=root, here=here, device="cpu",
              program="control")
    assert out["correct"] is False
    assert out["compared"]["block_err"]["value"] > 100 * out["compared"]["block_err"]["limit"]


def _held_case(small):
    root, here = small
    cfg = spec.config("water_4000_2x2", here)
    pat = pattern_of(cfg, here)
    ops = make_operands(cfg, pat, 3, 1, torch.device("cpu"))
    keys = tile_keys(superset(ops.pattern), int(cfg["tile"]))
    return cfg, ops, keys


def test_held_judge_reads_plan_and_tiles(small):
    """The per-process judge: zero tiles where the product is not zero read
    as wrong; tiles off C's superset, twice listed, or a plan whose ranks
    miss a tile or hold one twice read inf."""
    cfg, ops, keys = _held_case(small)
    ref = RowsProduct(ops.pattern, ops.keys, ops.b, torch.float64)
    t = int(cfg["tile"])
    half = [keys[: len(keys) // 2], keys[len(keys) // 2:]]

    def err(held, store):
        return held_block_err(ref, ops.a[0], held, store, float(cfg["eps"]),
                              float(cfg["norm_tie_rel"]))

    zeros = torch.zeros((len(half[0]), t, t), dtype=torch.float64)
    assert 0.1 < err(Held(keys=half[0], ranks=half), zeros) < np.inf
    assert err(Held(keys=half[0], ranks=[half[0], half[0]]), zeros) == np.inf
    assert err(Held(keys=half[0], ranks=[half[0]]), zeros) == np.inf
    assert err(Held(keys=np.concatenate([half[0][:-1], half[0][:1]])), zeros) == np.inf
    assert err(Held(keys=np.array([keys.max() + 1])), zeros[:1]) == np.inf
    assert err(Held(keys=half[0]), zeros[:-1]) == np.inf


def _ctx(counters=None, calls=4):
    job = Job(cell={}, config={}, traffic={}, seed=0, seconds=1.0, trace=True,
              device="cpu", here=spec.HERE, start_wall=0.0)
    return Context(job=job, kind="cpu", chips=4, pattern=None, setup_s=0.0, calls=calls,
                   elapsed_s=1.0, call_s=[], peak_bytes=0, counters=counters or {})


def test_comm_readers():
    read = spec.reader("comm.gb_per_step")
    assert read(_ctx({"messages": 8, "bytes_sent": 3e9, "bytes_received": 5e9})) == 2.0
    assert read(_ctx({})) is None  # one process: no transfer counts
    assert read(_ctx({"bytes_sent": 1, "bytes_received": 1}, calls=0)) is None
    from dbcsr_tpu_torch.core.timing import reset_timers

    reset_timers()
    assert spec.reader("comm.shift.ms")(_ctx()) is None  # no span, no device time
